"""``chip_smoke.py``'s mesh phase rehearsed whole on the CPU at a tiny
width (the sizes the card runs are ``chip_smoke.MESH_CFG``'s)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def test_mesh_phase_rehearsal_on_cpu(monkeypatch):
    """``chip_smoke.py``'s mesh phase whole on the CPU at a tiny width
    ([cpu] * 4 for the card listed four times), with counting stand-ins
    for the kernel wrappers (their plain versions): K1 counted per layer,
    shard and tick, K2 per verify pass and shard, K3-K6 per block, shard
    (or microbatch) and step, every loss check and sync-BN check on, and
    each fault control caught."""
    import importlib

    import chip_smoke
    from deeplearning4j_torch.models import generation as G
    fa = importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")
    pa = importlib.import_module(
        "deeplearning4j_torch.kernels.paged_attention")

    def counted(orig, owner=None):
        def wrapper(*a, **kw):
            (owner or wrapper).launches += 1
            return orig(*a, **kw)
        wrapper.launches = 0
        return wrapper

    for name in chip_smoke.FLASH_WRAPPERS:
        monkeypatch.setattr(fa, name, counted(getattr(fa, name)))
    for name in ("paged_decode_attention", "paged_verify_attention"):
        monkeypatch.setattr(G, name, counted(getattr(G, name),
                                             getattr(pa, name)))
    monkeypatch.setattr(chip_smoke, "RESNET_HW", 32)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    gpt = dict(vocab_size=64, max_len=1024, d_model=32, n_layers=2,
               n_heads=4, d_ff=64, seq_len=1024)
    cfg = dict(chip_smoke.MESH_CFG, gpt=gpt, vocab=64, n_slots=4,
               f32_requests=2, f32_new=8, mixed_requests=6,
               spec={"k": 2, "rounds": 2, "draft_layers": 1},
               train_b=2, train_t=512, short_t=512, dp_steps=1,
               tp_steps=1, pp_steps=1, short_steps=1, n_micro=2,
               resnet_b=4, resnet_hw=32, resnet_steps=2,
               ring={"b": 1, "h": 2, "dh": 8, "t": 64, "seq": 4},
               world_gpt=dict(vocab_size=48, max_len=16, d_model=16,
                              n_layers=2, n_heads=2, d_ff=32, seq_len=16),
               world_b=4, world_batches=3)
    counts = chip_smoke.mesh_parts(
        torch, np, "cpu", cfg, lambda: None, "cpu",
        lambda reset=False: None)
    (row,) = lines
    serve = counts["serve"]
    assert serve["bf16"]["paged_decode_attention"] >= \
        2 * 2 * row["a_serve"]["bf16"]["tp2"]["ticks"]
    assert serve["spec"]["paged_verify_attention"] == \
        2 * 2 * row["a_serve"]["spec"]["verify_passes"]
    assert row["a_serve"]["shard_kernels"]["h"] == 2
    train = counts["train"]
    assert train["dp"]["flash_fwd_single"] == 2 * 2
    assert train["pp"]["flash_fwd_single"] == 2 * 2
    assert train["tp"]["flash_fwd_single"] == 2
    assert train["dp_t512"]["flash_fwd_single"] == 2 * 2
    tol = chip_smoke.MESH_TOL
    assert row["c_resnet"]["first_loss_rel_diff"] <= tol["resnet_loss"]
    # every control (a fault injected into a sound run) trips a check
    assert row["c_resnet"]["control_local_bn"]["tripped"]
    ctl = row["b_train"]["controls"]
    assert "first_grad_normwise_diff" in ctl["dp_grad"]["tripped"]
    assert "replicas_equal_master" in ctl["dp_stale"]["tripped"]
    assert row["b_train"]["dp"]["replicas_equal_master"]
    assert row["a_serve"]["f32_data2"]["k1_launches"] >= \
        2 * 2 * 2 * row["a_serve"]["f32_data2"]["ticks"]
    assert row["d_ring"]["out_err"] <= 1e-5
    assert row["e_world"]["backend"] == "gloo"
    assert row["e_world"]["sum"] == 1 and row["e_world"]["or"] is True
