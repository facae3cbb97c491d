"""The card's phase ``wide`` parts (e) and (f) rehearsed on the CPU.

Part (e) serves ``zoo.Gpt(n_heads=3)`` (3 heads of 256 at d 768) and
part (f) ``Gpt(n_heads=2)`` (2 heads of 384), whose bf16 decode and
verify reads run the wide builds of K1 and K2.  Here
``chip_smoke.wide_serve`` runs at a tiny size with the same head widths —
2-layer ``Gpt``s (vocab 50, ff 256) with 2 heads of 256 (d 512) and 2 of
384 (d 768) — with stand-ins that count the paged wrappers' calls as the
card's wrappers count their launches.  (The same tiny models served by
the JAX package's GenerationServer and the port's:
``tests/test_torch_generation_server.py
::test_wide_heads_server_matches_jax_server``.)"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_torch.models import generation  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TINY = dict(vocab_size=50, max_len=64, d_model=512, n_layers=2, n_heads=2,
            d_ff=256, seq_len=16, compute_dtype=None, seed=5)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the card's part (e) at this size: 2 slots of 64 rows, block 8, bf16;
# 4 requests (2 greedy, 2 sampled), then the 2 greedy ones speculative
REHEARSAL = {
    "gpt": {k: TINY[k] for k in ("vocab_size", "max_len", "d_model",
                                 "n_layers", "d_ff")},
    "vocab": TINY["vocab_size"], "kernels": True,
    "serve": {"gpt": {"n_heads": 2},
              "server": {"n_slots": 2, "max_len": 64, "block_size": 8,
                         "tick_batch": 4, "compute_dtype": "bfloat16"},
              "requests": 4, "spec_requests": 2,
              "speculative": {"k": 4, "rounds": 2, "draft_layers": 1,
                              "adaptive": True}}}
# the card's part (f) at this size: the same server and requests, 2 heads
# of 384 at d 768 (the card's first 4 requests and 2 speculative ones)
REHEARSAL["serve_wider"] = {**REHEARSAL["serve"],
                            "gpt": {"n_heads": 2, "d_model": 768}}


def _rehearsal_requests():
    """Part (e)'s request set at this size: a shared 12-token prompt
    behind the first request, sampled ones between greedy ones."""
    rng = np.random.default_rng(2)
    system = rng.integers(0, 50, 12).astype(np.int32)
    reqs = []
    for i in range(4):
        tail = rng.integers(0, 50, int(rng.integers(3, 12))).astype(np.int32)
        prompt = np.concatenate([system, tail]) if i == 0 else tail
        samp = ({"temperature": 0.8, "top_k": 10, "seed": i}
                if i % 2 else None)
        reqs.append((prompt.astype(np.int32), int(rng.integers(6, 11)),
                     samp))
    return system, reqs


@pytest.fixture
def counting_paged(monkeypatch):
    """The generation module's two paged wrappers replaced by stand-ins
    that call them and add one to their own ``launches``, as a wrapper on
    the card counts its kernel's launches (the CPU route counts none)."""
    def stand_in(real):
        def wrapper(*a, **kw):
            out = real(*a, **kw)
            wrapper.launches += 1
            return out
        wrapper.__name__, wrapper.launches = real.__name__, 0
        return wrapper
    for name in ("paged_decode_attention", "paged_verify_attention"):
        monkeypatch.setattr(generation, name,
                            stand_in(getattr(generation, name)))


@pytest.mark.parametrize("key,head_dim", [("serve", 256),
                                          ("serve_wider", 384)])
def test_wide_serve_rehearsal_on_cpu(capsys, one_thread, counting_paged,
                                     key, head_dim):
    from deeplearning4j_torch.kernels import paged_attention as pa
    system, reqs = _rehearsal_requests()
    counts = chip_smoke.wide_serve(torch, np, pa, "cpu", REHEARSAL,
                                   lambda: None, "cpu rehearsal", system,
                                   reqs, key)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["phase"] == f"wide/{key}" and row["head_dim"] == head_dim
    n = TINY["n_layers"]
    plain, spec = row["plain"], row["spec"]
    assert (plain["requests"], plain["greedy"]) == (4, 2)
    assert (spec["requests"], spec["greedy"]) == (2, 2)
    # K1 once a layer a tick, no K2; then K2 once a layer a verify pass
    assert plain["k1_launches"] == n * plain["ticks"] > 0
    assert plain["k2_launches"] == 0
    assert spec["k2_launches"] == n * spec["ticks"] > 0
    assert spec["k1_launches"] > 0
    assert counts == {
        "plain": {"paged_decode_attention": plain["k1_launches"],
                  "paged_verify_attention": 0},
        "spec": {"paged_decode_attention": spec["k1_launches"],
                 "paged_verify_attention": spec["k2_launches"]}}
    # the route of each window's calls is the wide builds' (on the card
    # the launches are counted by build too; the stand-ins count none)
    assert plain["routes"] == {"paged_decode_attention": "wide"}
    assert spec["routes"] == {"paged_decode_attention": "wide",
                              "paged_verify_attention": "wide"}
    assert all(b == {} for part in (plain, spec)
               for b in part["builds"].values())
    # the warm-ups' operands were replayed (the plain route: exact here)
    assert set(plain["kernel_vs_plain"]) == {"paged_decode_attention"}
    assert set(spec["kernel_vs_plain"]) == {"paged_decode_attention",
                                            "paged_verify_attention"}
    assert all(v == 0.0 for part in (plain, spec)
               for v in part["kernel_vs_plain"].values())
