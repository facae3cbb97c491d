"""``Gpt`` with 256- and 192-wide heads in the PyTorch port against the
JAX package.

The card's phase ``wide`` drives ``zoo.Gpt(n_heads=3)`` and
``Gpt(n_heads=4)`` at ``Gpt()``'s widths: 3 heads of 256 and 4 of 192,
whose bf16 forward and backward run the wgmma builds of K3-K6 at those
head dims.  Here the same head widths at a tiny size: a 2-layer
``Gpt(vocab 50, d 512, 2 heads of 256, ff 256)`` (and d 384, 2 heads of
192, for the Adam step) at f32, b 2, t 512 (attention takes the flash
route, one key block: K4; K5 and K6 in the backward).  The JAX
package's parameters are carried into the port
(``utils.load_numpy_params``); the JAX package runs its Pallas kernels
in interpret mode, the port the kernels' plain versions.  Held:
- the head's logits and the loss at f32 atol 1e-5 (different summation
  orders), the loss per token: the per-example loss sums t token losses
  (~2480 here), where one f32 step is already 2.4e-4;
- one Adam step's parameters at 1e-4, with the key-bias third of
  ``bqkv`` at 2e-3 (its gradient is zero up to rounding, and Adam's
  first step turns that noise into steps of ~lr either way, as
  ``tests/test_torch_training.py`` holds it).
JAX compiles once per shape (one run per head width, cached for the
module); torch runs on one thread.  Then ``chip_smoke.wide_parts`` —
the card's parts (b), (c) and (d) — rehearsed at this size on the CPU,
with stand-ins that count the wrappers' calls as the card's wrappers
count their launches."""
import importlib
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.zoo.gpt import Gpt as JaxGpt  # noqa: E402

from deeplearning4j_torch.data import DataSet  # noqa: E402
from deeplearning4j_torch.utils import load_numpy_params  # noqa: E402
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402
from deeplearning4j_torch.zoo import Gpt  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

# the package's ``flash_attention`` name is the function; the module is
# reached by its full path
fa = importlib.import_module("deeplearning4j_torch.kernels.flash_attention")

WIDE = dict(vocab_size=50, max_len=512, d_model=512, n_layers=2, n_heads=2,
            d_ff=256, seq_len=512, compute_dtype=None, seed=7)
# the configuration at each head width: WIDE (2 heads of 256), and d 384
# for 2 heads of 192
WIDTHS = {256: WIDE, 192: {**WIDE, "d_model": 384}}
B, T = 2, 512
LOGIT_TOL, PARAM_TOL, KEY_BIAS_TOL = 1e-5, 1e-4, 2e-3


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _logits(net, x):
    """The head's pre-softmax activations [b, t, vocab] (either
    package)."""
    n = len(net.layers)
    h, _ = net._forward_layers(net.params_tree, net.state_tree, x, False,
                               None, upto=n - 1)
    return net.layers[-1].pre_output(net.params_tree[f"layer_{n - 1}"], h,
                                     net._compute_dtype)


_JAX_RUNS = {}


def _jax_run(dh):
    """The JAX package's run at head width ``dh``, once per module: its
    configuration, initial params, the logits and loss on one batch, and
    its params after one Adam step on it."""
    if dh not in _JAX_RUNS:
        cfg = WIDTHS[dh]
        rng = np.random.default_rng(3)
        x = rng.integers(0, cfg["vocab_size"], (B, T)).astype(np.int32)
        y = rng.integers(0, cfg["vocab_size"], (B, T)).astype(np.int32)
        jnet = JaxGpt(**cfg).init_graph()
        params0 = _np_tree(jnet.params_tree)
        logits = np.asarray(_logits(jnet, jax.numpy.asarray(x)))
        loss = jnet.score(JDataSet(x, y))
        jnet.fit(JDataSet(x, y))
        _JAX_RUNS[dh] = {"cfg": cfg, "x": x, "y": y, "params0": params0,
                         "logits": logits, "loss": loss,
                         "params1": _np_tree(jnet.params_tree)}
    return _JAX_RUNS[dh]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's run at 2 heads of 256."""
    return _jax_run(256)


def _port(run):
    pnet = Gpt(**run["cfg"]).init_graph(device="cpu")
    return load_numpy_params(pnet, run["params0"], device="cpu")


def test_wide_gpt_logits_and_loss_match_jax(jax_run, one_thread):
    pnet = _port(jax_run)
    fa.reset_route_log()
    logits = _logits(pnet, pnet._tensor(jax_run["x"])).numpy()
    loss = pnet.score(DataSet(jax_run["x"], jax_run["y"]))
    # every block took the flash route at head dim 256 (one key block),
    # in the logits' forward and in the loss's
    assert fa.route_log() == (("flash", T, 256),) * (2 * WIDE["n_layers"])
    assert logits.shape == (B, T, WIDE["vocab_size"])
    np.testing.assert_allclose(logits, jax_run["logits"], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(loss / T, jax_run["loss"] / T, rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("dh", [256, 192])
def test_wide_gpt_adam_step_matches_jax(dh, one_thread):
    jax_run = _jax_run(dh)
    pnet = _port(jax_run)
    fa.reset_route_log()
    pnet.fit(DataSet(jax_run["x"], jax_run["y"]))
    # every block's forward took the flash route at this head dim
    assert set(fa.route_log()) == {("flash", T, dh)}
    want = dict(iter_leaves(jax_run["params1"]))
    moved = 0
    for path, leaf in iter_leaves(pnet.params_tree):
        got, ref = leaf.numpy(), want[path]
        if path[-1] == "bqkv":
            d = got.shape[0] // 3
            np.testing.assert_allclose(got[d:2 * d], ref[d:2 * d], rtol=0,
                                       atol=KEY_BIAS_TOL)
            got = np.concatenate([got[:d], got[2 * d:]])
            ref = np.concatenate([ref[:d], ref[2 * d:]])
        np.testing.assert_allclose(got, ref, rtol=0, atol=PARAM_TOL,
                                   err_msg="/".join(path))
        moved += int(not np.array_equal(
            leaf.numpy(), dict(iter_leaves(jax_run["params0"]))[path]))
    assert moved > 0                      # the step changed the params


# the card's phase 10b parts (b)-(d) and (g) at this test's size: (b) at 2
# heads of 256 (K3 at t 1024, K4 at t 512, two fit steps at t 1024), (c)
# at 2 heads of 192 (d 384; K3 at t 1024, two fit steps), (d) at 2 heads
# of 384 (d 768; K3 at t 1024, K4 at t 512, each against plain attention,
# and two fit steps against plain attention's loss curve), (g) at one
# head of 768 (d 768; (d)'s two forward windows, no fit steps);
# the card holds the launch counts in the phase, this test the stand-ins'
REHEARSAL = {"gpt": {k: WIDE[k] for k in ("vocab_size", "d_model",
                                          "n_layers", "d_ff")}
             | {"max_len": 1024},
             "vocab": WIDE["vocab_size"], "b": B, "t": 1024,
             "t_single": T, "steps": 2, "heads": 2,
             "narrow": {"n_heads": 2, "d_model": 384},
             "wider": {"n_heads": 2, "d_model": 768},
             "widest": {"n_heads": 1, "d_model": 768}, "kernels": False}


@pytest.fixture
def counting_wrappers(monkeypatch):
    """Each flash wrapper replaced by a stand-in that calls it and adds
    one to its own ``launches``, as a wrapper on the card counts its
    kernel's launches (the CPU route counts none)."""
    def stand_in(real):
        def wrapper(*a, **kw):
            out = real(*a, **kw)
            wrapper.launches += 1
            return out
        wrapper.__name__, wrapper.launches = real.__name__, 0
        return wrapper
    for name in chip_smoke.FLASH_WRAPPERS:
        monkeypatch.setattr(fa, name, stand_in(getattr(fa, name)))


def test_wide_phase_rehearsal_on_cpu(capsys, one_thread, counting_wrappers):
    counts = chip_smoke.wide_parts(torch, np, "cpu", REHEARSAL,
                                   lambda: None, "cpu rehearsal")
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["phase"] == "wide/gpt"
    assert row["head_dim"] == 256 and row["narrow"]["head_dim"] == 192
    assert row["wider"]["head_dim"] == 384
    assert row["widest"]["head_dim"] == 768 and "fit" not in row["widest"]
    assert set(counts) == {"fwd", "fwd_single", "fit", "narrow",
                           "narrow_fit", "wider", "wider_single",
                           "wider_fit", "widest", "widest_single"}
    # each counted window's calls: once a layer, a step (2 fit steps)
    n, steps = WIDE["n_layers"], REHEARSAL["steps"]
    fwd = {w: 0 for w in chip_smoke.FLASH_WRAPPERS}
    for window, want in (
            ("fwd", {**fwd, "flash_fwd": n}),
            ("fwd_single", {**fwd, "flash_fwd_single": n}),
            ("fit", {**fwd, "flash_fwd": n * steps,
                     "flash_bwd_dkdv": n * steps,
                     "flash_bwd_dq": n * steps}),
            ("narrow", {**fwd, "flash_fwd": n}),
            ("wider", {**fwd, "flash_fwd": n}),
            ("wider_single", {**fwd, "flash_fwd_single": n}),
            ("widest", {**fwd, "flash_fwd": n}),
            ("widest_single", {**fwd, "flash_fwd_single": n})):
        assert counts[window] == want, window
    assert counts["narrow_fit"] == counts["fit"]
    assert counts["wider_fit"] == counts["fit"]
    for window in ("fwd", "fwd_single", "narrow"):
        assert row[window]["kernel_vs_plain"]      # the replays ran
    # (d) and (g): the replays ran, and the output held to plain attention
    for part_key in ("wider", "widest"):
        for window in ("fwd", "fwd_single"):
            part = row[part_key][window]
            assert set(part["kernel_vs_plain"]) == {
                ("flash_fwd" if window == "fwd" else "flash_fwd_single") + k
                for k in ("/o", "/lse")}
            assert part["plain_attention"]["err"] <= chip_smoke.FLASH_TOL[
                "bfloat16"]
            assert part["builds"] == {}     # the CPU route counts none
    # (b)'s fit steps at 2 heads of 256, (c)'s at 2 heads of 192, (d)'s
    # at 2 heads of 384
    for fit in (row["fit"], row["narrow"]["fit"], row["wider"]["fit"]):
        assert len(fit["losses"]) == 3
        assert fit["losses"][-1] < fit["losses"][0]
        assert fit["plain_attention"]["loss_curve_max_rel_diff"] <= 1e-3
        assert set(fit["kernel_vs_plain"]) == {
            "flash_fwd/o", "flash_fwd/lse", "flash_bwd_dkdv/dk",
            "flash_bwd_dkdv/dv", "flash_bwd_dq/dq"}
