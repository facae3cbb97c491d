"""Training in the PyTorch port against the JAX package.

The slice as a whole: a 2-layer ``Gpt(vocab 50, d 32, 2 heads, ff 64)``
at f32 is built in both packages, the JAX package trains one step (so
Adam's moments and step count are non-trivial), its ``params_tree`` and
``opt_state`` are carried into the port (``utils.convert``), and both
run three ``fit(DataSet)`` steps on the same numpy-seeded batches — at
seq_len 512 (attention routes to flash, one key block: K4) and 1024
(flash, streaming: K3), with and without a padded features mask (the
key-bias path); K5/K6 run in every backward.  The JAX package runs its
Pallas kernels in interpret mode, the port the kernels' plain versions.
Losses agree within rtol 1e-4 and params within 1e-4 (f32, different
summation orders).  Around it: each updater for one step at 1e-6, the
gradient normalizations, the non-finite-step select, checkpoints that
resume in the other package, and the flagship MLP."""
import importlib
import io
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.optimize import solver as jsolver  # noqa: E402
from deeplearning4j_tpu.optimize import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.utils.model_serializer import (  # noqa: E402
    restore_model as jax_restore, write_model as jax_write)
from deeplearning4j_tpu.zoo.gpt import Gpt as JaxGpt  # noqa: E402

from deeplearning4j_torch.data import DataSet, ListDataSetIterator  # noqa
from deeplearning4j_torch.optimize import CollectScoresListener  # noqa
from deeplearning4j_torch.optimize import solver as psolver  # noqa: E402
from deeplearning4j_torch.optimize import updaters as pupd  # noqa: E402
from deeplearning4j_torch.utils import (load_numpy_opt_state,  # noqa: E402
                                        load_numpy_params, restore_model,
                                        write_model)
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402
from deeplearning4j_torch.zoo import Gpt  # noqa: E402

# the package's ``flash_attention`` name is the function; the module is
# reached by its full path
fa = importlib.import_module("deeplearning4j_torch.kernels.flash_attention")
TINY = dict(vocab_size=50, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            compute_dtype=None, seed=11)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng, b, t, masked):
    x = rng.integers(0, 50, (b, t)).astype(np.int32)
    y = rng.integers(0, 50, (b, t)).astype(np.int32)
    fmask = lmask = None
    if masked:
        fmask = np.ones((b, t), np.float32)
        fmask[0, t - t // 3:] = 0.0            # row 0 padded at the end
        lmask = fmask.copy()
    return x, y, fmask, lmask


def _pair(seq_len, warm):
    """A JAX tiny Gpt after one fit step on ``warm``, and the port's copy
    of it (params, Adam state, counters) on the CPU."""
    jnet = JaxGpt(seq_len=seq_len, **TINY).init_graph()
    jnet.fit(JDataSet(*warm[:2], warm[2], warm[3]))
    pnet = Gpt(seq_len=seq_len, **TINY).init_graph(device="cpu")
    load_numpy_params(pnet, _np_tree(jnet.params_tree), device="cpu")
    load_numpy_opt_state(pnet, _np_tree(jnet.opt_state))
    pnet.iteration_count = jnet.iteration_count
    return jnet, pnet


def _assert_params_close(pnet, jnet, atol):
    """Every parameter within ``atol`` — except the key-bias third of
    ``bqkv``: adding a constant to every key's score of a row leaves the
    softmax unchanged, so its gradient is zero up to rounding (~1e-8) and
    Adam's m / sqrt(v) turns that noise into steps of ~lr in either
    direction.  Those entries are held only to a few Adam steps (2e-3)."""
    jp = dict(iter_leaves(_np_tree(jnet.params_tree)))
    for path, leaf in iter_leaves(pnet.params_tree):
        got, want = leaf.numpy(), jp[path]
        if path[-1] == "bqkv":
            d = got.shape[0] // 3
            np.testing.assert_allclose(got[d:2 * d], want[d:2 * d], rtol=0,
                                       atol=max(atol, 2e-3))
            got = np.concatenate([got[:d], got[2 * d:]])
            want = np.concatenate([want[:d], want[2 * d:]])
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("seq_len,masked,route", [
    (512, False, "single"), (1024, False, "stream"), (512, True, "single")])
def test_tiny_gpt_three_fit_steps_track_jax(seq_len, masked, route):
    rng = np.random.default_rng(seq_len + masked)
    warm = _batch(rng, 2, seq_len, masked)
    jnet, pnet = _pair(seq_len, warm)
    _assert_params_close(pnet, jnet, 0)
    fa.reset_route_log()
    jl, pl = [], []
    for _ in range(3):
        x, y, fm, lm = _batch(rng, 2, seq_len, masked)
        jl.append(jnet.fit(JDataSet(x, y, fm, lm)))
        pl.append(pnet.fit(DataSet(x, y, fm, lm)))
    # every block's attention took the flash route, as in the reference
    assert fa.route_log() == (("flash", seq_len, 16),) * (2 * 3)
    assert fa._auto_blocks(seq_len) == (
        (512, 512) if route == "single" else (1024, 512))
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert np.isfinite(pl).all()
    _assert_params_close(pnet, jnet, 1e-4)
    assert pnet.iteration_count == jnet.iteration_count == 4
    np.testing.assert_allclose(pnet.score(DataSet(x, y, fm, lm)),
                               jnet.score(JDataSet(x, y, fm, lm)), rtol=1e-4)


def test_flash_and_plain_attention_paths_agree_in_the_block():
    """use_flash=False (plain einsum attention) and use_flash=True (the
    autograd Function over K3-K6's plain versions) give the same loss and
    gradients on the same params, with a padded mask."""
    rng = np.random.default_rng(0)
    x, y, fm, lm = _batch(rng, 2, 512, True)
    nets = [Gpt(seq_len=512, use_flash=f, **TINY).init_graph(device="cpu")
            for f in (True, False)]
    load_numpy_params(nets[1], {k: {n: t.numpy() for n, t in v.items()}
                                for k, v in nets[0].params_tree.items()},
                      device="cpu")
    out = []
    for net in nets:
        net._build_solver()
        loss, _, grads = net._solver._loss_and_grads(
            net.params_tree, net.state_tree,
            net._batch_dict(DataSet(x, y, fm, lm)), None)
        out.append((float(loss), dict(iter_leaves(grads))))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    for path, g in out[0][1].items():
        torch.testing.assert_close(g, out[1][1][path], rtol=1e-4, atol=1e-5)


# -- updaters and the solver -------------------------------------------
_UPDATERS = [
    ("Sgd", {"learning_rate": 0.1}),
    ("Nesterovs", {"learning_rate": 0.05, "momentum": 0.9}),
    ("Adam", {"learning_rate": 3e-3}),
    ("AdamW", {"learning_rate": 3e-3, "weight_decay": 0.05}),
    ("NoOp", {}),
]


@pytest.mark.parametrize("name,kw", _UPDATERS, ids=[u[0] for u in _UPDATERS])
def test_updater_one_step_matches_jax(name, kw):
    rng = np.random.default_rng(1)
    params = {"a": {"W": rng.normal(size=(4, 3)).astype(np.float32)},
              "b": {"b": rng.normal(size=(5,)).astype(np.float32)}}
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    ju = jupd.updater_from_dict({"type": name, **kw})
    pu = pupd.updater_from_dict({"type": name, **kw})
    assert pu.to_dict() == ju.to_dict()
    tt = lambda tree: jax.tree_util.tree_map(torch.from_numpy, tree)
    js, ps = ju.init_state(params), pu.init_state(tt(params))
    for step in (0, 7):          # a fresh state, then a later step index
        jup, js = ju.update(grads, js, params, step)
        pup, ps = pu.update(tt(grads), ps, tt(params), step)
        for (path, a), (_, b) in zip(iter_leaves(_np_tree(jup)),
                                     iter_leaves(pup)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7,
                                       err_msg="/".join(path))


def test_adam_is_dl4j_form_not_torch_optim():
    """eps sits outside the bias-corrected sqrt: with a large eps the
    port's Adam differs from torch.optim.Adam and equals the JAX one."""
    p0 = np.asarray([0.5, -1.0, 2.0], np.float32)
    g = np.asarray([1e-3, -2e-3, 5e-4], np.float32)
    kw = {"learning_rate": 0.1, "epsilon": 1e-3}
    pu = pupd.Adam(**kw)
    u, _ = pu.update({"w": torch.from_numpy(g)},
                     pu.init_state({"w": torch.from_numpy(p0)}),
                     None, 0)
    ju = jupd.Adam(**kw)
    ju_u, _ = ju.update({"w": g}, ju.init_state({"w": p0}), None, 0)
    np.testing.assert_allclose(u["w"].numpy(), np.asarray(ju_u["w"]),
                               rtol=1e-6)
    w = torch.tensor(p0, requires_grad=True)
    opt = torch.optim.Adam([w], lr=0.1, eps=1e-3)
    w.grad = torch.from_numpy(g)
    opt.step()
    assert not np.allclose(p0 - u["w"].numpy(), w.detach().numpy(),
                           rtol=1e-3)


@pytest.mark.parametrize("kind", ["clip_global_norm", "clip_l2_per_layer",
                                  "clip_l2_per_param_type",
                                  "renormalize_l2_per_layer",
                                  "clip_element_wise_absolute_value"])
def test_normalize_gradients_matches_jax(kind):
    rng = np.random.default_rng(2)
    grads = {"layer_0": {"W": rng.normal(size=(6, 4)).astype(np.float32),
                         "b": rng.normal(size=(4,)).astype(np.float32)},
             "layer_1": {"W": 3 * rng.normal(size=(4, 2)).astype(np.float32)}}
    want = jsolver.normalize_gradients(grads, kind, 0.7)
    got = psolver.normalize_gradients(
        jax.tree_util.tree_map(torch.from_numpy, grads), kind, 0.7)
    for (path, a), (_, b) in zip(iter_leaves(_np_tree(want)),
                                 iter_leaves(got)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7,
                                   err_msg="/".join(path))


def test_non_finite_step_leaves_params_and_state_bit_identical():
    net = Gpt(seq_len=32, **TINY).init_graph(device="cpu")
    rng = np.random.default_rng(3)
    x, y, _, _ = _batch(rng, 2, 32, False)
    net.fit(DataSet(x, y))                       # Adam state now non-zero
    before = [t.clone() for _, t in iter_leaves(net.params_tree)]
    opt_before = [t.clone() for _, t in iter_leaves(net.opt_state)]
    ids = [id(t) for _, t in iter_leaves(net.params_tree)]
    with torch.no_grad():                        # poison one weight
        net.params_tree["layer_1"]["W1"][0, 0] = float("nan")
    before[[p for p, _ in iter_leaves(net.params_tree)].index(
        ("layer_1", "W1"))][0, 0] = float("nan")
    loss = net.fit(DataSet(x, y))
    assert not np.isfinite(loss)
    for a, (_, b) in zip(before, iter_leaves(net.params_tree)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, (_, b) in zip(opt_before, iter_leaves(net.opt_state)):
        assert torch.equal(a, b)
    # updated in place: the same tensors, no copies
    assert ids == [id(t) for _, t in iter_leaves(net.params_tree)]


# -- checkpoints across packages ---------------------------------------
def test_checkpoints_resume_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    b0, b1, b2 = (_batch(rng, 2, 32, False) for _ in range(3))
    # port -> JAX: the port trains a step and writes; both continue
    pnet = Gpt(seq_len=32, **TINY).init_graph(device="cpu")
    pnet.fit(DataSet(b0[0], b0[1]))
    write_model(pnet, tmp_path / "p.zip")
    with zipfile.ZipFile(tmp_path / "p.zip") as zf:
        assert "updaterState.npz" in zf.namelist()
        with np.load(io.BytesIO(zf.read("updaterState.npz"))) as z:
            assert "m/layer_1/Wqkv" in z.files
    jnet = jax_restore(str(tmp_path / "p.zip"))
    assert jnet.iteration_count == 1
    jl = jnet.fit(JDataSet(b1[0], b1[1]))
    pl = pnet.fit(DataSet(b1[0], b1[1]))
    assert pl == pytest.approx(jl, rel=1e-4)
    _assert_params_close(pnet, jnet, 1e-4)
    # JAX -> port: the JAX net writes, the port resumes
    jax_write(jnet, str(tmp_path / "j.zip"), save_updater=True)
    qnet = restore_model(tmp_path / "j.zip", device="cpu")
    assert qnet.iteration_count == 2 and qnet.opt_state is not None
    jl = jnet.fit(JDataSet(b2[0], b2[1]))
    ql = qnet.fit(DataSet(b2[0], b2[1]))
    assert ql == pytest.approx(jl, rel=1e-4)
    _assert_params_close(qnet, jnet, 1e-4)
    assert restore_model(tmp_path / "j.zip", device="cpu",
                         load_updater=False).opt_state is None


def test_load_numpy_opt_state_rejects_a_mismatched_tree():
    net = Gpt(seq_len=32, **TINY).init_graph(device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        load_numpy_opt_state(net, {"v": {}})


# -- the flagship MLP --------------------------------------------------
def test_flagship_mlp_trains_and_tracks_jax():
    """``__graft_entry__._flagship_mlp`` (784-256-10, relu, softmax +
    mcxent, Nesterovs) through ``fit(iterator)`` with async prefetch and
    listeners, from the JAX net's weights."""
    from __graft_entry__ import _flagship_mlp
    from deeplearning4j_tpu.data.iterator import (
        ListDataSetIterator as JList)
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
    jnet = _flagship_mlp()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jnet.conf.to_dict())).init(device="cpu")
    load_numpy_params(pnet, _np_tree(jnet.params_tree), device="cpu")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    scores = CollectScoresListener()
    pnet.set_listeners(scores)
    jnet.fit(JList([JDataSet(a, b) for a, b in batches]), n_epochs=2)
    pnet.fit(ListDataSetIterator([DataSet(a, b) for a, b in batches]),
             n_epochs=2)
    assert [i for i, _ in scores.scores] == list(range(8))
    assert pnet.epoch_count == 2 and pnet.iteration_count == 8
    assert scores.scores[-1][1] < scores.scores[0][1]
    _assert_params_close(pnet, jnet, 1e-5)
    np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=1e-5)


def test_regularization_decay_clipping_and_freeze_track_jax():
    """l1/l2 in the score, decoupled weight decay, clip_global_norm and a
    frozen layer, through two Adam fit steps from the same weights."""
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.layers_core import (
        DenseLayer as JDense, OutputLayer as JOut)
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf import (DenseLayer, OutputLayer,
                                              NeuralNetConfiguration)
    confs = []
    for nnc, dense, out in ((JNNC, JDense, JOut),
                            (NeuralNetConfiguration, DenseLayer,
                             OutputLayer)):
        c = (nnc.builder().seed(3).updater({"type": "Adam",
                                            "learning_rate": 1e-2})
             .l1(1e-3).l2(1e-2).weight_decay(5e-3)
             .gradient_normalization("clip_global_norm", 0.5).list()
             .layer(dense(n_in=12, n_out=16, activation="tanh"))
             .layer(dense(n_out=8, activation="relu"))
             .layer(out(n_out=4, activation="softmax", loss="mcxent"))
             .build())
        c.frozen_layers = [0]
        confs.append(c)
    assert confs[0].to_dict() == confs[1].to_dict()
    jnet = JMLN(confs[0]).init()
    pnet = MultiLayerNetwork(confs[1]).init(device="cpu")
    load_numpy_params(pnet, _np_tree(jnet.params_tree), device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(2):
        x = rng.normal(size=(10, 12)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 10)]
        assert pnet.fit(DataSet(x, y)) == pytest.approx(
            jnet.fit(JDataSet(x, y)), rel=1e-5)
    _assert_params_close(pnet, jnet, 1e-6)
    frozen = jnet.params_tree["layer_0"]["W"]
    np.testing.assert_array_equal(pnet.params_tree["layer_0"]["W"].numpy(),
                                  np.asarray(frozen))


def test_dropout_draws_by_key_and_statistics():
    """The port's dropout draws come from a torch.Generator seeded by the
    step's key — reproducible per key, not the reference's threefry bits
    — so they are held to the reference's statistics: the kept share is
    1 - rate and kept values scale by 1 / (1 - rate)."""
    from deeplearning4j_torch.nn.conf.layers_core import apply_dropout
    from deeplearning4j_torch.runtime.rng import RngKeyManager
    x = torch.ones(200_000)
    keys = RngKeyManager(5)
    k1, k2 = keys.next_key(), keys.next_key()
    a, b = apply_dropout(x, 0.3, True, k1), apply_dropout(x, 0.3, True, k1)
    assert torch.equal(a, b)
    assert not torch.equal(a, apply_dropout(x, 0.3, True, k2))
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert apply_dropout(x, 0.3, False, k1) is x
    assert keys.state() == [5, 2]
    keys.set_state([5, 0])
    assert keys.next_key() == k1


def test_gpt_dropout_fit_is_reproducible_and_train_only():
    """With dropout, output(training=False) is deterministic and the fit
    loss is reproducible from the same seed and weights."""
    kw = {**TINY, "dropout": 0.1}
    rng = np.random.default_rng(8)
    x, y, _, _ = _batch(rng, 2, 16, False)
    losses = []
    for _ in range(2):
        net = Gpt(seq_len=16, **kw).init_graph(device="cpu")
        losses.append(net.fit(DataSet(x, y)))
    assert losses[0] == losses[1]
    torch.testing.assert_close(net.output(x), net.output(x), rtol=0, atol=0)


def test_left_out_training_features_raise():
    """What still raises: resume without a CheckpointListener and an
    unknown updater name.  Truncated BPTT no longer does: over a Gpt's
    [b, t] token ids (no [b, t, f] array to split) it is one ordinary
    step, as ``tbptt_segments`` leaves such a batch in the JAX
    package."""
    net = Gpt(seq_len=16, **TINY).init_graph(device="cpu")
    x, y, _, _ = _batch(np.random.default_rng(9), 2, 16, False)
    # resume needs a CheckpointListener to restore from
    with pytest.raises(ValueError, match="CheckpointListener"):
        net.fit(DataSet(x, y), resume=True)
    net.conf.backprop_type = "truncated_bptt"
    net.conf.tbptt_fwd_length = 4
    assert np.isfinite(net.fit(DataSet(x, y)))
    assert net.iteration_count == 1
    with pytest.raises(ValueError, match="Unknown updater"):
        pupd.updater_from_dict({"type": "Adagrad"})


def test_check_numerics_names_the_bad_leaf(monkeypatch):
    net = Gpt(seq_len=16, **TINY).init_graph(device="cpu")
    x, y, _, _ = _batch(np.random.default_rng(10), 2, 16, False)
    with torch.no_grad():
        net.params_tree["layer_2"]["W2"][0, 0] = float("inf")
    monkeypatch.setenv("DL4J_TPU_CHECK_NUMERICS", "1")
    with pytest.raises(FloatingPointError, match="layer_2/W2"):
        net.fit(DataSet(x, y))


@pytest.mark.parametrize("spec", [
    0.01, {"type": "fixed", "value": 0.02},
    {"type": "exponential", "initial": 0.1, "gamma": 0.9},
    {"type": "inverse", "initial": 0.1, "gamma": 0.5, "power": 2.0},
    {"type": "poly", "initial": 0.1, "power": 2.0, "max_iter": 10},
    {"type": "step", "initial": 0.1, "decay": 0.5, "step": 3},
    {"type": "sigmoid", "initial": 0.1, "gamma": 0.7, "step": 4},
    {"type": "ramp", "initial": 0.1, "warmup": 5},
    {"type": "warmup_cosine", "initial": 0.1, "warmup": 3, "max_iter": 12},
    {"type": "cycle", "initial": 0.1, "cycle_length": 6, "max": 0.4},
    {"type": "map", "values": {"0": 0.1, "4": 0.01, "8": 0.001}}],
    ids=lambda s: s["type"] if isinstance(s, dict) else "float")
def test_schedules_match_jax(spec):
    from deeplearning4j_tpu.optimize.schedules import (
        schedule_from_spec as jax_schedule)
    from deeplearning4j_torch.optimize.schedules import schedule_from_spec
    want, got = jax_schedule(spec), schedule_from_spec(spec)
    for step in (0, 1, 3, 4, 7, 11, 15):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6)
