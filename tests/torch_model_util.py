"""What the port's model-level parity tests share: building a network of
either package from the same layer list or zoo model, carrying the JAX
net's parameters and state into the port, one training forward and
backward in each package, and the tree comparisons.  JAX is imported per
call, so a module that imports this one still collects without it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


def jax():
    return pytest.importorskip("jax")


@pytest.fixture
def one_torch_thread():
    """Torch on one intra-op thread for the test: under the suite's
    parallel workers every worker's default pool spans all cores, and
    the oversubscription slows these files and starves the timing tests
    beside them (one thread runs these files faster, too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    """A JAX tree as nested dicts of numpy arrays."""
    return jax().tree_util.tree_map(np.asarray, tree)


def carry(jnet, pnet, device="cpu"):
    """The JAX net's parameters and state installed on the port net."""
    from deeplearning4j_torch.utils.convert import (load_numpy_params,
                                                    load_numpy_state)
    load_numpy_params(pnet, np_tree(jnet.params_tree), device=device)
    return load_numpy_state(pnet, np_tree(jnet.state_tree))


def jax_from_port(jnet, pnet):
    """Install the port net's parameters and state (initialised on the
    CPU) on the JAX net, after checking every leaf's name and shape
    against what the JAX layers' own ``init`` builds (traced, not run:
    the JAX package's eager init of a deep graph takes seconds per
    layer shape).  Returns ``jnet``."""
    j = jax()
    from deeplearning4j_torch.utils.trees import map_leaves
    want_p, want_s = {}, {}
    named = ([(n, jnet.conf.vertices[n].layer)
              for n in jnet.conf.topological_order]
             if hasattr(jnet, "vertex_names") else
             [(f"layer_{i}", ly) for i, ly in enumerate(jnet.layers)])
    for key, ly in named:
        if ly is None:
            want_p[key], want_s[key] = {}, {}
            continue
        p, s = j.eval_shape(lambda ly=ly: ly.init(j.random.PRNGKey(0),
                                                  jnet._dtype))
        want_p[key] = j.tree_util.tree_map(lambda a: a.shape, p)
        want_s[key] = j.tree_util.tree_map(lambda a: a.shape, s)
    shapes = lambda t: map_leaves(lambda a: tuple(a.shape), t)
    assert shapes(pnet.params_tree) == want_p
    assert shapes(pnet.state_tree) == want_s
    as_jax = lambda t: map_leaves(
        lambda a: j.numpy.asarray(a.detach().cpu().numpy()), t)
    jnet.params_tree = as_jax(pnet.params_tree)
    jnet.state_tree = as_jax(pnet.state_tree)
    jnet.opt_state = None
    return jnet


_CONF_MODULES = ("builder", "inputs", "layers_core", "layers_conv",
                 "layers_misc", "layers_objdetect", "layers_recurrent",
                 "graph_vertices")


def conf_ns(package):
    """Every public name of ``package``'s configuration modules
    (``deeplearning4j_tpu`` or ``deeplearning4j_torch``) and its
    updaters, in one namespace: what a layer list is built from."""
    import importlib
    import types
    ns = types.SimpleNamespace()
    for mod in [f"{package}.nn.conf.{m}" for m in _CONF_MODULES] + [
            f"{package}.optimize.updaters"]:
        for k, v in vars(importlib.import_module(mod)).items():
            if not k.startswith("_"):
                setattr(ns, k, v)
    return ns


def mln_pair(layers_fn, input_type_fn, seed=5):
    """(JAX MultiLayerNetwork, port MultiLayerNetwork) of the same
    configuration and parameters: the port's seeded init installed on
    the JAX net (``jax_from_port``), then the JAX net's tree carried into
    a fresh port net (``carry``, ``utils.convert``).  ``layers_fn(P)`` and
    ``input_type_fn(P)`` build the layers and the input type from either
    package's ``nn.conf`` (``P``)."""
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JMLN)

    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork as PMLN)
    nets = []
    for P, cls in ((conf_ns("deeplearning4j_tpu"), JMLN),
                   (conf_ns("deeplearning4j_torch"), PMLN)):
        b = (P.NeuralNetConfiguration.builder().seed(seed)
             .updater(P.Sgd(learning_rate=0.1)).list())
        for ly in layers_fn(P):
            b.layer(ly)
        nets.append(cls(b.set_input_type(input_type_fn(P)).build()))
    jnet, pnet = nets
    assert pnet.conf.to_dict() == jnet.conf.to_dict()
    jnet = jax_from_port(jnet, pnet.init(device="cpu"))
    # and back through the carry every port test of the JAX package uses
    return jnet, carry(jnet, type(pnet)(pnet.conf))


def graph_pair(build_fn, seed=5):
    """(JAX ComputationGraph, port ComputationGraph) of the same graph:
    ``build_fn(P, g)`` adds inputs, vertices and outputs to either
    package's graph builder ``g``."""
    from deeplearning4j_tpu.models.computation_graph import (
        ComputationGraph as JCG)

    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph as PCG)
    nets = []
    for P, cls in ((conf_ns("deeplearning4j_tpu"), JCG),
                   (conf_ns("deeplearning4j_torch"), PCG)):
        g = (P.NeuralNetConfiguration.builder().seed(seed)
             .updater(P.Sgd(learning_rate=0.1)).graph())
        build_fn(P, g)
        nets.append(cls(g.build()))
    jnet, pnet = nets
    assert pnet.conf.to_dict() == jnet.conf.to_dict()
    jnet.init()
    return jnet, carry(jnet, pnet)


def batches(x, y, features_mask=None, labels_mask=None):
    """The same arrays as each package's DataSet: (JAX, port)."""
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet

    from deeplearning4j_torch.data.dataset import DataSet as PDataSet
    return tuple(D(x, y, features_mask=features_mask,
                   labels_mask=labels_mask) for D in (JDataSet, PDataSet))


def jax_loss_grads(jnet, ds, rng=None, training=True):
    """(loss, grads as numpy) of one forward and backward of the JAX
    net's training score on its DataSet ``ds``."""
    j = jax()
    batch = jnet._batch_dict(ds)
    loss, grads = j.jit(j.value_and_grad(
        lambda p, s, b: jnet._score_batch(p, s, b, rng, training)[0]))(
            jnet.params_tree, jnet.state_tree, batch)
    return float(loss), np_tree(grads)


def port_loss_grads(pnet, ds, rng=None):
    """(loss, grads as numpy) of one training forward and backward of
    the port net on its DataSet ``ds``."""
    from deeplearning4j_torch.utils.trees import map_leaves
    pnet._build_solver()
    loss, _, grads = pnet._solver._loss_and_grads(
        pnet.params_tree, pnet.state_tree, pnet._batch_dict(ds), rng)
    return float(loss), map_leaves(lambda g: g.detach().cpu().numpy(),
                                   grads)


def host(x):
    """A tensor (or JAX array, or a list/dict of them) as numpy."""
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [host(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def assert_trees_close(got, want, tol, path=()):
    """Every leaf of ``got`` within ``tol`` of ``want``'s largest
    element (relative), leaf for leaf; the two trees have one skeleton."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in got:
        if isinstance(got[k], dict):
            assert_trees_close(got[k], want[k], tol, path + (k,))
            continue
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                          np.float64)
        assert g.shape == w.shape, (path + (k,), g.shape, w.shape)
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-12)
        err = float(np.abs(g - w).max(initial=0.0)) / scale
        assert err <= tol, (path + (k,), err)
