"""Every mesh axis of the port across OS processes joined by
``torch.distributed`` over gloo (``tests/workers/torch_mesh_worker.py``),
held to ``tests/test_distributed_multiproc.py``: the model axis (the
MLP of ``dist_tp_worker.py`` and a tiny ``Gpt``), the pipeline axis, the
sequence axis (ring attention) and a checkpoint of a cross-process mesh
restored at one process.  Every rank reports the same losses (rtol
1e-6), equal to the one-process mesh and to the JAX ``ShardedTrainer``
on the conftest's virtual CPU devices (rtol 1e-5, the reference's
bound); each rank stores only its own shards.  The reference's four-
and eight-process cases are ``slow``, and so are their ports here."""
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORKERS = os.path.join(os.path.dirname(__file__), "workers")
WORKER = os.path.join(WORKERS, "torch_mesh_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, WORKERS)
import torch_mesh_worker as W  # noqa: E402

TWO = "tp_mlp,tp_gpt,pipe,ring,ckpt"


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(out_dir, world, scenarios, timeout=300):
    """Start ``world`` worker processes on ``scenarios``; every rank must
    finish; returns {scenario: [rank results]}."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(port),
         str(out_dir), scenarios], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert "MESH_WORKER_OK" in out
    return {name: [json.load(open(os.path.join(
        out_dir, f"{name}_rank{r}.json"))) for r in range(world)]
        for name in scenarios.split(",")}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh2")
    return d, run_ranks(d, 2, TWO)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranks_agree(ranks):
    for r in ranks[1:]:
        np.testing.assert_allclose(r["losses"], ranks[0]["losses"],
                                   rtol=1e-6)
        for k, v in ranks[0]["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def _local(model, mesh_conf, batches, n_micro=4):
    """The same steps on a one-process mesh of local CPU devices."""
    from deeplearning4j_torch.parallel import ShardedTrainer
    tr = ShardedTrainer(model, mesh_conf,
                        devices=[torch.device("cpu")] * mesh_conf.total(),
                        n_micro=n_micro)
    return [float(tr.fit_batch(x, y)) for x, y in batches]


def _jax(pnet, jconf, mesh_kw, batches, n_micro=4):
    """The same steps through the JAX ShardedTrainer, the port's init
    carried in; returns (losses, final params as numpy)."""
    import jax
    from torch_model_util import jax_from_port
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.parallel.mesh import MeshConfig as JMesh
    from deeplearning4j_tpu.parallel.trainer import (
        ShardedTrainer as JTrainer)
    jnet = jax_from_port(JMLN(jconf), pnet)
    jnet.params_tree = jax.tree_util.tree_map(np.array, jnet.params_tree)
    mesh = JMesh(**mesh_kw)
    jtr = JTrainer(jnet, mesh, devices=jax.devices()[:mesh.total()],
                   n_micro=n_micro)
    losses = [float(jtr.fit_batch(x, y)) for x, y in batches]
    if hasattr(jtr, "sync_model"):
        jtr.sync_model()
    return losses, jax.tree_util.tree_map(np.asarray, jnet.params_tree)


def _jax_mlp_conf():
    from deeplearning4j_tpu import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers_core import (DenseLayer,
                                                        OutputLayer)
    from deeplearning4j_tpu.optimize.updaters import Sgd
    return (NeuralNetConfiguration.builder().seed(11)
            .updater(Sgd(learning_rate=0.1)).list()
            .layer(DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .build())


def _jax_gpt_conf():
    from deeplearning4j_tpu.zoo.gpt import Gpt as JGpt
    return JGpt(**W.GPT_KW).conf()


def _params_close(got, want, atol):
    """Every parameter within ``atol`` — except the key-bias third of
    ``bqkv``, whose gradient is zero up to rounding and which Adam turns
    into steps of ~lr either way (``tests/test_torch_training.py``'s
    rule): it is held to a few Adam steps (2e-3)."""
    for path, v in got.items():
        node = want
        for k in path.split("/"):
            node = node[k]
        v, w = np.asarray(v, np.float32), np.asarray(node, np.float32)
        if path.endswith("bqkv"):
            d = v.shape[0] // 3
            np.testing.assert_allclose(v[d:2 * d], w[d:2 * d], atol=2e-3)
            v = np.concatenate([v[:d], v[2 * d:]])
            w = np.concatenate([w[:d], w[2 * d:]])
        np.testing.assert_allclose(v, w, atol=atol, err_msg=path)


def test_model_axis_across_processes_mlp_matches_jax(two):
    """MeshConfig(data=1, model=2) over two processes: the hidden and
    output weights' column shards live one per process; both ranks'
    losses equal the one-process mesh and the JAX ShardedTrainer on two
    virtual devices, and so do the final parameters (1e-5)."""
    ranks = two[1]["tp_mlp"]
    _ranks_agree(ranks)
    for r, res in enumerate(ranks):
        assert res["procs"] == [0, 1]
        assert res["held"]["layer_0/W/__tp%d" % r] == [6, 8]
        assert res["held"]["layer_1/W/__tp%d" % r] == [16, 1]
        assert not any(k.startswith("layer_0/W/__tp%d" % (1 - r))
                       for k in res["held"])
    batches = W.mlp_batches(5)
    from deeplearning4j_torch.parallel import MeshConfig
    np.testing.assert_allclose(
        ranks[0]["losses"], _local(W.mlp(), MeshConfig(model=2), batches),
        rtol=1e-6)
    want, params = _jax(W.mlp(), _jax_mlp_conf(), dict(data=1, model=2),
                        batches)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)
    _params_close(ranks[0]["params"], params, 1e-5)


def test_model_axis_across_processes_gpt_matches_jax(two):
    """The tiny Gpt at data 1 x model 2 over two processes: Wqkv/W1 by
    columns, Wo/W2 and the embedding by rows, the head by columns, one
    shard per process; losses and final parameters as above."""
    ranks = two[1]["tp_gpt"]
    _ranks_agree(ranks)
    for r, res in enumerate(ranks):
        held = res["held"]
        assert held["layer_1/Wqkv/__tp%d" % r] == [32, 48]
        assert held["layer_1/Wo/__tp%d" % r] == [16, 32]
        assert held["layer_0/W/__tp%d" % r] == [32, 32]
        assert not [k for k in held if k.endswith("__tp%d" % (1 - r))]
    batches = W.gpt_batches(5, 8)
    from deeplearning4j_torch.parallel import MeshConfig
    np.testing.assert_allclose(
        ranks[0]["losses"], _local(W.gpt(), MeshConfig(model=2), batches),
        rtol=1e-6)
    want, params = _jax(W.gpt(), _jax_gpt_conf(), dict(data=1, model=2),
                        batches)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)
    _params_close(ranks[0]["params"], params, 1e-5)


def test_pipeline_axis_across_processes_matches_jax(two):
    """MeshConfig(pipeline=2), n_micro 2, over two processes: stage 0
    holds the embedding and the first two blocks, stage 1 the last two
    and the head; both report the last stage's loss, equal to the
    one-process pipeline and to the JAX one (rtol 1e-5)."""
    ranks = two[1]["pipe"]
    _ranks_agree(ranks)
    layers = [sorted({k.split("/")[1] for k in r["held"]}) for r in ranks]
    assert layers == [["layer_0", "layer_1", "layer_2"],
                      ["layer_3", "layer_4", "layer_5"]]
    batches = W.gpt_batches(3)
    from deeplearning4j_torch.parallel import MeshConfig
    np.testing.assert_allclose(
        ranks[0]["losses"],
        _local(W.gpt(), MeshConfig(pipeline=2), batches, n_micro=2),
        rtol=1e-5)
    want, params = _jax(W.gpt(), _jax_gpt_conf(), dict(pipeline=2),
                        batches, n_micro=2)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)


def test_ring_attention_across_processes_matches_full(two):
    """ring_self_attention over a two-process sequence axis: every rank
    returns the full output and the full q/k/v gradients, equal to
    full attention (atol 1e-5, f32)."""
    from deeplearning4j_torch.parallel.ring_attention import (
        full_attention_reference)
    q, k, v, mask, w = W.ring_inputs()
    q, k, v = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = full_attention_reference(q, k, v, torch.tensor(mask))
    (o * torch.tensor(w)).sum().backward()
    for res in two[1]["ring"]:
        for got, want in ((res["out"], o), (res["dq"], q.grad),
                          (res["dk"], k.grad), (res["dv"], v.grad)):
            np.testing.assert_allclose(got, want.detach().numpy(),
                                       atol=1e-5)


def test_cross_process_tp_checkpoint_restores_at_one_process(two):
    """A CheckpointListener under the two-process model=2 mesh saves the
    full logical state; one process restores its newest step (a plain
    one-device trainer) and continues to the same losses."""
    from deeplearning4j_torch.data.iterator import ListDataSetIterator
    from deeplearning4j_torch.optimize.listeners import TrainingListener
    from deeplearning4j_torch.parallel import (CheckpointListener,
                                               MeshConfig, ShardedTrainer)
    d, res = two
    ranks = res["ckpt"]
    want = {int(k): v for k, v in ranks[0]["losses"].items()}
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["steps"] == [3, 6]
    assert "layer_0/W/__tp1" in ranks[1]["held"]
    ck_dir = d / "restore"
    shutil.copytree(d / "ck0", ck_dir)
    got = {}

    class Rec(TrainingListener):
        def iteration_done(self, model, iteration, epoch, loss):
            got[iteration] = float(loss)
    m = W.mlp()
    tr = ShardedTrainer(m, MeshConfig(data=1),
                        devices=[torch.device("cpu")])
    m.set_listeners(CheckpointListener(ck_dir, save_every_n_iterations=3,
                                       async_save=False), Rec())
    tr.fit(ListDataSetIterator(W.ckpt_batches()), n_epochs=2, resume=True)
    assert sorted(got) == [7]
    for it, loss in got.items():
        np.testing.assert_allclose(loss, want[it], rtol=1e-5)


@pytest.mark.slow
def test_four_process_2x2_tp_across_boundary(tmp_path):
    """Port of the reference's 4-process 2x2 (data x model) case: the TP
    shards live on all four processes, every rank reports the same
    losses, equal to the one-process mesh and to the JAX 2x2 mesh."""
    ranks = run_ranks(tmp_path, 4, "tp2x2", timeout=420)["tp2x2"]
    _ranks_agree(ranks)
    for r, res in enumerate(ranks):
        assert res["procs"] == [0, 1, 2, 3]
        assert list(res["held"]) == sorted(
            k for k in res["held"])     # one shard per TP leaf
        assert "layer_0/W/__tp%d" % (r % 2) in res["held"]
    batches = W.mlp_batches(5)
    from deeplearning4j_torch.parallel import MeshConfig
    np.testing.assert_allclose(
        ranks[0]["losses"],
        _local(W.mlp(), MeshConfig(data=2, model=2), batches), rtol=1e-6)
    want, _ = _jax(W.mlp(), _jax_mlp_conf(), dict(data=2, model=2),
                   batches)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)


@pytest.mark.slow
def test_eight_process_dp_tp_pp(tmp_path):
    """Port of the reference's 8-process 2x2x2 (data x model x pipeline)
    Gpt: all three axes cross the process boundary, each rank holds its
    stage's blocks' model shard, every rank reports the same losses,
    equal to the one-process 2x2x2 mesh and to the JAX one."""
    ranks = run_ranks(tmp_path, 8, "axis3", timeout=600)["axis3"]
    _ranks_agree(ranks)
    for r, res in enumerate(ranks):
        assert res["procs"] == list(range(8))
        m, s = (r // 2) % 2, r % 2
        blocks = [k for k in res["held"] if "/Wqkv/" in k]
        assert blocks == [f"run/layer_{1 + 2 * s + i}/Wqkv/__tp{m}"
                          for i in range(2)]
    batches = W.gpt_batches(3)
    from deeplearning4j_torch.parallel import MeshConfig
    np.testing.assert_allclose(
        ranks[0]["losses"],
        _local(W.gpt(), MeshConfig(data=2, model=2, pipeline=2), batches,
               n_micro=2), rtol=1e-5)
    want, _ = _jax(W.gpt(), _jax_gpt_conf(),
                   dict(data=2, model=2, pipeline=2), batches, n_micro=2)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)


FLEET = os.path.join(WORKERS, "torch_fleet_worker.py")


def _launch_fleet(port, out_dir, mode, phase, n_epochs=2, nproc=2,
                  extra=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, FLEET, str(rank), str(nproc), str(port),
         str(out_dir), mode, str(n_epochs), phase, *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(nproc)]


def _finish(procs, label, marker):
    for rank, p in enumerate(procs):
        o = p.communicate(timeout=420)[0].decode()
        assert p.returncode == 0, f"{label} rank {rank}:\n{o[-3000:]}"
        assert marker in o


def _preempt(out, mode, nproc):
    """Rank nproc - 1 alone SIGTERMs itself at iteration 3; every rank
    must stop at that step."""
    procs = _launch_fleet(_free_port(), out, mode, "preempt", nproc=nproc,
                          extra=("--preempt-rank", str(nproc - 1),
                                 "--preempt-iter", "3"))
    _finish(procs, "preempt", "FLEET_PREEMPTED")
    marks = [json.load(open(out / f"preempt_rank{r}.json"))
             for r in range(nproc)]
    assert [m["step"] for m in marks] == [3] * nproc, marks


@pytest.mark.slow
def test_fleet_coordinated_preempt_and_resume_pipeline(tmp_path):
    """Port of the reference's pipeline fleet chaos case: a 2-process
    pipeline (stages across the process boundary), rank 1 alone
    SIGTERMed mid-step, both ranks checkpoint at the same step, and a
    fresh fleet resumes to the uninterrupted run's losses and BYTE-equal
    final parameters."""
    out = tmp_path / "pipe"
    out.mkdir()
    _finish(_launch_fleet(_free_port(), out, "pipe", "ref"), "ref",
            "FLEET_WORKER_OK")
    ref = json.load(open(out / "ref_rank0.json"))
    _preempt(out, "pipe", 2)
    _finish(_launch_fleet(_free_port(), out, "pipe", "resume"), "resume",
            "FLEET_WORKER_OK")
    res = json.load(open(out / "resume_rank0.json"))
    assert res["final_iteration"] == ref["final_iteration"]
    for k, v in res["losses"].items():
        np.testing.assert_allclose(v, ref["losses"][k], rtol=0, atol=0,
                                   err_msg=f"step {k}")
    assert res["params_sha"] == ref["params_sha"]


@pytest.mark.slow
def test_fleet_elastic_shrink_2_to_1_pipeline(tmp_path):
    """Port of the reference's elastic pipeline case: the 2-process
    pipeline fleet's coordinated checkpoint resumes on ONE survivor as a
    plain trainer (the pipe-layout optimizer state unstacked), detected
    as a shrink, byte-equal to a fleet-free restore of a copy."""
    out = tmp_path / "pipe_2to1"
    out.mkdir()
    _preempt(out, "pipe", 2)
    ref_dir = tmp_path / "pipe_2to1_ref"
    shutil.copytree(out, ref_dir)
    _finish(_launch_fleet(_free_port(), out, "pipe", "resume", nproc=1),
            "resume", "FLEET_WORKER_OK")
    res = json.load(open(out / "resume_rank0.json"))
    assert res["elastic_shrink"] >= 1, res
    _finish(_launch_fleet(_free_port(), ref_dir, "pipe", "plainresume",
                          nproc=1), "plainresume", "FLEET_WORKER_OK")
    ref = json.load(open(ref_dir / "resume_rank0.json"))
    assert res["final_iteration"] == ref["final_iteration"]
    for k, v in res["losses"].items():
        np.testing.assert_allclose(v, ref["losses"][k], rtol=0, atol=0,
                                   err_msg=f"step {k}")
    assert res["params_sha"] == ref["params_sha"]
