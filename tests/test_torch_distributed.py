"""The port's multi-process layer on real OS processes joined by
``torch.distributed`` over gloo (``tests/workers/torch_dist_worker.py``),
held to ``tests/test_distributed_multiproc.py``: data parallelism across
two processes equals data parallelism over two local shards, the
control reductions agree on every rank, and a ``FleetCoordinator``
stops both ranks at the same step when one rank alone is preempted.
The reference's multi-process cases are ``slow``; so are their ports
here beyond the one tier-1 case."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORKER = os.path.join(os.path.dirname(__file__), "workers",
                      "torch_dist_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(tmp_path, world):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(rank), str(world), str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert "WORKER_OK" in out
    return [json.load(open(tmp_path / f"rank{r}.json"))
            for r in range(world)]


def _local_dp(world):
    """The same 5 steps as data parallelism over ``world`` local shards
    of one process."""
    sys.path.insert(0, os.path.dirname(WORKER))
    import torch_dist_worker as w
    from deeplearning4j_torch.parallel import MeshConfig, ShardedTrainer
    torch.set_num_threads(1)
    x, y = w.data()
    m = w.model()
    tr = ShardedTrainer(m, MeshConfig(data=world),
                        devices=[torch.device("cpu")] * world)
    losses = [float(tr.fit_batch(x, y)) for _ in range(5)]
    return losses, m.params_tree["layer_0"]["W"].numpy()


def test_two_process_gloo_dp_reductions_and_fleet_preemption(tmp_path):
    r0, r1 = _run_ranks(tmp_path, 2)
    assert (r0["process_count"], r1["process_count"]) == (2, 2)
    assert (r0["process_index"], r1["process_index"]) == (0, 1)
    # the gradient all-reduce crosses the process boundary: both ranks
    # hold the same model, equal to DP over two local shards
    np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=1e-6)
    losses, w0 = _local_dp(2)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(r0["W0"]), w0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r1["W0"]), w0, atol=1e-6)
    assert r0["losses"][-1] < r0["losses"][0]
    for r in (r0, r1):
        assert r["or"] is True and r["or_none"] is False
        assert r["min"] == 3 and r["sum"] == 2 and r["rendezvous"] == 2
        # rank 1's SIGTERM reached rank 0 at the same step boundary
        assert r["preempted_at"] == 2 and r["iterations"] == 3


@pytest.mark.slow
def test_four_process_gloo_dp(tmp_path):
    """Four ranks: the all-reduce over four processes equals DP over four
    local shards."""
    ranks = _run_ranks(tmp_path, 4)
    losses, w0 = _local_dp(4)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(r["W0"]), w0, atol=1e-6)
        assert r["sum"] == 4 and r["preempted_at"] == 2
