"""The port's fleet-coordination chaos worker (``tests/workers/
fleet_worker.py`` for ``deeplearning4j_torch``): N gloo processes train a
tiny ``Gpt`` whose PIPELINE stages span the processes (``dp``: a global
data axis) under a ``FleetCoordinator``.  A real SIGTERM to one rank
mid-step must checkpoint every rank at the same step, and a fresh fleet
session resumes through ``fleet_resume_fit`` — possibly at another
world size (ELASTIC: the 2-process pipeline's checkpoint resumes on one
survivor as a plain trainer).  ``plainresume`` is the control: the same
restore with no fleet machinery.  Each rank checkpoints into
``<out_dir>/ckpt<rank>``.

Usage: torch_fleet_worker.py <rank> <nproc> <port> <out_dir> <mode:dp|pipe>
       <n_epochs> <phase:ref|preempt|resume|plainresume>
       [--preempt-rank R --preempt-iter N]
"""
import hashlib
import json
import os
import signal
import sys

import numpy as np
import torch

(rank, nproc, port, out_dir, mode, n_epochs, phase) = (
    int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    sys.argv[5], int(sys.argv[6]), sys.argv[7])
preempt_rank = preempt_iter = None
if "--preempt-rank" in sys.argv:
    preempt_rank = int(sys.argv[sys.argv.index("--preempt-rank") + 1])
    preempt_iter = int(sys.argv[sys.argv.index("--preempt-iter") + 1])
torch.set_num_threads(1)

from deeplearning4j_torch.parallel import distributed  # noqa: E402

if phase == "resume":
    # the elastic entry: beacon into the shared directory and join
    # whoever shows up (the parent restarts exactly nproc processes)
    from deeplearning4j_torch.resilience import survivor_rendezvous
    w = survivor_rendezvous(out_dir, host_id=f"host{rank:03d}",
                            grace_s=10.0, expected=nproc)
    assert (w.world, w.rank) == (nproc, rank), (w, nproc, rank)

distributed.initialize(f"tcp://127.0.0.1:{port}", nproc, rank,
                       backend="gloo")

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_torch.data.iterator import (  # noqa: E402
    ListDataSetIterator)
from deeplearning4j_torch.optimize.listeners import (  # noqa: E402
    TrainingListener)
from deeplearning4j_torch.parallel import (  # noqa: E402
    CheckpointListener, MeshConfig, ShardedTrainer)
from deeplearning4j_torch.resilience import (  # noqa: E402
    FleetCoordinator, PreemptionGuard, TrainingPreempted,
    fleet_resume_fit)
from deeplearning4j_torch.utils.trees import iter_leaves  # noqa: E402

devices = distributed.global_devices([torch.device("cpu")])
rng = np.random.default_rng(7)
if mode == "dp":
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.layers_core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.builder().seed(11)
            .updater(Adam(learning_rate=0.01)).list()
            .layer(DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .build())
    model = MultiLayerNetwork(conf).init(device="cpu")
    trainer = ShardedTrainer(model, MeshConfig(data=nproc), devices=devices)
    gx = rng.normal(size=(24, 6)).astype(np.float32)
    gy = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 24)]
else:
    from deeplearning4j_torch.zoo import Gpt
    model = Gpt(vocab_size=32, max_len=8, d_model=16, n_layers=2,
                n_heads=2, d_ff=32, seq_len=8, compute_dtype=None,
                use_flash=False, seed=9).init_graph(device="cpu")
    trainer = ShardedTrainer(model, MeshConfig(pipeline=nproc),
                             devices=devices, n_micro=2)
    gx = rng.integers(0, 32, (24, 8)).astype(np.int32)
    gy = np.roll(gx, -1, axis=1)


def data():
    return ListDataSetIterator(DataSet(gx, gy).batch_by(8))


losses = {}


class _Recorder(TrainingListener):
    def iteration_done(self, model, iteration, epoch, loss):
        losses[iteration] = float(loss)


class _SelfSigterm(TrainingListener):
    """A real SIGTERM to THIS rank at a chosen iteration."""

    def iteration_done(self, model, iteration, epoch, loss):
        if iteration == preempt_iter:
            os.kill(os.getpid(), signal.SIGTERM)


listeners = [_Recorder()]
ck = None
if phase != "ref":
    ck = CheckpointListener(os.path.join(out_dir, f"ckpt{rank}"),
                            save_every_n_iterations=2, async_save=False,
                            world=nproc)
    listeners.append(ck)
if phase == "preempt" and rank == preempt_rank:
    listeners.append(_SelfSigterm())
model.set_listeners(*listeners)


def dump(tag):
    trainer.sync_model()            # collective: every rank gathers
    h = hashlib.sha256()
    for _, leaf in iter_leaves(model.params_tree):
        h.update(np.ascontiguousarray(leaf.detach().cpu().numpy())
                 .tobytes())
    elastic = telemetry.counter("fleet_elastic_resumes_total",
                                labelnames=("direction",))
    with open(os.path.join(out_dir, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "params_sha": h.hexdigest(),
                   "losses": {str(k): v for k, v in losses.items()},
                   "final_iteration": model.iteration_count,
                   "elastic_shrink":
                       elastic.labels(direction="shrink").value,
                   "elastic_grow":
                       elastic.labels(direction="grow").value}, f)


if phase == "ref":
    trainer.fit(data(), n_epochs=n_epochs)
    dump("ref")
    print("FLEET_WORKER_OK", rank)
elif phase == "preempt":
    try:
        with PreemptionGuard(), FleetCoordinator(trainer.mesh):
            trainer.fit(data(), n_epochs=n_epochs)
        raise SystemExit(f"rank {rank}: fit finished without preemption")
    except TrainingPreempted as e:
        with open(os.path.join(out_dir, f"preempt_rank{rank}.json"),
                  "w") as f:
            json.dump({"rank": rank, "step": e.step}, f)
        print("FLEET_PREEMPTED", rank, e.step)
elif phase == "plainresume":
    loss = trainer.fit(data(), n_epochs=n_epochs, resume=True)
    dump("resume")
    print("FLEET_WORKER_OK", rank, loss)
else:
    loss = fleet_resume_fit(
        lambda: trainer.fit(data(), n_epochs=n_epochs, resume=True),
        mesh=trainer.mesh, checkpoint=ck, world=nproc)
    dump("resume")
    print("FLEET_WORKER_OK", rank, loss)
if ck is not None:
    ck.ckpt.close()
distributed.shutdown()
