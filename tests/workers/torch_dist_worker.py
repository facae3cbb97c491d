"""One rank of the port's two-process gloo job (driven by
``tests/test_torch_distributed.py``): data-parallel steps whose gradient
all-reduce crosses the process boundary, the control reductions, and a
FleetCoordinator-run fit in which one rank is preempted.

Usage: torch_dist_worker.py RANK WORLD PORT OUTDIR"""
import json
import os
import sys

import numpy as np
import torch

def model():
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.layers_core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater(Adam(learning_rate=1e-2)).list()
            .layer(DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def data(n=32):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])


def main():
    RANK, WORLD, PORT, OUT = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_torch.data.iterator import ListDataSetIterator
    from deeplearning4j_torch.parallel import (CheckpointListener,
                                               MeshConfig, ShardedTrainer,
                                               distributed)
    from deeplearning4j_torch.resilience import (FaultInjector,
                                                 TrainingPreempted)
    from deeplearning4j_torch.resilience.coordination import (
        FleetCoordinator)
    distributed.initialize(f"tcp://127.0.0.1:{PORT}", WORLD, RANK,
                           backend="gloo")
    out = {"process_count": distributed.process_count(),
           "process_index": distributed.process_index()}
    cpu = [torch.device("cpu")]
    # every rank feeds the IDENTICAL global batch and keeps its rows
    x, y = data()
    m = model()
    tr = ShardedTrainer(m, MeshConfig(data=1), devices=cpu)
    out["losses"] = [float(tr.fit_batch(x, y)) for _ in range(5)]
    out["W0"] = m.params_tree["layer_0"]["W"].numpy().tolist()
    out["or"] = distributed.or_reduce_flag(RANK == 1)
    out["or_none"] = distributed.or_reduce_flag(False)
    out["min"] = distributed.min_reduce(RANK + 3)
    out["sum"] = distributed.sum_reduce(1)
    out["rendezvous"] = FleetCoordinator(tr.mesh).rendezvous()

    # a coordinated fit: rank 1 alone is preempted after iteration 2;
    # the in-band broadcast stops BOTH ranks at that step boundary
    m2 = model()
    tr2 = ShardedTrainer(m2, MeshConfig(data=1), devices=cpu)
    ck = CheckpointListener(os.path.join(OUT, f"ck{RANK}"),
                            save_every_n_iterations=100)
    m2.set_listeners(ck)
    it = ListDataSetIterator(DataSet(*data(64)).batch_by(16))
    faults = ["preempt@2"] if RANK == 1 else []
    try:
        with FleetCoordinator(tr2.mesh), FaultInjector(faults):
            tr2.fit(it, n_epochs=2)
        out["preempted_at"] = None
    except TrainingPreempted as e:
        out["preempted_at"] = e.step
    out["iterations"] = m2.iteration_count
    ck.ckpt.close()
    with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
