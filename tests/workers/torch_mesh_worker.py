"""One rank of a multi-process mesh job of the port, joined by
``torch.distributed`` over gloo on the CPU: every mesh axis may cross
the process boundary (``tests/test_torch_mesh_multiproc.py`` drives it
and holds the ranks to each other, to the one-process mesh and to the
JAX package).  Each scenario writes ``<OUTDIR>/<scenario>_rank<R>.json``.

Scenarios (the world size they need):

* ``tp_mlp`` (2) — ``MeshConfig(data=1, model=2)`` on the MLP of
  ``tests/workers/dist_tp_worker.py``, 5 steps;
* ``tp_gpt`` (2) — the same mesh on a tiny ``Gpt``, 5 steps;
* ``pipe`` (2) — ``MeshConfig(pipeline=2)``, ``n_micro=2``, 3 steps;
* ``ring`` (2) — ``ring_self_attention`` over ``MeshConfig(sequence=2)``:
  output and q/k/v gradients;
* ``ckpt`` (2) — the ``tp_mlp`` mesh under ``fit`` with a
  ``CheckpointListener`` (every 3 iterations) over 2 epochs of 4 batches;
* ``tp2x2`` (4) — ``MeshConfig(data=2, model=2)`` on the MLP, 5 steps;
* ``axis3`` (8) — ``MeshConfig(data=2, model=2, pipeline=2)`` on the tiny
  ``Gpt``, ``n_micro=2``, 3 steps.

Usage: torch_mesh_worker.py RANK WORLD PORT OUTDIR SCENARIO[,SCENARIO...]
"""
import json
import os
import sys

import numpy as np
import torch

CPU = torch.device("cpu")


def mlp():
    """``dist_tp_worker.py``'s MLP, built by the port on the CPU."""
    from deeplearning4j_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.layers_core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.optimize.updaters import Sgd
    conf = (NeuralNetConfiguration.builder().seed(11)
            .updater(Sgd(learning_rate=0.1)).list()
            .layer(DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def mlp_batches(n_steps):
    rng = np.random.default_rng(7)
    return [(rng.normal(size=(8, 6)).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)])
            for _ in range(n_steps)]


GPT_KW = dict(vocab_size=64, max_len=16, d_model=32, n_layers=4,
              n_heads=4, d_ff=64, seq_len=16, compute_dtype=None,
              use_flash=False, seed=17)


def gpt():
    from deeplearning4j_torch.zoo import Gpt
    return Gpt(**GPT_KW).init_graph(device="cpu")


def gpt_batches(n_steps, b=16):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n_steps):
        x = rng.integers(0, 64, (b, 16)).astype(np.int32)
        out.append((x, np.roll(x, -1, axis=1)))
    return out


def ring_inputs():
    """q, k, v [2, 2, 16, 8] f32, a key mask [2, 16] and the output
    weights of the scalar the gradients are taken of."""
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.normal(size=(2, 2, 16, 8)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((2, 16), np.float32)
    mask[1, 11:] = 0.0
    return q, k, v, mask, w


def ckpt_batches():
    from deeplearning4j_torch.data.dataset import DataSet
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    return DataSet(x, y).batch_by(8)


def _np(t):
    return t.detach().float().cpu().numpy().tolist()


def _held(trainer):
    """{storage path: shape} of the parameters this process stores."""
    from deeplearning4j_torch.utils.trees import iter_leaves
    return {"/".join(map(str, p)): list(t.shape)
            for p, t in iter_leaves(trainer._store[0])}


def _train(model, mesh_conf, batches, n_micro=4):
    from deeplearning4j_torch.parallel import ShardedTrainer, distributed
    from deeplearning4j_torch.utils.trees import iter_leaves
    tr = ShardedTrainer(model, mesh_conf,
                        devices=distributed.global_devices([CPU]),
                        n_micro=n_micro)
    losses = [float(tr.fit_batch(x, y)) for x, y in batches]
    held = _held(tr)
    tr.sync_model()             # collective: every rank gathers
    params = {"/".join(map(str, p)): _np(t)
              for p, t in iter_leaves(model.params_tree)}
    procs = sorted({int(v) for v in tr.mesh.owners.reshape(-1)})
    return {"losses": losses, "held": held, "params": params,
            "procs": procs}


def scenario(name, out_dir, rank):
    from deeplearning4j_torch.parallel import MeshConfig, distributed
    if name == "tp_mlp":
        out = _train(mlp(), MeshConfig(data=1, model=2), mlp_batches(5))
    elif name == "tp_gpt":
        out = _train(gpt(), MeshConfig(data=1, model=2), gpt_batches(5, 8))
    elif name == "pipe":
        out = _train(gpt(), MeshConfig(pipeline=2), gpt_batches(3),
                     n_micro=2)
    elif name == "tp2x2":
        out = _train(mlp(), MeshConfig(data=2, model=2), mlp_batches(5))
    elif name == "axis3":
        out = _train(gpt(), MeshConfig(data=2, model=2, pipeline=2),
                     gpt_batches(3), n_micro=2)
    elif name == "ring":
        from deeplearning4j_torch.parallel import ring_self_attention
        mesh = MeshConfig(sequence=2).build(
            distributed.global_devices([CPU]))
        q, k, v, mask, w = ring_inputs()
        q, k, v = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        o = ring_self_attention(mesh, q, k, v, torch.tensor(mask))
        (o * torch.tensor(w)).sum().backward()
        out = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
               "dv": _np(v.grad)}
    elif name == "ckpt":
        from deeplearning4j_torch.data.iterator import ListDataSetIterator
        from deeplearning4j_torch.optimize.listeners import (
            TrainingListener)
        from deeplearning4j_torch.parallel import (CheckpointListener,
                                                   ShardedTrainer)
        losses = {}

        class Rec(TrainingListener):
            def iteration_done(self, model, iteration, epoch, loss):
                losses[iteration] = float(loss)
        m = mlp()
        tr = ShardedTrainer(m, MeshConfig(data=1, model=2),
                            devices=distributed.global_devices([CPU]))
        ck = CheckpointListener(os.path.join(out_dir, f"ck{rank}"),
                                save_every_n_iterations=3,
                                async_save=False)
        m.set_listeners(ck, Rec())
        tr.fit(ListDataSetIterator(ckpt_batches()), n_epochs=2)
        ck.ckpt.close()
        out = {"losses": losses, "held": _held(tr),
               "steps": ck.ckpt.all_steps()}
    else:
        raise ValueError(f"unknown scenario {name!r}")
    with open(os.path.join(out_dir, f"{name}_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from deeplearning4j_torch.parallel import distributed
    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                           backend="gloo")
    for name in sys.argv[5].split(","):
        scenario(name, out_dir, rank)
    distributed.shutdown()
    print("MESH_WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
