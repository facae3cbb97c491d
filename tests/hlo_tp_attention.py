"""Evidence for "TP attention split by heads": which per-device shapes the
compiled HLO of the reference's ``ShardedTrainer`` step gives the
attention score and value einsums of a tiny ``Gpt`` (4 heads) at data 1
x model 2, on two of eight virtual CPU devices.

GSPMD partitions the step; the partitioned HLO's dots carry per-device
shapes.  A score einsum ``bhqd,bhkd->bhqk`` whose per-device result holds
all 4 heads means each device computes the whole attention (replicated:
the qkv activation regathered before the head split, as the port does);
2 heads would mean the attention is sharded over heads.

Run: ``python tests/hlo_tp_attention.py`` (prints one JSON line).
"""
import glob
import json
import os
import re
import shutil
import sys
import tempfile

DUMP = tempfile.mkdtemp(prefix="hlo_tp_attention_")
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    f"--xla_dump_to={DUMP} --xla_dump_hlo_as_text")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

B, T, H, DH = 8, 16, 4, 8


def main():
    from deeplearning4j_tpu.parallel.mesh import MeshConfig
    from deeplearning4j_tpu.parallel.trainer import ShardedTrainer
    from deeplearning4j_tpu.zoo.gpt import Gpt
    model = Gpt(vocab_size=64, max_len=T, d_model=H * DH, n_layers=2,
                n_heads=H, d_ff=64, seq_len=T, compute_dtype=None,
                use_flash=False, seed=17).init_graph()
    tr = ShardedTrainer(model, MeshConfig(data=1, model=2),
                        devices=jax.devices()[:2])
    x = np.random.default_rng(7).integers(0, 64, (B, T)).astype(np.int32)
    float(tr.fit_batch(x, np.roll(x, -1, axis=1)))
    dot = re.compile(r"= f32\[([\d,]+)\]\{[^}]*\} dot\(")
    found, shapes = {}, set()
    for path in glob.glob(os.path.join(DUMP, "*after_optimizations.txt")):
        text = open(path).read()
        if "num_partitions=2" not in text:
            continue
        for m in dot.finditer(text):
            dims = [int(d) for d in m.group(1).split(",")]
            # the score einsum's result ends in [t, t]; its leading dims
            # hold the batch and the heads this device computes
            if len(dims) >= 3 and dims[-2:] == [T, T]:
                heads = int(np.prod(dims[:-2])) // B
                found[heads] = found.get(heads, 0) + 1
                shapes.add(tuple(dims))
    verdict = ("replicated" if set(found) == {H} else
               "sharded over heads" if set(found) == {H // 2} else
               "mixed")
    print(json.dumps({"mesh": "data 1 x model 2", "heads": H,
                      "score_dots_by_heads_per_device": found,
                      "score_dot_shapes": sorted(shapes),
                      "attention": verdict}))


if __name__ == "__main__":
    try:
        main()
    finally:
        shutil.rmtree(DUMP, ignore_errors=True)
