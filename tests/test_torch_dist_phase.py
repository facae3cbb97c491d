"""Rehearsal of the card's phase 9f (``chip_smoke.dist_parts``) on the
CPU: the same worker processes of ``chip_smoke.py`` joined by gloo —
(a) model=2 over 2 processes with its dropped-sum control, (b)
pipeline=2, (c) data 2 x model 2 x pipeline 2 over 8, (d) ring
attention, (e) the data 2 x tp 2 server with its per-slot state on its
rows, (f) a SIGKILLed worker's black box — at a tiny width.  Every check
of the phase runs; the kernel launch counts are the card's alone (a CPU
tensor takes each wrapper's plain version)."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TINY = {"gpt": {"vocab_size": 64, "max_len": 256, "d_model": 32,
                "n_layers": 4, "n_heads": 4, "d_ff": 64},
        "vocab": 64, "b": 8, "t": 256, "steps": 2, "n_micro": 4,
        "axis3_layers": 4, "ring": {"b": 2, "h": 2, "dh": 8, "t": 64},
        "serve": {"n_slots": 4, "max_len": 64, "block_size": 8,
                  "tick_batch": 4, "tp": 2, "requests": 3, "new": 6,
                  "prompt_t": [4, 30],
                  "spec": {"k": 2, "rounds": 2, "draft_layers": 1}},
        "kernels": False, "timeout_s": 240}


def test_dist_phase_rehearsal_on_cpu(capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        counts = chip_smoke.dist_parts(torch, np, "cpu", TINY,
                                       lambda: None, "cpu rehearsal")
    finally:
        torch.set_num_threads(n)
    import json
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["phase"] == "dist"
    for part in ("a_tp", "b_pp", "c_axis3"):
        assert row[part]["rank_spread"] <= 1e-6
        assert max(row[part]["ref_max_rel_diff"].values()) <= \
            chip_smoke.MESH_TOL["train_loss"]
    assert row["a_tp"]["owners"] == [0, 1]
    assert row["c_axis3"]["owners"] == list(range(8))
    assert row["a_tp"]["control_drop"]["tripped"]
    assert row["e_serve"]["state_on_rows"]
    assert row["f_blackbox"]["salvaged"]
    assert set(counts) == {"tp", "pp", "axis3", "serve"}
