#!/usr/bin/env python3
"""Run ``chip_smoke.py --phases build,slo`` of two checkouts in turns on
one CUDA card, on a host made slower than it is.

    python3 scripts/slo_stress.py BEFORE_DIR AFTER_DIR [DELAY_MS [N_BUSY]]

Each directory is a checkout of the repository (for example the parent
commit unpacked with ``git archive``).  The turns run BEFORE, AFTER,
AFTER, BEFORE, each ``chip_smoke.py`` in its own checkout and process.
Two ways to slow the host, as a loaded machine does: every serving
dispatch (``GenerationServer._decode_scan`` and ``_spec_rounds``) first
sleeps ``DELAY_MS`` (default 0), which stretches the burst of part (b)
and the gaps between its waves of first tokens; and ``N_BUSY`` (default
0) spinning Python processes hold CPU cores from the first turn to the
last.  Each turn's output goes to
``slo_stress_out/<turn>_<before|after>.{log,err}`` under the current
directory; the script prints each turn's exit code and seconds, its
``slo/burst`` and ``slo/recovery`` numbers (alert transitions, timeline,
rung timeline) and, for a failed turn, the end of its standard error.
Exits nonzero when an AFTER turn failed."""
import json
import os
import subprocess
import sys
import time

# the child: the checkout's own chip_smoke.py as __main__, every serving
# dispatch first sleeping the delay
CHILD = """
import runpy, sys, time
sys.path.insert(0, ".")
delay = float(sys.argv[1]) / 1000.0
if delay > 0:
    from deeplearning4j_torch.parallel import generation_server as gs
    for name in ("_decode_scan", "_spec_rounds"):
        orig = getattr(gs.GenerationServer, name)
        def slow(self, *a, _orig=orig, **kw):
            time.sleep(delay)
            return _orig(self, *a, **kw)
        setattr(gs.GenerationServer, name, slow)
sys.argv = ["chip_smoke.py", "--phases", "build,slo"]
runpy.run_path("chip_smoke.py", run_name="__main__")
"""


def main():
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    trees = {"before": os.path.abspath(sys.argv[1]),
             "after": os.path.abspath(sys.argv[2])}
    delay_ms = sys.argv[3] if len(sys.argv) > 3 else "0"
    n_busy = int(sys.argv[4]) if len(sys.argv) > 4 else 0
    out = os.path.abspath("slo_stress_out")
    os.makedirs(out, exist_ok=True)
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(n_busy)]
    failed_after = False
    try:
        for i, name in enumerate(("before", "after", "after", "before")):
            log = os.path.join(out, f"{i}_{name}.log")
            err = os.path.join(out, f"{i}_{name}.err")
            t0 = time.time()
            with open(log, "w") as lo, open(err, "w") as le:
                try:
                    rc = subprocess.call(
                        [sys.executable, "-c", CHILD, delay_ms],
                        cwd=trees[name], stdout=lo, stderr=le, timeout=420)
                except subprocess.TimeoutExpired:
                    rc = "timeout"
            print(f"turn {i} {name} rc={rc} s={time.time() - t0:.1f}",
                  flush=True)
            for ln in open(log):
                if '"slo/burst"' in ln or '"slo/recovery"' in ln:
                    d = json.loads(ln)
                    keep = {k: d.get(k) for k in (
                        "seconds", "alert_transitions", "timeline",
                        "rung_timeline")}
                    print(d["phase"], json.dumps(keep), flush=True)
            if rc:
                failed_after |= name == "after"
                print("".join(open(err).readlines()[-6:]), flush=True)
    finally:
        for p in busy:
            p.kill()
        for p in busy:
            p.wait()
    sys.exit(1 if failed_after else 0)


if __name__ == "__main__":
    main()
