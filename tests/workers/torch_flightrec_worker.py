"""The port's flight-recorder SIGKILL victim (``tests/workers/
flightrec_worker.py`` for ``deeplearning4j_torch``; imports no JAX).

Runs a tiny ``GenerationServer`` on the CPU with the flight recorder's
black-box persistence armed (ring + open-span snapshots into the shared
dir every 50 ms), admits one slow decode (every scheduler pass throttled
by a ``serve_tick_stall`` plan, so the request stays mid-decode for
seconds) and waits to be SIGKILLed by the parent test.  A SIGKILL runs
no handlers: the only record is what the black-box daemon persisted.

Usage: torch_flightrec_worker.py <shared_dir>
"""
import os
import sys

import numpy as np
import torch

shared_dir = sys.argv[1]
torch.set_num_threads(1)

from deeplearning4j_torch import telemetry  # noqa: E402
from deeplearning4j_torch.parallel import GenerationServer  # noqa: E402
from deeplearning4j_torch.resilience import FaultInjector  # noqa: E402
from deeplearning4j_torch.resilience.faults import (  # noqa: E402
    throttled_stall_plan)
from deeplearning4j_torch.zoo import Gpt  # noqa: E402

host = f"victim-{os.getpid()}"
telemetry.get_flight_recorder().install_dump(
    shared_dir, host=host, persist_interval_s=0.05)

gpt = Gpt(vocab_size=50, max_len=64, d_model=32, n_layers=2, n_heads=4,
          d_ff=64, seq_len=8, compute_dtype=None,
          seed=3).init_graph(device="cpu")
# tick_batch=1 + a long throttle plan: every scheduler pass stalls 50 ms,
# so the 40-token decode stays in flight for ~2 s
with FaultInjector(throttled_stall_plan(
        2000, "serve_tick_stall@2001:0.05", enqueue_s=0.05)):
    with GenerationServer(gpt, n_slots=2, max_len=64, tick_batch=1,
                          tick_timeout_s=None, device="cpu") as srv:
        h = srv.submit_async(np.asarray([1, 2, 3, 4], np.int32),
                             n_new=40)
        # the parent SIGKILLs us mid-decode; result() never returns
        h.result(timeout=600)
print("UNEXPECTED: decode finished before the kill", flush=True)
