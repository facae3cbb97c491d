"""Shared pieces of the port's serving tests (``test_torch_*``): the tiny
Gpt both packages' serving suites use, and the near-tie stream check.

Torch's CPU matmuls do not give a row the same bits at every batch size,
so a served stream may leave the offline one only at a near tie: the
teacher-forced logits of the two tokens at the first divergence within
``NEAR_TIE`` of each other."""
import numpy as np
import torch

TINY = dict(vocab_size=50, max_len=32, d_model=32, n_layers=2, n_heads=4,
            d_ff=64, seq_len=8, compute_dtype=None, seed=3)
NEAR_TIE = 1e-4
CPU = dict(device="cpu")


def tiny_net():
    from deeplearning4j_torch.zoo import Gpt
    return Gpt(**TINY).init_graph(device="cpu")


def assert_stream(gen, out, ref):
    """``out`` equals ``ref``, or first diverges at a near tie."""
    out, ref = np.asarray(out), np.asarray(ref)
    if out.shape == ref.shape and np.array_equal(out, ref):
        return
    n = min(len(out), len(ref))
    diff = [j for j in range(n) if out[j] != ref[j]]
    assert diff, f"equal for {n} tokens, lengths {len(out)} != {len(ref)}"
    i = diff[0]
    emb, blks, head = gen._serving_params()
    lg = gen._prefill_rows(emb, blks, head,
                           torch.as_tensor(out[None, :i].astype(np.int64)))[0]
    margin = float((lg[0, int(out[i])] - lg[0, int(ref[i])]).abs())
    assert margin <= NEAR_TIE, (i, margin, out, ref)


def offline_ref(offline, prompt, n_new):
    """The port's offline greedy stream for one prompt."""
    return offline.generate(np.asarray(prompt)[None], n_new=n_new)[0]
