"""Loss functions (port of ``deeplearning4j_tpu/nn/losses.py``).

DL4J semantics kept for loss-curve parity: every loss returns per-example
scores [batch] (summed over the output dimensions of an example; the
caller averages over the minibatch), MCXENT expects probabilities unless
the fused softmax path hands it logits (``FUSED_ACTIVATIONS``), and label
masks weight the per-example scores at the caller.
"""
from __future__ import annotations

import torch

_EPS = 1e-7


def _sum_features(x):
    # Sum across all non-batch axes: handles 2-D dense, 4-D conv, 3-D time.
    return x.sum(dim=tuple(range(1, x.ndim))) if x.ndim > 1 else x


def mcxent(labels, preds, logits=None):
    """Multi-class cross entropy; from ``logits`` via log_softmax (the
    fused softmax + MCXENT path)."""
    if logits is not None:
        logp = torch.log_softmax(logits, dim=-1)
    else:
        logp = torch.log(torch.clamp(preds, _EPS, 1.0))
    return -_sum_features(labels * logp)


def negativeloglikelihood(labels, preds, logits=None):
    # DL4J's NLL is MCXENT (it subclasses LossMCXENT with clipping).
    return mcxent(labels, preds, logits)


def binary_xent(labels, preds, logits=None):
    """XENT — sigmoid binary cross entropy (``LossBinaryXENT``)."""
    if logits is not None:
        z = logits
        per = (torch.clamp(z, min=0.0) - z * labels
               + torch.log1p(torch.exp(-z.abs())))
        return _sum_features(per)
    p = torch.clamp(preds, _EPS, 1.0 - _EPS)
    return -_sum_features(labels * torch.log(p)
                          + (1.0 - labels) * torch.log1p(-p))


def _n_features(x):
    n = 1
    for s in x.shape[1:]:
        n *= s
    return n


def mse(labels, preds, logits=None):
    # DL4J LossMSE divides by the output count (LossL2 is the plain sum).
    return _sum_features(torch.square(preds - labels)) / _n_features(labels)


def l1(labels, preds, logits=None):
    return _sum_features((preds - labels).abs())


def l2(labels, preds, logits=None):
    return _sum_features(torch.square(preds - labels))


def hinge(labels, preds, logits=None):
    # labels in {-1, +1} per DL4J LossHinge
    return _sum_features(torch.clamp(1.0 - labels * preds, min=0.0))


def squared_hinge(labels, preds, logits=None):
    return _sum_features(torch.square(
        torch.clamp(1.0 - labels * preds, min=0.0)))


def kld(labels, preds, logits=None):
    y = torch.clamp(labels, _EPS, 1.0)
    p = torch.clamp(preds, _EPS, 1.0)
    return _sum_features(y * (torch.log(y) - torch.log(p)))


def poisson(labels, preds, logits=None):
    p = torch.clamp(preds, min=_EPS)
    return _sum_features(p - labels * torch.log(p))


def cosine_proximity(labels, preds, logits=None):
    yn = labels / (torch.linalg.norm(labels, dim=-1, keepdim=True) + _EPS)
    pn = preds / (torch.linalg.norm(preds, dim=-1, keepdim=True) + _EPS)
    return -_sum_features(yn * pn)


def mape(labels, preds, logits=None):
    return _sum_features(100.0 * ((labels - preds)
                                  / torch.clamp(labels.abs(), min=_EPS)).abs())


def msle(labels, preds, logits=None):
    return _sum_features(torch.square(
        torch.log1p(torch.clamp(preds, min=-1 + _EPS))
        - torch.log1p(torch.clamp(labels, min=-1 + _EPS))))


def sparse_mcxent(labels, preds, logits=None):
    """SPARSE_MCXENT — integer class labels of shape [batch]."""
    if logits is not None:
        logp = torch.log_softmax(logits, dim=-1)
    else:
        logp = torch.log(torch.clamp(preds, _EPS, 1.0))
    labels = labels.long()
    if labels.ndim == logp.ndim:  # [batch, 1]
        labels = labels.reshape(labels.shape[:-1])
    return -torch.take_along_dim(logp, labels[..., None], dim=-1)[..., 0]


LOSSES = {
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "sparse_mcxent": sparse_mcxent,
    "xent": binary_xent,
    "mse": mse,
    "squared_loss": mse,
    "l1": l1,
    "mae": l1,
    "l2": l2,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kld,
    "reconstruction_crossentropy": binary_xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "mean_absolute_percentage_error": mape,
    "mean_squared_logarithmic_error": msle,
}

# Losses that can consume raw logits when fused with these final activations.
FUSED_ACTIVATIONS = {
    "mcxent": "softmax",
    "negativeloglikelihood": "softmax",
    "sparse_mcxent": "softmax",
    "xent": "sigmoid",
}


def get_loss(name: str):
    fn = LOSSES.get(str(name).lower())
    if fn is None:
        raise ValueError(f"Unknown loss {name!r}; available: {sorted(LOSSES)}")
    return fn
