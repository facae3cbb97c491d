"""Solver: one eager training step (port of
``deeplearning4j_tpu/optimize/solver.py``).

The reference compiles the whole iteration — forward, loss, backward,
gradient normalization, updater, parameter update — into one XLA program
with the parameter and optimizer-state buffers donated.  Here the step
runs eagerly in the same order: forward and loss, ``torch.autograd``
backward, the finiteness probe ON THE DEVICE (no host sync), the
trainable mask, ``normalize_gradients``, the updater, decoupled weight
decay, then the update applied IN PLACE under ``torch.no_grad()`` (what
donation buys the reference): parameters and optimizer-state tensors
keep their identity and storage, and a non-finite step selects the old
values with ``torch.where`` — bit-identical, never ``0 * NaN``.  The
model state the forward returns (batch-norm running statistics) is kept
the same way: the new tree on a finite step, the old one on a bad step
(where the two trees line up: a recurrent model's first tBPTT chunk grows
the tree by its carry).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from deeplearning4j_torch.optimize.updaters import BaseUpdater
from deeplearning4j_torch.utils.trees import iter_leaves, map_leaves, set_path


def check_numerics_enabled() -> bool:
    """``DL4J_TPU_CHECK_NUMERICS=1``: every train step validates its loss
    and updated params on the host, naming the offending leaves (one
    device sync per step — a debug mode, as in the reference)."""
    return os.environ.get("DL4J_TPU_CHECK_NUMERICS", "") in ("1", "true")


def check_numerics(loss, params, step_idx: int):
    bad = []
    if not bool(torch.isfinite(loss).all()):
        bad.append(f"loss={float(loss)}")
    for path, leaf in iter_leaves(params):
        n_bad = int((~torch.isfinite(leaf)).sum())
        if n_bad:
            bad.append(f"params[{'/'.join(path)}]: {n_bad}/{leaf.numel()} "
                       "non-finite")
    if bad:
        raise FloatingPointError(
            f"Non-finite values after train step {step_idx} "
            f"(DL4J_TPU_CHECK_NUMERICS): " + "; ".join(bad[:8]))


def finite_step_ok(loss, grads, trainable_tree=None):
    """0-d bool tensor on the device: True iff the loss and every
    (trainable) gradient leaf are finite.  Frozen leaves (mask 0) are
    excluded — their grads are zeroed downstream and must not veto the
    step."""
    ok = torch.isfinite(loss).all()
    masks = ([m for _, m in iter_leaves(trainable_tree)]
             if trainable_tree is not None else None)
    for i, (_, g) in enumerate(iter_leaves(grads)):
        if masks is not None:
            g = torch.where(masks[i] > 0, g, torch.zeros_like(g))
        ok = ok & torch.isfinite(g).all()
    return ok


@torch.no_grad()
def apply_updates_if(ok, params, updates, lr_scale):
    """``params -= updates * lr_scale`` in place where ``ok``, else the
    old params, bit for bit (a select, not a multiply: 0 * NaN is NaN)."""
    for (_, p), (_, u) in zip(iter_leaves(params), iter_leaves(updates)):
        p.copy_(torch.where(ok, p - (u * lr_scale).to(u.dtype), p))


@torch.no_grad()
def select_step(ok, new_tree, old_tree):
    """Write ``new`` into ``old`` in place where ``ok`` (same structure) —
    how optimizer state sits out a non-finite step."""
    for (_, new), (_, old) in zip(iter_leaves(new_tree),
                                  iter_leaves(old_tree)):
        old.copy_(torch.where(ok, new, old))


def normalize_gradients(grads, kind: Optional[str], threshold: float):
    """DL4J ``GradientNormalization`` semantics, on the device."""
    if not kind or kind == "none":
        return grads
    if kind == "clip_element_wise_absolute_value":
        return map_leaves(lambda g: torch.clamp(g, -threshold, threshold),
                          grads)

    def clip(g, n):
        return g * torch.clamp(threshold / (n + 1e-12), max=1.0)

    if kind == "clip_l2_per_layer":
        return map_leaves(lambda g: clip(g, torch.linalg.norm(g.reshape(-1))),
                          grads)
    if kind == "renormalize_l2_per_layer":
        return map_leaves(
            lambda g: g / (torch.linalg.norm(g.reshape(-1)) + 1e-12), grads)
    if kind == "clip_l2_per_param_type":
        # one clip per parameter TYPE (all the W's together, ...)
        sq = {}
        for path, g in iter_leaves(grads):
            sq[path[-1]] = sq.get(path[-1], 0.0) + torch.sum(torch.square(g))
        out = {}
        for path, g in iter_leaves(grads):
            set_path(out, path, clip(g, torch.sqrt(sq[path[-1]])))
        return out
    if kind == "clip_global_norm":
        gn = torch.sqrt(sum(torch.sum(torch.square(g))
                            for _, g in iter_leaves(grads)))
        scale = torch.clamp(threshold / (gn + 1e-12), max=1.0)
        return map_leaves(lambda g: g * scale, grads)
    raise ValueError(f"Unknown gradient normalization {kind!r}")


class Solver:
    """Owns the step for one model.  ``score_fn(params, model_state,
    batch, rng, training) -> (loss, new_model_state)`` is supplied by the
    network class; ``batch`` is a dict with 'features', 'labels' and
    optional masks."""

    def __init__(self, score_fn: Callable, updater: BaseUpdater,
                 grad_normalization: Optional[str] = None,
                 grad_norm_threshold: float = 1.0, minimize: bool = True,
                 decay_tree=None, trainable_tree=None):
        self.score_fn = score_fn
        self.updater = updater
        self.grad_normalization = grad_normalization
        self.grad_norm_threshold = grad_norm_threshold
        self.minimize = minimize
        # per-leaf decoupled weight decay (update += lr * wd * param)
        self.decay_tree = decay_tree
        # 1.0/0.0 masks: 0.0 leaves are frozen (update zeroed)
        self.trainable_tree = trainable_tree

    def init_opt_state(self, params):
        return self.updater.init_state(params)

    def _loss_and_grads(self, params, model_state, batch, rng):
        """Forward + loss, then one ``torch.autograd.grad`` over every
        parameter leaf (leaves the loss does not reach get zeros).  The
        trees keep ``params``' skeleton, so a layer without parameters
        (pooling, activation) keeps its empty dict."""
        paths = [p for p, _ in iter_leaves(params)]
        leaves = [leaf.detach().requires_grad_(True)
                  for _, leaf in iter_leaves(params)]
        live = map_leaves(lambda _: None, params)
        for path, leaf in zip(paths, leaves):
            set_path(live, path, leaf)
        with torch.enable_grad():
            loss, new_state = self.score_fn(live, model_state, batch, rng,
                                            True)
            obj = loss if self.minimize else -loss
            grads = torch.autograd.grad(obj, leaves, allow_unused=True)
        tree = map_leaves(lambda _: None, params)
        for path, leaf, g in zip(paths, leaves, grads):
            set_path(tree, path, torch.zeros_like(leaf) if g is None else g)
        # the state leaves the graph here: a recurrent carry continues
        # into the next tBPTT chunk as a value, so gradients stop at the
        # chunk boundary (as in the reference's jitted step)
        return (loss.detach(), map_leaves(torch.Tensor.detach, new_state),
                tree)

    def step(self, params, opt_state, model_state, step_idx, batch, rng,
             lr_scale: float = 1.0):
        """One optimization iteration, updating ``params`` and
        ``opt_state`` in place; returns (params, opt_state, model_state,
        loss).  A non-finite loss or gradient leaves both bit-identical
        (the loss is still returned non-finite for the caller to see)."""
        loss, new_model_state, grads = self._loss_and_grads(
            params, model_state, batch, rng)
        with torch.no_grad():
            ok = finite_step_ok(loss, grads, self.trainable_tree)
            if self.trainable_tree is not None:
                # frozen grads zeroed BEFORE normalization and the updater
                grads = map_leaves(lambda g, m: g * m, grads,
                                   self.trainable_tree)
            grads = normalize_gradients(grads, self.grad_normalization,
                                        self.grad_norm_threshold)
            updates, new_opt = self.updater.update(grads, opt_state, params,
                                                   step_idx)
            if self.decay_tree is not None:
                lr = self.updater.lr_at(step_idx)
                updates = map_leaves(lambda u, p, wd: u + lr * wd * p,
                                     updates, params, self.decay_tree)
            if self.trainable_tree is not None:
                updates = map_leaves(lambda u, m: u * m, updates,
                                     self.trainable_tree)
            apply_updates_if(ok, params, updates, lr_scale)
            new_opt = self.updater.finalize(new_opt, params)
            select_step(ok, new_opt, opt_state)
            # model state (batch-norm statistics, a recurrent carry)
            # keeps its old value on a bad step too, where the two trees
            # line up: a first chunk GROWS the tree by its carry, and that
            # goes through (the next batch boundary clears it)
            if [p for p, _ in iter_leaves(new_model_state)] == \
                    [p for p, _ in iter_leaves(model_state)]:
                new_model_state = map_leaves(
                    lambda new, old: torch.where(ok, new, old),
                    new_model_state, model_state)
        if check_numerics_enabled():
            check_numerics(loss, params, int(step_idx))
        return params, opt_state, new_model_state, loss
