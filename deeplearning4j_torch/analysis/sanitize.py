"""Runtime sanitizer (port of ``deeplearning4j_tpu/analysis/sanitize.py``,
its ``nan`` mode).

``DL4J_TPU_SANITIZE=nan`` (or ``all``) turns on opt-in finite checks at
the two host boundaries the reference checks: the fit loop checks every
step's loss, and the decode tick checks the ACTIVE slots' held logits
(free slots park stale values).  Each check is one device->host read per
step or tick while enabled; with no mode active every hook is one
frozenset-membership check.

``donation`` is accepted by the parser, as in the reference, and does
nothing: torch has no buffer donation, so no buffer can be used after
its storage was handed to a call.

Telemetry: every trip increments ``sanitizer_trips_total{mode=nan}``.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import telemetry

MODES = ("nan", "donation")

_TRIPS = telemetry.counter(
    "sanitizer_trips_total",
    "runtime sanitizer violations detected (raise sites), by mode",
    labelnames=("mode",))


class SanitizerError(RuntimeError):
    """A runtime sanitizer check failed (a non-finite value)."""


def _parse(text: Optional[str]) -> frozenset:
    if not text:
        return frozenset()
    parts = {p.strip().lower() for p in text.split(",") if p.strip()}
    if "all" in parts:
        return frozenset(MODES)
    unknown = parts - set(MODES)
    if unknown:
        raise ValueError(
            f"DL4J_TPU_SANITIZE: unknown mode(s) {sorted(unknown)} "
            f"(choose from {MODES} or 'all')")
    return frozenset(parts)


def _parse_lenient(text: Optional[str]) -> frozenset:
    """Import-time parse: a typo in the env var must not make the
    whole package unimportable — warn and ignore the bad mode.
    ``refresh()`` (the explicit API) stays strict."""
    try:
        return _parse(text)
    except ValueError as e:
        logging.getLogger("deeplearning4j_torch").warning("%s", e)
        return frozenset(p.strip().lower() for p in (text or "").split(",")
                         if p.strip().lower() in MODES)


_active: frozenset = _parse_lenient(os.environ.get("DL4J_TPU_SANITIZE"))


def refresh() -> frozenset:
    """Re-read ``DL4J_TPU_SANITIZE`` (tests toggle the env mid-process;
    production reads it once at import)."""
    global _active
    _active = _parse(os.environ.get("DL4J_TPU_SANITIZE"))
    return _active


def active(mode: str) -> bool:
    return mode in _active


def enabled() -> frozenset:
    return _active


def check_finite(site: str, value, detail: str = "") -> None:
    """Raise :class:`SanitizerError` when any element of ``value`` (a
    tensor on any device, an array or a scalar) is non-finite.  Call
    only when ``active('nan')`` — the caller gates, so the off path
    costs one set lookup, not a device read."""
    if torch.is_tensor(value):
        if not value.is_floating_point():
            return
        bad = ~torch.isfinite(value.detach())
        n_bad, size = int(bad.sum()), value.numel()
    else:
        arr = np.asarray(value)
        if not np.issubdtype(arr.dtype, np.floating):
            return
        n_bad, size = int((~np.isfinite(arr)).sum()), arr.size
    if n_bad:
        _TRIPS.labels(mode="nan").inc()
        raise SanitizerError(
            f"[sanitize:nan] non-finite value at {site}: {n_bad}/"
            f"{size} elements{' — ' + detail if detail else ''}")


def check_finite_rows(site: str, value, row_mask,
                      detail: str = "") -> None:
    """Finite check restricted to rows where ``row_mask`` is True —
    the decode tick's shape: inactive slots legitimately hold stale
    values, only ACTIVE slots' state must stay finite.  A tensor is
    reduced to one finite flag per row on its own device, so the read
    is n_rows booleans."""
    mask = np.asarray(row_mask, bool)
    if not mask.any():
        return
    if torch.is_tensor(value):
        if not value.is_floating_point():
            return
        v = value.detach()
        finite = torch.isfinite(v.reshape(v.shape[0], -1)).all(dim=1)
        finite = finite.cpu().numpy()
    else:
        arr = np.asarray(value)
        if not np.issubdtype(arr.dtype, np.floating):
            return
        finite = np.isfinite(arr.reshape(arr.shape[0], -1)).all(axis=1)
    bad_rows = [int(i) for i in np.nonzero(mask)[0] if not finite[i]]
    if bad_rows:
        _TRIPS.labels(mode="nan").inc()
        raise SanitizerError(
            f"[sanitize:nan] non-finite values at {site} in active "
            f"row(s) {bad_rows}"
            f"{' — ' + detail if detail else ''}")
