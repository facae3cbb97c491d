"""Shared pieces of the port's control-plane tests (``test_torch_tsdb``,
``test_torch_slo``, ``test_torch_degrade``, ``test_torch_autoscale``):
both packages' plane modules under one name, and the check that holds
the port's results to the reference's.

A scenario is a function of one namespace ``P`` (``P.tsdb``, ``P.slo``,
``P.degrade``, ...).  :func:`both` runs it once against the JAX package
and once against the port, on the same scripted registry values and the
same injected times, and asserts the two results equal.  The control
plane is host-side Python in both packages with the same float
arithmetic in the same order, so results are expected bit-equal; floats
are compared at ``REL`` = 1e-12 relative so a reordered sum could not
fail the check for that alone."""
import importlib
import math
from types import SimpleNamespace

import pytest

PKGS = ("deeplearning4j_tpu", "deeplearning4j_torch")
REL = 1e-12

_MODULES = {"telemetry": "telemetry", "registry": "telemetry.registry",
            "tsdb": "telemetry.tsdb", "slo": "telemetry.slo",
            "fleet": "telemetry.fleet", "flightrec": "telemetry.flightrec",
            "exposition": "telemetry.exposition",
            "tracing": "telemetry.tracing", "serving": "serving",
            "degrade": "serving.degrade", "autoscale": "serving.autoscale"}


def plane(pkg: str) -> SimpleNamespace:
    """One package's control-plane modules by short name."""
    if pkg == PKGS[0]:
        pytest.importorskip("jax")
    return SimpleNamespace(pkg=pkg, **{
        k: importlib.import_module(f"{pkg}.{v}")
        for k, v in _MODULES.items()})


def assert_same(a, b, path="result"):
    """``a == b`` recursively; floats within ``REL`` relative (NaN equal
    to NaN), everything else exactly."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
        elif a != b:
            assert abs(a - b) <= REL * max(abs(a), abs(b)), (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def both(scenario):
    """Run ``scenario(P)`` in the JAX package and in the port; assert the
    two results equal (:func:`assert_same`) and return the port's."""
    ref = scenario(plane(PKGS[0]))
    port = scenario(plane(PKGS[1]))
    assert_same(ref, port)
    return port


def port_only(scenario):
    """The port half of a case whose reference runs in the JAX package's
    own test of the same name."""
    return scenario(plane(PKGS[1]))

