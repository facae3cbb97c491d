"""The PyTorch port stands alone: nothing under ``deeplearning4j_torch/``
and nothing in ``chip_smoke.py`` imports JAX or the JAX package (whose
``__init__`` imports jax), and importing the port leaves jax unloaded."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _port_files():
    return sorted((ROOT / "deeplearning4j_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    """Every module name the file imports — statements, and string
    arguments of importlib.import_module / __import__."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call):
            fn = node.func
            fname = (fn.attr if isinstance(fn, ast.Attribute)
                     else getattr(fn, "id", ""))
            if fname in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


def test_port_files_import_no_jax_or_reference_package():
    files = _port_files()
    assert len(files) > 20                  # the scan really ran
    offenders = [f"{p.relative_to(ROOT)}:{line}: {name}"
                 for p in files for line, name in _imports(p)
                 if _forbidden(name)]
    assert not offenders, offenders


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import deeplearning4j_torch.parallel.generation_server\n"
        "import deeplearning4j_torch.zoo, deeplearning4j_torch.utils\n"
        "import deeplearning4j_torch.kernels, deeplearning4j_torch.nn.conf\n"
        "import deeplearning4j_torch.kernels.flash_attention\n"
        "import deeplearning4j_torch.models.multi_layer_network\n"
        "import deeplearning4j_torch.optimize.solver\n"
        "import deeplearning4j_torch.optimize.fit_loop\n"
        "import deeplearning4j_torch.data, deeplearning4j_torch.nn.losses\n"
        "import deeplearning4j_torch.runtime.rng\n"
        "import deeplearning4j_torch.serving, deeplearning4j_torch.serving.router\n"
        "import deeplearning4j_torch.serving.placement\n"
        "import deeplearning4j_torch.serving.tenancy\n"
        "import deeplearning4j_torch.serving.errors\n"
        "import deeplearning4j_torch.parallel.kv_tiering\n"
        "import deeplearning4j_torch.resilience.faults\n"
        "import deeplearning4j_torch.resilience.retry\n"
        "import deeplearning4j_torch.telemetry.tracing\n"
        "import deeplearning4j_torch.telemetry.flightrec\n"
        "import deeplearning4j_torch.telemetry.profiling\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
