"""The PyTorch port stands alone: nothing under ``deeplearning4j_torch/``
and nothing in ``chip_smoke.py`` or the port's chip scripts imports JAX or the JAX package (whose
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
        ROOT / "chip_smoke.py"] + [
        # the port's chip scripts
        ROOT / "scripts" / n for n in ("flash_turns.py", "paged_turns.py",
                                       "slo_stress.py")]


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
        "from deeplearning4j_torch.zoo import Bert\n"
        "import deeplearning4j_torch.zoo.bert\n"
        "import deeplearning4j_torch.nlp, deeplearning4j_torch.nlp.wordpiece\n"
        "import deeplearning4j_torch.nlp.tokenizer\n"
        "import deeplearning4j_torch.data.bert_iterator\n"
        "import deeplearning4j_torch.data.tiny_sentiment\n"
        "import deeplearning4j_torch.data.dataset\n"
        "import deeplearning4j_torch.eval, deeplearning4j_torch.eval.roc\n"
        "import deeplearning4j_torch.eval.classification\n"
        "import deeplearning4j_torch.eval.regression\n"
        "import deeplearning4j_torch.eval.calibration\n"
        "import deeplearning4j_torch.nn.conf.layers_conv\n"
        "import deeplearning4j_torch.nn.conf.layers_core\n"
        "import deeplearning4j_torch.nn.conf.inputs\n"
        "import deeplearning4j_torch.utils.convert\n"
        "import deeplearning4j_torch.models.computation_graph\n"
        "import deeplearning4j_torch.nn.conf.graph_vertices\n"
        "import deeplearning4j_torch.zoo.resnet\n"
        "import deeplearning4j_torch.zoo.lenet\n"
        "import deeplearning4j_torch.zoo.simple_cnn\n"
        "import deeplearning4j_torch.data.mnist\n"
        "import deeplearning4j_torch.data.builtin\n"
        "import deeplearning4j_torch.data.normalization\n"
        "import deeplearning4j_torch.telemetry.registry\n"
        "import deeplearning4j_torch.telemetry.tsdb\n"
        "import deeplearning4j_torch.telemetry.slo\n"
        "import deeplearning4j_torch.telemetry.exposition\n"
        "import deeplearning4j_torch.telemetry.fleet\n"
        "import deeplearning4j_torch.telemetry.listener\n"
        "import deeplearning4j_torch.serving.degrade\n"
        "import deeplearning4j_torch.serving.autoscale\n"
        "import deeplearning4j_torch.analysis\n"
        "import deeplearning4j_torch.analysis.sanitize\n"
        "import deeplearning4j_torch.models.generation\n"
        "from deeplearning4j_torch.telemetry import get_tsdb\n"
        "import deeplearning4j_torch.resilience\n"
        "import deeplearning4j_torch.resilience.preemption\n"
        "import deeplearning4j_torch.resilience.policy\n"
        "import deeplearning4j_torch.parallel.checkpoint\n"
        "import deeplearning4j_torch.optimize\n"
        "import deeplearning4j_torch.optimize.updaters\n"
        "import deeplearning4j_torch.optimize.listeners\n"
        "import deeplearning4j_torch.utils.gradient_check\n"
        "import deeplearning4j_torch.data.iterator\n"
        "import deeplearning4j_torch.nn.conf.layers_recurrent\n"
        "import deeplearning4j_torch.data.char_iterator\n"
        "import deeplearning4j_torch.zoo.text_generation_lstm\n"
        "from deeplearning4j_torch.zoo import TextGenerationLSTM\n"
        "from deeplearning4j_torch.data import CharacterIterator\n"
        "from deeplearning4j_torch.nn.conf import GravesLSTM, Bidirectional\n"
        "import deeplearning4j_torch.models.network\n"
        "import deeplearning4j_torch.nn.conf.layers_misc\n"
        "import deeplearning4j_torch.nn.conf.layers_objdetect\n"
        "import deeplearning4j_torch.zoo.alexnet\n"
        "import deeplearning4j_torch.zoo.vgg\n"
        "import deeplearning4j_torch.zoo.darknet\n"
        "import deeplearning4j_torch.zoo.squeezenet\n"
        "import deeplearning4j_torch.zoo.unet\n"
        "import deeplearning4j_torch.zoo.xception\n"
        "import deeplearning4j_torch.zoo.inception\n"
        "import deeplearning4j_torch.zoo.facenet\n"
        "import deeplearning4j_torch.zoo.nasnet\n"
        "import deeplearning4j_torch.zoo.pretrained\n"
        "import deeplearning4j_torch.models.transfer_learning\n"
        "import deeplearning4j_torch.parallel.inference\n"
        "import deeplearning4j_torch.runtime.quantization\n"
        "from deeplearning4j_torch.parallel import ParallelInference\n"
        "from deeplearning4j_torch.runtime import QuantizedInference\n"
        "from deeplearning4j_torch.zoo import VGG16, YOLO2, load_pretrained\n"
        "import deeplearning4j_torch.datavec\n"
        "import deeplearning4j_torch.datavec.schema\n"
        "import deeplearning4j_torch.datavec.records\n"
        "import deeplearning4j_torch.datavec.transform\n"
        "import deeplearning4j_torch.datavec.iterator\n"
        "import deeplearning4j_torch.datavec.image\n"
        "import deeplearning4j_torch.autodiff\n"
        "import deeplearning4j_torch.autodiff.ops\n"
        "import deeplearning4j_torch.autodiff.samediff\n"
        "import deeplearning4j_torch.autodiff.rewrites\n"
        "import deeplearning4j_torch.autodiff.onnx_serde\n"
        "import deeplearning4j_torch.autodiff.onnx_import\n"
        "import deeplearning4j_torch.autodiff.tf_serde\n"
        "import deeplearning4j_torch.autodiff.tf_import\n"
        "import deeplearning4j_torch.utils.bert_fixture\n"
        "from deeplearning4j_torch.utils import samediff_from_dict\n"
        "import deeplearning4j_torch.parallel.mesh\n"
        "import deeplearning4j_torch.parallel.distributed\n"
        "import deeplearning4j_torch.parallel.trainer\n"
        "import deeplearning4j_torch.parallel.pipeline\n"
        "import deeplearning4j_torch.parallel.elastic\n"
        "import deeplearning4j_torch.parallel.ring_attention\n"
        "import deeplearning4j_torch.parallel.scaling\n"
        "import deeplearning4j_torch.resilience.coordination\n"
        "import deeplearning4j_torch.runtime.spmd\n"
        "from deeplearning4j_torch.parallel import (MeshConfig, \n"
        "    ShardedTrainer, ring_attention, ring_self_attention, \n"
        "    gpipe_apply, stack_block_params, PipelinedTransformerLM)\n"
        "from deeplearning4j_torch.resilience import fleet_resume_fit\n"
        "import deeplearning4j_torch.keras_import\n"
        "import deeplearning4j_torch.keras_import.keras_import\n"
        "from deeplearning4j_torch.keras_import import KerasModelImport\n"
        "import deeplearning4j_torch.nlp.word2vec\n"
        "import deeplearning4j_torch.nlp.fasttext\n"
        "import deeplearning4j_torch.nlp.serializer\n"
        "from deeplearning4j_torch.nlp import (Word2Vec, ParagraphVectors,\n"
        "    FastText, WordVectorSerializer)\n"
        "import deeplearning4j_torch.rl, deeplearning4j_torch.rl.mdp\n"
        "import deeplearning4j_torch.rl.dqn, deeplearning4j_torch.rl.a3c\n"
        "import deeplearning4j_torch.arbiter\n"
        "import deeplearning4j_torch.arbiter.space\n"
        "import deeplearning4j_torch.arbiter.runner\n"
        "import deeplearning4j_torch.ui, deeplearning4j_torch.ui.stats\n"
        "import deeplearning4j_torch.ui.report\n"
        "import deeplearning4j_torch.native_io\n"
        "import deeplearning4j_torch.native_io.binding\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu', 'tensorflow', 'cv2', "
        "'h5py', 'keras')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# TensorFlow only inside the functions that need it by nature
TF_ALLOWED = {("deeplearning4j_torch/autodiff/tf_import.py",
               "import_saved_model"),
              ("deeplearning4j_torch/autodiff/tf_import.py",
               "freeze_keras_model")}


def test_graph_import_modules_import_no_tensorflow_at_import_time():
    """``tf_serde``, ``tf_import``, ``onnx_*``, ``samediff``, ``ops`` and
    ``rewrites`` need neither JAX nor TensorFlow: TensorFlow appears only
    inside ``import_saved_model`` and ``freeze_keras_model`` (and
    ``ensure_bert_base_fixture``'s generator runs in a subprocess)."""
    offenders = []
    for path in sorted((ROOT / "deeplearning4j_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        rel = str(path.relative_to(ROOT))
        tree = ast.parse(path.read_text(), rel)
        for fn in ast.walk(tree):
            body = fn.body if isinstance(fn, ast.Module) else None
            if not isinstance(fn, (ast.FunctionDef, ast.Module)):
                continue
            for node in ast.walk(fn) if body is None else body:
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                if any(n.split(".")[0] == "tensorflow" for n in names):
                    where = None if body is not None else fn.name
                    if (rel, where) not in TF_ALLOWED:
                        offenders.append(f"{rel}:{node.lineno} in {where}")
    assert not offenders, offenders


def test_keras_import_reads_h5py_only_inside_its_readers():
    """h5py (absent from the card's machine) is imported only inside the
    Keras importer's two readers, never at a module's top level; the
    config-and-weights entry points run without it."""
    allowed = {("deeplearning4j_torch/keras_import/keras_import.py",
                "import_keras_model_and_weights"),
               ("deeplearning4j_torch/keras_import/keras_import.py",
                "_read_weights")}
    found = set()
    for path in sorted((ROOT / "deeplearning4j_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        rel = str(path.relative_to(ROOT))
        tree = ast.parse(path.read_text(), rel)
        parents = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            if any(n.split(".")[0] == "h5py" for n in names):
                fn = parents.get(node)
                while fn is not None and not isinstance(fn, ast.FunctionDef):
                    fn = parents.get(fn)
                found.add((rel, None if fn is None else fn.name))
    assert found == allowed, found
