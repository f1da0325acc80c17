"""Import rules of the PyTorch port: ``veles_tpu_torch`` and every
submodule import with ``jax`` blocked, no module imports ``veles_tpu``
(not even its jax-free parts), and entry points run on the card unless
the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy
import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "veles_tpu_torch")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_imports_with_jax_blocked():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "import veles_tpu_torch\n"
            "for m in veles_tpu_torch.SUBMODULES:\n"
            "    importlib.import_module(m)\n"
            "assert not any(n == 'veles_tpu' or n.startswith('veles_tpu.')\n"
            "               for n in sys.modules), 'veles_tpu was loaded'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


PARALLEL = ("veles_tpu_torch.parallel.mesh",
            "veles_tpu_torch.parallel.sharding",
            "veles_tpu_torch.parallel.collectives",
            "veles_tpu_torch.parallel.pipeline", "veles_tpu_torch.parallel",
            "veles_tpu_torch.models.gd_mesh", "veles_tpu_torch.serving.tp")


def test_parallel_modules_import_with_jax_blocked():
    """The modules of the in-process parallel layer import one after
    another with ``jax`` blocked, and none loads ``veles_tpu``."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "    assert not any(n == 'veles_tpu' or n.startswith(\n"
            "        'veles_tpu.') for n in sys.modules), m\n"
            "print('ok')\n" % (PARALLEL,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


#: the modules of the serving fleet and its observability
FLEET = ("veles_tpu_torch.tenant", "veles_tpu_torch.tenant.admission",
         "veles_tpu_torch.telemetry.federation",
         "veles_tpu_torch.telemetry.tsdb",
         "veles_tpu_torch.telemetry.alerts",
         "veles_tpu_torch.telemetry.dashboard",
         "veles_tpu_torch.serving.fleet", "veles_tpu_torch.serving.router",
         "veles_tpu_torch.serving.controller")


def test_fleet_modules_import_with_jax_blocked():
    """The tenant package, the store, alerts, federation and dashboard,
    and the fleet, router and controller import one after another with
    ``jax`` blocked, and none loads ``veles_tpu``."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "    assert not any(n == 'veles_tpu' or n.startswith(\n"
            "        'veles_tpu.') for n in sys.modules), m\n"
            "print('ok')\n" % (FLEET,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_submodule_list_is_complete():
    import veles_tpu_torch
    found = set()
    for path in _sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        found.add(rel[:-len(".__init__")] if rel.endswith(".__init__")
                  else rel)
    found.discard("veles_tpu_torch")
    assert found == set(veles_tpu_torch.SUBMODULES)


@pytest.mark.parametrize("banned", ["veles_tpu", "jax"])
def test_no_import_of(banned):
    """An AST scan of every module finds no import of ``banned``."""
    hits = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            hits += ["%s: %s" % (os.path.relpath(path, ROOT), n)
                     for n in names
                     if n == banned or n.startswith(banned + ".")]
    assert not hits, hits


def test_entry_points_default_to_the_card():
    """With no card and no ``device="cpu"``, the entry points raise;
    asked for the CPU they run there."""
    from veles_tpu_torch import resolve_device
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.serving import InferenceScheduler
    spec = [{"type": "embedding", "vocab": 8, "dim": 8},
            {"type": "transformer_block", "heads": 2},
            {"type": "token_logits", "vocab": 8}]
    chain = init_params(spec, 0, 16, device="cpu", dtype="float32")
    assert all(u.device.type == "cpu" for u in chain)
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(spec, 0, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceScheduler(chain)
    from veles_tpu_torch.restful_api import RESTfulAPI
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RESTfulAPI(forwards=chain)
    sch = InferenceScheduler(chain, device="cpu").start()
    try:
        out = sch.submit([1, 2, 3], 2).result(60)
    finally:
        sch.close()
    assert len(out) == 5 and out[:3] == [1, 2, 3]


@pytest.mark.parametrize("module,names", [
    ("veles_tpu_torch.serving", ("SSE_DONE", "StreamTimeoutError",
                                 "TokenStream", "sse_event", "SlotKVCache",
                                 "slot_decode_step", "openai_api",
                                 "ServingMetrics")),
    ("veles_tpu_torch.serving.openai_api", ("embed_supported", "embed_pool",
                                            "pooled_embeddings",
                                            "score_rows", "model_id",
                                            "parse_token_rows",
                                            "parse_completions",
                                            "completion_id", "text_of",
                                            "finish_reason",
                                            "completion_choice", "usage_of",
                                            "completion_reply",
                                            "completion_chunk",
                                            "models_reply",
                                            "embeddings_reply",
                                            "classify_reply")),
    ("veles_tpu_torch.models.generate", ("generate", "generate_beam",
                                         "kv_cache_eligible")),
    ("veles_tpu_torch.telemetry", ("FlightRecorder", "recorder",
                                   "HealthMonitor", "health_config",
                                   "monitor", "configure")),
    ("veles_tpu_torch.telemetry.health", ("POLICIES", "STATUS_NAMES",
                                          "HealthMonitor", "monitor",
                                          "health_config", "configure")),
    ("veles_tpu_torch.telemetry.flight_recorder", ("FlightRecorder",
                                                   "recorder", "_LogTail")),
    ("veles_tpu_torch.restful_api", ("RESTfulAPI", "_status_text")),
    ("veles_tpu_torch.telemetry", ("AlertEngine", "AlertRule",
                                   "default_rules", "firing_table",
                                   "fleet_families", "merge_scrapes",
                                   "parse_prometheus", "DEFAULT_TIERS",
                                   "TimeSeriesStore", "bundle_history",
                                   "history_query")),
    ("veles_tpu_torch.tenant", ("TenantAdmission", "resolve_tenant")),
    ("veles_tpu_torch.serving", ("Router", "Fleet", "LocalReplica",
                                 "SubprocessReplica", "free_port",
                                 "RouterMetrics")),
    ("veles_tpu_torch.serving.metrics", ("RouterMetrics",
                                         "forget_serving_replica")),
    ("veles_tpu_torch.serving", ("MedusaDraftHead", "draft_supported",
                                 "hidden_supported", "kv_quant_quality",
                                 "weight_quant_quality", "per_chip_bytes",
                                 "decode_export", "encode_export",
                                 "RoleMismatchError", "HostKVTier")),
    ("veles_tpu_torch.serving.disagg", ("WIRE_CONTENT_TYPE", "mint_handle",
                                        "encode_export", "decode_export",
                                        "encode_export_binary",
                                        "decode_export_binary",
                                        "record_nbytes", "quantize_record")),
    ("veles_tpu_torch.serving.kv_quality", ("KV_QUANT_CE_TOLERANCE",
                                            "WEIGHT_QUANT_CE_TOLERANCE",
                                            "teacher_forced_logits",
                                            "kv_quant_quality",
                                            "weight_quant_quality")),
    ("veles_tpu_torch.serving.scheduler", ("EXPORT_TTL", "EXPORT_BYTES",
                                           "RoleMismatchError")),
    ("veles_tpu_torch.models.moe", ("MoE", "moe_apply", "top_k")),
    ("veles_tpu_torch.models.transformer", ("MeanPoolSeq",)),
    ("veles_tpu_torch.models.recurrent", ("SimpleRNN", "LSTM",
                                          "LastTimestep")),
    ("veles_tpu_torch.models.conv", ("Deconv", "space_to_depth",
                                     "validate_space_to_depth")),
    ("veles_tpu_torch.models.pooling", ("Depooling",)),
    ("veles_tpu_torch.models.evaluator", ("EvaluatorMSE",)),
    ("veles_tpu_torch.models.kohonen", ("KohonenForward", "KohonenTrainer",
                                        "bmu")),
    ("veles_tpu_torch.models.rbm", ("BernoulliRBM", "cd_step")),
    ("veles_tpu_torch.samples.alexnet", ("alexnet_layers", "vgg_a_layers")),
    ("veles_tpu_torch.prng.random_generator", ("RandomGenerator",))])
def test_slice_surface_is_exported(module, names):
    """The names of the streams, aux, generate, dense, REST, drafter and
    KV-tier slices are importable where the reference exports them
    (``veles_tpu/serving/__init__.py``, ``serving/openai_api.py``,
    ``models/generate.py``, ``telemetry/__init__.py``,
    ``telemetry/health.py``, ``telemetry/flight_recorder.py``,
    ``restful_api.py``)."""
    import importlib
    mod = importlib.import_module(module)
    assert all(hasattr(mod, n) for n in names), \
        [n for n in names if not hasattr(mod, n)]


#: the modules of the layer-type slice (MoE, recurrent units, Kohonen
#: maps, RBMs) and the ones it extended
LAYER_SLICE = ("veles_tpu_torch.models.moe",
               "veles_tpu_torch.models.recurrent",
               "veles_tpu_torch.models.kohonen",
               "veles_tpu_torch.models.rbm")


@pytest.mark.parametrize("module", LAYER_SLICE)
def test_layer_slice_imports_alone_with_jax_blocked(module):
    """Each new module imports first in a fresh interpreter with ``jax``
    blocked, is listed in ``SUBMODULES``, and loads nothing of
    ``veles_tpu``; its own imports are torch, numpy, the standard
    library and the port."""
    import veles_tpu_torch
    assert module in veles_tpu_torch.SUBMODULES
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "importlib.import_module(%r)\n"
            "assert not any(n == 'veles_tpu' or n.startswith('veles_tpu.')\n"
            "               for n in sys.modules), 'veles_tpu was loaded'\n"
            "print('ok')\n" % module)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert roots <= {"numpy", "torch", "veles_tpu_torch"} \
        | set(sys.stdlib_module_names), roots


def test_layer_slice_entry_points_default_to_the_card():
    """The Kohonen trainer and the RBM take ``device=`` like every entry
    point: without a card they raise unless asked for the CPU."""
    from veles_tpu_torch.models.kohonen import KohonenTrainer
    from veles_tpu_torch.models.rbm import BernoulliRBM
    assert KohonenTrainer(4, device="cpu").weights.device.type == "cpu"
    assert BernoulliRBM(4, device="cpu").weights.device.type == "cpu"
    if torch.cuda.is_available():
        return
    for make in (lambda: KohonenTrainer(4), lambda: BernoulliRBM(4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


#: the modules of the workflow-runtime slice and the ones it extended
WORKFLOW_SLICE = ("veles_tpu_torch.mutable",
                  "veles_tpu_torch.logger",
                  "veles_tpu_torch.distributable",
                  "veles_tpu_torch.unit_registry",
                  "veles_tpu_torch.result_provider",
                  "veles_tpu_torch.units",
                  "veles_tpu_torch.plumbing",
                  "veles_tpu_torch.workflow",
                  "veles_tpu_torch.memory",
                  "veles_tpu_torch.accelerated_units",
                  "veles_tpu_torch.loader.base",
                  "veles_tpu_torch.loader.fullbatch",
                  "veles_tpu_torch.normalization",
                  "veles_tpu_torch.ops.normalize",
                  "veles_tpu_torch.models.gd",
                  "veles_tpu_torch.models.decision",
                  "veles_tpu_torch.snapshotter",
                  "veles_tpu_torch.pickle_debug",
                  "veles_tpu_torch.models.standard",
                  "veles_tpu_torch.models.kohonen",
                  "veles_tpu_torch.samples.alexnet",
                  "veles_tpu_torch.samples.lm",
                  "veles_tpu_torch.samples.mnist",
                  "veles_tpu_torch.samples.cifar",
                  "veles_tpu_torch.samples.transformer",
                  "veles_tpu_torch.samples.kohonen")


@pytest.mark.parametrize("module", WORKFLOW_SLICE)
def test_workflow_slice_imports_alone_with_jax_blocked(module):
    """Each module of the workflow slice imports first in a fresh
    interpreter with ``jax`` blocked, is listed in ``SUBMODULES``, loads
    nothing of ``veles_tpu`` and imports only torch, numpy, the standard
    library and the port."""
    test_layer_slice_imports_alone_with_jax_blocked(module)


@pytest.mark.parametrize("module,names", [
    ("veles_tpu_torch.mutable", ("Bool", "LinkableAttribute", "unshadow")),
    ("veles_tpu_torch.logger", ("Logger", "EventSink", "events")),
    ("veles_tpu_torch.distributable", ("Pickleable", "IDistributable",
                                       "Distributable",
                                       "TriviallyDistributable")),
    ("veles_tpu_torch.unit_registry", ("UnitRegistry", "MappedUnitRegistry",
                                       "RegisteredDistributable")),
    ("veles_tpu_torch.result_provider", ("IResultProvider",)),
    ("veles_tpu_torch.units", ("Unit", "MissingDemand")),
    ("veles_tpu_torch.plumbing", ("StartPoint", "EndPoint", "Repeater")),
    ("veles_tpu_torch.workflow", ("Workflow", "NoMoreJobs")),
    ("veles_tpu_torch.memory", ("Array", "Watcher", "roundup")),
    ("veles_tpu_torch.accelerated_units", ("AcceleratedUnit",
                                           "AcceleratedWorkflow",
                                           "FusedSegment",
                                           "DeviceBenchmark")),
    ("veles_tpu_torch.loader.fullbatch", ("FullBatchLoader",
                                          "FullBatchLoaderMSE")),
    ("veles_tpu_torch.normalization", ("get_normalizer", "NormalizerBase",
                                       "MeanDispNormalizer")),
    ("veles_tpu_torch.ops.normalize", ("mean_disp_normalize",
                                       "MeanDispNormalizer")),
    ("veles_tpu_torch.models.decision", ("DecisionGD", "Rollback")),
    ("veles_tpu_torch.snapshotter", ("SnapshotterBase", "SnapshotterToFile",
                                     "SnapshotterToDB", "Snapshotter")),
    ("veles_tpu_torch.pickle_debug", ("find_unpicklable",
                                      "explain_pickle_failure")),
    ("veles_tpu_torch.models.standard", ("StandardWorkflow",)),
    ("veles_tpu_torch.models.kohonen", ("KohonenDecision",)),
    ("veles_tpu_torch.convert", ("load_workflow_params",)),
    ("veles_tpu_torch.telemetry", ("enabled", "set_enabled",
                                   "next_span_id")),
    ("veles_tpu_torch.samples.alexnet", ("AlexNetWorkflow",)),
    ("veles_tpu_torch.samples.lm", ("LMWorkflow",)),
    ("veles_tpu_torch.samples.mnist", ("MnistWorkflow",)),
    ("veles_tpu_torch.samples.cifar", ("CifarWorkflow",)),
    ("veles_tpu_torch.samples.transformer", ("TransformerWorkflow",)),
    ("veles_tpu_torch.samples.kohonen", ("KohonenWorkflow",))])
def test_workflow_surface_is_exported(module, names):
    """The workflow runtime's names, where the reference exports them."""
    import importlib
    mod = importlib.import_module(module)
    assert all(hasattr(mod, n) for n in names), \
        [n for n in names if not hasattr(mod, n)]


def test_workflow_entry_points_default_to_the_card():
    """``Workflow.initialize()`` (an accelerated or a sample one), a
    loader's and an ``Array``'s upload go to ``cuda`` through
    ``resolve_device``: without a card they raise, asked for the CPU
    they run there."""
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.samples.kohonen import KohonenWorkflow
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    wf = KohonenWorkflow(samples=64, minibatch_size=32, max_epochs=1)
    wf.initialize(device="cpu")
    wf.run()
    assert wf.trainer.weights.device.type == "cpu"
    if torch.cuda.is_available():
        return
    from veles_tpu_torch.loader import FullBatchLoader
    for make in (lambda: AcceleratedWorkflow().initialize(),
                 lambda: MnistWorkflow(synthetic_train=32,
                                       synthetic_valid=32).initialize(),
                 lambda: KohonenWorkflow(samples=64).initialize(),
                 lambda: FullBatchLoader(numpy.zeros((4, 2))),
                 lambda: Array(numpy.zeros(3)).devmem):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


#: the modules of the input-pipeline slice and the ones it extended
INPUT_SLICE = ("veles_tpu_torch.prng.threefry",
               "veles_tpu_torch.prng.random_generator",
               "veles_tpu_torch.ops.augment",
               "veles_tpu_torch.ops.join",
               "veles_tpu_torch.loader",
               "veles_tpu_torch.loader.base",
               "veles_tpu_torch.loader.prefetch",
               "veles_tpu_torch.loader.image",
               "veles_tpu_torch.loader.pickles",
               "veles_tpu_torch.loader.hdf5_loader",
               "veles_tpu_torch.loader.text",
               "veles_tpu_torch.loader.sound",
               "veles_tpu_torch.loader.interactive",
               "veles_tpu_torch.loader.saver",
               "veles_tpu_torch.snd_features",
               "veles_tpu_torch.datasets",
               "veles_tpu_torch.datasets.glyphs",
               "veles_tpu_torch.datasets.scenes",
               "veles_tpu_torch.datasets.tones",
               "veles_tpu_torch.downloader",
               "veles_tpu_torch.models.gd",
               "veles_tpu_torch.samples.mnist",
               "veles_tpu_torch.samples.cifar",
               "veles_tpu_torch.samples.lm")


@pytest.mark.parametrize("module", INPUT_SLICE)
def test_input_slice_imports_alone_with_jax_blocked(module):
    """Each module of the input-pipeline slice imports first in a fresh
    interpreter with ``jax`` blocked, is listed in ``SUBMODULES``, loads
    nothing of ``veles_tpu`` and imports only torch, numpy, the standard
    library and the port; PIL, h5py and scipy are imported inside the
    functions that use them, so importing the module loads none of
    them."""
    import veles_tpu_torch
    assert module in veles_tpu_torch.SUBMODULES
    optional = ("PIL", "h5py", "scipy")
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "importlib.import_module(%r)\n"
            "assert not any(n == 'veles_tpu' or n.startswith('veles_tpu.')\n"
            "               for n in sys.modules), 'veles_tpu was loaded'\n"
            "assert not [n for n in %r if n in sys.modules]\n"
            "print('ok')\n" % (module, optional))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    path = os.path.join(ROOT, *module.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) \
        else path + ".py"
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert roots <= {"numpy", "torch", "veles_tpu_torch"} \
        | set(optional) | set(sys.stdlib_module_names), roots


@pytest.mark.parametrize("module,names", [
    ("veles_tpu_torch.prng.threefry", ("randint",)),
    ("veles_tpu_torch.ops.augment", ("image_augment", "make_augment")),
    ("veles_tpu_torch.ops.join", ("InputJoiner",)),
    ("veles_tpu_torch.loader", ("CLASS_NAME", "TEST", "VALID", "TRAIN",
                                "ILoader", "Loader", "FullBatchLoader",
                                "FullBatchLoaderMSE")),
    ("veles_tpu_torch.loader.base", ("PREFETCH_DEPTH",)),
    ("veles_tpu_torch.loader.prefetch", ("PrefetchPipeline",)),
    ("veles_tpu_torch.loader.image", (
        "IMAGE_EXTENSIONS", "ImagePipeline", "FileImageLoaderBase",
        "FileImageLoader", "FullBatchImageLoader",
        "FullBatchFileImageLoader", "FullBatchImageLoaderMSE")),
    ("veles_tpu_torch.loader.pickles", ("PicklesLoader",)),
    ("veles_tpu_torch.loader.hdf5_loader", ("FullBatchHDF5Loader",
                                            "HDF5Loader")),
    ("veles_tpu_torch.loader.text", ("BytePairVocab", "FullBatchTextLM")),
    ("veles_tpu_torch.loader.sound", ("SOUND_EXTENSIONS", "decode_sound",
                                      "SoundLoader")),
    ("veles_tpu_torch.loader.interactive", ("InteractiveLoader",)),
    ("veles_tpu_torch.loader.saver", ("MinibatchesSaver",
                                      "MinibatchesLoader")),
    ("veles_tpu_torch.snd_features", ("parse_features_xml",
                                      "FeatureExtractor",
                                      "extract_features")),
    ("veles_tpu_torch.datasets", ("render_digits", "render_scenes")),
    ("veles_tpu_torch.datasets.tones", ("GENRES", "synth_track",
                                        "default_cache_dir", "generate")),
    ("veles_tpu_torch.downloader", ("Downloader",))])
def test_input_surface_is_exported(module, names):
    """The input pipeline's names, where the reference exports them."""
    test_workflow_surface_is_exported(module, names)


#: the modules of the command-line slice
CLI_SLICE = ("veles_tpu_torch.__main__", "veles_tpu_torch.config",
             "veles_tpu_torch.import_file", "veles_tpu_torch.cmdline",
             "veles_tpu_torch.cli_exec", "veles_tpu_torch.launcher",
             "veles_tpu_torch.safe_pickle", "veles_tpu_torch.jax_snapshot",
             "veles_tpu_torch.telemetry.spans",
             "veles_tpu_torch.telemetry.trace_export",
             "veles_tpu_torch.restful_api",
             "veles_tpu_torch.samples.mnist_ae",
             "veles_tpu_torch.samples.mnist_forward",
             "veles_tpu_torch.samples.gtzan",
             "veles_tpu_torch.samples.serve",
             "veles_tpu_torch.samples.mnist_config",
             "veles_tpu_torch.samples.cifar_config",
             "veles_tpu_torch.samples.alexnet_config")


def test_cli_slice_imports_with_jax_blocked():
    """The command-line slice's modules import in one fresh interpreter
    with ``jax`` blocked and load nothing of ``veles_tpu``, nor ``PIL``,
    ``h5py`` or ``scipy``."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "assert not any(n == 'veles_tpu' or n.startswith('veles_tpu.')\n"
            "               for n in sys.modules), 'veles_tpu was loaded'\n"
            "assert not [n for n in ('PIL', 'h5py', 'scipy')\n"
            "            if n in sys.modules]\n"
            "print('ok')\n" % (CLI_SLICE,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("module", CLI_SLICE)
def test_cli_slice_imports_only_the_port(module):
    """Each module of the command-line slice is listed in
    ``SUBMODULES`` and imports only torch, numpy, the standard library
    and the port."""
    import veles_tpu_torch
    assert module in veles_tpu_torch.SUBMODULES
    path = os.path.join(ROOT, *module.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) \
        else path + ".py"
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert roots <= {"numpy", "torch", "veles_tpu_torch"} \
        | set(sys.stdlib_module_names), roots


@pytest.mark.parametrize("module,names", [
    ("veles_tpu_torch.config", ("Config", "root", "apply_config_file",
                                "apply_override", "load_site_configs",
                                "get", "Range", "Choice", "fix_config")),
    ("veles_tpu_torch.import_file", ("import_file_as_module",)),
    ("veles_tpu_torch.cmdline", ("build_parser", "filter_argv",
                                 "backend_device")),
    ("veles_tpu_torch.cli_exec", ("run_cli_collect_results",)),
    ("veles_tpu_torch.launcher", ("Launcher",)),
    ("veles_tpu_torch.__main__", ("Main", "main")),
    ("veles_tpu_torch.safe_pickle", ("RestrictedUnpickler", "safe_loads",
                                     "warn_if_public")),
    ("veles_tpu_torch.telemetry", ("span", "iter_spans", "next_span_id")),
    ("veles_tpu_torch.telemetry.spans", ("span", "iter_spans",
                                         "next_span_id")),
    ("veles_tpu_torch.telemetry.trace_export", (
        "spans_to_chrome", "export", "export_request", "main")),
    ("veles_tpu_torch.restful_api", ("RESTfulAPI", "RestfulLoader")),
    ("veles_tpu_torch.prng", ("get",)),
    ("veles_tpu_torch.samples.mnist_ae", ("MnistAEWorkflow",
                                          "MnistAELoader", "run")),
    ("veles_tpu_torch.samples.mnist_forward", ("forward_from_snapshot",
                                               "forward_from_package",
                                               "main")),
    ("veles_tpu_torch.samples.gtzan", ("GtzanWorkflow", "GtzanLoader",
                                       "FEATURES_XML", "run")),
    ("veles_tpu_torch.samples.serve", ("ServeWorkflow", "_ServingLoader",
                                       "run")),
    ("veles_tpu_torch.samples.mnist", ("run",)),
    ("veles_tpu_torch.samples.cifar", ("run",)),
    ("veles_tpu_torch.samples.alexnet", ("run",)),
    ("veles_tpu_torch.samples.lm", ("run",)),
    ("veles_tpu_torch.samples.kohonen", ("run",)),
    ("veles_tpu_torch.samples.transformer", ("run",))])
def test_cli_surface_is_exported(module, names):
    """The command line's names, where the reference exports them."""
    test_workflow_surface_is_exported(module, names)


#: item 10's cross-process half: the gang, the coordinator and the
#: modules that now drive them
GANG_SLICE = ("veles_tpu_torch.parallel.multihost",
              "veles_tpu_torch.parallel.coordinator",
              "veles_tpu_torch.parallel.collectives",
              "veles_tpu_torch.parallel.sharding",
              "veles_tpu_torch.models.gd_mesh",
              "veles_tpu_torch.launcher", "veles_tpu_torch.__main__")


def test_gang_slice_imports_with_jax_blocked():
    """The gang's and the master/worker exchange's modules import one
    after another with ``jax`` blocked, load nothing of ``veles_tpu``,
    and importing them joins no gang."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "    assert not any(n == 'veles_tpu' or n.startswith(\n"
            "        'veles_tpu.') for n in sys.modules), m\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "print('ok')\n" % (GANG_SLICE,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("module", GANG_SLICE[:2])
def test_gang_slice_imports_only_the_port(module):
    """The gang and the coordinator are listed in ``SUBMODULES`` and
    import only torch, numpy, the standard library and the port."""
    test_cli_slice_imports_only_the_port(module)


@pytest.mark.parametrize("module,names", [
    ("veles_tpu_torch.parallel.multihost", (
        "initialize", "global_mesh", "global_put", "process_allgather",
        "sync_global_devices", "exchange", "shutdown", "Gang")),
    ("veles_tpu_torch.parallel.coordinator", (
        "Coordinator", "WorkerClient", "send_frame", "recv_frame",
        "serve_master", "serve_worker", "RejectedError"))])
def test_gang_surface_is_exported(module, names):
    """The reference's names of the gang and the coordinator."""
    test_workflow_surface_is_exported(module, names)


#: item 11.2: the command line's fleet modes and the services that
#: accompany a run
CLI_MODES = ("veles_tpu_torch.package_export", "veles_tpu_torch.ensemble",
             "veles_tpu_torch.loader.ensemble", "veles_tpu_torch.genetics",
             "veles_tpu_torch.genetics.core",
             "veles_tpu_torch.genetics.optimizer",
             "veles_tpu_torch.genetics.fleet", "veles_tpu_torch.plotter",
             "veles_tpu_torch.plotting_units",
             "veles_tpu_torch.graphics_server",
             "veles_tpu_torch.graphics_client",
             "veles_tpu_torch.web_status", "veles_tpu_torch.frontend",
             "veles_tpu_torch.interaction")

#: optional third-party modules a service imports where it runs
OPTIONAL = {"veles_tpu_torch.graphics_server": {"zmq"},
            "veles_tpu_torch.graphics_client": {"zmq", "matplotlib"},
            "veles_tpu_torch.interaction": {"IPython"}}


@pytest.mark.parametrize("module", CLI_MODES)
def test_cli_modes_import_alone_with_jax_blocked(module):
    """Each module of the fleet modes imports first in a fresh
    interpreter with ``jax`` blocked, loads nothing of ``veles_tpu``,
    and neither matplotlib nor tornado."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "importlib.import_module(%r)\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in\n"
            "       ('veles_tpu', 'matplotlib', 'tornado')]\n"
            "assert not bad, bad\n"
            "print('ok')\n" % module)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("module", CLI_MODES)
def test_cli_modes_import_only_the_port(module):
    """Each is listed in ``SUBMODULES`` and imports only torch, numpy,
    the standard library and the port (and the graphics transport's
    ``zmq``, the client's matplotlib, the shell's IPython)."""
    import veles_tpu_torch
    assert module in veles_tpu_torch.SUBMODULES
    path = os.path.join(ROOT, *module.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) \
        else path + ".py"
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert roots <= {"numpy", "torch", "veles_tpu_torch"} \
        | set(sys.stdlib_module_names) | OPTIONAL.get(module, set()), roots


@pytest.mark.parametrize("module,names", [
    ("veles_tpu_torch.package_export", (
        "export_package", "load_package", "PackagedWorkflow",
        "FORMAT_VERSION", "V2_KEYS")),
    ("veles_tpu_torch.ensemble", ("EnsembleTrainer", "EnsembleTester")),
    ("veles_tpu_torch.loader.ensemble", ("EnsembleLoader",)),
    ("veles_tpu_torch.genetics", (
        "Choice", "Chromosome", "Population", "Range", "Tuneable",
        "collect_tuneables", "fix_config", "GeneticsOptimizer",
        "SubprocessEvaluator", "fitness_from_results")),
    ("veles_tpu_torch.genetics.fleet", (
        "FleetJobSource", "CoordinatorEvaluator", "serve_fleet_worker")),
    ("veles_tpu_torch.plotter", ("Plotter",)),
    ("veles_tpu_torch.plotting_units", (
        "AccumulatingPlotter", "MatrixPlotter", "ImagePlotter",
        "Histogram", "MultiHistogram", "TableMaxMin", "SlaveStats")),
    ("veles_tpu_torch.graphics_server", ("GraphicsServer", "HAS_ZMQ")),
    ("veles_tpu_torch.graphics_client", ("render_payload", "main")),
    ("veles_tpu_torch.web_status", (
        "WebStatusServer", "StatusNotifier", "render_graph_svg", "main")),
    ("veles_tpu_torch.frontend", ("Frontend", "compose_argv")),
    ("veles_tpu_torch.interaction", ("Shell",))])
def test_cli_modes_surface_is_exported(module, names):
    """The reference's names of each module of the fleet modes."""
    test_workflow_surface_is_exported(module, names)


def test_genetics_reexports_the_config_markers():
    """``Range``, ``Choice`` and ``fix_config`` are the config tree's
    own, not second copies."""
    from veles_tpu_torch import config, genetics
    assert genetics.Range is config.Range
    assert genetics.Choice is config.Choice
    assert genetics.fix_config is config.fix_config
