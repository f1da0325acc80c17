"""Import rules of the PyTorch port: ``veles_tpu_torch`` and every
submodule import with ``jax`` blocked, no module imports ``veles_tpu``
(not even its jax-free parts), and entry points run on the card unless
the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

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
                                           "RoleMismatchError"))])
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
