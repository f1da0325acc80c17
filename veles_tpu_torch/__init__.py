"""veles_tpu_torch — the PyTorch/CUDA port of ``veles_tpu`` for NVIDIA
Hopper (H100).

It serves the LM chain ``Embedding → TransformerBlock×N →
TokenProjection`` through a paged KV cache (fp32 or int8 pools), with
speculative decoding (n-gram drafts scored in one verify pass), a
radix prefix cache over the KV blocks and the request lifecycle
(priorities and shed, deadlines, cancel, preempt→resume, drain, a
watchdog; ``faults`` injects failures into it), reports its serving
metrics and per-request traces (``telemetry``, ``logger.events``),
streams tokens as they are accepted and runs embedding and scoring jobs
on an aux lane, serves the dense slot-major KV layout on request
(``kv="dense"``), decodes outside the scheduler (``models/generate.py``:
greedy, sampled and beam search), answers HTTP clients in front of all
of it (``restful_api.py``: ``/generate`` with SSE, the OpenAI
``/v1/*`` routes, ``/healthz`` over the training-health monitor,
``/metrics``, ``/debug/state`` over the flight recorder, ``/drain``,
``/alerts`` and ``/metrics/history`` over the alert engine and the
time-series store, tenants metered per step), fronts several such
servers with a health-aware router (``serving/router.py``: breakers,
retries, hedging, shedding, mid-stream failover, prefix shipping,
tenant admission, fleet federation and a dashboard) over a supervised
replica fleet (``serving/fleet.py``) and its control plane
(``serving/controller.py``),
trains
it (``samples/lm.py``: ``GradientDescent`` with the next-token loss over
a device-resident ``FullBatchLoader``) and trains AlexNet and VGG-A
(``samples/alexnet.py``: convolutions, LRN, pooling, dropout, FC layers
and a softmax head over a synthetic ImageNet drawn on the card, or
from image files).  Its
chains take every layer type of the reference (``models/standard.py``):
mixture-of-experts FFNs (served and trained like dense ones), recurrent
units, transposed convolutions and depooling under the MSE evaluator;
``models/kohonen.py`` and ``models/rbm.py`` train self-organizing maps
and RBMs.  Training runs through the reference's workflow runtime too
(``units``, ``workflow``, ``accelerated_units``, ``memory``,
``snapshotter``, ``models/standard.StandardWorkflow`` with
``models/decision.DecisionGD``): the samples ``mnist``, ``cifar``,
``alexnet``, ``lm``, ``transformer`` and ``kohonen`` are workflows run
by ``Workflow.run()``.  Their input pipeline is the reference's:
streaming loaders (``loader/{image, text, pickles, hdf5_loader, sound,
interactive, saver}``) whose decode the prefetch pipeline
(``loader/prefetch.py``) overlaps with the step, in-step augmentation
(``ops/augment.py``), the stand-in datasets (``datasets``) and a local
``downloader``.  Its command line (``python -m veles_tpu_torch``) runs
the reference's modes: one training run, the master and its workers,
the genetic optimizer (``genetics``), ensembles (``ensemble``,
``loader/ensemble.py``) and the composer form (``frontend``); a run
exports its chain as an inference package (``package_export``, read by
the C++ runner in ``runtime/``), publishes live plots (``plotter``,
``plotting_units``, ``graphics_server``/``graphics_client``) and its
status (``web_status``).  Its kernels are written by hand for
``sm_90a`` under ``csrc/``:

- ``ops/paged_attend.py`` — block-table paged attention with the
  int8 dequant fused, a row's blocks split over a thread-block cluster
  (replaces ``veles_tpu/ops/pallas_paged.py``);
- ``ops/gemm.py::int8_matmul`` — the weight-only int8 GEMM with the
  per-column scale fused into the store (replaces the ``col_scale``
  epilogue of ``veles_tpu/ops/gemm.py::pallas_matmul``);
- ``ops/gemm.py::pallas_matmul`` — the general tiled GEMM with a fused
  epilogue (the rest of ``veles_tpu/ops/gemm.py::pallas_matmul``);
- ``ops/flash_attention.py`` — FlashAttention-2 forward, dq and dk/dv
  kernels behind an autograd Function (replaces
  ``veles_tpu/ops/pallas_attention.py``, and serves
  ``attn_impl="flash"`` too);
- ``ops/lrn.py`` — cross-channel LRN forward and recompute backward
  behind an autograd Function (replaces ``veles_tpu/ops/lrn.py::
  lrn_pallas``);
- ``ops/random.py`` — the uniform fill, ``jax.random.uniform``'s
  Threefry stream bit for bit (replaces ``veles_tpu/ops/random.py::
  pallas_uniform``).

The package imports ``torch`` and numpy only: never ``jax``, and
nothing of ``veles_tpu``.  Entry points take ``device=`` and default
to ``"cuda"``; without a card they raise unless the caller asks for
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version (it does so only for tensors that lie on the CPU).
"""

from veles_tpu_torch import dtypes  # noqa: F401 (sets the TF32 policy)
from veles_tpu_torch.backends import resolve_device  # noqa: F401

SUBMODULES = (
    "veles_tpu_torch.__main__",
    "veles_tpu_torch.backends",
    "veles_tpu_torch.config",
    "veles_tpu_torch.import_file",
    "veles_tpu_torch.cmdline",
    "veles_tpu_torch.cli_exec",
    "veles_tpu_torch.launcher",
    "veles_tpu_torch.safe_pickle",
    "veles_tpu_torch.jax_snapshot",
    "veles_tpu_torch.package_export",
    "veles_tpu_torch.ensemble",
    "veles_tpu_torch.genetics",
    "veles_tpu_torch.genetics.core",
    "veles_tpu_torch.genetics.optimizer",
    "veles_tpu_torch.genetics.fleet",
    "veles_tpu_torch.plotter",
    "veles_tpu_torch.plotting_units",
    "veles_tpu_torch.graphics_server",
    "veles_tpu_torch.graphics_client",
    "veles_tpu_torch.web_status",
    "veles_tpu_torch.frontend",
    "veles_tpu_torch.interaction",
    "veles_tpu_torch.dtypes",
    "veles_tpu_torch.faults",
    "veles_tpu_torch.logger",
    "veles_tpu_torch.mutable",
    "veles_tpu_torch.distributable",
    "veles_tpu_torch.unit_registry",
    "veles_tpu_torch.result_provider",
    "veles_tpu_torch.units",
    "veles_tpu_torch.plumbing",
    "veles_tpu_torch.workflow",
    "veles_tpu_torch.memory",
    "veles_tpu_torch.accelerated_units",
    "veles_tpu_torch.normalization",
    "veles_tpu_torch.snapshotter",
    "veles_tpu_torch.pickle_debug",
    "veles_tpu_torch.downloader",
    "veles_tpu_torch.snd_features",
    "veles_tpu_torch.datasets",
    "veles_tpu_torch.datasets.glyphs",
    "veles_tpu_torch.datasets.scenes",
    "veles_tpu_torch.datasets.tones",
    "veles_tpu_torch.telemetry",
    "veles_tpu_torch.telemetry.registry",
    "veles_tpu_torch.telemetry.reqtrace",
    "veles_tpu_torch.telemetry.health",
    "veles_tpu_torch.telemetry.flight_recorder",
    "veles_tpu_torch.telemetry.spans",
    "veles_tpu_torch.telemetry.trace_export",
    "veles_tpu_torch.telemetry.federation",
    "veles_tpu_torch.telemetry.tsdb",
    "veles_tpu_torch.telemetry.alerts",
    "veles_tpu_torch.telemetry.dashboard",
    "veles_tpu_torch.tenant",
    "veles_tpu_torch.tenant.admission",
    "veles_tpu_torch._build",
    "veles_tpu_torch.convert",
    "veles_tpu_torch.ops",
    "veles_tpu_torch.ops.paged_attention",
    "veles_tpu_torch.ops.paged_attend",
    "veles_tpu_torch.ops.gemm",
    "veles_tpu_torch.ops.attention",
    "veles_tpu_torch.ops.flash_attention",
    "veles_tpu_torch.ops.flash",
    "veles_tpu_torch.ops.lrn",
    "veles_tpu_torch.ops.random",
    "veles_tpu_torch.ops.normalize",
    "veles_tpu_torch.ops.augment",
    "veles_tpu_torch.ops.join",
    "veles_tpu_torch.prng",
    "veles_tpu_torch.prng.threefry",
    "veles_tpu_torch.prng.random_generator",
    "veles_tpu_torch.models",
    "veles_tpu_torch.models.activations",
    "veles_tpu_torch.models.nn_units",
    "veles_tpu_torch.models.conv",
    "veles_tpu_torch.models.pooling",
    "veles_tpu_torch.models.lrn",
    "veles_tpu_torch.models.dropout",
    "veles_tpu_torch.models.all2all",
    "veles_tpu_torch.models.attention",
    "veles_tpu_torch.models.embedding",
    "veles_tpu_torch.models.moe",
    "veles_tpu_torch.models.transformer",
    "veles_tpu_torch.models.recurrent",
    "veles_tpu_torch.models.kohonen",
    "veles_tpu_torch.models.rbm",
    "veles_tpu_torch.models.standard",
    "veles_tpu_torch.models.evaluator",
    "veles_tpu_torch.models.solvers",
    "veles_tpu_torch.models.lr_adjust",
    "veles_tpu_torch.models.gd",
    "veles_tpu_torch.models.gd_mesh",
    "veles_tpu_torch.models.decision",
    "veles_tpu_torch.models.generate",
    "veles_tpu_torch.loader",
    "veles_tpu_torch.loader.base",
    "veles_tpu_torch.loader.fullbatch",
    "veles_tpu_torch.loader.prefetch",
    "veles_tpu_torch.loader.image",
    "veles_tpu_torch.loader.pickles",
    "veles_tpu_torch.loader.hdf5_loader",
    "veles_tpu_torch.loader.text",
    "veles_tpu_torch.loader.sound",
    "veles_tpu_torch.loader.interactive",
    "veles_tpu_torch.loader.saver",
    "veles_tpu_torch.loader.ensemble",
    "veles_tpu_torch.samples",
    "veles_tpu_torch.samples.lm",
    "veles_tpu_torch.samples.alexnet",
    "veles_tpu_torch.samples.mnist",
    "veles_tpu_torch.samples.cifar",
    "veles_tpu_torch.samples.transformer",
    "veles_tpu_torch.samples.kohonen",
    "veles_tpu_torch.samples.mnist_ae",
    "veles_tpu_torch.samples.mnist_forward",
    "veles_tpu_torch.samples.gtzan",
    "veles_tpu_torch.samples.serve",
    "veles_tpu_torch.samples.mnist_config",
    "veles_tpu_torch.samples.cifar_config",
    "veles_tpu_torch.samples.alexnet_config",
    "veles_tpu_torch.parallel",
    "veles_tpu_torch.parallel.mesh",
    "veles_tpu_torch.parallel.sharding",
    "veles_tpu_torch.parallel.collectives",
    "veles_tpu_torch.parallel.pipeline",
    "veles_tpu_torch.parallel.multihost",
    "veles_tpu_torch.parallel.coordinator",
    "veles_tpu_torch.serving",
    "veles_tpu_torch.serving.kv_slots",
    "veles_tpu_torch.serving.prefill",
    "veles_tpu_torch.serving.engine",
    "veles_tpu_torch.serving.prefix_cache",
    "veles_tpu_torch.serving.scheduler",
    "veles_tpu_torch.serving.spec",
    "veles_tpu_torch.serving.metrics",
    "veles_tpu_torch.serving.streams",
    "veles_tpu_torch.serving.openai_api",
    "veles_tpu_torch.serving.draft",
    "veles_tpu_torch.serving.kv_quality",
    "veles_tpu_torch.serving.kv_host",
    "veles_tpu_torch.serving.disagg",
    "veles_tpu_torch.serving.tp",
    "veles_tpu_torch.serving.fleet",
    "veles_tpu_torch.serving.router",
    "veles_tpu_torch.serving.controller",
    "veles_tpu_torch.restful_api",
)
