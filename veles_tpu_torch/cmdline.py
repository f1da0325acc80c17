"""The command line surface (the port of ``veles_tpu/cmdline.py``):
``python -m veles_tpu_torch <workflow.py> [config.py] ...``.

:func:`build_parser` takes every flag of the reference, and
:mod:`veles_tpu_torch.__main__` runs each: ``-l`` runs the master, ``-m``
a worker of a master, and ``-w`` (with ``-l``) spawns the master's
workers; ``--optimize``, ``--ensemble-train``/``--ensemble-test`` (with
``--train-ratio``) and ``--frontend`` run the fleet modes;
``--export-package``, ``-g`` and ``--web-status`` accompany a training
run.  :func:`backend_device` maps ``-a``/``-d`` onto a torch device.
"""

import argparse

def build_parser():
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch",
        description="veles_tpu_torch — the PyTorch/CUDA port of "
                    "veles_tpu: python -m veles_tpu_torch "
                    "<workflow.py> [config.py]")
    p.add_argument("workflow", nargs="?",
                   help="workflow python file (defines run(load, main))")
    p.add_argument("config", nargs="?", default=None,
                   help="config python file (mutates root.*)")
    p.add_argument("-a", "--backend", default=None,
                   help="device backend: cuda|gpu|numpy|cpu|auto (auto "
                        "and no -a: cuda, which needs a card)")
    p.add_argument("-d", "--device", type=int, default=0,
                   help="CUDA device index")
    p.add_argument("-s", "--snapshot", default=None,
                   help="resume from snapshot file")
    p.add_argument("--decision", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override a decision-unit attribute after "
                        "(re)construction — e.g. max_epochs=30 or "
                        "fail_iterations=100 to extend a RESUMED "
                        "run, whose pickled stopping state would "
                        "otherwise end it immediately (repeatable)")
    p.add_argument("-c", "--config-override", action="append", default=[],
                   metavar="SNIPPET",
                   help='python snippet, e.g. "root.x.y = 1" '
                        "(repeatable)")
    p.add_argument("--seed", default=None,
                   help="int, or file:N to read N bytes of entropy "
                        "(the reference's --random-seed)")
    p.add_argument("--result-file", default=None,
                   help="write gathered metrics JSON here")
    p.add_argument("--dump-config", action="store_true",
                   help="print the effective config and exit")
    p.add_argument("--visualize", action="store_true",
                   help="print the workflow graph DOT and exit")
    p.add_argument("-l", "--listen", default=None, metavar="ADDR",
                   help="run as coordinator, listen on host:port")
    p.add_argument("-m", "--master-address", default=None, metavar="ADDR",
                   help="run as worker of the given coordinator")
    p.add_argument("-w", "--workers", default=None, metavar="N|HOSTS",
                   help="with -l: spawn N local worker processes, or a "
                        "comma list of hosts over ssh")
    p.add_argument("-g", "--graphics", action="store_true",
                   help="publish live plot payloads over ZMQ PUB")
    p.add_argument("--web-status", default=None, metavar="URL",
                   help="POST run status to a web_status dashboard")
    p.add_argument("--optimize", default=None, metavar="SIZE[:GENS]",
                   help="genetic hyper-parameter search over the "
                        "config's Range() tuneables")
    p.add_argument("--ensemble-train", type=int, default=None,
                   metavar="N", help="train N model instances and "
                   "aggregate results")
    p.add_argument("--ensemble-test", default=None, metavar="SUMMARY",
                   help="re-run the snapshots of an ensemble summary "
                        "JSON and aggregate metrics")
    p.add_argument("--train-ratio", type=float, default=1.0,
                   help="ensemble: fraction of the train span each "
                        "instance sees")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v debug, -vv everything")
    p.add_argument("--timings", action="store_true",
                   help="per-unit run timing printout")
    p.add_argument("--frontend", action="store_true",
                   help="serve a browser form to compose the command "
                        "line, then execute the submitted run")
    p.add_argument("--frontend-port", type=int, default=8070,
                   help="frontend HTTP port")
    p.add_argument("--export-package", default=None, metavar="FILE",
                   help="after the run, export the forward chain as an "
                        "inference package")
    p.add_argument("--debug-pickle", action="store_true",
                   help="after initialize, verify the workflow pickles "
                        "and name any unpicklable attribute paths")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace (CPU and CUDA "
                        "activity) of the run into DIR as a Chrome "
                        "trace; also annotates each unit run "
                        "(default: root.common.trace.profiler_dir)")
    p.add_argument("--events-log", default=None, metavar="FILE",
                   help="record the span/event stream to a JSONL FILE "
                        "(convert for Perfetto with python -m "
                        "veles_tpu.telemetry.trace_export)")
    p.add_argument("--health-policy", default=None,
                   choices=("warn", "skip_step", "halt"),
                   help="what a NaN/Inf training step triggers: warn "
                        "(log+count), skip_step (drop the update "
                        "in-graph), halt (stop the workflow, keep the "
                        "process up); sets root.common.health.policy")
    p.add_argument("--prefetch", type=int, default=None, nargs="?",
                   const=2, metavar="DEPTH",
                   help="asynchronous input pipeline for streaming "
                        "loaders: decode/upload DEPTH minibatches "
                        "ahead of the training step (bare flag: "
                        "depth 2; 0 pins the synchronous path); sets "
                        "root.common.loader.prefetch")
    p.add_argument("--compilation-cache", default=None, metavar="DIR",
                   help="accepted for the reference's command lines; "
                        "the eager port compiles no XLA program, so "
                        "there is nothing to cache (logged); sets "
                        "root.common.trace.compilation_cache_dir")
    p.add_argument("--admin-token", default=None, metavar="TOKEN",
                   help="bearer token a NON-loopback caller must "
                        "present (Authorization: Bearer TOKEN) to hit "
                        "the REST admin endpoints /drain and "
                        "/shutdown — the remote-router rolling-"
                        "restart story; sets "
                        "root.common.api.admin_token (unset: those "
                        "endpoints stay loopback-only)")
    p.add_argument("--flightrec-dir", default=None, metavar="DIR",
                   help="write crash flight-recorder bundles "
                        "(flightrec-<pid>.json) to DIR instead of the "
                        "snapshot dir; the recorder itself installs "
                        "on every CLI run unless "
                        "root.common.flightrec.enabled is False")
    return p


def filter_argv(argv, *allowed):
    """Keep only known flags — used when re-exec'ing workers."""
    out = []
    i = 0
    while i < len(argv):
        a = argv[i]
        key = a.split("=")[0]
        if key in allowed:
            out.append(a)
            if "=" not in a and i + 1 < len(argv) \
                    and not argv[i + 1].startswith("-"):
                out.append(argv[i + 1])
                i += 1
        i += 1
    return out


#: -a spellings -> torch device type
BACKENDS = {None: "cuda", "auto": "cuda", "cuda": "cuda", "gpu": "cuda",
            "numpy": "cpu", "cpu": "cpu"}


def backend_device(backend=None, index=0):
    """The torch device ``-a backend -d index`` names: cuda/gpu/auto (and
    no ``-a``) → ``cuda`` (``cuda:<index>`` for an index above 0),
    numpy/cpu → ``cpu``.  ``tpu`` and
    other names raise ``ValueError``; a CUDA device without a card
    raises ``RuntimeError`` when it is resolved (there is no fallback to
    the CPU)."""
    kind = BACKENDS.get(backend.lower() if backend else backend)
    if kind is None:
        raise ValueError(
            "-a %s: the port runs on cuda (gpu, auto) or cpu (numpy); "
            "there is no %s backend" % (backend, backend))
    if kind == "cpu":
        return "cpu"
    # device 0 is the port's default "cuda" (device objects compare by
    # their index: "cuda" is not "cuda:0")
    return "cuda:%d" % int(index) if index else "cuda"
