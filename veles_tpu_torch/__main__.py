"""The command line: ``python -m veles_tpu_torch <workflow.py>
[config.py]`` (the port of ``veles_tpu/__main__.py``).

The workflow file implements the reference's ``run(load, main)``
contract::

    def run(load, main):
        load(MnistWorkflow, layers=[100, 10])   # construct or resume
        main()                                   # initialize + run

``load`` returns ``(workflow, restored_from_snapshot)``: with ``-s`` it
resumes the snapshot (the port's own, or one the JAX package wrote)
instead of constructing.  ``main`` initializes the launcher-owned
workflow on its device and runs it to completion.

The run's settings go through the config tree
(:mod:`veles_tpu_torch.config`): the config file, then the ``-c``
snippets, then the flags.  ``-l host:port`` runs the master of the
master/worker exchange, ``-m host:port`` a worker of one, and ``-w N``
(or ``-w host[/D],...``, with ``-l``) spawns the master's workers, each
running this command line's workflow, config, ``-c`` snippets and
shared flags (:meth:`Main._worker_tail`) with ``-d D -m host:port``.

The fleet modes run instead of one training run: ``--optimize
SIZE[:GENERATIONS]`` searches the config's ``Range``/``Choice``
tuneables with the genetic optimizer (:mod:`veles_tpu_torch.genetics`),
``--ensemble-train N`` (with ``--train-ratio``) trains N instances and
``--ensemble-test SUMMARY`` runs their snapshots again
(:mod:`veles_tpu_torch.ensemble`) — each individual or instance a child
command line run one after another, given ``-a``, ``-d``,
``--decision`` and ``-v`` (:meth:`Main._child_argv`); the results file
gets the outcome or the summary.  ``--frontend`` serves a form that
composes the command line and runs it (before any config is applied).
After a training run, ``--export-package FILE`` writes its forward chain
as an inference package (:mod:`veles_tpu_torch.package_export`); ``-g``
publishes the live plots and ``--web-status URL`` POSTs the run's status
(:class:`~veles_tpu_torch.launcher.Launcher`).
"""

import ast
import json
import logging
import sys

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.cmdline import backend_device, build_parser, filter_argv
from veles_tpu_torch.config import (
    apply_config_file, apply_override, fix_config, load_site_configs, root)
from veles_tpu_torch.import_file import import_file_as_module
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.logger import setup_logging
from veles_tpu_torch.snapshotter import SnapshotterToDB, SnapshotterToFile

log = logging.getLogger("Main")


def apply_common():
    """Hand ``root.common``'s health and telemetry knobs to the port's
    process-wide switches (the reference's units read the tree)."""
    from veles_tpu_torch import telemetry
    from veles_tpu_torch.telemetry import health
    knobs = root.common.get_dict("health", {})
    health.configure(**{k: v for k, v in knobs.items()
                        if k in health.DEFAULTS})
    telemetry.set_enabled(root.common.telemetry.get("enabled", True))


class Main:
    """A command-line run; :meth:`run` returns its exit code."""

    def __init__(self, argv=None):
        self.argv = list(sys.argv[1:] if argv is None else argv)
        self.args = None
        self.launcher = None
        self.workflow = None
        self.restored = False

    # -- seeding --------------------------------------------------------------

    def _seed_random(self):
        """Seed the process-wide generator ``prng.get()``: 42 without
        ``--seed``, an int, or ``file:<path>[:n]`` — the first n bytes
        (16 by default) of a file, hashed."""
        seed = self.args.seed
        if seed is None:
            prng.get().seed(42)
            return
        if seed.startswith("file:"):
            path, _, nbytes = seed[5:].partition(":")
            with open(path, "rb") as f:
                data = f.read(int(nbytes) if nbytes else 16)
            prng.get().seed(numpy.frombuffer(data, numpy.uint8))
        else:
            prng.get().seed(int(seed))

    # -- the load/main contract -----------------------------------------------

    def _load(self, workflow_class, **kwargs):
        if self.args.snapshot:
            snap = self.args.snapshot
            if snap.startswith(("sqlite:", "odbc:")):
                # "#table/prefix" selects the store; an odbc: DSN raises
                # in SnapshotterToDB, as it does for a snapshotter
                dsn, _, frag = snap.partition("#")
                table, _, prefix = frag.partition("/")
                self.workflow = SnapshotterToDB.import_db(
                    dsn, table=table or "veles", prefix=prefix or None)
            else:
                self.workflow = SnapshotterToFile.import_file(snap)
            self.workflow.workflow = self.launcher
            self.restored = True
            log.info("resumed %s from %s", type(self.workflow).__name__,
                     snap)
        else:
            self.workflow = workflow_class(self.launcher, **kwargs)
        return self.workflow, self.restored

    def _apply_decision_overrides(self):
        """``--decision KEY=VALUE``: set an attribute of the decision
        unit — the way to extend a resumed run, whose decision carries
        its pickled stopping state."""
        if not self.args.decision:
            return
        dec = getattr(self.workflow, "decision", None)
        if dec is None:
            raise ValueError(
                "--decision: workflow %s has no decision unit"
                % type(self.workflow).__name__)
        from veles_tpu_torch.mutable import Bool
        for kv in self.args.decision:
            key, sep, val = kv.partition("=")
            if not sep or not hasattr(dec, key):
                raise ValueError(
                    "--decision %r: %s has no attribute %r"
                    % (kv, type(dec).__name__, key))
            try:
                parsed = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                parsed = val
            current = getattr(dec, key)
            if isinstance(parsed, str) and not isinstance(current, str):
                raise ValueError(
                    "--decision %r: could not parse %r (current "
                    "value is %r)" % (kv, val, current))
            if isinstance(current, Bool):
                # gate expressions reference the shared Bool: set it,
                # never replace it
                current.set(bool(parsed))
            else:
                try:
                    setattr(dec, key, parsed)
                except AttributeError:
                    raise ValueError(
                        "--decision %r: %s.%s is read-only"
                        % (kv, type(dec).__name__, key))
            log.info("decision.%s = %r", key, parsed)

    def _main(self, **kwargs):
        self._apply_decision_overrides()
        self.launcher.initialize(**kwargs)
        if self.args.debug_pickle:
            from veles_tpu_torch.pickle_debug import (
                _try_pickle, explain_pickle_failure)
            if _try_pickle(self.workflow) is None:
                log.info("workflow pickles cleanly")
            else:
                log.error("%s", explain_pickle_failure(self.workflow))
        self.launcher.run()
        if self.args.result_file:
            self.launcher.write_results(self.args.result_file)
        if self.args.export_package:
            self.workflow.package_export(self.args.export_package)
            log.info("package -> %s", self.args.export_package)

    # -- the fleet modes --------------------------------------------------------

    def _child_argv(self):
        """The flags an optimizer individual or an ensemble instance
        runs with: ``-a``, ``-d``, ``--decision`` and ``-v``."""
        argv = []
        if self.args.backend:
            argv += ["-a", self.args.backend]
        if self.args.device:
            argv += ["-d", str(self.args.device)]
        for kv in self.args.decision:
            argv += ["--decision", kv]
        return argv + ["-v"] * self.args.verbose

    def _write_json(self, data):
        if self.args.result_file:
            with open(self.args.result_file, "w") as f:
                json.dump(data, f, indent=2, default=str)

    def _run_optimize(self):
        from veles_tpu_torch.genetics import (
            GeneticsOptimizer, SubprocessEvaluator)
        size, _, gens = self.args.optimize.partition(":")
        evaluator = SubprocessEvaluator(
            self.args.workflow, self.args.config,
            base_overrides=self.args.config_override,
            extra_argv=self._child_argv())
        opt = GeneticsOptimizer(
            root, evaluator, size=int(size),
            generations=int(gens) if gens else 4)
        outcome = opt.run()
        log.info("optimization done: best fitness %s with %s",
                 outcome["best_fitness"], outcome["best_genes"])
        self._write_json(outcome)
        return 0

    def _run_ensemble_train(self):
        from veles_tpu_torch.ensemble import EnsembleTrainer
        trainer = EnsembleTrainer(
            self.args.workflow, self.args.config,
            size=self.args.ensemble_train,
            train_ratio=self.args.train_ratio,
            base_overrides=self.args.config_override,
            extra_argv=self._child_argv())
        summary = trainer.run(output_path=self.args.result_file)
        return 0 if summary["succeeded"] == summary["size"] else 1

    def _run_ensemble_test(self):
        from veles_tpu_torch.ensemble import EnsembleTester
        tester = EnsembleTester(self.args.ensemble_test,
                                extra_argv=self._child_argv())
        out = tester.run(output_path=self.args.result_file)
        ok = all("error" not in t and t.get("results") is not None
                 for t in out["tests"])
        return 0 if ok else 1

    def _run_frontend(self, parser):
        """Serve the composer form, wait for one submission and run it
        in this process."""
        from veles_tpu_torch.frontend import Frontend
        frontend = Frontend(parser, port=self.args.frontend_port)
        try:
            argv = frontend.wait()
        finally:
            frontend.stop()
        if not argv:
            return 1
        log.info("frontend composed: %s", " ".join(argv))
        return Main(argv).run()

    # -- run ------------------------------------------------------------------

    def _apply_flags(self):
        a = self.args
        if a.timings:
            root.common.timings = True
        if a.config:
            apply_config_file(a.config)
        for snippet in a.config_override:
            apply_override(snippet)
        if a.health_policy:
            root.common.health.policy = a.health_policy
        if a.flightrec_dir:
            root.common.flightrec.dir = a.flightrec_dir
        if a.admin_token:
            root.common.api.admin_token = a.admin_token
        if a.prefetch is not None:
            root.common.loader.prefetch.enabled = a.prefetch > 0
            root.common.loader.prefetch.depth = a.prefetch
        if a.compilation_cache:
            root.common.trace.compilation_cache_dir = a.compilation_cache
        if root.common.trace.get("compilation_cache_dir"):
            log.info("compilation cache %s: the port runs eagerly and "
                     "compiles no XLA program, so there is nothing to "
                     "cache", root.common.trace.compilation_cache_dir)

    def run(self):
        parser = build_parser()
        self.args = parser.parse_args(self.argv)
        try:
            backend_device(self.args.backend, self.args.device)
        except ValueError as e:
            parser.error(str(e))
        setup_logging((logging.WARNING, logging.INFO,
                       logging.DEBUG)[min(self.args.verbose + 1, 2)])
        if self.args.frontend:
            # the composed run owns the config tree, not this argv
            return self._run_frontend(parser)
        if self.args.export_package and (
                self.args.optimize or self.args.ensemble_train
                or self.args.ensemble_test):
            parser.error("--export-package applies to a single training "
                         "run, not the optimize/ensemble fleet modes")
        load_site_configs()
        from veles_tpu_torch.logger import events
        opened = False
        if self.args.events_log:
            events.open(self.args.events_log)
            opened = True
        try:
            return self._run(parser)
        finally:
            if opened:
                events.close()

    #: flags a spawned worker shares with its master
    CHILD_FLAGS = ("-a", "--backend", "--decision", "--seed",
                   "--health-policy")

    def _worker_tail(self):
        """The command tail a spawned worker runs: the workflow file,
        the config file, every ``-c`` snippet and the shared flags
        (:data:`CHILD_FLAGS`, ``-v``); the spawner appends ``-d`` and
        ``-m``."""
        tail = [self.args.workflow]
        if self.args.config:
            tail.append(self.args.config)
        for snippet in self.args.config_override:
            tail += ["-c", snippet]
        tail += filter_argv(self.argv, *self.CHILD_FLAGS)
        return tail + ["-v"] * self.args.verbose

    def _run(self, parser):
        self._apply_flags()
        if self.args.dump_config:
            root.print_()
            return 0
        apply_common()
        if root.common.flightrec.get("enabled", True):
            from veles_tpu_torch.telemetry.flight_recorder import recorder
            recorder.install(directory=root.common.flightrec.get("dir")
                             or root.common.dirs.get("snapshots"))
        if self.args.ensemble_test:
            return self._run_ensemble_test()
        if not self.args.workflow:
            parser.print_help()
            return 1
        if self.args.optimize:
            return self._run_optimize()
        if self.args.ensemble_train:
            return self._run_ensemble_train()
        # un-tuned Range()/Choice() markers take their defaults, so a
        # config written for --optimize runs standalone
        fix_config(root)
        self._seed_random()
        workers = self.args.workers
        if workers and not self.args.listen:
            parser.error("-w/--workers requires -l/--listen "
                         "(the coordinator spawns the workers)")
        if workers and workers.isdigit():
            workers = int(workers)
        self.launcher = Launcher(
            backend=self.args.backend, device_index=self.args.device,
            listen=self.args.listen,
            master_address=self.args.master_address,
            graphics=self.args.graphics or None,
            status_url=self.args.web_status,
            profile_dir=self.args.profile
            or root.common.trace.get("profiler_dir"), workers=workers,
            worker_cmd_tail=self._worker_tail())
        module = import_file_as_module(self.args.workflow)
        if not hasattr(module, "run"):
            print("workflow file must define run(load, main)",
                  file=sys.stderr)
            return 1
        if self.args.visualize:
            module.run(self._load, lambda **kw: None)
            print(self.workflow.generate_graph())
            return 0
        module.run(self._load, self._main)
        return 0


def main(argv=None):
    return Main(argv).run()


if __name__ == "__main__":
    sys.exit(main())
