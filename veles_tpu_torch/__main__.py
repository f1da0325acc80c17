"""The command line: ``python -m veles_tpu_torch <workflow.py>
[config.py]`` (the port of ``veles_tpu/__main__.py``, standalone).

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
snippets, then the flags.  The flags of the fleet and the
master/worker modes raise and name the ROADMAP item that brings them
(:func:`veles_tpu_torch.cmdline.refuse_unported`).
"""

import ast
import logging
import sys

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.cmdline import (
    backend_device, build_parser, refuse_unported)
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
    knobs = root.common.health.__content__()
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
        refuse_unported(parser, self.args)
        try:
            backend_device(self.args.backend, self.args.device)
        except ValueError as e:
            parser.error(str(e))
        setup_logging((logging.WARNING, logging.INFO,
                       logging.DEBUG)[min(self.args.verbose + 1, 2)])
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
        if not self.args.workflow:
            parser.print_help()
            return 1
        # un-tuned Range()/Choice() markers take their defaults, so a
        # config written for --optimize runs standalone
        fix_config(root)
        self._seed_random()
        self.launcher = Launcher(
            backend=self.args.backend, device_index=self.args.device,
            profile_dir=self.args.profile)
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
