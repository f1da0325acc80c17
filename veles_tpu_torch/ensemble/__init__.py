"""ensemble — train and test fleets of model instances (the port of
``veles_tpu/ensemble/``).

:class:`EnsembleTrainer` runs ``size`` command lines of one workflow
(``python -m veles_tpu_torch``) one after another, seeded ``4242 + i``,
each with its own snapshot suffix and, below a ``train_ratio`` of 1, a
sub-sampled train span (``root.common.ensemble_train_ratio``), and
writes one summary JSON of every instance's ``--result-file`` metrics
and snapshot.  :class:`EnsembleTester` runs each instance's snapshot
again (``--snapshot``) and gathers its metrics.  The members run in
turn, never side by side on one card.
"""

import json
import logging
import os

from veles_tpu_torch.cli_exec import run_cli_collect_results as _run_cli

log = logging.getLogger("ensemble")

#: the first member's seed; member i is seeded SEED_BASE + i
SEED_BASE = 4242


class EnsembleTrainer:
    """Train ``size`` instances; aggregate their metrics and snapshots."""

    def __init__(self, workflow_file, config_file=None, size=4,
                 train_ratio=1.0, base_overrides=(), extra_argv=(),
                 timeout=None):
        self.workflow_file = workflow_file
        self.config_file = config_file
        self.size = size
        self.train_ratio = train_ratio
        self.base_overrides = list(base_overrides)
        self.extra_argv = list(extra_argv)
        self.timeout = timeout

    def argv(self, seed, index):
        """The command line of instance ``index``."""
        argv = [self.workflow_file]
        if self.config_file:
            argv.append(self.config_file)
        for ov in self.base_overrides:
            argv += ["-c", ov]
        # distinct snapshot files per instance
        argv += ["-c", "root.common.snapshot_suffix = 'ens%d'" % index]
        if self.train_ratio < 1.0:
            argv += ["-c", "root.common.ensemble_train_ratio = %r"
                     % self.train_ratio]
        return argv + ["--seed", str(seed)] + self.extra_argv

    def run(self, output_path=None):
        instances = []
        for i in range(self.size):
            log.info("training ensemble instance %d/%d", i + 1, self.size)
            seed = SEED_BASE + i
            results = _run_cli(self.argv(seed, i), timeout=self.timeout)
            instances.append({
                "index": i,
                "seed": seed,
                "train_ratio": self.train_ratio,
                "results": results,
                "snapshot": (results or {}).get("Snapshot"),
            })
        summary = {"size": self.size, "instances": instances,
                   "workflow_file": self.workflow_file,
                   "config_file": self.config_file,
                   "base_overrides": self.base_overrides}
        summary["succeeded"] = sum(
            1 for inst in instances if inst["results"] is not None)
        if output_path:
            with open(output_path, "w") as f:
                json.dump(summary, f, indent=2, default=str)
            log.info("ensemble summary -> %s", output_path)
        return summary


class EnsembleTester:
    """Run every saved instance snapshot of a summary again and gather
    its metrics."""

    def __init__(self, summary_path, extra_argv=(), timeout=None):
        self.summary_path = summary_path
        self.extra_argv = list(extra_argv)
        self.timeout = timeout

    def run(self, output_path=None):
        with open(self.summary_path) as f:
            summary = json.load(f)
        tests = []
        for inst in summary.get("instances", []):
            snap = inst.get("snapshot")
            if not snap or not os.path.isfile(snap):
                tests.append({"index": inst.get("index"),
                              "error": "snapshot missing"})
                continue
            argv = [summary["workflow_file"]]
            if summary.get("config_file"):
                argv.append(summary["config_file"])
            for ov in summary.get("base_overrides", []):
                argv += ["-c", ov]
            argv += ["--snapshot", snap] + self.extra_argv
            results = _run_cli(argv, timeout=self.timeout)
            tests.append({"index": inst.get("index"), "results": results})
        out = {"summary": self.summary_path, "tests": tests}
        if output_path:
            with open(output_path, "w") as f:
                json.dump(out, f, indent=2, default=str)
        return out
