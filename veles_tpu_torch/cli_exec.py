"""Run the command line in a subprocess and collect its results file
(the port of ``veles_tpu/cli_exec.py``): the contract by which genetics
individuals and ensemble instances are evaluated."""

import json
import logging
import os
import subprocess
import sys
import tempfile

log = logging.getLogger("cli_exec")


def child_env():
    """The environment of a child command line: this one, with the
    package this process runs first on ``PYTHONPATH``."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (pkg_root, os.environ.get("PYTHONPATH")) if p))


def run_cli_collect_results(argv, timeout=None):
    """Run ``python -m veles_tpu_torch`` (the package this process
    runs) with the arguments ``argv + [--result-file tmp]``; return the
    parsed metrics dict, or None on any failure (logged, never
    raised)."""
    with tempfile.NamedTemporaryFile(
            mode="r", suffix=".json", delete=False) as f:
        result_file = f.name
    argv = [sys.executable, "-m", "veles_tpu_torch"] + list(argv) + [
        "--result-file", result_file]
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout, cwd=os.getcwd(),
                              env=child_env())
        if proc.returncode != 0:
            log.warning("subprocess failed (rc=%d): %s", proc.returncode,
                        proc.stderr[-500:])
            return None
        with open(result_file) as f:
            return json.load(f)
    except (subprocess.TimeoutExpired, OSError, ValueError) as e:
        log.warning("subprocess evaluation error: %s", e)
        return None
    finally:
        try:
            os.unlink(result_file)
        except OSError:
            pass
