"""The port's command line (``python -m veles_tpu_torch``) held against
the JAX package's (``python -m veles_tpu``) on the CPU: the cases of
``tests/test_cli.py::TestCLI``, each run by both ``Main`` classes on the
same argv (``-a numpy``, float32 compute), the results files agreeing
and the weights within 2e-5; the flags the port does not have yet
exiting non-zero and naming their ROADMAP item; the master and worker
modes (``-l``, ``-m``, ``-w``), in process and as spawned workers; ``-a``'s mapping;
``--seed``, ``--events-log`` and the other flags into ``root.common``;
``-s sqlite:``; the Kohonen sample through both command lines; and one
``python -m veles_tpu_torch`` subprocess through ``cli_exec``.

Both packages' ``Main`` seed and configure process-wide state: the
:func:`cli_env` fixture restores both config trees, every generator of
both packages, the health knobs, the flight recorders (with
``sys.excepthook`` and faulthandler), the event sinks, the working
directory and the workflow-file modules afterwards."""

import contextlib
import faulthandler
import json
import logging
import os
import sys

import numpy
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 2e-5


def jax_sample(name):
    return os.path.join(REPO, "veles_tpu", "samples", name)


def port_sample(name):
    return os.path.join(REPO, "veles_tpu_torch", "samples", name)


def _tree_state(node, out):
    from veles_tpu.config import Config as JaxConfig
    from veles_tpu_torch.config import Config
    out.append((node, dict(vars(node))))
    for v in list(vars(node).values()):
        if isinstance(v, (Config, JaxConfig)):
            _tree_state(v, out)
    return out


@contextlib.contextmanager
def restored_process_state():
    """Restore everything the two ``Main`` classes change process-wide."""
    from veles_tpu import prng as jprng
    from veles_tpu.config import root as jroot
    from veles_tpu.logger import events as jevents
    from veles_tpu.telemetry.flight_recorder import recorder as jrec
    from veles_tpu_torch import prng, telemetry
    from veles_tpu_torch.config import root
    from veles_tpu_torch.logger import events
    from veles_tpu_torch.telemetry import health
    from veles_tpu_torch.telemetry.flight_recorder import recorder
    trees = _tree_state(jroot, []) + _tree_state(root, [])
    jgens = dict(jprng.random_generator._generators)
    jstates = {k: g.state for k, g in jgens.items()}
    pgens = dict(prng.random_generator._generators)
    pstates = {k: (g._seed, g._counter, g.np.bit_generator.state)
               for k, g in pgens.items()}
    hook, fault = sys.excepthook, faulthandler.is_enabled()
    installed = {rec: rec._installed for rec in (jrec, recorder)}
    sinks = {sink: sink._file for sink in (jevents, events)}
    log_root = logging.getLogger()
    log_state = (log_root.level, list(log_root.handlers))
    modules = {m: sys.modules.get(m) for m in (
        "mnist", "mnist_ae", "lm", "alexnet", "gtzan", "serve",
        "cifar", "kohonen", "transformer")}
    cwd = os.getcwd()
    try:
        yield
    finally:
        os.chdir(cwd)
        for node, d in trees:
            vars(node).clear()
            vars(node).update(d)
        jprng.random_generator._generators.clear()
        jprng.random_generator._generators.update(jgens)
        for k, s in jstates.items():
            jgens[k].state = s
        prng.random_generator._generators.clear()
        prng.random_generator._generators.update(pgens)
        for k, (seed, counter, st) in pstates.items():
            pgens[k].seed(seed)
            pgens[k]._counter = counter
            pgens[k].np.bit_generator.state = st
        for rec, was in installed.items():
            if rec._installed and not was:
                rec.uninstall()
        sys.excepthook = hook
        if not fault and faulthandler.is_enabled():
            faulthandler.disable()
        for sink, was in sinks.items():
            if was is None:
                sink.close()
        log_root.setLevel(log_state[0])
        log_root.handlers[:] = log_state[1]
        health.configure(**health.DEFAULTS)
        telemetry.set_enabled(True)
        for m, mod in modules.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    """A scratch working directory with both snapshot directories under
    it, and every process-wide setting restored afterwards."""
    with restored_process_state():
        monkeypatch.chdir(tmp_path)
        from veles_tpu.config import root as jroot
        from veles_tpu_torch.config import root
        vars(jroot.common.dirs)["snapshots"] = str(tmp_path / "jax_snaps")
        vars(root.common.dirs)["snapshots"] = str(tmp_path / "port_snaps")
        yield tmp_path


def run_jax(argv):
    """The JAX ``Main`` on ``argv`` with its ``loader``/``trainer``
    generators seeded 42 (the port's per-unit seeds)."""
    from veles_tpu import prng
    from veles_tpu.__main__ import Main
    for g in ("loader", "trainer"):
        prng.get(g).seed(42)
    with prng.get().preserve_state():
        m = Main(list(argv))
        assert m.run() == 0
    return m


def run_port(argv):
    from veles_tpu_torch.__main__ import Main
    m = Main(list(argv))
    assert m.run() == 0
    return m


MNIST_KEYS = ("root.mnist_tpu.update({'synthetic_train': 512, "
              "'synthetic_valid': 256, 'max_epochs': 2, "
              "'minibatch_size': 64, 'layers': [32, 10], "
              "'snapshot_time_interval': 0.0})")
F32 = "root.common.precision.compute_dtype = 'float32'"
SMALL = ["-c", MNIST_KEYS, "-c", F32, "-a", "numpy"]


def mnist_argv(pkg):
    sample = jax_sample if pkg == "jax" else port_sample
    return [sample("mnist.py"), sample("mnist_config.py")]


def jax_weights(wf):
    return [{n: numpy.array(a.map_read().mem)
             for n, a in u.param_arrays().items()} for u in wf.forwards]


def port_weights(wf):
    return [{n: t.detach().cpu().numpy() for n, t in u.params.items()}
            for u in wf.forwards]


def assert_weights_close(jwf, pwf, tol=W):
    want, got = jax_weights(jwf), port_weights(pwf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for n in w:
            numpy.testing.assert_allclose(g[n], w[n], rtol=tol, atol=tol)


def assert_results_close(got, want, tol=W):
    skip = ("elapsed_sec", "Snapshot")
    assert sorted(k for k in got if k not in skip) == \
        sorted(k for k in want if k not in skip)
    for k, w in want.items():
        if k in skip:
            continue
        if isinstance(w, float):
            assert abs(got[k] - w) <= tol * max(1.0, abs(w)), (k, got[k], w)
        else:
            assert got[k] == w, (k, got[k], w)


def snap_of(pkg):
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root
    tree = jroot if pkg == "jax" else root
    return os.path.join(tree.common.dirs.get("snapshots"),
                        "mnist_current.pickle.gz")


def _dump_block(out, key):
    """The lines of ``--dump-config``'s top-level block ``key:``."""
    lines = out.splitlines()
    start = lines.index(key + ":")
    block = [lines[start]]
    for line in lines[start + 1:]:
        if not line.startswith(" "):
            break
        block.append(line)
    return block


def _dump_keys(out, key):
    """The keys one level below the top-level block ``key:``."""
    return sorted(line.split(":")[0].strip()
                  for line in _dump_block(out, key)[1:]
                  if line.startswith("  ") and not line.startswith("   "))


class TestCLI:
    def test_end_to_end_train(self, cli_env):
        jm = run_jax(mnist_argv("jax") + SMALL
                     + ["--result-file", str(cli_env / "j.json")])
        pm = run_port(mnist_argv("port") + SMALL
                      + ["--result-file", str(cli_env / "p.json")])
        want = json.loads((cli_env / "j.json").read_text())
        got = json.loads((cli_env / "p.json").read_text())
        assert got["Total epochs"] == 2
        assert "validation_error_pct" in got
        assert_results_close(got, want)
        assert_weights_close(jm.workflow, pm.workflow)
        assert os.path.exists(snap_of("port"))
        assert got["Snapshot"].endswith("mnist.pickle.gz")

    def test_resume_from_snapshot(self, cli_env):
        run_jax(mnist_argv("jax") + SMALL)
        run_port(mnist_argv("port") + SMALL)
        jm = run_jax(mnist_argv("jax") + ["-s", snap_of("jax"),
                     "--result-file", str(cli_env / "j.json")] + SMALL)
        pm = run_port(mnist_argv("port") + ["-s", snap_of("port"),
                      "--result-file", str(cli_env / "p.json")] + SMALL)
        assert pm.restored and jm.restored
        got = json.loads((cli_env / "p.json").read_text())
        assert got["Total epochs"] >= 1
        assert_results_close(
            got, json.loads((cli_env / "j.json").read_text()))
        assert_weights_close(jm.workflow, pm.workflow)

    def test_resume_extends_with_decision_override(self, cli_env):
        run_jax(mnist_argv("jax") + SMALL)
        run_port(mnist_argv("port") + SMALL)
        jm = run_jax(mnist_argv("jax") + [
            "-s", snap_of("jax"), "--decision", "max_epochs=4",
            "--result-file", str(cli_env / "j.json")] + SMALL)
        pm = run_port(mnist_argv("port") + [
            "-s", snap_of("port"), "--decision", "max_epochs=4",
            "--result-file", str(cli_env / "p.json")] + SMALL)
        assert pm.workflow.decision.max_epochs == 4
        got = json.loads((cli_env / "p.json").read_text())
        assert got["Total epochs"] == 4
        assert_results_close(
            got, json.loads((cli_env / "j.json").read_text()))
        assert_weights_close(jm.workflow, pm.workflow)
        from veles_tpu_torch.__main__ import Main
        with pytest.raises(ValueError, match="no attribute"):
            Main(mnist_argv("port") + ["-s", snap_of("port"),
                 "--decision", "nonsense=1"] + SMALL).run()
        with pytest.raises(ValueError, match="could not parse"):
            Main(mnist_argv("port") + ["-s", snap_of("port"),
                 "--decision", "max_epochs=4O"] + SMALL).run()
        m3 = run_port(mnist_argv("port") + [
            "-s", snap_of("port"), "--decision", "max_epochs=5",
            "--decision", "complete=False"] + SMALL)
        from veles_tpu_torch.mutable import Bool
        assert isinstance(m3.workflow.decision.complete, Bool)
        assert m3.workflow.loader.gate_block is \
            m3.workflow.decision.complete

    def test_visualize(self, capsys, cli_env):
        run_jax(mnist_argv("jax") + ["--visualize"] + SMALL)
        want = capsys.readouterr().out
        run_port(mnist_argv("port") + ["--visualize"] + SMALL)
        got = capsys.readouterr().out
        assert "digraph MnistWorkflow" in got and "MnistLoader" in got
        for unit in ("Repeater", "GradientDescent", "DecisionGD",
                     "SnapshotterToFile", "Start", "End"):
            assert unit in got and unit in want, unit

    def test_dump_config(self, capsys, cli_env):
        run_jax(mnist_argv("jax") + ["--dump-config"] + SMALL)
        want = capsys.readouterr().out
        run_port(mnist_argv("port") + ["--dump-config"] + SMALL)
        got = capsys.readouterr().out
        assert "mnist_tpu" in got
        # the run's own subtree is the JAX run's; the process-wide trees
        # may hold other tests' subtrees, so only it and the shape of
        # root.common are compared
        assert _dump_block(got, "mnist_tpu") == \
            _dump_block(want, "mnist_tpu")
        assert _dump_keys(got, "common") == _dump_keys(want, "common")
        assert "    kv_dtype: 'fp32'" in _dump_block(got, "common")

    def test_missing_workflow_shows_help(self, cli_env):
        from veles_tpu.__main__ import Main as JaxMain
        from veles_tpu_torch.__main__ import Main
        assert JaxMain([]).run() == Main([]).run() == 1

    def test_filter_argv(self):
        from veles_tpu.cmdline import filter_argv as jax_filter
        from veles_tpu_torch.cmdline import filter_argv
        argv = ["wf.py", "cfg.py", "-a", "numpy", "--result-file",
                "r.json", "--listen", ":5050", "-c=x"]
        for allowed in (("-a", "--listen"), ("--result-file", "-c")):
            assert filter_argv(argv, *allowed) == \
                jax_filter(argv, *allowed)
        assert filter_argv(argv, "-a", "--listen") == \
            ["-a", "numpy", "--listen", ":5050"]


# -- flags the port does not have yet ------------------------------------------

REFUSED = [
    (["--optimize", "4:2"], "item 11"),
    (["--ensemble-train", "3"], "item 11"),
    (["--ensemble-test", "summary.json"], "item 11"),
    (["--frontend"], "item 11"),
    (["-g"], "item 11"),
    (["--web-status", "http://localhost:8090"], "item 11"),
    (["--export-package", "m.tar.gz"], "item 11"),
]


@pytest.mark.parametrize("flags,item", REFUSED,
                         ids=[f[0][0] for f in REFUSED])
def test_unported_flag_exits_naming_its_item(flags, item, cli_env, capsys):
    from veles_tpu_torch.__main__ import Main
    with pytest.raises(SystemExit) as e:
        Main(mnist_argv("port") + flags + SMALL).run()
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "ROADMAP " + item in err and flags[0].lstrip("-") in err


def test_launcher_refuses_distributed_modes():
    """The launcher takes the reference's three modes and refuses what
    the reference refuses: an OS-assigned master port with spawned
    workers (they need a dialable address before it binds)."""
    from veles_tpu_torch.launcher import Launcher
    modes = {"standalone": {}, "master": {"listen": ":5050"},
             "slave": {"master_address": "h:1"}}
    for mode, kw in modes.items():
        launcher = Launcher(**kw)
        assert launcher.mode == mode
        assert (launcher.is_standalone, launcher.is_master,
                launcher.is_slave) == tuple(
                    mode == m for m in ("standalone", "master", "slave"))
    with pytest.raises(ValueError, match="-l :0"):
        Launcher(listen=":0", workers=2)._spawn_workers()


# -- the master/worker modes: -l, -m, -w -------------------------------------

def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


MNIST_RUN = dict(synthetic_train=512, synthetic_valid=256, max_epochs=2,
                 minibatch_size=64, layers=(32, 10), dtype="float32",
                 snapshotter_config={"enabled": False})
TRAIN_JOBS = 2 * 512 // 64


class _Mode:
    def __init__(self, mode):
        self.mode = mode

    def add_ref(self, unit):
        pass

    def del_ref(self, unit):
        pass


def _mnist_in_mode(mode):
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    wf = MnistWorkflow(_Mode(mode), **MNIST_RUN)
    wf.initialize(device="cpu")
    return wf


def _in_thread(fn):
    import threading
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # reported by the caller
            out["error"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    return t, out


MODES = ["-l", "-m", "-w"]


@pytest.mark.parametrize("flag", MODES)
def test_distributed_flag_runs_its_mode(flag, cli_env, capsys):
    """``-l``: the command line's master serves a worker (a port worker
    in a thread) to the end of its epochs and writes its coordinator's
    stats; ``-m``: the command line's worker takes every job of a
    master (a port coordinator in a thread) and stops at its terminate;
    ``-w`` without ``-l`` exits 2 with the reference's message."""
    import asyncio
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.parallel.coordinator import (
        Coordinator, WorkerClient)
    if flag == "-w":
        from veles_tpu.__main__ import Main as JaxMain
        for main in (Main, JaxMain):
            with pytest.raises(SystemExit) as e:
                main(mnist_argv("port") + ["-w", "2"] + SMALL).run()
            assert e.value.code == 2
            assert "-w/--workers requires -l/--listen" in \
                capsys.readouterr().err
        return
    addr = "127.0.0.1:%d" % _free_port()
    if flag == "-l":
        worker = _mnist_in_mode("slave")
        client = WorkerClient(worker, addr, reconnect_delay=0.05,
                              max_reconnects=100)
        t, out = _in_thread(lambda: asyncio.run(client.run()))
        res = cli_env / "master.json"
        try:
            m = run_port(mnist_argv("port") + SMALL + [
                "-l", addr, "--result-file", str(res)])
        finally:
            t.join(60)
            worker.stop()
        assert "error" not in out, out.get("error")
        assert m.launcher.is_master and m.workflow.is_master
        assert worker.gd.global_step == TRAIN_JOBS
        results = json.loads(res.read_text())
        assert results["Total epochs"] == 2
        assert "validation_error_pct" in results
        stats = results["Coordinator"]
        assert stats["jobs"] == stats["updates"] == (512 + 256) * 2 // 64
        assert stats["job_frame_bytes"] > 0 < stats["update_frame_bytes"]
        assert results["Workers"] == []
        return
    master = _mnist_in_mode("master")
    host, port = addr.split(":")

    async def serve():
        coord = Coordinator(master, host, int(port))
        await coord.start()
        await coord.wait_finished()
        await coord.stop()
        return coord

    t, out = _in_thread(lambda: asyncio.run(serve()))
    try:
        m = run_port(mnist_argv("port") + SMALL + ["-m", addr])
    finally:
        t.join(60)
        master.stop()
    assert "error" not in out, out.get("error")
    assert m.launcher.is_slave and m.workflow.is_slave
    assert m.workflow.gd.global_step == TRAIN_JOBS
    assert master.all_jobs_done() and master.decision._master_epoch == 2
    report = [l for l in capsys.readouterr().out.splitlines()
              if l.startswith("veles-worker-report ")]
    assert len(report) == 1
    assert json.loads(report[0].split(" ", 1)[1])["steps"] == TRAIN_JOBS


def test_master_spawns_workers_end_to_end(cli_env):
    """``-l`` + ``-w 2``: the master spawns two worker processes that
    join its coordinator and run the whole training from one command
    (``tests/test_cli.py``'s case, on the port): its results file counts
    the epoch, every job and the workers' reports."""
    import subprocess
    port = _free_port()
    out = cli_env / "dist.json"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch"] + mnist_argv("port")
        + ["-l", "127.0.0.1:%d" % port, "-w", "2",
           "-c", "root.mnist_tpu.update({'max_epochs': 1, "
           "'synthetic_train': 512, 'synthetic_valid': 128, "
           "'minibatch_size': 128, 'snapshot_time_interval': 1e9})",
           "-c", F32, "-a", "numpy", "--result-file", str(out)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    results = json.loads(out.read_text())
    assert results["Total epochs"] >= 1
    assert "validation_error_pct" in results
    workers = results["Workers"]
    assert [w["rc"] for w in workers] == [0, 0]
    # an idle worker may take the next epoch's first jobs before the
    # last update of this one lands, as in the reference: at least the
    # epoch's 4 train steps and 5 updates
    assert sum(w["steps"] for w in workers) >= 512 // 128
    assert all("lrn_fwd" in w["launches"] for w in workers)
    assert results["Coordinator"]["updates"] >= (512 + 128) // 128


def test_backend_mapping(cli_env, capsys):
    import torch
    from veles_tpu_torch.cmdline import backend_device
    assert backend_device("numpy") == backend_device("cpu") == "cpu"
    assert backend_device("cuda", 1) == backend_device("gpu", 1) \
        == "cuda:1"
    assert backend_device(None) == backend_device("auto") \
        == backend_device("cuda", 0) == "cuda"
    with pytest.raises(ValueError, match="tpu"):
        backend_device("tpu")
    from veles_tpu_torch.__main__ import Main
    with pytest.raises(SystemExit):
        Main(mnist_argv("port") + ["-a", "tpu", "-c", MNIST_KEYS]).run()
    assert "tpu" in capsys.readouterr().err
    if not torch.cuda.is_available():
        # no -a means the card: without one the run raises, and never
        # falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Main(mnist_argv("port") + ["-c", MNIST_KEYS]).run()


def test_seed_and_events_log(cli_env):
    """``--seed`` seeds the process-wide generator the first weights are
    drawn from, as the JAX ``--seed`` does (``file:`` hashes the
    bytes); ``--events-log`` records the unit spans, which both
    packages' exporters turn into the same Chrome trace."""
    entropy = cli_env / "entropy.bin"
    entropy.write_bytes(bytes(range(40)))
    for seed in ("7", "file:%s:24" % entropy):
        jm = run_jax(mnist_argv("jax") + SMALL + ["--seed", seed])
        pm = run_port(mnist_argv("port") + SMALL + ["--seed", seed])
        assert_weights_close(jm.workflow, pm.workflow)
    log = cli_env / "events.jsonl"
    pm = run_port(mnist_argv("port") + SMALL + ["--events-log", str(log)])
    from veles_tpu.telemetry import trace_export as jexp
    from veles_tpu_torch.telemetry import trace_export
    got = trace_export.spans_to_chrome(trace_export.iter_spans(str(log)))
    assert got == jexp.spans_to_chrome(jexp.iter_spans(str(log)))
    names = {e["name"] for e in got if e["ph"] == "B"}
    assert "workflow run" in names
    for unit in pm.workflow.units:
        if unit.timers["runs"]:
            assert "unit:%s" % unit.name in names, unit.name


def test_flags_reach_the_tree_and_the_switches(cli_env, caplog):
    """``--timings``, ``--health-policy``, ``--flightrec-dir``,
    ``--admin-token``, ``--prefetch``, ``--compilation-cache`` and
    ``--debug-pickle`` as the reference takes them: into ``root.common``
    and the port's process-wide switches."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.telemetry import health
    from veles_tpu_torch.telemetry.flight_recorder import recorder
    caplog.set_level(logging.INFO)
    m = run_port(mnist_argv("port") + SMALL + [
        "--timings", "--health-policy", "skip_step",
        "--flightrec-dir", str(cli_env / "fr"), "--admin-token", "tok",
        "--prefetch", "0", "--compilation-cache", str(cli_env / "cc"),
        "--debug-pickle"])
    assert root.common.timings is True and m.workflow.timings is True
    assert health.health_config()["policy"] == "skip_step"
    assert root.common.flightrec.dir == str(cli_env / "fr")
    assert recorder._dir == str(cli_env / "fr")
    assert root.common.api.admin_token == "tok"
    assert root.common.loader.prefetch.enabled is False
    assert m.workflow.loader._prefetch_depth() == 0
    assert root.common.trace.compilation_cache_dir == str(cli_env / "cc")
    text = caplog.text
    assert "nothing to cache" in text and "pickles cleanly" in text


def test_resume_from_sqlite(cli_env):
    """``-s sqlite:<db>#<table>/<prefix>`` resumes the newest snapshot
    of a ``SnapshotterToDB`` store as a file resumes; ``odbc:`` DSNs
    raise."""
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.snapshotter import SnapshotterToDB
    m = run_port(mnist_argv("port") + SMALL)
    db = str(cli_env / "snaps.db")
    unit = SnapshotterToDB(m.workflow, odbc="sqlite:" + db, table="runs",
                           prefix="mnist", compression="gz")
    unit.initialize()
    unit.export()
    m.workflow.del_ref(unit)
    step = m.workflow.gd.global_step
    # the store holds the finished run: its gate Bool is set again
    from_db = run_port(mnist_argv("port") + SMALL + [
        "-s", "sqlite:%s#runs/mnist" % db, "--decision", "max_epochs=3",
        "--decision", "complete=False",
        "--result-file", str(cli_env / "db.json")])
    assert from_db.restored
    assert json.loads((cli_env / "db.json").read_text())[
        "Total epochs"] == 3
    assert from_db.workflow.gd.global_step == step + 512 // 64
    with pytest.raises(ValueError, match="sqlite"):
        Main(mnist_argv("port") + SMALL + ["-s", "odbc:DSN=x"]).run()


def test_kohonen_through_both_command_lines(cli_env):
    """``samples/kohonen.py`` (not a StandardWorkflow) through both
    ``Main`` classes: the quantization error and the map within 2e-5
    (the JAX "kohonen" generator seeded 42, the port trainer's
    default)."""
    from veles_tpu import prng
    prng.get("kohonen").seed(42)
    argv = ["-c", "root.kohonen_tpu.update({'samples': 512, "
            "'max_epochs': 3, 'minibatch_size': 128})", "-c", F32,
            "-a", "numpy"]
    jm = run_jax([jax_sample("kohonen.py")] + argv + [
        "--result-file", str(cli_env / "j.json")])
    pm = run_port([port_sample("kohonen.py")] + argv + [
        "--result-file", str(cli_env / "p.json")])
    got = json.loads((cli_env / "p.json").read_text())
    assert got["Total epochs"] == 3
    assert_results_close(got, json.loads((cli_env / "j.json").read_text()))
    numpy.testing.assert_allclose(
        pm.workflow.trainer.weights.detach().cpu().numpy(),
        numpy.array(jm.workflow.trainer.weights.map_read().mem),
        rtol=W, atol=W)


def test_module_entry_subprocess(cli_env):
    """``python -m veles_tpu_torch`` through ``cli_exec`` (one
    subprocess): the results file of a CPU run."""
    from veles_tpu_torch.cli_exec import run_cli_collect_results
    env_path = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + env_path
                                       if env_path else "")
    try:
        res = run_cli_collect_results(
            mnist_argv("port") + SMALL + ["-c", "root.common.dirs."
                                          "snapshots = 'snaps'"],
            timeout=240)
    finally:
        if env_path:
            os.environ["PYTHONPATH"] = env_path
        else:
            os.environ.pop("PYTHONPATH")
    assert res is not None and res["Total epochs"] == 2
    assert 0.0 <= res["validation_error_pct"] <= 100.0
