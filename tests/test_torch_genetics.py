"""The genetic optimizer of the PyTorch port (``veles_tpu_torch/
genetics``) held against the JAX package's on the CPU (the oracle is
``tests/test_genetics_ensemble.py``):

- ``Range``/``Choice`` draw, mutate and clip as the JAX markers do from
  the same generator; ``collect_tuneables`` and ``fix_config`` walk the
  port's config tree as the JAX ones walk theirs;
- the same tuneables and seed under the same injected evaluator give
  identical generations and bests in both packages' populations and
  optimizers, failed individuals included;
- ``--optimize 2:1`` runs through ``python -m veles_tpu_torch``;
- the GA fleet evaluates over the port's coordinator with two workers.

Every subprocess and wait has its own timeout."""

import json
import os
import subprocess
import sys
import threading

import numpy
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs():
    """The same tuneables in both packages' config trees."""
    from veles_tpu.config import Config as JConfig
    from veles_tpu.genetics import Choice as JChoice, Range as JRange
    from veles_tpu_torch.config import Config
    from veles_tpu_torch.genetics import Choice, Range
    out = []
    for C, R, Ch in ((JConfig, JRange, JChoice), (Config, Range, Choice)):
        cfg = C("t")
        cfg.model.lr = R(0.1, 0.001, 1.0)
        cfg.model.depth = R(3, 1, 8)
        cfg.model.solver = Ch("sgd", ["sgd", "adam", "adagrad"])
        cfg.model.name = "mlp"
        cfg.x = R(5.0, -10.0, 10.0)
        out.append(cfg)
    return out


def _quadratic(overrides, seed):
    vals = dict(s.split(" = ") for s in overrides)
    return -(float(vals["root.x"]) - 2.0) ** 2 \
        - (float(vals["root.model.lr"]) - 0.3) ** 2 \
        + (0.5 if vals["root.model.solver"] == "'adam'" else 0.0) \
        - abs(int(vals["root.model.depth"]) - 5)


def test_range_clip_and_int():
    from veles_tpu_torch.genetics import Range
    r = Range(10, 2, 20)
    assert r.clip(25) == 20 and r.clip(-1) == 2
    assert isinstance(r.clip(7.6), int)
    f = Range(0.1, 0.0, 1.0)
    assert isinstance(f.clip(0.5), float)
    rng = numpy.random.default_rng(0)
    for _ in range(20):
        assert 2 <= r.random(rng) <= 20
        assert 0.0 <= f.mutate(0.5, rng, 0.2) <= 1.0


def test_markers_draw_as_the_reference():
    """The same generator gives the same draws and mutations."""
    from veles_tpu.genetics import Choice as JChoice, Range as JRange
    from veles_tpu_torch.genetics import Choice, Range
    a, b = numpy.random.default_rng(5), numpy.random.default_rng(5)
    pairs = ((Range(10, 2, 20), JRange(10, 2, 20)),
             (Range(0.1, 0.0, 1.0), JRange(0.1, 0.0, 1.0)),
             (Choice("sgd", ["sgd", "adam"]), JChoice("sgd", ["sgd", "adam"])))
    for _ in range(30):
        for p, j in pairs:
            assert p.random(a) == j.random(b)
            assert p.mutate(p.default, a, 0.2) == j.mutate(j.default, b, 0.2)
            assert p.clip(7.6) == j.clip(7.6)
            assert repr(p) == repr(j) or isinstance(p, Choice)


def test_choice():
    from veles_tpu_torch.genetics import Choice
    c = Choice("sgd", ["sgd", "adam", "adagrad"])
    rng = numpy.random.default_rng(0)
    assert c.random(rng) in c.choices
    assert c.mutate("adam", rng, 0.0) in c.choices


def test_collect_and_fix_config():
    from veles_tpu.genetics import collect_tuneables as jax_collect
    from veles_tpu_torch.genetics import collect_tuneables, fix_config
    jcfg, cfg = _configs()
    found = collect_tuneables(cfg)
    assert [p for p, _ in found] == [p for p, _ in jax_collect(jcfg)] == [
        "root.model.depth", "root.model.lr", "root.model.solver", "root.x"]
    fix_config(cfg)
    assert cfg.model.lr == 0.1 and cfg.model.depth == 3
    assert cfg.model.solver == "sgd" and cfg.model.name == "mlp"
    assert collect_tuneables(cfg) == []


def test_population_matches_reference():
    """Generation for generation the same genes and the same best, the
    fitness of some individuals missing (``None`` → the optimizer's
    fallback is not involved: here the population alone)."""
    from veles_tpu.genetics import (
        Population as JPopulation, collect_tuneables as jax_collect)
    from veles_tpu_torch.genetics import Population, collect_tuneables
    jcfg, cfg = _configs()
    jp = JPopulation(jax_collect(jcfg), size=9, seed=3)
    pp = Population(collect_tuneables(cfg), size=9, seed=3)
    for gen in range(8):
        assert [c.genes for c in pp.individuals] == \
            [c.genes for c in jp.individuals], gen
        for pop in (jp, pp):
            for c in pop.individuals:
                c.fitness = _quadratic(c.overrides(pop.tuneables), 0)
        jp.evolve()
        pp.evolve()
        assert pp.best.genes == jp.best.genes
        assert pp.best.fitness == jp.best.fitness
        assert pp.generation == jp.generation == gen + 1


def test_population_optimizes_quadratic():
    from veles_tpu_torch.config import Config
    from veles_tpu_torch.genetics import Population, Range, collect_tuneables
    cfg = Config("t")
    cfg.x = Range(5.0, -10.0, 10.0)
    pop = Population(collect_tuneables(cfg), size=10, seed=3)
    for _ in range(12):
        for c in pop.individuals:
            if c.fitness is None:
                c.fitness = -(c.genes[0] - 2.0) ** 2
        pop.evolve()
    assert abs(pop.best.genes[0] - 2.0) < 0.5, pop.best.genes


def test_fitness_from_results_priority():
    from veles_tpu.genetics import fitness_from_results as jax_fitness
    from veles_tpu_torch.genetics import fitness_from_results
    for results in ({"EvaluationFitness": 3.5},
                    {"min_validation_n_err": 42, "validation_loss": 1.0},
                    {"validation_error_pct": 2.5, "RMSE": 0.1},
                    {"RMSE": 0.25}):
        assert fitness_from_results(results) == jax_fitness(results)
    assert fitness_from_results(
        {"min_validation_n_err": 42, "validation_loss": 1.0}) == -42.0
    with pytest.raises(KeyError):
        fitness_from_results({"unrelated": 1})


@pytest.mark.parametrize("fail_every", [0, 3])
def test_optimizer_matches_reference(fail_every):
    """Both optimizers over the same injected evaluator — every
    ``fail_every``-th evaluation failing (None) — call it with the same
    overrides and seeds and return the same outcome."""
    from veles_tpu.genetics import GeneticsOptimizer as JOptimizer
    from veles_tpu_torch.genetics import GeneticsOptimizer
    jcfg, cfg = _configs()
    outcomes, calls = [], []
    for cls, tree in ((JOptimizer, jcfg), (GeneticsOptimizer, cfg)):
        seen = []

        def evaluate(overrides, seed, seen=seen):
            seen.append((list(overrides), seed))
            if fail_every and len(seen) % fail_every == 0:
                return None
            return _quadratic(overrides, seed)
        outcomes.append(cls(tree, evaluate, size=8, generations=5,
                            seed=7).run())
        calls.append(seen)
    assert calls[1] == calls[0]
    assert outcomes[1] == outcomes[0]
    assert outcomes[1]["generations"] == 5 and len(outcomes[1]["history"]) == 5


def test_failed_individuals_get_fallback_fitness():
    from veles_tpu_torch.config import Config
    from veles_tpu_torch.genetics import GeneticsOptimizer, Range
    cfg = Config("t")
    cfg.x = Range(0.0, -1.0, 1.0)
    calls = []

    def evaluate(overrides, seed):
        calls.append(overrides)
        return None if len(calls) % 2 == 0 else 1.0

    assert GeneticsOptimizer(cfg, evaluate, size=4,
                             generations=2).run()["best_fitness"] == 1.0


def test_subprocess_evaluator_argv():
    """The command line of one individual: the workflow, the config,
    the base and the individual's ``-c`` snippets, its seed and the
    shared flags — the JAX evaluator's argv after its interpreter and
    module."""
    from veles_tpu.genetics import SubprocessEvaluator as JEval
    from veles_tpu_torch.genetics import SubprocessEvaluator
    kw = dict(base_overrides=["root.a = 1"], extra_argv=["-a", "cpu"],
              timeout=60)
    pe = SubprocessEvaluator("wf.py", "cfg.py", **kw)
    got = pe.argv(["root.x = 0.5"], 1003)
    assert got == ["wf.py", "cfg.py", "-c", "root.a = 1", "-c",
                   "root.x = 0.5", "--seed", "1003", "-a", "cpu"]
    seen = {}
    import veles_tpu.genetics.optimizer as jopt
    orig = jopt.run_cli_collect_results
    jopt.run_cli_collect_results = lambda argv, timeout=None: \
        seen.update(argv=argv, timeout=timeout)
    try:
        assert JEval("wf.py", "cfg.py", **kw)(["root.x = 0.5"], 1003) is None
    finally:
        jopt.run_cli_collect_results = orig
    assert seen["argv"][3:] == got and seen["timeout"] == pe.timeout == 60


TINY = ("root.mnist_tpu.update({'max_epochs':1,'synthetic_train':512,"
        "'synthetic_valid':128,'snapshot_time_interval':0.0,"
        "'minibatch_size':128})")


def test_cli_optimize_smoke(tmp_path):
    """``--optimize 2:1`` through ``python -m veles_tpu_torch`` on the
    CPU: each individual a child command line."""
    out = tmp_path / "opt.json"
    sample = os.path.join(REPO, "veles_tpu_torch", "samples")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch",
         os.path.join(sample, "mnist.py"),
         os.path.join(sample, "mnist_config.py"), "-a", "cpu",
         "--optimize", "2:1",
         "-c", "root.mnist_tpu.learning_rate = Range(0.02, 0.001, 0.5)",
         "-c", TINY, "--result-file", str(out)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    outcome = json.loads(out.read_text())
    assert list(outcome["best_genes"]) == ["root.mnist_tpu.learning_rate"]
    assert outcome["best_fitness"] is not None
    assert 0.001 <= outcome["best_genes"][
        "root.mnist_tpu.learning_rate"] <= 0.5


def test_genetics_fleet_two_workers():
    """The GA evaluates individuals as jobs of the port's coordinator
    across two fleet workers, converges, and the workers exit on
    terminate."""
    from veles_tpu_torch.config import Config
    from veles_tpu_torch.genetics import GeneticsOptimizer, Range
    from veles_tpu_torch.genetics.fleet import (
        CoordinatorEvaluator, serve_fleet_worker)
    cfg = Config("t")
    cfg.a = Range(0.0, -4.0, 4.0)
    cfg.b = Range(0.0, -4.0, 4.0)
    seen_by = {"w1": 0, "w2": 0}

    def make_eval(tag):
        def evaluate(overrides, seed):
            seen_by[tag] += 1
            vals = {s.split("=")[0].strip(): float(s.split("=")[1])
                    for s in overrides}
            return -(vals["root.a"] - 1) ** 2 - (vals["root.b"] + 2) ** 2
        return evaluate

    fleet = CoordinatorEvaluator(checksum="ga-test", port=0,
                                 result_timeout=120)
    addr = "127.0.0.1:%d" % fleet.port
    workers = [threading.Thread(
        target=serve_fleet_worker, args=(addr, make_eval(tag)),
        kwargs={"checksum": "ga-test", "worker_id": tag}, daemon=True)
        for tag in ("w1", "w2")]
    for w in workers:
        w.start()
    try:
        outcome = GeneticsOptimizer(cfg, fleet, size=10, generations=6,
                                    seed=7).run()
    finally:
        fleet.close()
    for w in workers:
        w.join(10)
    assert outcome["best_fitness"] > -1.0, outcome
    assert seen_by["w1"] > 0 and seen_by["w2"] > 0, seen_by
    assert not any(w.is_alive() for w in workers)
    assert not fleet._thread.is_alive()
