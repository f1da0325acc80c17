"""GeneticsOptimizer — hyper-parameter search over command-line runs
(the port of ``veles_tpu/genetics/optimizer.py``).

Each individual is evaluated by running ``python -m veles_tpu_torch
<workflow> <config>`` with ``-c`` overrides for its genes and a
``--result-file`` for its fitness (:class:`SubprocessEvaluator`); the
evaluator is pluggable (a callable, or a fleet's batch evaluator).
"""

import logging

from veles_tpu_torch.cli_exec import run_cli_collect_results
from veles_tpu_torch.genetics.core import Population, collect_tuneables

log = logging.getLogger("genetics")

#: result-file keys tried, in order, for the fitness; all but the first
#: are minimized, so their fitness is ``-value``
FITNESS_KEYS = ("EvaluationFitness", "min_validation_n_err",
                "validation_error_pct", "validation_loss", "RMSE")


def fitness_from_results(results):
    """The fitness (maximized) of a results file's dict: an explicit
    ``EvaluationFitness`` wins, an error-like metric is negated."""
    if "EvaluationFitness" in results:
        return float(results["EvaluationFitness"])
    for key in FITNESS_KEYS[1:]:
        if key in results:
            return -float(results[key])
    raise KeyError(
        "no fitness key in result file (have: %s; expected one of %s)"
        % (sorted(results), list(FITNESS_KEYS)))


class SubprocessEvaluator:
    """Runs one individual through the command line in a child process
    (``timeout`` seconds at most, None: no limit); a failed run gives
    None."""

    def __init__(self, workflow_file, config_file=None, base_overrides=(),
                 extra_argv=(), timeout=None):
        self.workflow_file = workflow_file
        self.config_file = config_file
        self.base_overrides = list(base_overrides)
        self.extra_argv = list(extra_argv)
        self.timeout = timeout

    def argv(self, overrides, seed):
        """The command line's arguments for one individual."""
        argv = [self.workflow_file]
        if self.config_file:
            argv.append(self.config_file)
        for ov in self.base_overrides + list(overrides):
            argv += ["-c", ov]
        return argv + ["--seed", str(seed)] + self.extra_argv

    def __call__(self, overrides, seed):
        results = run_cli_collect_results(self.argv(overrides, seed),
                                          timeout=self.timeout)
        if results is None:
            return None
        try:
            return fitness_from_results(results)
        except KeyError as e:
            log.warning("individual produced no fitness: %s", e)
            return None


class GeneticsOptimizer:
    """The population loop.  ``evaluate(overrides, seed) -> fitness or
    None`` is pluggable (an evaluator with ``evaluate_batch`` gets each
    generation at once); a failed individual gets one below the worst
    fitness of its generation."""

    def __init__(self, config_root, evaluate, size=8, generations=4,
                 seed=42):
        self.tuneables = collect_tuneables(config_root)
        self.population = Population(self.tuneables, size=size, seed=seed)
        self.evaluate = evaluate
        self.generations = generations
        self.history = []

    def _evaluate_generation(self, gen):
        """The fitness of every unevaluated individual, seeded ``1000 +
        100·generation + index``."""
        pending = [(i, indiv) for i, indiv in
                   enumerate(self.population.individuals)
                   if indiv.fitness is None]
        if hasattr(self.evaluate, "evaluate_batch"):
            batch = [(indiv.overrides(self.tuneables),
                      1000 + gen * 100 + i) for i, indiv in pending]
            fits = self.evaluate.evaluate_batch(batch)
        else:
            fits = [self.evaluate(indiv.overrides(self.tuneables),
                                  seed=1000 + gen * 100 + i)
                    for i, indiv in pending]
        for (i, indiv), fit in zip(pending, fits):
            indiv.fitness = fit
            log.info("gen %d individual %d: fitness %s  genes %s",
                     gen, i, fit, indiv.genes)
        return [f for f in fits if f is not None]

    def run(self):
        for gen in range(self.generations):
            # elites are evaluated again each generation: a short run's
            # fitness is noisy, and a lucky seed must not stay forever
            evaluated = self._evaluate_generation(gen)
            worst = min(evaluated) if evaluated else None
            fallback = (worst if worst is not None else 0.0) - 1.0
            for indiv in self.population.individuals:
                if indiv.fitness is None:
                    indiv.fitness = fallback
            self.history.append(max(
                c.fitness for c in self.population.individuals))
            self.population.evolve()
            log.info("gen %d done: best fitness %s genes %s", gen,
                     self.population.best.fitness,
                     self.population.best.genes)
        best = self.population.best
        return {
            "best_fitness": best.fitness,
            "best_genes": {path: g for (path, _), g in
                           zip(self.tuneables, best.genes)},
            "history": self.history,
            "generations": self.generations,
        }
