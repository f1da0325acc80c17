"""The genetic algorithm's core — tuneables, chromosomes, population
(the port of ``veles_tpu/genetics/core.py``).

The markers :class:`Range` and :class:`Choice` and :func:`fix_config`
are the config tree's own (:mod:`veles_tpu_torch.config`); this module
walks the tree for them and evolves gene vectors over
``numpy.random.default_rng(seed)``, drawing from it in the reference's
order, so the same tuneables, seed and fitnesses give the reference's
generations.  The algorithm is host-side Python; a fitness comes from
running the model's workflow (:mod:`veles_tpu_torch.genetics.optimizer`).
"""

import numpy

from veles_tpu_torch.config import (  # noqa: F401
    Choice, Config, Range, Tuneable, fix_config)


def collect_tuneables(cfg, path="root"):
    """The tree's Tuneable markers as ``[(dotted path, marker)]``,
    sorted by path."""
    found = []
    for k, v in vars(cfg).items():
        if k.startswith("_") and k.endswith("_"):
            continue
        p = "%s.%s" % (path, k)
        if isinstance(v, Config):
            found.extend(collect_tuneables(v, p))
        elif isinstance(v, Tuneable):
            found.append((p, v))
    return sorted(found, key=lambda pv: pv[0])


class Chromosome:
    """One instantiation of the tuneables."""

    __slots__ = ("genes", "fitness")

    def __init__(self, genes):
        self.genes = list(genes)
        self.fitness = None

    def overrides(self, tuneables):
        """The command line's ``-c`` snippets applying these genes."""
        return ["%s = %r" % (path, g)
                for (path, _), g in zip(tuneables, self.genes)]


class Population:
    """Tournament selection, blend crossover, Gaussian mutation and
    elitism over small numeric gene vectors."""

    def __init__(self, tuneables, size=8, seed=42, mutation_scale=0.15,
                 crossover_rate=0.9, elite=1):
        if not tuneables:
            raise ValueError("no Tuneable markers found in the config")
        self.tuneables = tuneables
        self.size = size
        self.rng = numpy.random.default_rng(seed)
        self.mutation_scale = mutation_scale
        self.crossover_rate = crossover_rate
        self.elite = elite
        first = Chromosome([t.default for _, t in tuneables])
        self.individuals = [first] + [
            Chromosome([t.random(self.rng) for _, t in tuneables])
            for _ in range(size - 1)]
        self.generation = 0
        self.best = None

    def _tournament(self, k=2):
        picks = self.rng.choice(len(self.individuals), size=k,
                                replace=False)
        return max((self.individuals[i] for i in picks),
                   key=lambda c: c.fitness)

    def evolve(self):
        """One generation step; every individual must have a fitness."""
        assert all(c.fitness is not None for c in self.individuals)
        ranked = sorted(self.individuals, key=lambda c: c.fitness,
                        reverse=True)
        if self.best is None or ranked[0].fitness > self.best.fitness:
            self.best = ranked[0]
        nxt = [Chromosome(list(c.genes)) for c in ranked[:self.elite]]
        while len(nxt) < self.size:
            a, b = self._tournament(), self._tournament()
            genes = []
            for (_, t), ga, gb in zip(self.tuneables, a.genes, b.genes):
                if self.rng.random() < self.crossover_rate \
                        and isinstance(t, Range):
                    w = self.rng.random()
                    g = t.clip(w * ga + (1 - w) * gb)  # blend crossover
                else:
                    g = ga if self.rng.random() < 0.5 else gb
                if self.rng.random() < 0.3:
                    g = t.mutate(g, self.rng, self.mutation_scale)
                genes.append(g)
            nxt.append(Chromosome(genes))
        self.individuals = nxt
        self.generation += 1
