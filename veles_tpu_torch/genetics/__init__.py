"""genetics — genetic hyper-parameter search (the port of
``veles_tpu/genetics/``).

``Range``/``Choice`` markers in the config tree are the search space;
individuals are evaluated by re-running the workflow's command line
(``python -m veles_tpu_torch``) with ``-c`` overrides for their genes
and reading the ``--result-file`` fitness, locally one after another
(:class:`SubprocessEvaluator`) or as jobs of the elastic coordinator
(:mod:`veles_tpu_torch.genetics.fleet`).
"""

from veles_tpu_torch.genetics.core import (  # noqa: F401
    Choice, Chromosome, Population, Range, Tuneable, collect_tuneables,
    fix_config)
from veles_tpu_torch.genetics.optimizer import (  # noqa: F401
    GeneticsOptimizer, SubprocessEvaluator, fitness_from_results)
