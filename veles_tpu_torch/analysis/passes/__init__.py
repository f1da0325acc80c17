"""The veles-lint passes.  Adding a pass: subclass
:class:`veles_tpu_torch.analysis.core.Pass`, give every code a ``CODES``
entry, and append an instance to :data:`ALL_PASSES` — the runner,
docs and ``--list-codes`` pick it up from there."""

from veles_tpu_torch.analysis.passes.config_keys import ConfigKeysPass
from veles_tpu_torch.analysis.passes.donation import DonationPass
from veles_tpu_torch.analysis.passes.fault_points import FaultPointsPass
from veles_tpu_torch.analysis.passes.locks import LocksPass
from veles_tpu_torch.analysis.passes.metrics_hygiene import \
    MetricsHygienePass
from veles_tpu_torch.analysis.passes.purity import PurityPass

ALL_PASSES = (DonationPass(), PurityPass(), LocksPass(),
              ConfigKeysPass(), MetricsHygienePass(),
              FaultPointsPass())

ALL_CODES = {}
for _p in ALL_PASSES:
    ALL_CODES.update(_p.CODES)
