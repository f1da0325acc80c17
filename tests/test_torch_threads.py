"""One intra-op thread for torch in every test process.

The suite runs under several pytest-xdist workers on few cores, and
each worker imports every test module while it collects, so this
module's cap reaches every worker before any test runs.  Without it
each worker that runs a port test starts torch's default pool of one
OpenMP thread per core, whose threads spin after their work and slow
the JAX package's wall-clock tests on the same machine.  The inter-op
pool is left alone: torch refuses to resize it once any module has
used it, and no port test does."""

import pytest
import torch

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


def test_one_intra_op_thread():
    assert torch.get_num_threads() == 1
