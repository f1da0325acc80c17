"""LRNormalizerForward — the port of ``veles_tpu/models/lrn.py``:
cross-channel local response normalization over NHWC through the LRN
kernel pair (``ops/lrn.py``, kernel 4).  On the TPU the JAX unit runs the
band-matmul formulation because the kernel's 4D→2D relayout costs a copy
there; NHWC rows are already contiguous ``[R, C]`` on the card, so here
the unit always calls the kernel."""

from veles_tpu_torch.models.nn_units import ForwardBase
from veles_tpu_torch.ops.lrn import lrn


class LRNormalizerForward(ForwardBase):
    """``alpha``, ``beta``, window size ``n`` and bias ``k`` (the
    AlexNet paper's defaults)."""

    def __init__(self, alpha=1e-4, beta=0.75, n=5, k=2.0, device=None,
                 dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.n = int(n)
        self.k = float(k)

    def apply(self, x):
        return lrn(x, self.alpha, self.beta, self.n, self.k)
