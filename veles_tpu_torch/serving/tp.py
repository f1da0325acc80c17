"""The port's copy of ``veles_tpu/serving/tp.py::per_chip_bytes``.

Tensor-parallel serving itself (the reference's ``ServingTP``, its
weight and pool splits) is not ported yet; the port serves on one card,
where every array is resident in full.
"""

import numpy
import torch


def per_chip_bytes(tree):
    """The bytes one card holds of the tensors and arrays in a (possibly
    nested) dict or sequence tree.  On one card every tensor counts in
    full, as the reference counts an unsharded array."""
    total = 0

    def visit(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, numpy.ndarray):
            total += x.nbytes

    visit(tree)
    return total


def chain_params(forwards):
    """``{chain index: {name: tensor}}`` of a chain's parameters (what
    :func:`per_chip_bytes` reads for the weights' bytes)."""
    return {i: dict(u.params) for i, u in enumerate(forwards)}
