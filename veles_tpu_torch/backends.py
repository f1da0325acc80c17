"""Device resolution: the port runs on the card unless the caller asks
for the CPU.

There is no silent fallback: ``resolve_device()`` with no CUDA device
raises instead of quietly picking the CPU, so a run that meant to
measure the card can never measure the host instead.
"""

import torch


def resolve_device(device=None):
    """``None`` → ``cuda``; ``"cpu"`` only when asked.  Raises
    ``RuntimeError`` for a CUDA device when no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be 'cuda' or 'cpu', got %r"
                         % (device,))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
