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


#: device name -> measured rating (FLOP/s), for this process
_POWER = {}


def compute_power(device=None, n=2048, refresh=False):
    """The device's rating for the coordinator's handshake: the FLOP/s of
    a bf16 (CPU: f32) ``n``-cubed ``torch.matmul``, timed over 8 chained
    products after one warm-up, cached per device for the process (the
    reference's ``Device.compute_power`` probe, without its on-disk
    cache)."""
    import time
    dev = resolve_device(device)
    key = str(dev)
    if key in _POWER and not refresh:
        return _POWER[key]
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    x = torch.full((n, n), 1.0 / n, dtype=dt, device=dev)
    out = x @ x
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    reps = 8
    for _ in range(reps):
        out = out @ x
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = (time.perf_counter() - t0) / reps
    _POWER[key] = float(2 * n ** 3 / seconds)
    return _POWER[key]
