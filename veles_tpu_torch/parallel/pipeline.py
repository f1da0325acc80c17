"""Pipeline parallelism — the GPipe schedule over the ``pp`` mesh axis,
the port of ``veles_tpu/parallel/pipeline.py``.

A stage lives on one ``pp`` position; activations hop stage to stage
by a copy onto the next stage's device.  The schedule is the
reference's bubble loop: with S stages and M microbatches, at step
t = 0 .. S + M - 2 stage s runs microbatch t - s, so on several cards
the stages overlap.  Every hop is a differentiable copy, so the
backward runs the transposed schedule through autograd, and the result
equals the stages applied in sequence, forward and gradient.
"""

import torch


def split_stages(n_layers, n_stages):
    """Contiguous layer → stage assignment: ``n_stages`` lists of layer
    indices, balanced within ±1 (the first ``n_layers % n_stages``
    stages take one extra layer)."""
    if n_stages > n_layers:
        raise ValueError("more stages (%d) than layers (%d)"
                         % (n_stages, n_layers))
    base, extra = divmod(n_layers, n_stages)
    out, start = [], 0
    for s in range(n_stages):
        size = base + (1 if s < extra else 0)
        out.append(list(range(start, start + size)))
        start += size
    return out


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def stack_stage_params(per_stage_params):
    """[stage] of (nested dicts of) tensors → the same tree with a
    leading stage dimension."""
    return _stack(list(per_stage_params))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def gpipe_apply(stage_fn, stage_params, microbatches, devices,
                out_device=None):
    """Run the bubble schedule: ``stage_fn(stage_params[s], h) -> h``
    on ``devices[s]`` (every stage maps activations of one shape and
    dtype, the GPipe constraint); ``microbatches`` is a sequence of M
    tensors entering stage 0.  Returns the last stage's outputs
    stacked as [M, ...] on ``out_device`` (default the last stage's
    device)."""
    n = len(devices)
    m = len(microbatches)
    outputs = [None] * m
    recv = {}
    for t in range(m + n - 1):
        sent = {}
        for s in range(n):
            mb = t - s
            if not 0 <= mb < m:
                continue
            h = microbatches[mb].to(devices[0]) if s == 0 else recv[s]
            h = stage_fn(stage_params[s], h)
            if s == n - 1:
                outputs[mb] = h
            else:
                sent[s + 1] = h.to(devices[s + 1])
        recv = sent
    dev = out_device if out_device is not None else devices[-1]
    return torch.stack([o.to(dev) for o in outputs])


def _stage_groups(mesh, axis, batch_axes):
    """Per data-parallel slice, the positions of its stages in stage
    order."""
    groups = []
    for p in range(mesh.size):
        c = mesh.coords(p)
        if c.get(axis, 0) != 0:
            continue
        if any(c.get(a, 0) and a not in batch_axes for a in mesh.shape
               if a != axis):
            continue
        groups.append(mesh.along(p, axis))
    return groups


def gpipe_train(mesh, stage_fn, stage_params, x, n_micro, axis="pp",
                batch_axes=None):
    """GPipe over ``mesh``'s ``axis``: ``x`` [batch, ...] is cut into
    ``n_micro`` microbatches; with ``batch_axes`` (pp×dp) each
    microbatch's samples split over those axes' slices, and every slice
    runs its own schedule on its stage positions.  ``stage_params`` is
    the list of per-stage parameters (moved to each stage's device).
    Returns [batch, ...] on ``x``'s device."""
    if x.shape[0] % n_micro:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (x.shape[0], n_micro))
    mb = x.shape[0] // n_micro
    micro = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    groups = _stage_groups(mesh, axis, tuple(batch_axes or ()))
    if mb % len(groups):
        raise ValueError("microbatch %d not divisible over %d slices"
                         % (mb, len(groups)))
    per = mb // len(groups)
    outs = []
    for g, positions in enumerate(groups):
        devices = [mesh.device(p) for p in positions]
        params = [_to(sp, d) for sp, d in zip(stage_params, devices)]
        chunks = [micro[i, g * per:(g + 1) * per] for i in range(n_micro)]
        outs.append(gpipe_apply(stage_fn, params, chunks, devices,
                                out_device=x.device))
    out = torch.cat(outs, dim=1)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))


def pipeline_forward(mesh, stage_fn, per_stage_params, x, n_micro,
                     axis="pp", batch_axes=None):
    """Convenience wrapper: one stage per ``axis`` position, ``x``
    [batch, ...] microbatched, the GPipe loop run; returns [batch, ...]
    outputs."""
    if len(per_stage_params) != mesh.shape[axis]:
        raise ValueError(
            "%d stages != %s axis size %d — each mesh position holds "
            "exactly one stage (group layers with split_stages first)"
            % (len(per_stage_params), axis, mesh.shape[axis]))
    return gpipe_train(mesh, stage_fn, list(per_stage_params), x, n_micro,
                       axis=axis, batch_axes=batch_axes)

