"""Pipeline parallelism — the GPipe schedule over the ``pp`` mesh axis,
the port of ``veles_tpu/parallel/pipeline.py``.

A stage lives on one ``pp`` position; activations hop stage to stage
by a copy onto the next stage's device, or, when the next stage belongs
to another process of a gang, by a differentiable hop
(``parallel.p2p``).  The schedule is the
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


def gpipe_apply(stage_fn, stage_params, microbatches, route,
                out_device=None):
    """Run the bubble schedule: ``stage_fn(stage_params[s], h) -> h``
    on the device of ``route``'s stage position ``s`` (``route`` a
    ``parallel.p2p.Route`` whose ring is the stages' positions, from the
    group's home; every stage maps activations of one shape and dtype,
    the GPipe constraint); ``microbatches`` is a sequence of M tensors
    entering stage 0 from the home.  Returns the last stage's outputs,
    brought back to the home in microbatch order after the loop and
    stacked as [M, ...] on ``out_device`` (default the home's device).

    The stages may belong to several processes of a gang: each process
    runs the stages it holds, and every activation moves to the next
    stage by ``route.move`` (a hop across processes, taken by both ends
    at the same (t, s) of the schedule).  A process that does not hold
    the home passes None microbatches and gets None."""
    n = len(route.ring)
    m = len(microbatches)
    outputs = [None] * m
    recv = {}
    for t in range(m + n - 1):
        sent = {}
        for s in range(n):
            mb = t - s
            if not 0 <= mb < m:
                continue
            h = None
            if route.here(s):
                h = recv[s] if s > 0 \
                    else route.move(microbatches[mb], None, 0)
                h = stage_fn(stage_params[s], h)
            if s == n - 1:
                outputs[mb] = h
            else:
                sent[s + 1] = route.move(h, s, s + 1)
        recv = sent
    outputs = [route.move(o, n - 1, None) for o in outputs]
    if not route.here():
        return None
    dev = out_device if out_device is not None else route.device()
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
    Returns [batch, ...] on ``x``'s device.

    On a mesh across a gang's processes every process passes the same
    ``x`` and ``stage_params`` and runs its stages; the slices' outputs
    come together in the process of the mesh's first position, and the
    others get None."""
    from veles_tpu_torch.parallel.p2p import Route, move
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
        route = Route(mesh, positions[0], positions)
        params = [_to(sp, mesh.device(p)) if mesh.is_local(p) else None
                  for sp, p in zip(stage_params, positions)]
        chunks = [micro[i, g * per:(g + 1) * per] if route.here() else None
                  for i in range(n_micro)]
        out = gpipe_apply(stage_fn, params, chunks, route,
                          out_device=x.device)
        outs.append(move(out, mesh, positions[0], 0))
    if not mesh.is_local(0):
        return None
    out = torch.cat(outs, dim=1).to(x.device)
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

