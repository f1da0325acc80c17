"""Tensor-parallel serving — the port of ``veles_tpu/serving/tp.py``:
a model too wide for one card serves with its blocks' weights and its
paged K/V pools split over a ``{"tp": N}`` mesh of positions.

Megatron-LM's layer split (Shoeybi et al., 2019): each block declares
its layout (``TransformerBlock.tp_param_spec``) — ``wq``/``wk``/``wv``
and the FFN up-projection column-parallel, ``wo`` and the FFN
down-projection row-parallel — so each position holds whole heads and
whole hidden columns, and the only cross-position traffic per layer is
the two row-parallel output reductions, explicit here
(``parallel.collectives.psum``: fixed position order, the identical sum
on every position).  The paged pools split head-wise: each position holds its
own ``[blocks, block, d/N]`` tensor of every pool; the int8 pools'
per-row ``*_scale`` arrays are replicated, and since a row's scale is
the amax of the WHOLE row the blocks take the max across positions
before any of them quantizes, so quantized values are bit-identical to
the unsharded pool's.  Everything host-side (block tables, admission,
the radix trie, drafting, the scheduler loop) stays as it is; only the
steps split.

One controller drives the positions in turn: per layer, every position
runs its share of the block, then the reductions.  The embedding and
the logits head declare no layout; they run once, on position 0 (the
chain's device), and the hidden state is copied to each position.
"""

import numpy
import torch

from veles_tpu_torch.parallel.mesh import build_mesh, default_positions
from veles_tpu_torch.parallel.sharding import P, put


class PerPosition(list):
    """One entry per mesh position (a placement): :func:`per_chip_bytes`
    counts entry ``p`` on position ``p``."""


def tp_supported(forwards, size):
    """True when every cacheable block in the chain declares a
    tensor-parallel layout that divides over ``size`` positions
    (``tp_shardable``: heads, model dim and FFN hidden divisible; MoE
    and ``int8_decode`` blocks opt out)."""
    if size < 2:
        return False
    has = False
    for u in forwards:
        if hasattr(u, "init_cache"):
            has = True
            fn = getattr(u, "tp_shardable", None)
            if fn is None or not fn(size):
                return False
    return has


class ServingTP:
    """One serving replica's ``{"tp": size}`` mesh and its placements.

    ``positions`` (default ``parallel.mesh.default_positions`` of
    ``device``) — the first ``size`` form the mesh.
    :meth:`device_params` places each block's weights by its declared
    spec once per chain (serving weights do not change);
    :meth:`shard_pools` splits a cache's pools head-wise."""

    def __init__(self, size, positions=None, device=None):
        self.size = int(size)
        if self.size < 2:
            raise ValueError("tp needs size >= 2 (got %d)" % size)
        devs = list(positions) if positions is not None \
            else default_positions(device)
        if len(devs) < self.size:
            raise ValueError("tp=%d needs %d positions, found %d"
                             % (self.size, self.size, len(devs)))
        self.mesh = build_mesh({"tp": self.size}, devs[:self.size])
        self.devices = self.mesh.devices
        self._params = None
        self._params_for = None
        self._views = None

    def device_params(self, forwards):
        """Per position, ``{chain index: {name: tensor}}`` of the
        blocks' weights (sharded where the unit declares a spec,
        replicated otherwise); units without a layout are not placed
        (they run on position 0).  Cached per chain."""
        key = id(forwards)
        if self._params is not None and self._params_for == key:
            return self._params
        out = PerPosition({} for _ in range(self.size))
        with torch.no_grad():
            for i, u in enumerate(forwards):
                spec_fn = getattr(u, "tp_param_spec", None)
                if spec_fn is None or not u.tp_shardable(self.size):
                    continue
                for name, t in u.params.items():
                    spec = spec_fn(name, self.size)
                    for p, shard in enumerate(put(
                            t.detach(), self.mesh,
                            spec if spec is not None else P())):
                        out[p].setdefault(i, {})[name] = shard
        self._params, self._params_for, self._views = out, key, None
        return out

    def views(self, forwards):
        """``{chain index: [per-position block]}``: each block as its
        shard on one position — a shallow copy holding that position's
        weights and ``heads / size`` heads."""
        params = self.device_params(forwards)
        if self._views is None:
            self._views = {}
            for i in params[0]:
                u = forwards[i]
                got = []
                for p, dev in enumerate(self.devices):
                    v = object.__new__(type(u))
                    v.__dict__ = dict(u.__dict__)
                    v.params = params[p][i]
                    v.heads = u.heads // self.size
                    v.device = dev
                    v._derived = {}
                    got.append(v)
                self._views[i] = got
        return self._views

    def shard_pools(self, pools):
        """One cache's per-layer pool dicts split over the positions:
        ``{layer: [per-position dict]}``, K/V ``[blocks, block, d]``
        cut into ``d / size`` columns each (copies on the positions),
        ``*_scale`` arrays replicated."""
        out = {}
        for i, layer in pools.items():
            got = PerPosition({} for _ in range(self.size))
            for name, a in layer.items():
                spec = P() if name.endswith("_scale") or a.dim() != 3 \
                    else P(None, None, "tp")
                for p, shard in enumerate(put(a, self.mesh, spec)):
                    got[p][name] = shard
            out[i] = got
        return out

    def run_chain(self, forwards, h, block, other, want_hidden=False):
        """The chain over hidden ``h`` (on position 0): ``block(i, unit,
        views, xs)`` runs a sharded block over per-position inputs
        ``xs`` and returns per-position outputs; ``other(i, unit, h)``
        runs any other unit on position 0.  Returns ``(h, hid)``, hid
        the f32 input of the final unit when ``want_hidden``."""
        views = self.views(forwards)
        hs, hid = None, None
        last = len(forwards) - 1
        for i, u in enumerate(forwards):
            if want_hidden and i == last:
                hid = (hs[0] if hs is not None else h).to(torch.float32)
            if i in views:
                xs = hs if hs is not None \
                    else [h.to(d) for d in self.devices]
                hs = block(i, u, views[i], xs)
            else:
                if hs is not None:
                    h, hs = hs[0], None
                h = other(i, u, h)
        if hs is not None:
            h = hs[0]
        return h, hid


def per_chip_bytes(tree):
    """The most bytes any one mesh position holds of the tensors and
    arrays in a (possibly nested) dict or sequence tree: entry ``p`` of
    a :class:`PerPosition` list (a :class:`ServingTP` placement: the
    blocks' weights, a cache's pools) counts on position ``p``, any
    other tensor in full on position 0 (an unplaced unit's, on the
    chain's device)."""
    acc = {}

    def visit(x, p):
        if isinstance(x, PerPosition):
            for q, v in enumerate(x):
                visit(v, q)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v, p)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v, p)
        elif isinstance(x, torch.Tensor):
            acc[p] = acc.get(p, 0) + x.numel() * x.element_size()
        elif isinstance(x, numpy.ndarray):
            acc[p] = acc.get(p, 0) + x.nbytes

    visit(tree, 0)
    return max(acc.values()) if acc else 0


def chain_params(forwards, tp=None):
    """The chain's parameters as :func:`per_chip_bytes` reads them:
    ``{chain index: {name: tensor}}``, or under ``tp`` (a
    :class:`ServingTP`) the blocks' per-position placement beside the
    unplaced units' tensors."""
    if tp is None:
        return {i: dict(u.params) for i, u in enumerate(forwards)}
    placed = tp.device_params(forwards)
    rest = {i: dict(u.params) for i, u in enumerate(forwards)
            if i not in placed[0]}
    return {"blocks": placed, "rest": rest}
