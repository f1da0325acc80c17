"""The serving KV caches — the port of ``veles_tpu/serving/kv_slots.py``:
the block-paged :class:`PagedKVCache` (PagedAttention layout, Kwon et
al., SOSP 2023; the scheduler's default) and the dense
:class:`SlotKVCache` (``kv="dense"``).

Paged K/V live in per-layer pools of fixed-size blocks
(``[num_blocks, block_size, d]``) plus a per-slot block table; a
request holds ``ceil((prompt + steps) / block_size)`` blocks instead of
a window row.  Physical block 0 is the reserved TRASH block: never
allocated, it absorbs the writes of occupancy-bucket padding rows and
backs the stale tail of every table (the causal mask hides it).
``kv_dtype="int8"`` stores the pools int8 with per-row f32 scales
beside them, indexed by the same physical block ids, so scales follow
their blocks; inserts quantize.

The block movers of the host tier and of disaggregation:
:meth:`PagedKVCache.export_blocks` copies blocks RAW off the card into
host numpy arrays (int8 stays int8, the scales ride along; a bfloat16
pool widens exactly to float32, which numpy can hold),
:meth:`PagedKVCache.import_blocks` scatters such a record back into
blocks of this cache, and :meth:`PagedKVCache.take_free_blocks` claims
blocks outside the slot machinery for them.

Under tensor-parallel serving (``tp``, a :class:`~veles_tpu_torch.
serving.tp.ServingTP`) each layer's pools are a per-position list: each
position holds its own ``[num_blocks, block_size, d/tp]`` K/V tensors
and a replicated copy of the scales.  The block movers read and write
whole rows — a read puts the positions' columns back together, a write
splits them — so staging rows, exports and imports keep the unsharded
layout, and an int8 insert quantizes whole rows before it splits them.

Host bookkeeping (free lists, tables) is numpy; the buffers are tensors
on the chain's device, updated in place.  One thread (the scheduler's
loop) calls every method.
"""

import numpy
import torch

from veles_tpu_torch.ops.paged_attention import (
    dequantize_kv, quantize_kv_rows)


def paged_supported(forwards):
    """True when every cacheable unit speaks the paged decode step."""
    cacheable = [u for u in forwards if hasattr(u, "init_cache")]
    return bool(cacheable) and all(hasattr(u, "apply_step_paged")
                                   for u in cacheable)


class SlotKVCache:
    """Per-layer dense slot-major K/V buffers ``[max_slots, window, d]``
    + free-slot bookkeeping — the reference's legacy layout and the
    parity baseline of the paged cache (``kv="dense"``).  A slot
    reserves a whole window row whatever the request's length."""

    def __init__(self, forwards, max_slots, window):
        self.max_slots = int(max_slots)
        self.window = int(window)
        if self.max_slots < 1 or self.window < 2:
            raise ValueError("need max_slots >= 1 and window >= 2")
        self.caches = {
            i: u.init_cache(self.max_slots, self.window, u.dtype)
            for i, u in enumerate(forwards) if hasattr(u, "init_cache")}
        if not self.caches:
            raise ValueError("chain has no cacheable blocks")
        self.device = next(iter(self.caches.values()))["k"].device
        # lowest slot first — keeps occupancy dense and debuggable
        self._free = list(range(self.max_slots - 1, -1, -1))

    @property
    def free_slots(self):
        return len(self._free)

    @property
    def active_slots(self):
        return self.max_slots - len(self._free)

    def can_admit(self, total_tokens):
        """A free slot is the only requirement."""
        return bool(self._free)

    def alloc(self, total_tokens=0):
        """Claim a free slot index, or None when all are busy."""
        return self._free.pop() if self._free else None

    def release(self, slot):
        slot = int(slot)
        if slot in self._free:
            raise ValueError("slot %d double-freed" % slot)
        self._free.append(slot)

    def insert(self, slot, row_caches, length=None):
        """Adopt a prefilled batch-1 staging row (trimmed to the window)
        into ``slot``'s row from position 0.  Rows the staging does not
        cover keep the previous occupant's K/V: decode attends only
        over ``[0, len)`` and writes every later position itself."""
        for i, layer in self.caches.items():
            for name, dst in layer.items():
                src = row_caches[i][name][0, :self.window]
                dst[int(slot), :src.shape[0]] = src.to(dst.dtype)


class PagedKVCache:
    """Block-paged K/V pools + per-slot block tables.

    ``kv_blocks`` — usable capacity in blocks (default the dense
    equivalent ``max_slots · ceil(window / block_size)``); ``window``
    is the per-request length bound."""

    def __init__(self, forwards, max_slots, window, block_size=16,
                 kv_blocks=None, kv_dtype="fp32", tp=None):
        self.max_slots = int(max_slots)
        self.window = int(window)
        self.block_size = int(block_size)
        if self.max_slots < 1 or self.window < 2:
            raise ValueError("need max_slots >= 1 and window >= 2")
        if self.block_size < 1:
            raise ValueError("need block_size >= 1")
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError("kv_dtype must be 'fp32' or 'int8'")
        self.kv_dtype = kv_dtype
        self.blocks_per_slot = -(-self.window // self.block_size)
        self.capacity_blocks = int(
            kv_blocks or self.max_slots * self.blocks_per_slot)
        if self.capacity_blocks < 1:
            raise ValueError("need kv_blocks >= 1")
        num = self.capacity_blocks + 1          # + the trash block 0
        self.pools = {
            i: u.init_block_pool(num, self.block_size, u.dtype,
                                 kv_dtype=kv_dtype)
            for i, u in enumerate(forwards) if hasattr(u, "init_cache")}
        if not self.pools:
            raise ValueError("chain has no cacheable blocks")
        self.device = next(iter(self.pools.values()))["k"].device
        #: tensor-parallel context (serving/tp.py): pools per position
        self.tp_ = tp
        if tp is not None:
            self.pools = tp.shard_pools(self.pools)
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._free_blocks = list(range(num - 1, 0, -1))
        #: host tables [max_slots, blocks_per_slot]; entries past a
        #: slot's live count stay 0 (the trash block)
        self.tables = numpy.zeros(
            (self.max_slots, self.blocks_per_slot), numpy.int32)
        self.n_blocks = numpy.zeros((self.max_slots,), numpy.int32)
        #: leading SHARED blocks per slot (prefix-cache residents the
        #: slot reads but does not own)
        self.n_shared = numpy.zeros((self.max_slots,), numpy.int32)

    # -- occupancy -------------------------------------------------------------

    @property
    def free_slots(self):
        return len(self._free_slots)

    @property
    def active_slots(self):
        return self.max_slots - len(self._free_slots)

    @property
    def free_blocks(self):
        return len(self._free_blocks)

    @property
    def used_blocks(self):
        return self.capacity_blocks - len(self._free_blocks)

    def _part(self, layer, p=0):
        """Position ``p``'s pool dict of ``layer`` (the dict itself when
        unsharded)."""
        return layer if self.tp_ is None else layer[p]

    def _read(self, layer, name, idx):
        """Whole rows ``idx`` of pool ``name`` (a gather: a new tensor on
        the cache's device); a tp pool's positions' columns are put back
        together, its replicated scales read from position 0."""
        if self.tp_ is None:
            return layer[name][idx]
        if name.endswith("_scale"):
            return layer[0][name][idx.to(layer[0][name].device)]
        return torch.cat([d[name][idx.to(d[name].device)].to(self.device)
                          for d in layer], dim=-1)

    def _write(self, layer, name, idx, rows):
        """Write whole rows into pool ``name`` at ``idx``: split by
        columns over a tp pool's positions, its scales copied to each."""
        if self.tp_ is None:
            layer[name][idx] = rows.to(layer[name].device, layer[name].dtype)
            return
        parts = [rows] * len(layer) if name.endswith("_scale") \
            else torch.chunk(rows, len(layer), dim=-1)
        for d, part in zip(layer, parts):
            d[name][idx.to(d[name].device)] = part.to(d[name].device,
                                                      d[name].dtype)

    def bytes_per_token(self):
        """Device bytes ONE cached token costs one position across every
        layer's pools: ``d`` elements of K and of V per layer (``d/tp``
        under tensor-parallel serving, each position storing its
        columns of every row), plus one f32 scale each under int8,
        replicated (the ``kv_bytes_per_token`` gauge)."""
        total = 0
        for layer in self.pools.values():
            for name, arr in self._part(layer).items():
                if name.endswith("_scale"):   # one scale per row
                    total += arr.element_size()
                else:
                    total += arr.shape[-1] * arr.element_size()
        return int(total)

    def blocks_needed(self, total_tokens):
        return -(-max(int(total_tokens), 1) // self.block_size)

    def can_admit(self, total_tokens):
        """A free slot and enough free blocks for the request's whole
        budget (prompt + steps, reserved up front so decode never
        starves for a block mid-flight)."""
        return bool(self._free_slots) \
            and self.blocks_needed(total_tokens) <= len(self._free_blocks)

    def alloc(self, total_tokens, shared=()):
        """Claim a slot and its full block budget, or None when slots
        or blocks are exhausted.  ``shared`` — block ids of a resident
        prompt prefix (a prefix-cache hit): they head the table READ
        ONLY and only ``need - len(shared)`` new blocks are claimed."""
        need = self.blocks_needed(total_tokens)
        shared = [int(b) for b in shared]
        if need > self.blocks_per_slot:
            raise ValueError(
                "request of %d tokens needs %d blocks > %d per-slot "
                "table width" % (total_tokens, need, self.blocks_per_slot))
        if len(shared) >= need:
            raise ValueError(
                "shared prefix of %d blocks must leave at least one "
                "private block of the %d-block budget"
                % (len(shared), need))
        if not self._free_slots \
                or need - len(shared) > len(self._free_blocks):
            return None
        slot = self._free_slots.pop()
        ids = shared + [self._free_blocks.pop()
                        for _ in range(need - len(shared))]
        self.tables[slot, :need] = ids
        self.tables[slot, need:] = 0
        self.n_blocks[slot] = need
        self.n_shared[slot] = len(shared)
        return slot

    def release(self, slot, donate=0):
        """Free a slot.  The leading shared blocks are handed back
        (the prefix cache still owns them); the next ``donate`` private
        blocks pass to the caller (a finished request donating its
        stream to the cache); the rest return to the free list.
        Returns ``(shared_ids, donated_ids)``."""
        slot = int(slot)
        if slot in self._free_slots:
            raise ValueError("slot %d double-freed" % slot)
        n = int(self.n_blocks[slot])
        ns = int(self.n_shared[slot])
        donate = int(donate)
        if donate < 0 or ns + donate > n:
            raise ValueError(
                "donate=%d outside slot %d's %d private blocks"
                % (donate, slot, n - ns))
        row = [int(b) for b in self.tables[slot, :n]]
        shared, donated = row[:ns], row[ns:ns + donate]
        self._free_blocks.extend(reversed(row[ns + donate:]))
        self.tables[slot, :] = 0
        self.n_blocks[slot] = 0
        self.n_shared[slot] = 0
        self._free_slots.append(slot)
        return shared, donated

    def reclaim(self, ids):
        """Return blocks whose ownership left the slot machinery
        (prefix-cache evictions, duplicate donations) to the free
        list."""
        for b in ids:
            b = int(b)
            if b < 1 or b > self.capacity_blocks:
                raise ValueError("reclaim of invalid block %d" % b)
            if b in self._free_blocks:
                raise ValueError("block %d double-freed" % b)
            self._free_blocks.append(b)

    def take_free_blocks(self, n):
        """Claim ``n`` blocks off the free list outside the slot
        machinery (host-tier promotion, a peer's prefix import: the
        caller fills them with :meth:`import_blocks` and hands them to
        the prefix cache).  Returns the ids, or None when the free list
        is short."""
        n = int(n)
        if n < 0 or n > len(self._free_blocks):
            return None
        return [self._free_blocks.pop() for _ in range(n)]

    def export_blocks(self, ids):
        """Copy blocks ``ids`` RAW out of every layer's pools: ``{layer:
        {"k", "v"[, "k_scale", "v_scale"]}}`` host numpy arrays, K/V
        ``[len(ids), block_size, d]`` in the pool's storage dtype (int8
        stays int8 and its scales ride along, so an importer holds the
        same bytes; a bfloat16 pool widens exactly to float32).  The
        arrays are copies, never views of the pools."""
        idx = torch.as_tensor(numpy.asarray(ids, numpy.int64),
                              device=self.device)
        out = {}
        for i, layer in self.pools.items():
            got = {}
            for name in self._part(layer):
                rows = self._read(layer, name, idx)   # a new tensor
                if rows.dtype == torch.bfloat16:
                    rows = rows.float()
                got[name] = rows.cpu().numpy()
            out[i] = got
        return out

    def import_blocks(self, ids, layers):
        """Scatter an :meth:`export_blocks` record (or a wire record of
        either package) into this cache's blocks ``ids``: the contents
        land unconverted, scales included, so the importing blocks hold
        what the exporter's held."""
        n = len(ids)
        idx = torch.as_tensor(numpy.asarray(ids, numpy.int64),
                              device=self.device)
        for i, layer in self.pools.items():
            src = layers[i]
            ref = src["k"] if "k" in src else next(iter(src.values()))
            if ref.shape[0] != n or ref.shape[1] != self.block_size:
                raise ValueError(
                    "imported layer %s blocks %s do not fit %d x "
                    "block_size %d" % (i, tuple(ref.shape[:2]), n,
                                       self.block_size))
            if self.kv_dtype == "int8" and "k_scale" not in src:
                raise ValueError("int8 import needs k_scale/v_scale riding "
                                 "the exported blocks")
            for name in self._part(layer):
                a = numpy.asarray(src[name])
                if not a.flags.writeable:   # a zero-copy wire view
                    a = a.copy()
                self._write(layer, name, idx, torch.from_numpy(a))

    def check(self, resident=()):
        """Invariant sweep: every block is exactly one of {trash, free,
        resident in the prefix cache, owned by one slot}, every slot's
        shared prefix is in ``resident``, and int8 pools keep their
        scales."""
        resident = set(int(b) for b in resident)
        live = []
        for slot in range(self.max_slots):
            if slot not in self._free_slots:
                ns = int(self.n_shared[slot])
                row = [int(b) for b in
                       self.tables[slot, :self.n_blocks[slot]]]
                assert set(row[:ns]) <= resident, \
                    "slot %d shares non-resident blocks %s" \
                    % (slot, sorted(set(row[:ns]) - resident))
                live.extend(row[ns:])
        owned = live + [int(b) for b in self._free_blocks] \
            + sorted(resident)
        assert 0 not in owned, "trash block leaked into circulation"
        assert len(owned) == len(set(owned)), "block double-owned"
        assert len(owned) == self.capacity_blocks, \
            "block leaked: %d tracked of %d" % (len(owned),
                                                self.capacity_blocks)
        assert len(set(self._free_slots)) == len(self._free_slots), \
            "slot double-freed"
        if self.kv_dtype == "int8":
            for i, layers in self.pools.items():
                for layer in (layers if self.tp_ is not None
                              else [layers]):
                    assert {"k", "v", "k_scale", "v_scale"} <= set(layer), \
                        "layer %s lost its scale arrays" % (i,)
                    for name in ("k", "v"):
                        assert layer[name + "_scale"].shape \
                            == layer[name].shape[:2], \
                            "layer %s %s_scale shape drifted" % (i, name)

    def table_rows(self, slots, width):
        """The packed [len(slots), width] block-table batch."""
        return self.tables[numpy.asarray(slots, numpy.intp), :width]

    def insert(self, slot, row_caches, length, from_block=0):
        """Block-scatter a prefilled batch-1 staging row (width a
        multiple of block_size, rows ≥ length zeroed) into ``slot``'s
        table blocks ``[from_block, ceil(length / block_size))``,
        quantizing per row for int8 pools.  ``from_block`` skips a warm
        shared prefix: those staging rows were gathered from resident
        blocks (:meth:`load_staging`) that other requests read, and are
        never written back."""
        need = self.blocks_needed(length)
        f = int(from_block)
        if need > int(self.n_blocks[slot]):
            raise ValueError(
                "insert of %d tokens exceeds slot %d's %d-block budget"
                % (length, slot, int(self.n_blocks[slot])))
        if f >= need:
            raise ValueError(
                "from_block %d leaves nothing of the %d-block insert"
                % (f, need))
        ids = torch.as_tensor(self.tables[slot, f:need].astype(numpy.int64),
                              device=self.device)
        bs = self.block_size
        for i, layer in self.pools.items():
            src = row_caches[i]
            if src["k"].shape[1] < need * bs:
                raise ValueError("staging width %d < %d blocks x %d"
                                 % (src["k"].shape[1], need, bs))
            for name in ("k", "v"):
                rows = src[name][0, f * bs:need * bs].reshape(
                    need - f, bs, -1)
                if self.kv_dtype == "int8":
                    q, scale = quantize_kv_rows(rows)
                    self._write(layer, name, ids, q)
                    self._write(layer, name + "_scale", ids, scale)
                else:
                    self._write(layer, name, ids, rows)

    def load_staging(self, row_caches, ids):
        """Copy resident blocks ``ids`` (a matched prompt prefix) into
        the FRONT of a batch-1 staging row — the warm half of a
        prefix-cache admission; the cold tail's chunked prefill then
        attends over these rows.  int8 blocks dequantize against their
        scales into the staging dtype, so the tail attends over the
        values later decode steps read.  The rows are copies: the
        staging row never aliases the pools.  Returns the staging
        dict."""
        if not len(ids):
            return row_caches
        n = len(ids) * self.block_size
        ids = torch.as_tensor(numpy.asarray(ids, numpy.int64),
                              device=self.device)
        for i, layer in self.pools.items():
            dst = row_caches[i]
            for name in ("k", "v"):
                if self.kv_dtype == "int8":
                    rows = dequantize_kv(
                        self._read(layer, name, ids),
                        self._read(layer, name + "_scale", ids),
                        dst[name].dtype)
                else:
                    rows = self._read(layer, name, ids).to(dst[name].dtype)
                dst[name][0, :n] = rows.reshape(n, -1)
        return row_caches
