"""Block-paged KV cache — the port of
``veles_tpu/serving/kv_slots.py::PagedKVCache`` (PagedAttention
layout, Kwon et al., SOSP 2023).

K/V live in per-layer pools of fixed-size blocks
(``[num_blocks, block_size, d]``) plus a per-slot block table; a
request holds ``ceil((prompt + steps) / block_size)`` blocks instead of
a window row.  Physical block 0 is the reserved TRASH block: never
allocated, it absorbs the writes of occupancy-bucket padding rows and
backs the stale tail of every table (the causal mask hides it).
``kv_dtype="int8"`` stores the pools int8 with per-row f32 scales
beside them, indexed by the same physical block ids, so scales follow
their blocks; inserts quantize.

Host bookkeeping (free lists, tables) is numpy; the pools are tensors
on the chain's device, updated in place.  One thread (the scheduler's
loop) calls every method.
"""

import numpy
import torch

from veles_tpu_torch.ops.paged_attention import quantize_kv_rows


def paged_supported(forwards):
    """True when every cacheable unit speaks the paged decode step."""
    cacheable = [u for u in forwards if hasattr(u, "init_cache")]
    return bool(cacheable) and all(hasattr(u, "apply_step_paged")
                                   for u in cacheable)


class PagedKVCache:
    """Block-paged K/V pools + per-slot block tables.

    ``kv_blocks`` — usable capacity in blocks (default the dense
    equivalent ``max_slots · ceil(window / block_size)``); ``window``
    is the per-request length bound."""

    def __init__(self, forwards, max_slots, window, block_size=16,
                 kv_blocks=None, kv_dtype="fp32"):
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
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._free_blocks = list(range(num - 1, 0, -1))
        #: host tables [max_slots, blocks_per_slot]; entries past a
        #: slot's live count stay 0 (the trash block)
        self.tables = numpy.zeros(
            (self.max_slots, self.blocks_per_slot), numpy.int32)
        self.n_blocks = numpy.zeros((self.max_slots,), numpy.int32)

    # -- occupancy -------------------------------------------------------------

    @property
    def free_slots(self):
        return len(self._free_slots)

    @property
    def free_blocks(self):
        return len(self._free_blocks)

    def blocks_needed(self, total_tokens):
        return -(-max(int(total_tokens), 1) // self.block_size)

    def can_admit(self, total_tokens):
        """A free slot AND blocks for the request's whole budget
        (prompt + steps, reserved up front so decode never starves)."""
        return bool(self._free_slots) \
            and self.blocks_needed(total_tokens) <= len(self._free_blocks)

    def alloc(self, total_tokens):
        """Claim a slot and its full block budget, or None when slots
        or blocks are exhausted."""
        need = self.blocks_needed(total_tokens)
        if need > self.blocks_per_slot:
            raise ValueError(
                "request of %d tokens needs %d blocks > %d per-slot "
                "table width" % (total_tokens, need, self.blocks_per_slot))
        if not self._free_slots or need > len(self._free_blocks):
            return None
        slot = self._free_slots.pop()
        ids = [self._free_blocks.pop() for _ in range(need)]
        self.tables[slot, :need] = ids
        self.tables[slot, need:] = 0
        self.n_blocks[slot] = need
        return slot

    def release(self, slot):
        """Free a slot and return its blocks to the free list."""
        slot = int(slot)
        if slot in self._free_slots:
            raise ValueError("slot %d double-freed" % slot)
        n = int(self.n_blocks[slot])
        self._free_blocks.extend(
            int(b) for b in reversed(self.tables[slot, :n]))
        self.tables[slot, :] = 0
        self.n_blocks[slot] = 0
        self._free_slots.append(slot)

    def check(self):
        """Invariant sweep: every block is exactly one of {trash, free,
        owned by one slot}, and int8 pools keep their scales."""
        live = []
        for slot in range(self.max_slots):
            if slot not in self._free_slots:
                live.extend(int(b) for b in
                            self.tables[slot, :self.n_blocks[slot]])
        owned = live + [int(b) for b in self._free_blocks]
        assert 0 not in owned, "trash block leaked into circulation"
        assert len(owned) == len(set(owned)), "block double-owned"
        assert len(owned) == self.capacity_blocks, \
            "block leaked: %d tracked of %d" % (len(owned),
                                                self.capacity_blocks)
        assert len(set(self._free_slots)) == len(self._free_slots), \
            "slot double-freed"
        if self.kv_dtype == "int8":
            for i, layer in self.pools.items():
                assert {"k", "v", "k_scale", "v_scale"} <= set(layer), \
                    "layer %s lost its scale arrays" % (i,)
                for name in ("k", "v"):
                    assert layer[name + "_scale"].shape \
                        == layer[name].shape[:2], \
                        "layer %s %s_scale shape drifted" % (i, name)

    def table_rows(self, slots, width):
        """The packed [len(slots), width] block-table batch."""
        return self.tables[numpy.asarray(slots, numpy.intp), :width]

    def insert(self, slot, row_caches, length):
        """Block-scatter a prefilled batch-1 staging row (width a
        multiple of block_size, rows ≥ length zeroed) into ``slot``'s
        table blocks ``[0, ceil(length / block_size))``, quantizing
        per row for int8 pools."""
        need = self.blocks_needed(length)
        if need > int(self.n_blocks[slot]):
            raise ValueError(
                "insert of %d tokens exceeds slot %d's %d-block budget"
                % (length, slot, int(self.n_blocks[slot])))
        ids = torch.as_tensor(self.tables[slot, :need].astype(numpy.int64),
                              device=self.device)
        n = need * self.block_size
        for i, layer in self.pools.items():
            src = row_caches[i]
            if src["k"].shape[1] < n:
                raise ValueError("staging width %d < %d blocks x %d"
                                 % (src["k"].shape[1], need,
                                    self.block_size))
            for name in ("k", "v"):
                rows = src[name][0, :n].reshape(need, self.block_size, -1)
                if self.kv_dtype == "int8":
                    q, scale = quantize_kv_rows(rows)
                    layer[name][ids] = q
                    layer[name + "_scale"][ids] = scale
                else:
                    layer[name][ids] = rows.to(layer[name].dtype)
