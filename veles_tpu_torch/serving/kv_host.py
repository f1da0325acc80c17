"""Host-RAM overflow tier for the radix prefix cache — the port of
``veles_tpu/serving/kv_host.py``.

When admission pressure evicts a refcount-0 block from the trie, the
scheduler first copies its contents off the card
(``PagedKVCache.export_blocks``: int8 stays int8, the scales ride
along) and parks them here, keyed by the rolling digest of the token
prefix the block completes (:func:`~veles_tpu_torch.serving.
prefix_cache.chunk_digests`).  A later admission whose prompt runs past
its device-resident prefix into host territory promotes those blocks
back into freshly claimed device blocks and re-inserts them into the
trie; the request then admits through the ordinary warm path.  The
cache's capacity becomes device memory plus host RAM.

Entries are numpy copies owned by the tier (never views of a pool),
bounded by a byte budget with LRU eviction.  A digest names a full
token path and each entry stores its own chunk's tokens, so a match
re-verifies tokens level by level: a crc32 collision is a miss, never
wrong KV.  Evicting a mid-chain entry orphans its descendants (the
match walk stops at the gap) and LRU ages them out.  The scheduler's
loop owns every call.
"""

import numpy

from veles_tpu_torch.serving.prefix_cache import chunk_digests


class _HostBlock:
    __slots__ = ("digest", "key", "depth", "layers", "nbytes", "stamp")

    def __init__(self, digest, key, depth, layers, nbytes, stamp):
        self.digest = digest      # rolling digest of the full path
        self.key = key            # this block's block_size tokens
        self.depth = depth        # 0-based chunk index in the path
        self.layers = layers      # {chain idx: {name: numpy array}}
        self.nbytes = nbytes
        self.stamp = stamp        # LRU tick of the last touch


class HostKVTier:
    """Byte-budgeted, LRU host store of demoted KV blocks."""

    def __init__(self, byte_budget, block_size):
        self.byte_budget = int(byte_budget)
        self.block_size = int(block_size)
        self._entries = {}        # digest -> _HostBlock
        self._clock = 0
        self.bytes = 0            # resident payload bytes
        self.demotions = 0        # blocks accepted, cumulative
        self.promotions = 0       # blocks promoted out, cumulative
        self.evictions = 0        # blocks LRU-dropped, cumulative

    @property
    def blocks(self):
        return len(self._entries)

    def digests(self):
        """Every resident path digest (merged into the scheduler's
        ``prefix_digests`` beside the trie's)."""
        return list(self._entries)

    def put(self, path_tokens, layers):
        """Adopt one evicted block's contents: ``path_tokens`` the full
        block-aligned token prefix the block completes, ``layers``
        ``{chain idx: {name: [1, bs, d] array}}``.  Returns whether the
        block was adopted (not when it alone exceeds the budget or the
        path is unaligned)."""
        bs = self.block_size
        if not path_tokens or len(path_tokens) % bs:
            return False
        held = {}
        nbytes = 0
        for i, layer in layers.items():
            held[int(i)] = row = {}
            for name, a in layer.items():
                arr = numpy.array(a, copy=True, order="C")
                row[str(name)] = arr
                nbytes += arr.nbytes
        if nbytes > self.byte_budget:
            return False
        self._clock += 1
        digest = chunk_digests(path_tokens, bs)[-1]
        old = self._entries.pop(digest, None)
        if old is not None:
            self.bytes -= old.nbytes
        while self.bytes + nbytes > self.byte_budget:
            if not self._evict_lru():
                return False
        self._entries[digest] = _HostBlock(
            digest, tuple(int(t) for t in path_tokens[-bs:]),
            len(path_tokens) // bs - 1, held, nbytes, self._clock)
        self.bytes += nbytes
        self.demotions += 1
        return True

    def match(self, tokens, start_blocks, max_blocks=None):
        """The host extension of a device-resident prefix: entries for
        consecutive chunks of ``tokens`` from depth ``start_blocks``,
        token-verified level by level.  Entries stay until :meth:`pop`."""
        bs = self.block_size
        digs = chunk_digests(tokens, bs)
        stop = len(digs)
        if max_blocks is not None:
            stop = min(stop, int(start_blocks) + int(max_blocks))
        out = []
        self._clock += 1
        for d in range(int(start_blocks), stop):
            e = self._entries.get(digs[d])
            if e is None or e.depth != d or e.key != tuple(
                    int(t) for t in tokens[d * bs:(d + 1) * bs]):
                break
            e.stamp = self._clock
            out.append(e)
        return out

    def pop(self, entries):
        """Remove promoted entries (their contents live in device blocks
        now; a later device eviction demotes them again)."""
        for e in entries:
            if self._entries.pop(e.digest, None) is not None:
                self.bytes -= e.nbytes
                self.promotions += 1

    def _evict_lru(self):
        victim = None
        for e in self._entries.values():
            if victim is None or e.stamp < victim.stamp:
                victim = e
        if victim is None:
            return False
        del self._entries[victim.digest]
        self.bytes -= victim.nbytes
        self.evictions += 1
        return True

    def clear(self):
        self._entries.clear()
        self.bytes = 0
