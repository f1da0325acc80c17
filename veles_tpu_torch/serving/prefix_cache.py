"""Cross-request radix prefix cache over the paged KV block pools — the
port's own copy of ``veles_tpu/serving/prefix_cache.py`` (pure Python,
no tensors).

SGLang-lineage (RadixAttention, Zheng et al.): finished requests
DONATE the KV blocks of their prompt + generated stream into a trie
keyed on ``block_size``-token chunks, and a joining request walks the
trie with its prompt — every matched chunk is a block of K/V it does
not have to prefill and does not have to claim from the free pool.

Ownership contract with :class:`~veles_tpu_torch.serving.kv_slots.
PagedKVCache`:

- blocks resident here are OUT of the cache's free list — the trie
  owns them (``resident_blocks()`` feeds ``PagedKVCache.check``);
- a match refcounts every node on the path; the scheduler releases
  the handle when the request leaves its slot.  Evicting a pinned
  block raises, and so does a double release;
- eviction is LRU over refcount-0 LEAVES only (an inner node is
  prefix state for its children), freeing blocks back to the pool
  under admission pressure;
- matched blocks head a slot's table READ-ONLY: the scheduler starts
  every write (cold-tail prefill, decode, verify) past the shared
  range, so sharing needs no copy-on-write.  The port's pools are
  written in place, so this is what keeps one request's writes out of
  the rows another request reads.

Single-threaded: the scheduler's loop owns every mutating call.
"""

import zlib


def chunk_digests(tokens, block_size, max_depth=None):
    """Rolling digests of ``tokens`` at block granularity: entry i is
    the crc32 of chunks 0..i chained (chunk i's canonical bytes,
    seeded with digest i-1) — the name of the prefix
    ``tokens[:(i + 1) * block_size]``."""
    bs = int(block_size)
    n = len(tokens) // bs
    if max_depth is not None:
        n = min(n, int(max_depth))
    out, d = [], 0
    for i in range(n):
        chunk = tokens[i * bs:(i + 1) * bs]
        d = zlib.crc32(
            (",".join(str(int(t)) for t in chunk)).encode("ascii"), d)
        out.append(d)
    return out


class _Node:
    __slots__ = ("key", "block", "refs", "children", "parent",
                 "stamp")

    def __init__(self, key, block, parent, stamp):
        self.key = key            # the block's block_size tokens
        self.block = int(block)   # physical block id it owns
        self.refs = 0             # active slots reading through it
        self.children = {}        # token-tuple -> _Node
        self.parent = parent
        self.stamp = stamp        # LRU tick of the last touch


class MatchHandle:
    """The pinned path a :meth:`RadixPrefixCache.match` returned: the
    matched nodes (refcounted until released), their block ids in
    prefix order."""

    __slots__ = ("nodes", "released")

    def __init__(self, nodes):
        self.nodes = nodes
        self.released = False

    @property
    def blocks(self):
        return [n.block for n in self.nodes]

    def __len__(self):
        return len(self.nodes)


class RadixPrefixCache:
    """Trie of donated KV blocks keyed on token-block boundaries."""

    def __init__(self, block_size):
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError("need block_size >= 1")
        self._root = {}           # token-tuple -> _Node
        self._clock = 0
        self._resident = 0        # owned blocks
        self.hits = 0             # matches with >= 1 block
        self.misses = 0
        self.hit_blocks = 0       # blocks served warm, cumulative
        self.evictions = 0        # blocks evicted, cumulative

    # -- reads -------------------------------------------------------------

    @property
    def resident(self):
        return self._resident

    def _nodes(self):
        stack = list(self._root.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def resident_blocks(self):
        """Every block id the trie owns (``PagedKVCache.check``)."""
        return [n.block for n in self._nodes()]

    def shared_blocks(self):
        """Blocks currently pinned by at least one request."""
        return sum(1 for n in self._nodes() if n.refs)

    def evictable_blocks(self):
        """How many blocks :meth:`evict` could free right now: every
        refcount-0 block whose subtree holds no pinned node (leaf
        eviction peels such a subtree bottom-up)."""
        def sweep(node):
            free, pinned = 0, node.refs > 0
            for c in node.children.values():
                f, p = sweep(c)
                free += f
                pinned = pinned or p
            if not pinned:
                free += 1
            return free, pinned
        return sum(sweep(n)[0] for n in self._root.values())

    def path_digests(self, max_entries=1024):
        """Rolling digests (:func:`chunk_digests`) of every resident
        path, breadth-first so the shallow (most shareable) prefixes
        survive the cap: the cache's advertisement of what it holds
        (``metrics()["prefix_digests"]``)."""
        out = []
        queue = [(0, n) for n in self._root.values()]
        while queue and len(out) < int(max_entries):
            next_q = []
            for seed, node in queue:
                d = zlib.crc32(
                    (",".join(str(int(t)) for t in node.key))
                    .encode("ascii"), seed)
                out.append(d)
                if len(out) >= int(max_entries):
                    break
                next_q.extend((d, c) for c in node.children.values())
            queue = next_q
        return out

    def peek(self, tokens, max_blocks=None):
        """How many leading blocks of ``tokens`` are resident —
        :meth:`match` without pinning (admission sizing)."""
        return len(self._walk(tokens, max_blocks))

    def resident_prefix(self, tokens, max_blocks=None):
        """Block ids of the resident leading chunks of ``tokens`` —
        :meth:`match` without pinning or hit/miss accounting."""
        return [n.block for n in self._walk(tokens, max_blocks)]

    # -- match / release ---------------------------------------------------

    def _chunks(self, tokens, max_blocks=None):
        bs = self.block_size
        n = len(tokens) // bs
        if max_blocks is not None:
            n = min(n, int(max_blocks))
        return [tuple(tokens[i * bs:(i + 1) * bs]) for i in range(n)]

    def _walk(self, tokens, max_blocks=None):
        nodes = []
        level = self._root
        for key in self._chunks(tokens, max_blocks):
            node = level.get(key)
            if node is None:
                break
            nodes.append(node)
            level = node.children
        return nodes

    def match(self, tokens, max_blocks=None):
        """Longest-prefix match at block granularity: a
        :class:`MatchHandle` whose blocks hold the K/V of
        ``tokens[:len(handle) * block_size]``, every matched node
        pinned until :meth:`release`.  ``max_blocks`` caps the walk
        (the scheduler leaves >= 1 cold token so the request still
        produces first-token logits)."""
        self._clock += 1
        nodes = self._walk(tokens, max_blocks)
        for n in nodes:
            n.refs += 1
            n.stamp = self._clock
        if nodes:
            self.hits += 1
            self.hit_blocks += len(nodes)
        else:
            self.misses += 1
        return MatchHandle(nodes)

    def release(self, handle):
        """Unpin a match.  Releasing twice — the shared-block double
        free — raises instead of corrupting refcounts."""
        if handle.released:
            raise ValueError("match handle double-released")
        handle.released = True
        for n in handle.nodes:
            if n.refs < 1:
                raise ValueError(
                    "shared block %d double-freed (refcount underflow)"
                    % n.block)
            n.refs -= 1

    # -- insert / evict ----------------------------------------------------

    def insert(self, tokens, block_ids):
        """Donate the blocks of a finished sequence: ``block_ids[i]``
        holds the K/V of token chunk i.  Chunks already resident keep
        their incumbent block — the donated duplicate is REJECTED and
        returned for the caller to free (``PagedKVCache.reclaim``);
        new chunks take ownership of their block.  Returns
        ``(taken, rejected)`` id lists."""
        self._clock += 1
        taken, rejected = [], []
        level, parent = self._root, None
        for key, bid in zip(self._chunks(tokens), block_ids):
            node = level.get(key)
            if node is None:
                node = _Node(key, bid, parent, self._clock)
                level[key] = node
                self._resident += 1
                taken.append(int(bid))
            else:
                node.stamp = self._clock
                if int(bid) != node.block:
                    rejected.append(int(bid))
            level, parent = node.children, node
        return taken, rejected

    def evict(self, n_blocks):
        """Free up to ``n_blocks`` blocks, LRU-first over refcount-0
        LEAVES (peeling a cold chain bottom-up); returns their ids for
        ``PagedKVCache.reclaim``."""
        return [bid for bid, _ in self.evict_with_paths(n_blocks)]

    def evict_with_paths(self, n_blocks):
        """:meth:`evict`, each freed block paired with the full token
        prefix it completed — ``[(block_id, path_tokens)]`` — so the
        host tier can key its contents before the block is reclaimed.
        Leaves are visited in the reference's order, so ties of the LRU
        stamp fall to the same victim."""
        freed = []
        while len(freed) < int(n_blocks):
            victim = None
            stack = [(None, self._root)]
            while stack:
                _, level = stack.pop()
                for node in level.values():
                    if not node.children and not node.refs \
                            and (victim is None
                                 or node.stamp < victim.stamp):
                        victim = node
                    stack.append((node, node.children))
            if victim is None:
                break
            path = self._path_tokens(victim)
            freed.append((self._evict_node(victim), path))
        return freed

    def _path_tokens(self, node):
        """The full token prefix a node's block completes."""
        keys = []
        while node is not None:
            keys.append(node.key)
            node = node.parent
        out = []
        for key in reversed(keys):
            out.extend(key)
        return tuple(out)

    def _evict_node(self, node):
        """Drop one node: a pinned or inner node is a programming
        error, loudly."""
        if node.refs:
            raise ValueError(
                "evicting block %d with %d live reference(s)"
                % (node.block, node.refs))
        if node.children:
            raise ValueError(
                "evicting inner block %d (%d children depend on it)"
                % (node.block, len(node.children)))
        level = self._root if node.parent is None \
            else node.parent.children
        level.pop(node.key, None)
        self._resident -= 1
        self.evictions += 1
        return node.block

    def clear(self):
        """Drop every unpinned subtree; returns the freed block ids.
        Pinned paths stay — their slots still read them."""
        freed = []
        while True:
            batch = self.evict(self._resident or 1)
            if not batch:
                return freed
            freed.extend(batch)
