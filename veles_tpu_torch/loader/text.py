"""Text corpus loading for language models (the port of
``veles_tpu/loader/text.py``): a trainable byte-level BPE vocabulary
and a full-batch window loader.

Byte-level BPE: the base alphabet is all 256 bytes, so any input
encodes without unknown tokens; merges are learned over
whitespace-delimited chunks (each chunk keeps its trailing whitespace,
so a detokenized stream round-trips exactly).  Optional ``specials``
reserve ids right after the byte alphabet — the encoder never emits
them; they exist for the caller (``<eos>`` pairs with
``generate(stop_token=vocab.special("<eos>"))``).  Merges, ids and the
saved JSON are the JAX package's for the same text.
"""

import collections
import json

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


def _chunks(text):
    """Whitespace-keeping pre-tokenization: every chunk is a word plus
    its trailing whitespace, so concat(chunks) == text exactly."""
    out, start = [], 0
    n = len(text)
    i = 0
    while i < n:
        while i < n and not text[i].isspace():
            i += 1
        while i < n and text[i].isspace():
            i += 1
        out.append(text[start:i])
        start = i
    return out


class BytePairVocab:
    """Byte-level BPE vocabulary: ids 0..255 are raw bytes, then
    ``specials``, then learned merges (rank order)."""

    #: bound on the per-chunk encode memo (LRU): a long-lived server
    #: encoding diverse text must not grow the cache without limit
    CACHE_LIMIT = 65536

    def __init__(self, merges, specials=()):
        #: merge list [(left_id, right_id)] in rank order; merged
        #: token i gets id base + i
        self.merges = [tuple(m) for m in merges]
        self.specials = tuple(specials)
        self._special_ids = {s: 256 + i
                             for i, s in enumerate(self.specials)}
        base = 256 + len(self.specials)
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        self._merged_id = {m: base + i for i, m in enumerate(self.merges)}
        #: id → bytes (specials decode to b"")
        toks = [bytes([i]) for i in range(256)]
        toks += [b"" for _ in self.specials]
        for left, right in self.merges:
            toks.append(toks[left] + toks[right])
        self._bytes = toks
        self._cache = collections.OrderedDict()

    # -- construction --------------------------------------------------------

    @classmethod
    def train(cls, text, vocab_size, specials=(), min_freq=2):
        """Learn merges on ``text`` until the vocab reaches
        ``vocab_size`` (or no pair clears ``min_freq``).

        Pair counts are maintained INCREMENTALLY: each merge still
        scans the chunk vocabulary for containment (O(unique chunks)
        per merge), but only the words that actually contain the
        merged pair are re-tokenized and have their pair counts
        adjusted — far cheaper than a full corpus re-count per merge,
        so training a 512-token vocab on a multi-megabyte corpus
        stays seconds."""
        base = 256 + len(specials)
        if vocab_size < base:
            raise ValueError(
                "vocab_size %d < %d (256 bytes + %d specials)"
                % (vocab_size, base, len(specials)))
        freqs = collections.Counter(_chunks(text))
        words = {w: tuple(w.encode("utf-8")) for w in freqs}
        pair_counts = collections.Counter()
        for w, f in freqs.items():
            seq = words[w]
            for a, b in zip(seq, seq[1:]):
                pair_counts[(a, b)] += f
        merges = []
        while base + len(merges) < vocab_size and pair_counts:
            pair, count = pair_counts.most_common(1)[0]
            if count < min_freq:
                break
            new_id = base + len(merges)
            merges.append(pair)
            for w, f in freqs.items():
                seq = words[w]
                if len(seq) < 2:
                    continue
                # fast containment scan before any rebuilding
                hit = False
                for i in range(len(seq) - 1):
                    if seq[i] == pair[0] and seq[i + 1] == pair[1]:
                        hit = True
                        break
                if not hit:
                    continue
                for a, b in zip(seq, seq[1:]):
                    pair_counts[(a, b)] -= f
                out, i = [], 0
                while i < len(seq):
                    if i + 1 < len(seq) and (seq[i], seq[i + 1]) == pair:
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(seq[i])
                        i += 1
                words[w] = tuple(out)
                for a, b in zip(out, out[1:]):
                    pair_counts[(a, b)] += f
            pair_counts = +pair_counts  # drop zero/negative entries
        return cls(merges, specials)

    # -- io ------------------------------------------------------------------

    def save(self, path):
        with open(path, "w") as f:
            json.dump({"merges": self.merges,
                       "specials": list(self.specials)}, f)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            d = json.load(f)
        return cls(d["merges"], d.get("specials", ()))

    # -- encoding ------------------------------------------------------------

    @property
    def size(self):
        return 256 + len(self.specials) + len(self.merges)

    def special(self, name):
        return self._special_ids[name]

    def _encode_chunk(self, chunk):
        ids = self._cache.get(chunk)
        if ids is not None:
            self._cache.move_to_end(chunk)
            return ids
        seq = list(chunk.encode("utf-8"))
        while len(seq) > 1:
            # merge the lowest-rank pair present (standard BPE encode)
            best, best_rank = None, None
            for a, b in zip(seq, seq[1:]):
                r = self._ranks.get((a, b))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = (a, b), r
            if best is None:
                break
            nid = self._merged_id[best]
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and (seq[i], seq[i + 1]) == best:
                    out.append(nid)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seq = out
        self._cache[chunk] = seq
        if len(self._cache) > self.CACHE_LIMIT:
            self._cache.popitem(last=False)  # evict least-recent
        return seq

    def encode(self, text):
        """text → list of ids (never emits specials; no unknowns —
        the byte alphabet covers everything)."""
        ids = []
        for chunk in _chunks(text):
            ids.extend(self._encode_chunk(chunk))
        return ids

    def decode(self, ids):
        """ids → text (specials decode to nothing; invalid utf-8 from
        a truncated window decodes with replacement)."""
        return b"".join(self._bytes[int(i)]
                        for i in ids).decode("utf-8", "replace")


class FullBatchTextLM(FullBatchLoader):
    """Sliding windows of BPE token ids over a text corpus —
    ``[n_windows, seq_len]`` int32, ready for ``loss="next_token"``.

    The vocabulary is trained on the corpus itself unless one is
    passed in (``vocab=``) or loadable from ``vocab_path``.  Windows
    are laid out valid-first (``class_lengths`` convention: test,
    valid, train), with the validation share taken from the corpus
    TAIL so it is never seen in training windows."""

    def __init__(self, workflow=None, path=None, text=None, vocab=None,
                 vocab_path=None, vocab_size=512, seq_len=64,
                 stride=None, valid_fraction=0.1, specials=("<eos>",),
                 **kwargs):
        super(FullBatchTextLM, self).__init__(workflow, **kwargs)
        if (path is None) == (text is None):
            raise ValueError("pass exactly one of path= or text=")
        self.path = path
        self.text = text
        self.vocab = vocab
        self.vocab_path = vocab_path
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.stride = int(stride) if stride else int(seq_len)
        self.valid_fraction = float(valid_fraction)
        self.specials = tuple(specials)

    def load_data(self):
        text = self.text
        if text is None:
            with open(self.path, encoding="utf-8") as f:
                text = f.read()
        if self.vocab is None:
            import os
            if self.vocab_path and os.path.exists(self.vocab_path):
                self.vocab = BytePairVocab.load(self.vocab_path)
            else:
                self.vocab = BytePairVocab.train(
                    text, self.vocab_size, specials=self.specials)
                if self.vocab_path:
                    # persist the artifact: decoding a served model's
                    # token replies needs this file client-side
                    self.vocab.save(self.vocab_path)
        ids = numpy.asarray(self.vocab.encode(text), numpy.int32)
        if ids.size < self.seq_len + 1:
            raise ValueError(
                "corpus shorter than one %d-token window" % self.seq_len)

        def windows(stream):
            if stream.size < self.seq_len:
                return numpy.zeros((0, self.seq_len), numpy.int32)
            starts = range(0, stream.size - self.seq_len + 1,
                           self.stride)
            return numpy.stack([stream[s:s + self.seq_len]
                                for s in starts])

        if self.valid_fraction > 0:
            # split the TOKEN STREAM before windowing: overlapping
            # windows across the boundary would leak training tokens
            # into validation when stride < seq_len
            n_valid_tok = max(self.seq_len,
                              int(round(ids.size * self.valid_fraction)))
            split = ids.size - n_valid_tok
            if split < self.seq_len:
                raise ValueError(
                    "corpus too small for the requested split")
            train_w = windows(ids[:split])
            valid_w = windows(ids[split:])
        else:
            train_w = windows(ids)
            valid_w = numpy.zeros((0, self.seq_len), numpy.int32)
        # layout is valid-first (test, valid, train convention)
        self.original_data = numpy.concatenate([valid_w, train_w])
        self.class_lengths[:] = [0, len(valid_w), len(train_w)]
        self.original_labels = [0] * (len(valid_w) + len(train_w))
