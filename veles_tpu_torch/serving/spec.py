"""Speculative decoding: the n-gram / prompt-lookup draft proposer and
the acceptance rule — the port of ``veles_tpu/serving/spec.py`` (pure
Python; the port keeps its own copy).

Decode is one model pass per token.  Speculative decoding drafts ``k``
candidate tokens cheaply, scores the pending token plus all k drafts
in ONE batched verify pass
(:func:`veles_tpu_torch.serving.engine.verify_step_paged`) and keeps
the longest accepted prefix, so an iteration that accepts ``a`` drafts
emits ``a + 1`` tokens for one model pass.

The draft for the next tokens is whatever followed the most recent
earlier occurrence of the context's trailing n-gram.  Acceptance keeps
the emitted stream exactly the target model's (greedy and per-seed
sampling), and a draft that never matches degrades to plain decoding.
A per-request :class:`NgramIndex` turns the right-to-left rescan into
an O(max_ngram) lookup after an O(max_ngram)-per-token sync.
"""


class NgramIndex:
    """Incremental trailing-n-gram index over ONE request's append-only
    context: ``_last[gram] = (last_start, prev_start)``, the start
    offsets of the gram's most recent and second most recent
    occurrences (``None`` when it appeared once).  After :meth:`sync`
    the trailing gram's most recent occurrence is the tail itself, so
    ``prev_start`` is the most recent PRIOR occurrence the scanning
    proposer finds."""

    def __init__(self, max_ngram=3, min_ngram=1):
        self.max_ngram = int(max_ngram)
        self.min_ngram = max(1, int(min_ngram))
        self.n = 0          # context prefix already indexed
        self._last = {}

    def sync(self, context):
        """Fold newly appended tokens into the index; a context shorter
        than what was indexed was rewritten, so the index rebuilds."""
        if len(context) < self.n:
            self.n = 0
            self._last.clear()
        for i in range(self.n, len(context)):
            for g in range(self.min_ngram,
                           min(self.max_ngram, i + 1) + 1):
                s = i - g + 1
                gram = tuple(context[s:i + 1])
                prev = self._last.get(gram)
                self._last[gram] = (
                    s, prev[0] if prev is not None else None)
        self.n = len(context)

    def prior(self, gram):
        """Start offset of the most recent occurrence of ``gram`` before
        its trailing occurrence, or None."""
        entry = self._last.get(tuple(gram))
        return entry[1] if entry is not None else None


class NgramProposer:
    """Draft up to ``k`` tokens by prompt lookup: find the most recent
    earlier occurrence of the context's trailing ``n``-gram (longest n
    first, ``max_ngram`` down to ``min_ngram``) and propose the tokens
    that followed it."""

    def __init__(self, k=4, max_ngram=3, min_ngram=1):
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = max(1, int(min_ngram))
        if self.k < 1:
            raise ValueError("need k >= 1")
        if self.max_ngram < self.min_ngram:
            raise ValueError("max_ngram < min_ngram")

    def propose(self, context, max_tokens=None, index=None):
        """Draft tokens continuing ``context`` (the request's prompt and
        generated stream, a list of ints): at most ``min(k,
        max_tokens)`` ids, empty when the trailing n-gram never occurred
        before.  ``index`` (the request's :class:`NgramIndex`) gives the
        same drafts by lookup instead of a rescan."""
        limit = self.k if max_tokens is None \
            else min(self.k, int(max_tokens))
        n_ctx = len(context)
        if limit < 1 or n_ctx < self.min_ngram + 1:
            return []
        if index is not None:
            index.sync(context)
        for n in range(min(self.max_ngram, n_ctx - 1),
                       self.min_ngram - 1, -1):
            tail = context[n_ctx - n:]
            if index is not None:
                j = index.prior(tail)
                if j is not None:
                    cont = context[j + n:j + n + limit]
                    if cont:
                        return list(cont)
                continue
            # the most recent prior occurrence predicts best
            for j in range(n_ctx - n - 1, -1, -1):
                if context[j:j + n] == tail:
                    cont = context[j + n:j + n + limit]
                    if cont:
                        return list(cont)
        return []


def accept_drafts(drafts, sampled):
    """Given the ``drafts`` [d_1..d_m] a slot proposed and the
    ``sampled`` [s_0..s_m] tokens of its verify pass (s_j: the token
    sequential decode emits after the context extended by d_1..d_j),
    return the accepted run: s_0, then each s_j while every earlier
    draft matched its sample (d_i == s_{i-1}); the first mismatching
    position still contributes its sample (the correction) and the rest
    rolls back.  The run equals what spec-off decoding emits."""
    out = [int(sampled[0])]
    for j in range(1, len(drafts) + 1):
        if int(drafts[j - 1]) != out[-1]:
            break
        out.append(int(sampled[j]))
    return out
