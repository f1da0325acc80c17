"""The port's ``InferenceScheduler`` reads ``root.common.serving`` for
every knob left None, as the JAX package's does (fault C9).

Each case sets one or more of the 22 keys in BOTH packages' trees,
builds ``InferenceScheduler(chain)`` with no knob in each on a tiny LM
chain (the same weights, carried over), and compares the 22 attributes
the two constructors settle on.  Both trees are restored after each
case.  The reference's fallbacks where the tree lacks a key are held
too: ``spec`` and ``prefix_cache`` read False there while the tree's
default is True.  An explicit argument still wins over the tree.
Schedulers are built and never started: the constructor alone decides
the attributes."""

import pytest

from veles_tpu.config import root as jax_root

from tests.test_torch_transformer import jax_chain, lm_spec, port_chain

pytestmark = pytest.mark.torch_port

#: the tree keys and the attribute each one settles (the same name)
KEYS = ("kv", "block_size", "kv_blocks", "kv_dtype", "prefill_chunk",
        "warm_buckets", "request_timeout", "watchdog",
        "shed_block_factor", "spec", "spec_k", "drafter", "draft_k_min",
        "draft_ema", "draft_shrink", "draft_grow", "prefix_cache",
        "prefix_evict", "role", "kv_host_bytes", "kv_export_bytes", "tp")

#: one value per key, each away from both trees' defaults
CASES = {
    "kv": "dense",
    "block_size": 8,
    "kv_blocks": 40,
    "kv_dtype": "int8",
    "prefill_chunk": 32,
    "warm_buckets": False,
    "request_timeout": 7.5,
    "watchdog": 0.0,
    "shed_block_factor": 2.0,
    "spec": False,
    "spec_k": 2,
    "drafter": "model",
    "draft_k_min": 2,
    "draft_ema": 0.25,
    "draft_shrink": 0.3,
    "draft_grow": 0.9,
    "prefix_cache": False,
    "prefix_evict": False,
    "role": "decode",
    "kv_host_bytes": 1 << 20,
    "kv_export_bytes": 1 << 22,
    "tp": 2,
}

#: the delta that fault C9 showed: the reference read int8, False, 8
#: and 0 from such a tree, the port fp32, True, 16 and 64
C9_DELTA = {"kv_dtype": "int8", "spec": False, "block_size": 8,
            "prefill_chunk": 0}


def _save(node):
    return {k: v for k, v in vars(node).items()
            if not (k.startswith("_") and k.endswith("_"))}


def _restore(node, saved):
    for k in [k for k in vars(node)
              if not (k.startswith("_") and k.endswith("_"))]:
        if k not in saved:
            delattr(node, k)
    for k, v in saved.items():
        setattr(node, k, v)


@pytest.fixture(scope="module")
def chains():
    from veles_tpu import prng
    saved = jax_root.common.precision.get("compute_dtype", "bfloat16")
    jax_root.common.precision.compute_dtype = "float32"
    try:
        spec = lm_spec()
        # the chain's weights are drawn from the JAX package's process
        # generator: leave it as the tests after this file expect it
        with prng.get().preserve_state():
            fw = jax_chain(spec)
        return fw, port_chain(spec, fw)
    finally:
        jax_root.common.precision.compute_dtype = saved


@pytest.fixture
def trees():
    """Both packages' serving trees, restored after the case; the port
    offers 2 positions per device so ``tp=2`` can pass its gate, as the
    JAX side has the suite's 8 virtual devices."""
    from veles_tpu_torch.config import root as port_root
    from veles_tpu_torch.parallel.mesh import set_positions_per_device
    nodes = (jax_root.common.serving, port_root.common.serving)
    saved = [_save(n) for n in nodes]
    old = set_positions_per_device(2)
    try:
        yield nodes
    finally:
        set_positions_per_device(old)
        for n, s in zip(nodes, saved):
            _restore(n, s)


def _attrs(sch):
    return {k: getattr(sch, k) for k in KEYS}


def _build(chains, **kw):
    from veles_tpu.serving import InferenceScheduler as JaxScheduler
    from veles_tpu_torch.serving import InferenceScheduler
    fw, chain = chains
    jax_sch = JaxScheduler(fw, max_slots=2, **kw)
    port_sch = InferenceScheduler(chain, max_slots=2, device="cpu", **kw)
    return _attrs(jax_sch), _attrs(port_sch)


@pytest.mark.parametrize("key", KEYS)
def test_tree_key_read_as_reference(chains, trees, key):
    for node in trees:
        node.update({key: CASES[key]})
    want, got = _build(chains)
    assert got == want
    # every gate passes on this chain: the value set is the value read
    # (a "model" drafter without a draft head is n-gram in both)
    assert got[key] == ("ngram" if key == "drafter" else CASES[key])


def test_tree_defaults_read_as_reference(chains, trees):
    want, got = _build(chains)
    assert got == want
    assert got["spec"] is True and got["prefix_cache"] is True


def test_c9_delta(chains, trees):
    """The tree of the fault's report: the port read fp32, True, 16 and
    64 from it before the fix; both now read int8, False, 8 and 0."""
    for node in trees:
        node.update(C9_DELTA)
    want, got = _build(chains)
    assert got == want
    assert {k: got[k] for k in C9_DELTA} == C9_DELTA


def test_absent_keys_take_reference_fallbacks(chains, trees):
    """With ``spec`` and ``prefix_cache`` missing from the tree, both
    fall back to False (the tree itself says True)."""
    for node in trees:
        delattr(node, "spec")
        delattr(node, "prefix_cache")
    want, got = _build(chains)
    assert got == want
    assert got["spec"] is False and got["prefix_cache"] is False


def test_explicit_argument_wins(chains, trees):
    for node in trees:
        node.update(dict(C9_DELTA, tp=2, watchdog=9.0))
    explicit = {"kv_dtype": "fp32", "spec": True, "block_size": 16,
                "prefill_chunk": 64, "tp": 0, "watchdog": 0}
    want, got = _build(chains, **explicit)
    assert got == want
    assert got["kv_dtype"] == "fp32" and got["spec"] is True
    assert got["block_size"] == 16 and got["prefill_chunk"] == 64
    assert got["tp"] == 0 and got["watchdog"] == 0.0
