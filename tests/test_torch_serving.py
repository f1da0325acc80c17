"""Serving through the PyTorch port's ``InferenceScheduler`` on the CPU
held against the JAX package's: the session's briefly-trained chain
(``spec_trained_chain``: d=16, 2 layers, vocab 12 — its confident
argmax keeps greedy decoding away from near-ties) is carried into the
port, both schedulers serve the same 4 concurrent greedy requests, and
the token streams must be IDENTICAL — over fp32 and int8 KV pools,
one-shot and chunked prefill, and with ``int8_decode``.  Both sides
decode with speculative decoding and the prefix cache off, so every
token after the first comes from one decode step
(``tests/test_torch_spec.py`` holds the spec-on streams,
``tests/test_torch_prefix.py`` the warm ones).  The port's paged cache
must be clean after ``close()``."""

import pytest

from veles_tpu.config import root

from tests.test_torch_transformer import port_chain

pytestmark = pytest.mark.torch_port

WINDOW, BLOCK, STEPS = 64, 16, 12


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


def _spec(fw, **block):
    """The port's layer spec of a JAX LM chain."""
    emb, blocks, head = fw[0], fw[1:-1], fw[-1]
    spec = [{"type": "embedding", "vocab": emb.vocab, "dim": emb.dim}]
    spec += [dict({"type": "transformer_block", "heads": u.heads,
                   "causal": True}, **block) for u in blocks]
    return spec + [{"type": "token_logits", "vocab": head.vocab}]


def _prompts(pattern):
    # 20 tokens exceed the 16-token chunk (chunked path); the others
    # prefill one-shot
    return [(pattern * 4)[o:o + n]
            for o, n in ((0, 5), (2, 12), (1, 20), (3, 3))]


def _serve_jax(fw, prompts, kv_dtype, chunk):
    from veles_tpu.serving import InferenceScheduler
    sch = InferenceScheduler(
        fw, max_slots=4, window=WINDOW, kv="paged", block_size=BLOCK,
        kv_dtype=kv_dtype, prefill_chunk=chunk, spec=False,
        prefix_cache=False, warm_buckets=False).start()
    try:
        futs = [sch.submit(p, STEPS, seed=0) for p in prompts]
        return [f.result(240) for f in futs]
    finally:
        sch.close()


def _serve_port(chain, prompts, kv_dtype, chunk):
    from veles_tpu_torch.serving import InferenceScheduler
    sch = InferenceScheduler(
        chain, max_slots=4, window=WINDOW, block_size=BLOCK,
        kv_dtype=kv_dtype, prefill_chunk=chunk, spec=False,
        prefix_cache=False, device="cpu").start()
    try:
        futs = [sch.submit(p, STEPS, seed=0) for p in prompts]
        out = [f.result(240) for f in futs]
        assert sch.decode_steps >= STEPS - 1
        # every request's first token comes from its prefill, the rest
        # from decode steps
        assert sch.decode_tokens == len(prompts) * (STEPS - 1)
        assert len(sch.completed) == len(prompts)
        assert all(0 < ttft <= total for ttft, total in sch.completed)
    finally:
        sch.close()
    sch.check_kv()
    assert sch.cache_.free_slots == 4
    assert sch.cache_.free_blocks == sch.cache_.capacity_blocks
    return out


@pytest.mark.parametrize("chunk", [0, 16], ids=["oneshot", "chunked"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_greedy_streams_identical(f32, spec_trained_chain, kv_dtype,
                                  chunk):
    fw, pattern = spec_trained_chain
    prompts = _prompts(pattern)
    want = _serve_jax(fw, prompts, kv_dtype, chunk)
    got = _serve_port(port_chain(_spec(fw), fw), prompts, kv_dtype, chunk)
    assert [len(g) for g in got] == [len(p) + STEPS for p in prompts]
    assert got == want


def test_greedy_streams_identical_int8_decode(f32, spec_trained_chain):
    """int8 pools with the weight-only int8 decode matmuls on both
    sides (the slice's configuration)."""
    fw, pattern = spec_trained_chain
    prompts = _prompts(pattern)
    blocks = [u for u in fw if hasattr(u, "init_cache")]
    for u in blocks:
        u.int8_decode = True
    try:
        want = _serve_jax(fw, prompts, "int8", 16)
    finally:
        for u in blocks:
            u.int8_decode = False
    got = _serve_port(port_chain(_spec(fw, int8_decode=True), fw),
                      prompts, "int8", 16)
    assert got == want


@pytest.mark.parametrize("bucket", [16, 32])
def test_prefill_bucket_matches_reference(f32, spec_trained_chain, bucket):
    """Fault C7: the port's scheduler takes the reference's
    ``prefill_bucket`` and ``warm_buckets``.  At ``prefill_bucket`` 16
    and 32 (``warm_buckets=False`` on both sides) the staging widths equal
    the reference's for every prompt length, one-shot and chunked, and
    the greedy streams, the chunk counters of ``metrics()`` and a clean
    ``check_kv()`` equal the reference's."""
    from veles_tpu.serving import InferenceScheduler as JaxScheduler
    from veles_tpu_torch.serving import InferenceScheduler
    fw, pattern = spec_trained_chain
    chain = port_chain(_spec(fw), fw)
    kw = dict(max_slots=4, window=WINDOW, kv="paged", block_size=BLOCK,
              prefill_chunk=16, spec=False, prefix_cache=False,
              prefill_bucket=bucket, warm_buckets=False)
    jsch = JaxScheduler(fw, **kw)
    sch = InferenceScheduler(chain, device="cpu", **kw)
    assert (sch.prefill_bucket, sch.warm_buckets) == (bucket, False)
    for p_len in range(1, WINDOW):
        for chunk in (0, 16):
            assert sch._staging_width(p_len, chunk) \
                == jsch._staging_width(p_len, chunk), (p_len, chunk)
    prompts = _prompts(pattern)
    out = {}
    for name, s in (("jax", jsch), ("port", sch)):
        s.start()
        try:
            futs = [s.submit(p, STEPS, seed=0) for p in prompts]
            streams = [f.result(240) for f in futs]
            m = s.metrics()
        finally:
            s.close()
        s.check_kv()
        out[name] = (streams, m["prefill_chunks"], m["prefill_chunk_tokens"])
    assert out["port"] == out["jax"]
    assert out["port"][2] > 0
