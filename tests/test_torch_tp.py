"""Tensor-parallel serving in the PyTorch port (``serving/tp.py``, the
blocks' Megatron layout, the head-wise paged pools, the engine's and
prefill's per-shard bodies, the scheduler's ``tp`` gates and
``RESTfulAPI(serving_tp=)``) held against the JAX package on the CPU,
on the suite's trained chain carried into the port.  The JAX side runs
on 2 of the suite's 8 virtual devices, the port on 2 positions sharing
the CPU.

The oracle is ``tests/test_tp.py``: the port's ``tp=2`` streams equal
the JAX package's ``tp=2`` streams and the port's ``tp=0`` streams —
greedy and seeded sampling, chunked prefill, spec verify, int8 pools,
preempt→resume, the model drafter (against JAX under ``tp_overlap``) —
exactly; per position ``kv_bytes_per_token`` is the reference's
``bytes_per_token`` at tp 2 (half of tp 0's for fp32 pools); a chain
over a per-position byte budget at tp 0 fits it at tp 2; the gates
serve unsharded and report ``tp`` 0 where the reference's do."""

import json
import time
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.config import root

from tests.test_torch_serving import _spec
from tests.test_torch_transformer import port_chain

pytestmark = pytest.mark.torch_port


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture
def positions():
    from veles_tpu_torch.parallel.mesh import set_positions_per_device
    old = set_positions_per_device(2)
    yield
    set_positions_per_device(old)


@pytest.fixture(scope="module")
def trained(spec_trained_chain):
    fw, pattern = spec_trained_chain
    return fw, pattern, port_chain(_spec(fw), fw)


def _port_run(chain, submits, check=True, **kw):
    from veles_tpu_torch.serving import InferenceScheduler
    kw.setdefault("max_slots", 3)
    kw.setdefault("window", 64)
    sch = InferenceScheduler(chain, warm_buckets=False, device="cpu",
                             **kw).start()
    try:
        outs = [list(f.result(240)) for f in [
            sch.submit(p, steps, **skw) for p, steps, skw in submits]]
        if check:
            sch.check_kv()
        return outs, sch.metrics()
    finally:
        sch.close()


def _jax_run(fw, submits, **kw):
    from tests.test_tp import _run
    outs, snap = _run(fw, submits, check=True, **kw)
    return [list(o) for o in outs], snap


def _submits(pattern):
    prompts = [(pattern * 2)[:12], [5, 2] * 5, [7] * 5]
    subs = [(p, 10, dict(seed=0)) for p in prompts]
    return subs + [(p, 8, dict(temperature=0.9, top_k=5, seed=41 + i))
                   for i, p in enumerate(prompts)]


def test_tp_specs_and_gates(f32, positions, trained):
    from veles_tpu.serving import tp_supported as jax_supported
    from veles_tpu_torch.parallel.mesh import set_positions_per_device
    from veles_tpu_torch.serving import InferenceScheduler
    from veles_tpu_torch.serving.tp import tp_supported
    fw, _, chain = trained
    block, jblock = chain[1], fw[1]
    for tp in (2, 3, 4):
        assert block.tp_shardable(tp) == jblock.tp_shardable(tp)
        assert tp_supported(chain, tp) == jax_supported(fw, tp)
    for name in block.params:
        want = jblock.tp_param_spec(name, 2)
        got = block.tp_param_spec(name, 2)
        assert (got is None) == (want is None), name
        if got is not None:
            assert tuple(got) == tuple(want), name
    kw = dict(max_slots=2, window=64, warm_buckets=False, device="cpu")
    sch = InferenceScheduler(chain, tp=3, **kw)
    assert sch.tp == 0 and sch.tp_ is None and sch.metrics()["tp"] == 0
    assert InferenceScheduler(chain, tp=2, kv="dense", **kw).tp == 0
    old = set_positions_per_device(1)        # one position: too few
    try:
        assert InferenceScheduler(chain, tp=2, **kw).tp == 0
    finally:
        set_positions_per_device(old)
    moe = port_chain(_spec(fw), fw)
    moe[1].n_experts = 2                     # a MoE block opts out
    assert not moe[1].tp_shardable(2)
    chain[2].int8_decode = True              # so does int8_decode
    try:
        assert InferenceScheduler(chain, tp=2, **kw).tp == 0
    finally:
        chain[2].int8_decode = False
    assert InferenceScheduler(chain, tp=2, **kw).tp == 2


def test_tp2_stream_parity(f32, positions, trained):
    """Greedy and seeded streams through chunked prefill and spec verify:
    the port's tp=2 = JAX's tp=2 = the port's tp=0; per-position bytes
    per token halve, equal to the JAX gauge."""
    fw, pattern, chain = trained
    submits = _submits(pattern)
    kw = dict(kv="paged", block_size=4, prefill_chunk=4, spec=True,
              spec_k=3, prefix_cache=False)
    want, jsnap = _jax_run(fw, submits, tp=2, **kw)
    base, snap0 = _port_run(chain, submits, tp=0, **kw)
    got, snap2 = _port_run(chain, submits, tp=2, **kw)
    assert got == want == base
    assert (snap0["tp"], snap2["tp"], jsnap["tp"]) == (0, 2, 2)
    assert snap2["kv_bytes_per_token"] == jsnap["kv_bytes_per_token"] \
        == snap0["kv_bytes_per_token"] // 2
    assert snap2["spec_drafted_tokens"] > 0


def test_tp2_overlap_with_model_drafter(f32, positions, trained,
                                        spec_trained_head):
    """tp=2 with the model drafter (the hidden lane through the
    per-shard body) = the port's tp=0 spec-off run = JAX's tp=2 run
    under its overlap gate.  The port has one per-shard step, so it
    takes no overlap knob: ``root.common.serving.tp_overlap`` reaches
    neither the scheduler nor the REST server (ROADMAP §C)."""
    import inspect
    from tests.test_torch_draft import _port_head
    from veles_tpu_torch.restful_api import RESTfulAPI
    from veles_tpu_torch.serving import InferenceScheduler
    fw, pattern, chain = trained
    jhead, _ = spec_trained_head
    prompts = [(pattern * 2)[:12], [5, 2] * 5]
    submits = [(p, 10, dict(seed=0)) for p in prompts]
    submits += [(p, 8, dict(temperature=0.9, top_k=5, seed=41 + i))
                for i, p in enumerate(prompts)]
    kw = dict(kv="paged", block_size=4, prefill_chunk=4, spec=True,
              spec_k=4, drafter="model", prefix_cache=False)
    base, _ = _port_run(chain, submits, tp=0, kv="paged", block_size=4,
                        prefill_chunk=4, spec=False, prefix_cache=False)
    root.common.serving.tp_overlap = True
    try:
        want, _ = _jax_run(fw, submits, tp=2, draft_head=jhead, **kw)
    finally:
        root.common.serving.tp_overlap = False
    got, snap = _port_run(chain, submits, tp=2,
                          draft_head=_port_head(jhead), **kw)
    assert got == base == want
    assert snap["tp"] == 2 and snap["drafter"] == "model"
    assert snap["spec_accept_rate_by_drafter"].get("model") is not None
    assert "tp_overlap" not in inspect.signature(
        InferenceScheduler).parameters
    assert "tp_overlap" not in RESTfulAPI.SERVING_KNOBS


def test_tp2_int8_parity(f32, positions, trained):
    """int8 pools: each block takes the whole row's amax across the
    positions before quantizing, so the first block's pools hold the
    unsharded pool's bytes (later blocks' inputs carry the tp
    reduction's rounding) and the streams equal tp=0's and JAX's
    tp=2."""
    from veles_tpu_torch.serving.kv_slots import PagedKVCache
    from veles_tpu_torch.serving.tp import ServingTP
    from veles_tpu_torch.serving.engine import paged_decode_step
    fw, pattern, chain = trained
    submits = [((pattern * 2)[:10], 10, dict(seed=0)),
               ([5, 2] * 4, 8, dict(temperature=0.8, top_k=4, seed=9))]
    kw = dict(kv="paged", block_size=4, prefill_chunk=4, kv_dtype="int8",
              spec=False, max_slots=2, prefix_cache=False)
    want, jsnap = _jax_run(fw, submits, tp=2, **kw)
    base, snap0 = _port_run(chain, submits, tp=0, **kw)
    got, snap2 = _port_run(chain, submits, tp=2, **kw)
    assert got == want == base
    assert snap2["kv_bytes_per_token"] == jsnap["kv_bytes_per_token"] \
        < snap0["kv_bytes_per_token"]
    # one decode step into both layouts: the same int8 bytes and scales
    caches = [PagedKVCache(chain, 2, 64, 4, kv_dtype="int8"),
              PagedKVCache(chain, 2, 64, 4, kv_dtype="int8",
                           tp=ServingTP(2, ["cpu", "cpu"]))]
    for c in caches:
        c.alloc(12)
        c.alloc(12)
        paged_decode_step(chain, c, [[3], [5]], [2, 7], c.table_rows(
            [0, 1], 3), [0, 0], [0, 0], [0, 0], [0, 0])
    ids = [int(b) for b in caches[0].tables[:2, :3].reshape(-1)]
    a, b = (c.export_blocks(ids) for c in caches)
    # the first block's rows are the same K/V: the same bytes; a later
    # block's input went through the tp reduction (its own rounding)
    for name in a[1]:
        assert numpy.array_equal(a[1][name], b[1][name]), name
    for i in a:
        for name in ("k", "v"):
            numpy.testing.assert_allclose(
                a[i][name] * a[i][name + "_scale"][..., None],
                b[i][name] * b[i][name + "_scale"][..., None],
                rtol=0, atol=2 * a[i][name + "_scale"].max())


def test_tp2_preempt_resume_parity(f32, positions, trained):
    from veles_tpu_torch.serving import InferenceScheduler
    fw, pattern, chain = trained
    jobs = [((pattern * 2)[:7], dict(seed=0)),
            ([7, 2] * 4, dict(temperature=0.9, top_k=5, seed=123))]

    def run(preempt):
        sch = InferenceScheduler(chain, max_slots=2, window=64, kv="paged",
                                 block_size=4, prefill_chunk=4, tp=2,
                                 warm_buckets=False, device="cpu").start()
        try:
            futs = [sch.submit(p, 16, **kw) for p, kw in jobs]
            if preempt:
                deadline = time.monotonic() + 60
                while sch.metrics()["slot_busy_steps"] < 4:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                sch.request_preempt()
            outs = [list(f.result(240)) for f in futs]
            snap = sch.metrics()
            sch.check_kv()
            return outs, snap
        finally:
            sch.close()

    base, _ = run(False)
    got, snap = run(True)
    assert snap["preempts"] >= 1 and snap["tp"] == 2
    assert got == base
    want, _ = _jax_run(fw, [(p, 16, kw) for p, kw in jobs], tp=2,
                       max_slots=2, kv="paged", block_size=4,
                       prefill_chunk=4)
    assert got == want


def test_tp_serves_wider_model_at_fixed_budget(f32, positions):
    """A chain whose blocks' weights and pools overflow a per-position
    budget at tp 0 fit it at tp 2 and serve the same stream."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.serving import InferenceScheduler, per_chip_bytes
    from veles_tpu_torch.serving.tp import chain_params
    spec = [{"type": "embedding", "vocab": 16, "dim": 64}]
    spec += [{"type": "transformer_block", "heads": 4, "causal": True}
             for _ in range(2)]
    spec += [{"type": "token_logits", "vocab": 16}]
    chain = init_params(spec, 77, window=32, device="cpu", dtype="float32")
    kw = dict(max_slots=2, window=32, kv="paged", block_size=8,
              kv_blocks=8, prefill_chunk=0, spec=False, prefix_cache=False,
              warm_buckets=False, device="cpu")

    def footprint(tp):
        sch = InferenceScheduler(chain, tp=tp, **kw).start()
        try:
            assert sch.tp == tp
            total = per_chip_bytes({"params": chain_params(chain, sch.tp_),
                                    "pools": sch.cache_.pools})
            out = list(sch.submit([3, 1, 4, 1], 6, seed=0).result(240))
            sch.check_kv()
            return total, out
        finally:
            sch.close()

    one, out1 = footprint(0)
    two, out2 = footprint(2)
    assert out2 == out1
    budget = (one + two) // 2
    assert one > budget >= two


def test_rest_serving_tp(f32, positions, trained):
    """``RESTfulAPI(serving_tp=2)`` serves ``/generate`` replies equal
    to the tp=0 scheduler's streams and reports ``tp`` 2 in
    ``/serving/metrics`` and ``/healthz``."""
    from veles_tpu_torch.restful_api import RESTfulAPI
    fw, pattern, chain = trained
    prompt = (pattern * 2)[:9]
    base, _ = _port_run(chain, [(prompt, 8, dict(seed=0))], tp=0,
                        kv="paged", block_size=4, prefill_chunk=4,
                        spec=True, spec_k=4)
    api = RESTfulAPI(None, forwards=chain, port=0, serving_tp=2,
                     serving_block_size=4, serving_prefill_chunk=4,
                     serving_spec=True, serving_spec_k=4, device="cpu")
    api.initialize()
    try:
        url = "http://127.0.0.1:%d" % api.port
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(
                {"prompt": prompt, "steps": 8}).encode(),
            headers={"Content-Type": "application/json"})
        reply = json.loads(urllib.request.urlopen(req, timeout=120).read())
        got = reply.get("tokens", reply.get("output"))
        assert list(got)[-8:] == base[0][-8:]
        metrics = json.loads(urllib.request.urlopen(
            url + "/serving/metrics", timeout=60).read())
        assert metrics["tp"] == 2
        health = json.loads(urllib.request.urlopen(
            url + "/healthz", timeout=60).read())
        assert health["tp"] == 2
    finally:
        api.stop()


def test_tp2_prefix_cache_and_block_movers(f32, positions, trained):
    """Under tp=2 a resubmitted prompt admits warm through the prefix
    cache (its shared blocks gathered whole from the positions' columns)
    and streams as at tp 0; blocks exported from an unsharded cache and
    imported into a tp=2 one (the host tier's and disaggregation's
    movers) read back the same bytes, scales included."""
    from veles_tpu_torch.serving.kv_slots import PagedKVCache
    from veles_tpu_torch.serving.tp import ServingTP
    fw, pattern, chain = trained
    prompt = (pattern * 3)[:17]
    submits = [(prompt, 6, dict(seed=0)), (prompt, 6, dict(seed=0)),
               (prompt[:9], 6, dict(temperature=0.9, top_k=5, seed=3))]
    kw = dict(kv="paged", block_size=4, prefill_chunk=4, spec=False,
              max_slots=1, prefix_cache=True)
    base, snap0 = _port_run(chain, submits, tp=0, **kw)
    got, snap2 = _port_run(chain, submits, tp=2, **kw)
    assert got == base
    assert snap2["prefix_cache_hits"] == snap0["prefix_cache_hits"] >= 1
    rng = numpy.random.default_rng(5)
    for kv_dtype in ("fp32", "int8"):
        flat = PagedKVCache(chain, 1, 64, 4, kv_dtype=kv_dtype)
        split = PagedKVCache(chain, 1, 64, 4, kv_dtype=kv_dtype,
                             tp=ServingTP(2, ["cpu", "cpu"]))
        ids = [3, 7, 1]
        for layer in flat.pools.values():
            for name, t in layer.items():
                t.copy_(torch.as_tensor(rng.standard_normal(
                    tuple(t.shape)) * 50).to(t.dtype))
        record = flat.export_blocks(ids)
        split.import_blocks(ids, record)
        back = split.export_blocks(ids)
        for i in record:
            for name in record[i]:
                assert numpy.array_equal(back[i][name], record[i][name])
        assert split.take_free_blocks(2) is not None
