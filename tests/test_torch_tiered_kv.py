"""The KV tiers of the PyTorch port held against the JAX package on the
CPU: the KV quality gate (``serving/kv_quality.kv_quant_quality``), the
handoff wire (``serving/disagg.py``, both forms, records crossing
between the packages), the host-RAM tier (``serving/kv_host.py`` and the
scheduler's demotion and promotion), the export table's byte cap and
TTL, disaggregated prefill/decode (``role``, ``submit_prefill``,
``kv_export``, ``submit_imported``) and prefix export/import, on the
suite's trained chain (``spec_trained_chain``) carried into the port.

Tolerances: the gate's cross-entropies within 1e-5, its top-1 agreement
exact; wire arrays, token streams, block counts and counters exact."""

import json

import numpy
import pytest

from veles_tpu.config import root

from tests.test_torch_serving import _spec
from tests.test_torch_transformer import port_chain

pytestmark = pytest.mark.torch_port

WINDOW = 64


@pytest.fixture
def f32():
    saved = root.common.precision.get("compute_dtype", "bfloat16")
    root.common.precision.compute_dtype = "float32"
    yield
    root.common.precision.compute_dtype = saved


@pytest.fixture(autouse=True)
def _no_faults():
    from veles_tpu_torch import faults
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def trained(spec_trained_chain):
    fw, pattern = spec_trained_chain
    return fw, pattern, port_chain(_spec(fw), fw)


def _sched(pkg, chain, **kw):
    """A scheduler of either package at the file's shapes (window 64,
    block 4, chunk 4, 2 slots); the caller starts and closes it."""
    kw = dict(dict(max_slots=2, window=WINDOW, kv="paged", block_size=4,
                   prefill_chunk=4, warm_buckets=False), **kw)
    if pkg == "jax":
        from veles_tpu.serving import InferenceScheduler
        return InferenceScheduler(chain, **kw)
    from veles_tpu_torch.serving import InferenceScheduler
    return InferenceScheduler(chain, device="cpu", **kw)


def _fake_record(dtype="float32", layers=2, blocks=3, bs=4, d=8,
                 logits=True, seed=0):
    rng = numpy.random.default_rng(seed)
    rec = {"handle": "h-test", "prompt": list(range(blocks * bs)),
           "length": blocks * bs,
           "kv_dtype": "int8" if dtype == "int8" else "fp32",
           "block_size": bs, "layers": {}}
    for i in range(layers):
        if dtype == "int8":
            row = {n: rng.integers(-127, 128, (blocks, bs, d))
                   .astype(numpy.int8) for n in ("k", "v")}
            row.update({n: rng.random((blocks, bs)).astype(numpy.float32)
                        for n in ("k_scale", "v_scale")})
        else:
            row = {n: rng.standard_normal((blocks, bs, d))
                   .astype(numpy.float32) for n in ("k", "v")}
        rec["layers"][i] = row
    if logits:
        rec["logits"] = rng.standard_normal(11).astype(numpy.float32)
    return rec


def _same_record(a, b):
    assert a["prompt"] == b["prompt"] and a["length"] == b["length"]
    assert (a["kv_dtype"], a["block_size"]) == (b["kv_dtype"],
                                                b["block_size"])
    assert ("logits" in a) == ("logits" in b)
    if "logits" in a:
        assert a["logits"].tobytes() == b["logits"].tobytes()
    assert set(a["layers"]) == set(b["layers"])
    for i, row in a["layers"].items():
        assert set(row) == set(b["layers"][i])
        for n, x in row.items():
            y = b["layers"][i][n]
            assert x.dtype == y.dtype and x.shape == y.shape, (i, n)
            assert x.tobytes() == y.tobytes(), (i, n)


# -- the quality gate ----------------------------------------------------------

@pytest.mark.parametrize("block", [8, 16, 32])
def test_kv_quant_quality_matches_reference(f32, trained, block):
    """The int8-KV gate's record equals the reference's (cross-entropies
    within 1e-5, agreement and positions exact) at block 8, 16 and 32 —
    a verify pass of ``block`` queries per row — and the delta is within
    the 0.05-nat tolerance."""
    from veles_tpu.serving.kv_quality import kv_quant_quality as jax_gate
    from veles_tpu_torch.serving.kv_quality import (
        KV_QUANT_CE_TOLERANCE, kv_quant_quality)
    fw, pattern, chain = trained
    rng = numpy.random.default_rng(8)
    seqs = [([p % 12 for p in pattern] * 8)[:64],
            rng.integers(0, 12, (64,)).tolist()]
    want = jax_gate(fw, seqs, block_size=block)
    got = kv_quant_quality(chain, seqs, block_size=block)
    assert set(got) == set(want)
    for key, value in want.items():
        if key.startswith("kv_quant_ce_") and key != "kv_quant_ce_tolerance":
            assert got[key] == pytest.approx(value, abs=1e-5), key
        else:
            assert got[key] == value, key
    assert got["kv_quant_within_tolerance"]
    assert got["kv_quant_ce_delta"] <= KV_QUANT_CE_TOLERANCE


# -- the wire ------------------------------------------------------------------

def test_wire_crosses_packages():
    """Records encoded by either package (the b64 JSON envelope and the
    VKV1 frame, fp32 and int8, with and without logits, an ``extra``
    dict) decode bit-identically in the other; a bfloat16 array of the
    reference's wire decodes to its exact float32 values; the frame is
    smaller than the envelope."""
    from veles_tpu.serving import disagg as jax_wire
    from veles_tpu_torch.serving import disagg
    for dtype in ("float32", "int8"):
        for logits in (True, False):
            rec = _fake_record(dtype=dtype, logits=logits)
            for enc, dec in ((disagg, jax_wire), (jax_wire, disagg)):
                blob = enc.encode_export_binary(rec, extra={"steps": 6})
                out, extra = dec.decode_export_binary(blob)
                assert extra == {"steps": 6}
                _same_record(out, rec)
                env = json.loads(json.dumps(enc.encode_export(rec)))
                _same_record(dec.decode_export(env), rec)
            assert disagg.encode_export_binary(rec) \
                == jax_wire.encode_export_binary(rec)
            assert disagg.record_nbytes(rec) == jax_wire.record_nbytes(rec)
    rec = _fake_record(blocks=8, d=16)
    assert len(disagg.encode_export_binary(rec)) \
        < 0.8 * len(json.dumps(disagg.encode_export(rec)))
    import ml_dtypes
    bf = _fake_record()
    for row in bf["layers"].values():
        for n in ("k", "v"):
            row[n] = row[n].astype(ml_dtypes.bfloat16)
    for out in (disagg.decode_export_binary(
            jax_wire.encode_export_binary(bf))[0],
            disagg.decode_export(json.loads(json.dumps(
                jax_wire.encode_export(bf))))):
        for i, row in bf["layers"].items():
            for n in ("k", "v"):
                assert out["layers"][i][n].dtype == numpy.float32
                assert numpy.array_equal(out["layers"][i][n],
                                         row[n].astype(numpy.float32))


def test_wire_rejects_malformed():
    """Both decoders refuse the same broken frames and envelopes."""
    from veles_tpu.serving import disagg as jax_wire
    from veles_tpu_torch.serving import disagg
    blob = disagg.encode_export_binary(_fake_record())
    for bad in (b"", b"XXXX" + blob[4:], blob[:20], blob[:-3],
                blob + b"\0"):
        for dec in (disagg, jax_wire):
            with pytest.raises(ValueError):
                dec.decode_export_binary(bad)
    for env in ({}, {"handle": "h"}, {"handle": "h", "prompt": 3,
                                      "length": 1, "kv_dtype": "fp32",
                                      "block_size": 4, "layers": {}}):
        for dec in (disagg, jax_wire):
            with pytest.raises(ValueError):
                dec.decode_export(env)


def test_quantize_record_matches_reference():
    """In-flight int8 quantization of a fp32 record equals the
    reference's; int8 records pass through."""
    from veles_tpu.serving import disagg as jax_wire
    from veles_tpu_torch.serving import disagg
    rec = _fake_record()
    _same_record(disagg.quantize_record(rec), jax_wire.quantize_record(rec))
    q8 = _fake_record("int8")
    assert disagg.quantize_record(q8) is q8


# -- the host tier -------------------------------------------------------------

def test_host_tier_put_match_pop_budget():
    """Demoted contents come back byte-identical (scales too) and are
    the tier's own copies; token verification turns a wrong path into a
    miss; the byte budget LRU-evicts; ``clear`` empties the bytes."""
    from veles_tpu_torch.serving import HostKVTier
    rng = numpy.random.default_rng(3)

    def one_block(seed):
        r = numpy.random.default_rng(seed)
        return {0: {"k": r.integers(-127, 128, (1, 4, 8)).astype(numpy.int8),
                    "k_scale": r.random((1, 4)).astype(numpy.float32)}}

    tier = HostKVTier(10 << 20, 4)
    path = tuple(rng.integers(0, 11, (8,)).tolist())
    layers = one_block(1)
    want = {n: a.copy() for n, a in layers[0].items()}
    assert tier.put(path, layers)
    layers[0]["k"][:] = 0                  # the tier holds its own copy
    assert not tier.put(path[:3], layers)  # unaligned
    got = tier.match(list(path) + [9, 9], 1)
    assert len(got) == 1
    for n, a in want.items():
        assert got[0].layers[0][n].tobytes() == a.tobytes()
    wrong = list(path[:4]) + [(t + 1) % 11 for t in path[4:]]
    assert tier.match(wrong, 1) == []
    tier.pop(got)
    assert tier.blocks == 0 and tier.promotions == 1 and tier.bytes == 0
    nbytes = sum(a.nbytes for a in want.values())
    tier = HostKVTier(2 * nbytes, 4)
    paths = [tuple(rng.integers(0, 11, (4,)).tolist()) for _ in range(3)]
    for i, p in enumerate(paths):
        assert tier.put(p, one_block(10 + i))
        tier.match(list(p), 0)
    assert tier.blocks == 2 and tier.evictions == 1
    assert tier.match(list(paths[0]), 0) == []
    assert not HostKVTier(nbytes - 1, 4).put(paths[0], one_block(1))
    tier.clear()
    assert tier.blocks == 0 and tier.bytes == 0


def _churn(sch, prompts, min_blocks=6):
    """Submit distinct long prompts until trie eviction has demoted at
    least ``min_blocks`` blocks to the host tier."""
    for i, p in enumerate(prompts):
        sch.submit(p, 4, seed=100 + i).result(240)
        if sch.metrics().get("kv_host_blocks", 0) >= min_blocks:
            return i + 1
    raise AssertionError("churn never demoted %d blocks" % min_blocks)


HOST_KEYS = ("kv_host_blocks", "kv_host_bytes", "kv_host_promotions",
             "kv_host_demotions", "kv_host_evictions",
             "prefix_cache_hits", "prefix_cache_evictions")


@pytest.mark.parametrize("kv_dtype,spec", [("fp32", False), ("fp32", True),
                                           ("int8", False)])
def test_host_promoted_parity(f32, trained, kv_dtype, spec):
    """A prompt whose prefix was demoted to the host tier replays its
    cold stream once promoted back (greedy and seeded, spec on and off,
    fp32 and int8 pools), as the reference's does, with the reference's
    host-tier and prefix counters."""
    fw, _, chain = trained
    rng = numpy.random.default_rng(19)
    pa = rng.integers(0, 12, (16,)).tolist()
    pb = rng.integers(0, 12, (16,)).tolist()
    churn = [rng.integers(0, 12, (44,)).tolist() for _ in range(6)]
    out = {}
    for pkg, c in (("jax", fw), ("port", chain)):
        sch = _sched(pkg, c, kv_blocks=28, prefill_chunk=8,
                     prefix_cache=True, spec=spec, spec_k=2,
                     kv_dtype=kv_dtype, kv_host_bytes=32 << 20).start()
        try:
            cold = [sch.submit(pa, 10).result(240),
                    sch.submit(pb, 10, temperature=0.8, top_k=4,
                               seed=11).result(240)]
            n = _churn(sch, churn)
            warm = [sch.submit(pa, 10).result(240),
                    sch.submit(pb, 10, temperature=0.8, top_k=4,
                               seed=11).result(240)]
            snap = sch.metrics()
            sch.check_kv()
        finally:
            sch.close()
        assert warm == cold
        assert snap["kv_host_promotions"] >= 1
        out[pkg] = (cold, n, {k: snap[k] for k in HOST_KEYS})
    assert out["port"] == out["jax"]


def test_check_kv_clean_under_churn_with_promote_faults(f32, trained):
    """Mixed traffic over the host tier with the promote fault point
    raising and step delays armed, a preemption and a cancel: every
    request retires or fails without leaking a block or a pin."""
    from veles_tpu_torch import faults
    from veles_tpu_torch.serving import SchedulerError
    _, _, chain = trained
    rng = numpy.random.default_rng(29)
    warm_p = rng.integers(0, 12, (16,)).tolist()
    sch = _sched("port", chain, max_slots=3, kv_blocks=28, prefill_chunk=8,
                 prefix_cache=True, spec=True, spec_k=2,
                 kv_host_bytes=32 << 20, request_timeout=60.0).start()
    try:
        sch.submit(warm_p, 6, seed=0).result(240)
        _churn(sch, [rng.integers(0, 12, (44,)).tolist() for _ in range(6)])
        faults.inject("scheduler.kv.promote", "exception", times=8)
        faults.load("serving.scheduler.step=delay:0.002x20")
        futs = []
        for i in range(10):
            p = warm_p if i % 2 else \
                rng.integers(0, 12, (rng.integers(4, 20),)).tolist()
            futs.append(sch.submit(p, 6, seed=i))
            if i == 5:
                sch.request_preempt()
            if i == 7:
                sch.cancel(futs[3])
        done = failed = 0
        for f in futs:
            try:
                f.result(240)
                done += 1
            except SchedulerError:
                failed += 1
        assert done + failed == 10 and done >= 6
        faults.clear()
        sch.check_kv()
        assert sch.metrics()["active_slots"] == 0
    finally:
        sch.close()
    sch.check_kv()


# -- the export table ----------------------------------------------------------

def test_export_byte_cap_and_ttl(f32, trained, monkeypatch):
    """Below two records' bytes, parking the second evicts the first
    (counted as expired), as the reference's table does; a record past
    its TTL is swept and counted too; a fetched handle reads
    ``"fetched"``."""
    import veles_tpu_torch.serving.scheduler as sched
    fw, _, chain = trained
    statuses = {}
    for pkg, c in (("jax", fw), ("port", chain)):
        sch = _sched(pkg, c, prefill_chunk=8, prefix_cache=False,
                     spec=False, kv_export_bytes=1).start()
        try:
            h1 = sch.submit_prefill([1, 2, 3, 4, 5]).result(240)["handle"]
            first = sch.kv_export_status(h1)
            h2 = sch.submit_prefill([5, 4, 3, 2, 1]).result(240)["handle"]
            got = (first, sch.kv_export_status(h1),
                   sch.kv_export_status(h2),
                   sch.metrics()["kv_exports_expired"],
                   sch.kv_export(h2) is not None,
                   sch.kv_export_status(h2), sch.kv_export(h2))
            sch.check_kv()
        finally:
            sch.close()
        statuses[pkg] = got
    assert statuses["port"] == statuses["jax"] \
        == ("pending", "unknown", "pending", 1, True, "fetched", None)
    monkeypatch.setattr(sched, "EXPORT_TTL", 0.05)
    sch = _sched("port", chain, prefix_cache=False, spec=False).start()
    try:
        h = sch.submit_prefill([1, 2, 3]).result(240)["handle"]
        assert sch.metrics()["kv_exports_pending"] == 1
        import time
        deadline = time.monotonic() + 10
        while sch.kv_export_status(h) != "unknown":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        snap = sch.metrics()
        assert snap["kv_exports_expired"] == 1
        assert snap["kv_exports_pending"] == 0
    finally:
        sch.close()


# -- disaggregated prefill/decode ----------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_disagg_handoff_matches_colocated(f32, trained, kv_dtype):
    """submit_prefill → kv_export → (either wire form) → submit_imported
    gives the colocated stream, greedy and seeded, and the reference's;
    roles refuse the other half (409); the handle is one-shot; int8
    scales travel with the blocks; a mismatched record is a ValueError;
    both pools end clean."""
    from veles_tpu_torch.serving import RoleMismatchError, disagg
    fw, pattern, chain = trained
    prompt = (pattern * 2)[:10]
    colo = _sched("port", chain, kv_dtype=kv_dtype).start()
    jcolo = _sched("jax", fw, kv_dtype=kv_dtype).start()
    pre = _sched("port", chain, kv_dtype=kv_dtype, role="prefill").start()
    dec = _sched("port", chain, kv_dtype=kv_dtype, role="decode").start()
    try:
        want = colo.submit(prompt, 9, seed=0).result(240)
        want_s = colo.submit(prompt, 9, temperature=0.8, top_k=4,
                             seed=7).result(240)
        assert want == jcolo.submit(prompt, 9, seed=0).result(240)
        assert want_s == jcolo.submit(prompt, 9, temperature=0.8, top_k=4,
                                      seed=7).result(240)
        with pytest.raises(RoleMismatchError) as e:
            pre.submit(prompt, 4)
        assert e.value.http_status == 409
        with pytest.raises(RoleMismatchError):
            dec.submit_prefill(prompt)
        with pytest.raises(RoleMismatchError):
            pre.submit_imported({}, 4)
        for wire in ("json", "binary"):
            h = pre.submit_prefill(prompt).result(240)
            assert h["blocks"] == -(-len(prompt) // 4)
            assert h["prompt_tokens"] == len(prompt)
            rec = pre.kv_export(h["handle"])
            assert pre.kv_export(h["handle"]) is None
            assert pre.kv_export_status(h["handle"]) == "fetched"
            layer = rec["layers"][1]
            if kv_dtype == "int8":
                assert {"k", "v", "k_scale", "v_scale"} == set(layer)
                assert layer["k"].dtype == numpy.int8
            if wire == "json":
                back = disagg.decode_export(json.loads(json.dumps(
                    disagg.encode_export(rec))))
            else:
                back, _ = disagg.decode_export_binary(
                    disagg.encode_export_binary(rec))
            _same_record({k: v for k, v in rec.items()
                          if k not in ("t", "bytes")}, back)
            assert dec.submit_imported(back, 9, seed=0).result(240) == want
            rec2 = pre.kv_export(pre.submit_prefill(prompt).result(240)[
                "handle"])
            assert dec.submit_imported(rec2, 9, temperature=0.8, top_k=4,
                                       seed=7).result(240) == want_s
        for bad in (dict(rec2, kv_dtype="fp8"), dict(rec2, block_size=8),
                    dict(rec2, length=3)):
            with pytest.raises(ValueError):
                dec.submit_imported(bad, 4)
        assert pre.metrics()["role"] == "prefill"
        assert dec.metrics()["role"] == "decode"
        for s in (pre, dec, colo):
            s.check_kv()
    finally:
        for s in (colo, jcolo, pre, dec):
            s.close()


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_records_cross_packages_in_the_schedulers(f32, trained, kv_dtype):
    """A prefill record exported by either package's scheduler, sent
    over either wire form of the exporter's package and decoded by the
    importer's, imports into the other package's decode scheduler and
    gives the colocated stream, bit for bit."""
    from veles_tpu.serving import disagg as jax_wire
    from veles_tpu_torch.serving import disagg
    fw, pattern, chain = trained
    prompt = (pattern * 3)[:13]
    wires = {"jax": jax_wire, "port": disagg}
    scheds = {}
    try:
        for pkg, c in (("jax", fw), ("port", chain)):
            for role in ("prefill", "decode"):
                scheds[pkg, role] = _sched(pkg, c, kv_dtype=kv_dtype,
                                           role=role).start()
        colo = _sched("port", chain, kv_dtype=kv_dtype).start()
        scheds["colo"] = colo
        want = colo.submit(prompt, 8, seed=0).result(240)
        for src, dst in (("jax", "port"), ("port", "jax")):
            pre, dec = scheds[src, "prefill"], scheds[dst, "decode"]
            for form in ("json", "binary"):
                h = pre.submit_prefill(prompt).result(240)["handle"]
                rec = pre.kv_export(h)
                if form == "json":
                    back = wires[dst].decode_export(json.loads(json.dumps(
                        wires[src].encode_export(rec))))
                else:
                    back, _ = wires[dst].decode_export_binary(
                        wires[src].encode_export_binary(rec))
                got = dec.submit_imported(back, 8, seed=0).result(240)
                assert got == want, (src, dst, form)
        for s in scheds.values():
            s.check_kv()
    finally:
        for s in scheds.values():
            s.close()


def test_prefix_export_import(f32, trained):
    """A resident prefix read off one replica (both tiers) and imported
    into another makes the resubmit admit warm there with the cold
    stream; a record of the reference's scheduler imports as well; a
    mismatched record is refused; an empty trie exports None."""
    fw, pattern, chain = trained
    prompt = (pattern * 4)[:24]
    a = _sched("port", chain, prefix_cache=True, spec=False).start()
    b = _sched("port", chain, prefix_cache=True, spec=False).start()
    j = _sched("jax", fw, prefix_cache=True, spec=False).start()
    try:
        assert a.submit_prefix_export(prompt).result(240) is None
        cold = a.submit(prompt, 6, seed=0).result(240)
        rec = a.submit_prefix_export(prompt).result(240)
        assert rec["length"] == len(rec["prompt"]) and rec["length"] >= 16
        assert rec["prompt"] == prompt[:rec["length"]]
        assert "logits" not in rec
        got = b.submit_prefix_import(rec).result(240)
        assert got["blocks"] == rec["length"] // 4
        assert b.submit_prefix_import(rec).result(240) == {"blocks": 0}
        hits = b.metrics()["prefix_cache_hits"]
        assert b.submit(prompt, 6, seed=0).result(240) == cold
        assert b.metrics()["prefix_cache_hits"] == hits + 1
        j.submit(prompt, 6, seed=0).result(240)
        jrec = j.submit_prefix_export(prompt).result(240)
        c = _sched("port", chain, prefix_cache=True, spec=False).start()
        try:
            assert c.submit_prefix_import(jrec).result(240)["blocks"] \
                == jrec["length"] // 4
            assert c.submit(prompt, 6, seed=0).result(240) == cold
            assert c.metrics()["prefix_cache_hits"] == 1
            c.check_kv()
        finally:
            c.close()
        with pytest.raises(ValueError):
            b.submit_prefix_import(dict(rec, kv_dtype="int8"))
        with pytest.raises(ValueError):
            b.submit_prefix_import(dict(rec, prompt=rec["prompt"][:-1],
                                        length=rec["length"] - 1))
        for s in (a, b):
            s.check_kv()
    finally:
        for s in (a, b, j):
            s.close()
