"""Disaggregated prefill/decode: the KV handoff wire — the port of
``veles_tpu/serving/disagg.py``, byte-compatible with it.

A prefill replica finishes a prompt, copies the slot's blocks RAW off
the card (``PagedKVCache.export_blocks``: int8 stays int8, the scales
ride along) and parks the record under a handle; ``GET
/serving/kv_export/<handle>`` serves it; a decode replica scatters the
blocks into its own table (``import_blocks``) and samples the first
token from the exported last-position logits, so the stream is the
colocated one.

JSON envelope (arrays as base64 of C-order bytes)::

    {"handle": "...", "prompt": [ids...], "length": P,
     "kv_dtype": "fp32"|"int8", "block_size": 16,
     "logits": {"b64": ..., "dtype": "float32", "shape": [vocab]},
     "layers": {"<chain idx>": {"k": <arr>, "v": <arr>
                                [, "k_scale": <arr>, "v_scale": <arr>]}}}

K/V arrays are ``[ceil(P / block_size), block_size, d]``; scales
``[blocks, block_size]`` f32.  Binary frame (``application/x-veles-kv``)::

    b"VKV1" | u32 header_len (LE) | header JSON (UTF-8) | raw bytes

The header carries the envelope's scalars, an ``arrays`` manifest
(``{"key": ["logits"] | ["layers", "<i>", "<name>"], "dtype", "shape"}``
in order: logits first, then layers by index, names sorted) and an
optional ``extra`` dict; the payload is each array's C-order bytes in
manifest order.  Decoding slices zero-copy ``numpy.frombuffer`` views
out of the frame.  The port never puts bfloat16 on the wire (its
exports widen bfloat16 pools to float32); a ``"bfloat16"`` array from
another replica decodes exactly to float32.
"""

import base64
import json
import struct
import uuid

import numpy
import torch

#: Content-Type / Accept token of the binary frame
WIRE_CONTENT_TYPE = "application/x-veles-kv"

_MAGIC = b"VKV1"


def mint_handle():
    """An unguessable export handle (the handle is the only capability
    to fetch the record)."""
    return uuid.uuid4().hex


def _np_dtype(name):
    """numpy dtype of a wire dtype name; bfloat16 reads as its raw
    16-bit words (:func:`_widen`)."""
    if name == "bfloat16":
        return numpy.dtype("<u2")
    try:
        return numpy.dtype(name)
    except TypeError:
        raise ValueError("unknown kv wire dtype %r" % (name,))


def _widen(a, name):
    """A bfloat16 array's words as the float32 values they encode."""
    if name != "bfloat16":
        return a
    return (a.astype(numpy.uint32) << 16).view(numpy.float32)


def _encode_array(a):
    a = numpy.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def _decode_array(obj):
    name = str(obj["dtype"])
    raw = base64.b64decode(obj["b64"])
    a = numpy.frombuffer(raw, dtype=_np_dtype(name)).reshape(
        [int(s) for s in obj["shape"]]).copy()
    return _widen(a, name)


def encode_export(record):
    """A record (numpy arrays) as the JSON-safe envelope."""
    out = {
        "handle": record["handle"],
        "prompt": [int(t) for t in record["prompt"]],
        "length": int(record["length"]),
        "kv_dtype": record["kv_dtype"],
        "block_size": int(record["block_size"]),
        "layers": {str(i): {n: _encode_array(a) for n, a in layer.items()}
                   for i, layer in record["layers"].items()},
    }
    if "logits" in record:
        out["logits"] = _encode_array(record["logits"])
    return out


def decode_export(obj):
    """The JSON envelope back into a record.  Raises ``ValueError`` on a
    malformed payload (a client error)."""
    try:
        rec = {
            "handle": str(obj["handle"]),
            "prompt": [int(t) for t in obj["prompt"]],
            "length": int(obj["length"]),
            "kv_dtype": str(obj["kv_dtype"]),
            "block_size": int(obj["block_size"]),
            "layers": {int(i): {n: _decode_array(a)
                                for n, a in layer.items()}
                       for i, layer in obj["layers"].items()},
        }
        if obj.get("logits") is not None:
            rec["logits"] = _decode_array(obj["logits"])
        return rec
    except (KeyError, TypeError, AttributeError) as e:
        raise ValueError("malformed kv export payload: %r" % (e,))


def record_nbytes(record):
    """Payload bytes of a record's arrays (the export table's and the
    host tier's budgeting unit)."""
    n = record["logits"].nbytes if "logits" in record else 0
    for layer in record["layers"].values():
        for a in layer.values():
            n += a.nbytes
    return n


def _manifest(record):
    """The frame's array order: logits first (when present), then the
    layers by chain index, names sorted."""
    entries = []
    if "logits" in record:
        entries.append((("logits",), record["logits"]))
    for i in sorted(record["layers"]):
        layer = record["layers"][i]
        for n in sorted(layer):
            entries.append((("layers", str(i), n), layer[n]))
    return entries


def encode_export_binary(record, extra=None):
    """A record as ``application/x-veles-kv`` bytes; ``extra`` (a
    JSON-safe dict) rides in the header."""
    entries = [(key, numpy.ascontiguousarray(a))
               for key, a in _manifest(record)]
    header = {
        "handle": record["handle"],
        "prompt": [int(t) for t in record["prompt"]],
        "length": int(record["length"]),
        "kv_dtype": record["kv_dtype"],
        "block_size": int(record["block_size"]),
        "arrays": [{"key": list(key), "dtype": str(a.dtype),
                    "shape": list(a.shape)} for key, a in entries],
    }
    if extra:
        header["extra"] = extra
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return b"".join([_MAGIC, struct.pack("<I", len(hjson)), hjson]
                    + [a.data for _, a in entries])


def decode_export_binary(blob):
    """An ``application/x-veles-kv`` frame back into ``(record, extra)``.
    The arrays are read-only views into ``blob``.  Raises ``ValueError``
    on a malformed frame."""
    try:
        view = memoryview(blob)
        if bytes(view[:4]) != _MAGIC:
            raise ValueError("bad kv wire magic")
        (hlen,) = struct.unpack("<I", view[4:8])
        header = json.loads(bytes(view[8:8 + hlen]).decode("utf-8"))
        record = {
            "handle": str(header["handle"]),
            "prompt": [int(t) for t in header["prompt"]],
            "length": int(header["length"]),
            "kv_dtype": str(header["kv_dtype"]),
            "block_size": int(header["block_size"]),
            "layers": {},
        }
        off = 8 + hlen
        for ent in header["arrays"]:
            name = str(ent["dtype"])
            dtype = _np_dtype(name)
            shape = [int(s) for s in ent["shape"]]
            nbytes = dtype.itemsize * int(numpy.prod(shape,
                                                     dtype=numpy.int64))
            if off + nbytes > len(view):
                raise ValueError("kv wire length mismatch")
            a = _widen(numpy.frombuffer(view[off:off + nbytes],
                                        dtype=dtype).reshape(shape), name)
            off += nbytes
            key = ent["key"]
            if key == ["logits"]:
                record["logits"] = a
            elif len(key) == 3 and key[0] == "layers":
                record["layers"].setdefault(int(key[1]), {})[
                    str(key[2])] = a
            else:
                raise ValueError("bad array key %r" % (key,))
        if off != len(view):
            raise ValueError("kv wire length mismatch")
        return record, header.get("extra") or {}
    except (KeyError, TypeError, AttributeError, struct.error,
            UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError("malformed kv wire frame: %r" % (e,))


def quantize_record(record):
    """int8-quantize a fp32 record's K/V blocks in flight (per-row
    absmax, the int8 pools' quantization), shrinking the wire ~4x.
    Lossy; int8 records pass through untouched."""
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    if record["kv_dtype"] != "fp32":
        return record
    layers = {}
    for i, layer in record["layers"].items():
        got = {}
        for name in ("k", "v"):
            q, s = quantize_kv_rows(torch.from_numpy(
                numpy.array(layer[name], numpy.float32)))
            got[name] = q.numpy()
            got[name + "_scale"] = s.to(torch.float32).numpy()
        layers[i] = got
    out = dict(record)
    out["kv_dtype"] = "int8"
    out["layers"] = layers
    return out
