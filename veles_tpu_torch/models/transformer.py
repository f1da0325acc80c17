"""Pre-LN transformer block, the sequence mean-pool and the per-token
logits head — the port of ``veles_tpu/models/transformer.py``.

:meth:`TransformerBlock.apply` is the training forward: its attention
core is ``models/attention.attention_core`` with the JAX package's
selection rule (the FlashAttention kernels on the card at head_dim %
128 == 0).  Serving prefill and the dense decode steps
(:meth:`~TransformerBlock.apply_step` for ``models/generate.py``,
:meth:`~TransformerBlock.apply_step_slots` for the dense slot cache)
keep the plain masked softmax (:meth:`TransformerBlock._attend`), as
the JAX methods do: they are einsums there, not Pallas kernels.

Every method keeps the JAX unit's dtype conventions so the two agree
in float32 to rounding: projections take compute-dtype operands and
sum in f32 (:meth:`ForwardBase.linear`), q/k/v and attention run in
the compute dtype, layer norm and the logits run in f32.  Caches and
pools are updated in place (the JAX methods return new arrays; these
return the same dicts they were given, written).

``n_experts`` > 0 makes the FFN a top-k mixture of experts
(``models/moe.moe_apply``, dense dispatch; ``gate`` and the
expert-major ``expert_*`` tensors replace ``ffn_*``).  Every path goes
through :meth:`TransformerBlock._attn_tail`, so a MoE block trains,
prefills and decodes (dense and paged, decode and verify) through the
same methods.

``int8_decode`` routes the paged decode and verify steps' output
projection and both FFN matmuls through the weight-only int8 GEMM
(``ops/gemm.int8_matmul``, the hand-written kernel on the card) — three
launches per layer per step; prefill and the dense steps keep the
policy matmul.  A MoE block's FFN stays on the policy products, as the
reference's ``_ffn`` returns the MoE result before it looks at the
int8 path: one launch per layer per step (``wo``).  Int8 weight
checkpoints need the dense FFN and refuse a MoE block.

Int8 weight checkpoints (:meth:`TransformerBlock.quantize_weights`, or
``load_params`` given int8 weights with their ``*_scale`` arrays) store
the six matmul weights int8 with one f32 scale per output column; every
path multiplies the f32 sum of the int8 weight by its scale
(``_dequant_dot`` in the reference).  ``int8_decode`` on such a block is
refused with a ``ValueError``: the reference's weight-only decode
re-quantizes the stored int8 values and never applies the scales, so
its logits are those of a different model.
"""

import numpy
import torch

from veles_tpu_torch.models.attention import sp_core, sp_remote
from veles_tpu_torch.models.moe import (
    MOE_BIASES, MOE_PARAMS, moe_apply, moe_fans, moe_shapes)
from veles_tpu_torch.models.nn_units import ForwardBase
from veles_tpu_torch.ops import softmax
from veles_tpu_torch.ops.gemm import int8_matmul, int8_weight_quantize
from veles_tpu_torch.ops.paged_attend import attend_scale
from veles_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_q8,
    paged_verify_attention, paged_verify_attention_fused,
    paged_verify_attention_q8)


def _layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


#: the matmul weights an int8 checkpoint stores quantized
INT8_WEIGHTS = ("wq", "wk", "wv", "wo", "ffn_w1", "ffn_w2")
_W8_REFUSED = (
    "int8_decode on an int8 weight checkpoint: the weight-only decode "
    "path would re-quantize the stored int8 values and drop their "
    "*_scale arrays (the reference's logits then belong to another "
    "model); serve an int8 checkpoint with int8_decode=False")
_MOE_INT8 = ("int8 weight checkpoints need the dense FFN (a MoE block's "
             "expert weights are not quantized)")


class TransformerBlock(ForwardBase):
    """x → x + MHA(LN(x)) → + FFN(LN(.)), x: [batch, seq, d]."""

    BASE_PARAMS = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
                   "ln2_scale", "ln2_bias")
    DENSE_FFN = ("ffn_w1", "ffn_b1", "ffn_w2", "ffn_b2")
    PARAMS = BASE_PARAMS + DENSE_FFN
    VECTORS = MOE_BIASES

    def __init__(self, heads=4, hidden=None, causal=True, n_experts=0,
                 top_k=2, attn_block_size=None, attn_impl=None,
                 int8_decode=False, device=None, dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        self.heads = int(heads)
        self.hidden = hidden     # None → 4·d
        self.causal = bool(causal)
        #: a top-k MoE FFN of this many experts (0: the dense FFN)
        self.n_experts = int(n_experts)
        self.top_k = int(top_k)
        if self.n_experts and self.top_k > self.n_experts:
            raise ValueError("top_k %d > n_experts %d"
                             % (self.top_k, self.n_experts))
        self.PARAMS = self._ffn_params()
        #: attention core of :meth:`apply` (models/attention.py)
        self.attn_block_size = attn_block_size
        self.attn_impl = attn_impl
        #: int8 weight checkpoint: the INT8_WEIGHTS stored int8 beside
        #: their per-column ``*_scale`` arrays
        self.weights_int8 = False
        #: weight-only int8 matmuls for the decode step's output
        #: projection and FFN (the weights quantize once, at first use)
        self.int8_decode = bool(int8_decode)

    @property
    def int8_decode(self):
        return self._int8_decode

    @int8_decode.setter
    def int8_decode(self, on):
        if on and self.weights_int8:
            raise ValueError(_W8_REFUSED)
        self._int8_decode = bool(on)

    def param_shapes(self, in_shape, window):
        d = in_shape[-1]
        if d % self.heads:
            raise ValueError("model dim %d not divisible by %d heads"
                             % (d, self.heads))
        h = int(self.hidden or 4 * d)
        shapes = {n: (d,) for n in ("ln1_scale", "ln1_bias", "ln2_scale",
                                    "ln2_bias")}
        shapes.update({n: (d, d) for n in ("wq", "wk", "wv", "wo")})
        if self.n_experts:
            shapes.update(moe_shapes(d, self.n_experts, h))
        else:
            shapes.update({"ffn_w1": (d, h), "ffn_b1": (h,),
                           "ffn_w2": (h, d), "ffn_b2": (d,)})
        return shapes

    def fans(self, shape):
        return moe_fans(shape)

    def load_params(self, arrays):
        """Load f32 weights, or an int8 checkpoint: the INT8_WEIGHTS as
        int8 arrays, each with its ``{name}_scale`` f32 vector."""
        int8 = any(n + "_scale" in arrays for n in INT8_WEIGHTS)
        if int8:
            if self.n_experts:
                raise ValueError(_MOE_INT8)
            if self.int8_decode:
                raise ValueError(_W8_REFUSED)
            bad = [n for n in INT8_WEIGHTS
                   if numpy.asarray(arrays.get(n)).dtype != numpy.int8
                   or n + "_scale" not in arrays]
            if bad:
                raise ValueError("int8 checkpoint: %s must be int8 with "
                                 "*_scale arrays" % bad)
        self.PARAMS = self._ffn_params() + (
            tuple(n + "_scale" for n in INT8_WEIGHTS) if int8 else ())
        super().load_params(arrays)
        if int8:
            for n in INT8_WEIGHTS:   # integers in [-127, 127]: exact
                self.params[n] = self.params[n].to(torch.int8)
        self.weights_int8 = int8
        self.hidden = int(self.params["expert_w1"].shape[2]
                          if self.n_experts
                          else self.params["ffn_w1"].shape[1])

    def export_config(self):
        p = self.params
        hidden = p["expert_w1"].shape[2] if "expert_w1" in p \
            else p["ffn_w1"].shape[1] if "ffn_w1" in p else self.hidden
        cfg = {"heads": self.heads, "hidden": int(hidden),
               "causal": self.causal, "n_experts": self.n_experts,
               "top_k": self.top_k}
        if self.attn_block_size:  # v2 keys: omitted when unused
            cfg["attn_block_size"] = int(self.attn_block_size)
        if self.attn_impl:
            cfg["attn_impl"] = self.attn_impl
        if self.int8_decode:
            cfg["int8_decode"] = True
        if self.weights_int8:
            cfg["weights_int8"] = True
        return cfg

    def _ffn_params(self):
        """The parameters of the block's FFN kind (no int8 scales)."""
        return self.BASE_PARAMS + (MOE_PARAMS if self.n_experts
                                   else self.DENSE_FFN)

    def quantize_weights(self):
        """Re-store the six matmul weights as an int8 checkpoint:
        per-output-column symmetric absmax quantization
        (``ops/gemm.int8_weight_quantize``), the int8 tensor replacing
        the f32 one and a ``{name}_scale`` f32 vector joining ``PARAMS``.
        Idempotent.  Refused while ``int8_decode`` is on (see the module
        docstring)."""
        if self.n_experts:
            raise ValueError(_MOE_INT8)
        if self.weights_int8:
            return
        if self.int8_decode:
            raise ValueError(_W8_REFUSED)
        for name in INT8_WEIGHTS:
            wq, scale = int8_weight_quantize(self.params[name])
            self.params[name] = wq
            self.params[name + "_scale"] = scale.to(torch.float32)
        self.PARAMS = self._ffn_params() + tuple(
            n + "_scale" for n in INT8_WEIGHTS)
        self.weights_int8 = True
        self._derived = {}

    def _proj(self, x, name):
        """``x @ params[name]`` under the dtype policy, f32 result; an
        int8 weight's f32 sum is multiplied by its column scales (the
        upcast operand is transient, so the int8 bytes are all that
        stays resident)."""
        w = self.params[name]
        if w.dtype != torch.int8:
            return self.linear(x, name)
        y = torch.matmul(x.to(self.dtype).to(torch.float32),
                         w.to(torch.float32))
        return y * self.params[name + "_scale"]

    @property
    def d_model(self):
        return int(self.params["wq"].shape[0])

    # -- shared pieces ---------------------------------------------------------

    def _qkv(self, x):
        """LN1 + q/k/v projections, each [b, s, d] in the compute
        dtype (shared by prefill, chunked prefill and decode so all
        write identical K/V rows)."""
        ln = _layer_norm(x, self.params["ln1_scale"],
                         self.params["ln1_bias"])
        return tuple(self._proj(ln, n).to(self.dtype)
                     for n in ("wq", "wk", "wv"))

    def _attend(self, q, k, v, keep):
        """Masked softmax attention in the compute dtype: q [b, s, d],
        k/v [b, L, d], ``keep`` [s, L] or [b, 1, s, L] → [b, s, d]."""
        b, s, d = q.shape
        hd = d // self.heads
        qh = q.reshape(b, s, self.heads, hd)
        kh = k.to(self.dtype).reshape(b, -1, self.heads, hd)
        vh = v.to(self.dtype).reshape(b, -1, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * attend_scale(hd)
        logits = logits.masked_fill(~keep, float("-inf"))
        probs = softmax(logits)
        return torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, s, d)

    def _w8_matmul(self, x, name):
        """Weight-only int8 matmul of ``x`` [b, s, d1] by parameter
        ``name`` [d1, d2] (per-column quantization cached): [b, s, d2]
        f32."""
        b, s, d1 = x.shape
        wq, scale = self.derived(
            ("w8", name), lambda: int8_weight_quantize(self.params[name]))
        out = int8_matmul(x.reshape(b * s, d1).to(self.dtype).contiguous(),
                          wq, scale)
        return out.reshape(b, s, -1)

    def _ffn(self, x, w8=False):
        if self.n_experts:   # before the int8 path, as the reference
            return moe_apply(self.params, x, self.top_k, "strict_relu",
                             self.dtype, self.mm_weight,
                             getattr(self, "ep_shards_", None),
                             getattr(self, "ep_route_", None))
        mm = self._w8_matmul if w8 else self._proj
        h1 = mm(x, "ffn_w1")
        h1 = torch.relu(h1 + self.params["ffn_b1"]).to(self.dtype)
        y = mm(h1, "ffn_w2")
        return (y + self.params["ffn_b2"]).to(x.dtype)

    def _attn_tail(self, x, o, w8=False):
        """Output projection + residual + FFN half over an attention
        context ``o`` [b, s, d]; ``w8`` takes the int8 weight-only
        path (decode steps with ``int8_decode``)."""
        attn = (self._w8_matmul(o, "wo") if w8
                else self._proj(o, "wo")).to(x.dtype)
        y = x + attn
        return y + self._ffn(_layer_norm(y, self.params["ln2_scale"],
                                         self.params["ln2_bias"]), w8=w8)

    def _attn_out(self, x, q, k, v, keep):
        """Masked attention + the shared tail, never on the int8
        weight path (prefill and the dense decode steps, as in the
        reference)."""
        return self._attn_tail(x, self._attend(q, k, v, keep))

    # -- full sequence -------------------------------------------------------

    def apply(self, x):
        b, s, d = x.shape
        q, k, v = (t.reshape(b, s, self.heads, d // self.heads)
                   for t in self._qkv(x))
        o = sp_core(self, q, k, v, self.causal, self.attn_block_size,
                    self.attn_impl)
        return self._attn_tail(x, o.reshape(b, s, d))

    def apply_remote(self):
        """This process's share of a group whose input another process
        holds (``models/gd_mesh``): its positions of the ``sp`` ring,
        then its expert slices."""
        sp_remote(self, self.causal)
        if self.n_experts:
            moe_apply(self.params, None, self.top_k, "strict_relu",
                      self.dtype, ep_shards=getattr(self, "ep_shards_", None),
                      route=getattr(self, "ep_route_", None))

    # -- serving ---------------------------------------------------------------

    def _require_causal(self):
        if not self.causal:
            raise ValueError("serving needs causal blocks (a KV cache "
                             "holds only the past)")

    def init_cache(self, batch, max_len, dtype):
        """Zeroed K/V buffers, [batch, max_len, d] each."""
        self._require_causal()
        d = self.d_model
        return {n: torch.zeros((batch, max_len, d), dtype=dtype,
                               device=self.device) for n in ("k", "v")}

    def _write_rows(self, cache, k_new, v_new, start, lens):
        if lens is not None:
            keep = (torch.arange(k_new.shape[1], device=k_new.device)[None, :]
                    < lens.long()[:, None])[..., None]
            k_new = torch.where(keep, k_new, torch.zeros_like(k_new))
            v_new = torch.where(keep, v_new, torch.zeros_like(v_new))
        end = start + k_new.shape[1]
        cache["k"][:, start:end] = k_new.to(cache["k"].dtype)
        cache["v"][:, start:end] = v_new.to(cache["v"].dtype)
        return k_new, v_new

    def apply_prefill(self, x, cache, lens=None):
        """Consume all of x [batch, P, d] in one pass, writing every
        position's K/V into cache rows [0, P).  ``lens`` [batch]: rows
        at or past each length are zeroed; output rows past it are
        garbage the caller must not read."""
        p = x.shape[1]
        q, k, v = self._qkv(x)
        k, v = self._write_rows(cache, k, v, 0, lens)
        ar = torch.arange(p, device=x.device)
        return self._attn_out(x, q, k, v, ar[None, :] <= ar[:, None]), cache

    def apply_prefill_chunk(self, x, cache, offset, chunk_lens=None,
                            key_width=None):
        """Chunked prefill: x [b, C, d] at positions [offset,
        offset+C), written into cache rows [offset, offset+C); queries
        attend over cached keys [0, key_width) with ``key ≤ offset +
        q``.  Chained chunks reproduce :meth:`apply_prefill`."""
        c = x.shape[1]
        offset = int(offset)
        q, k, v = self._qkv(x)
        self._write_rows(cache, k, v, offset, chunk_lens)
        kw = int(key_width or cache["k"].shape[1])
        keep = (torch.arange(kw, device=x.device)[None, :]
                <= (offset + torch.arange(c, device=x.device))[:, None])
        return self._attn_out(x, q, cache["k"][:, :kw], cache["v"][:, :kw],
                              keep), cache

    def apply_step(self, x, pos, cache):
        """Decode ONE position: x [batch, 1, d] at sequence index
        ``pos`` (an int), its K/V written into cache row ``pos``; the
        query attends over the whole cache with keys past ``pos``
        masked (``models/generate.py``'s kv path)."""
        pos = int(pos)
        q, k_new, v_new = self._qkv(x)
        cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
        keep = (torch.arange(cache["k"].shape[1], device=x.device)
                <= pos)[None, :]
        return self._attn_out(x, q, cache["k"], cache["v"], keep), cache

    def apply_step_slots(self, x, pos, cache):
        """Decode ONE position PER ROW against dense slot caches: x
        [batch, 1, d] with row n at ``pos[n]`` ([batch] ints), written
        there; row n attends over its keys <= ``pos[n]``.  Row for row
        :meth:`apply_step`."""
        q, k_new, v_new = self._qkv(x)
        rows = torch.arange(x.shape[0], device=x.device)
        pos = pos.long()
        cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
        keep = (torch.arange(cache["k"].shape[1], device=x.device)[None, :]
                <= pos[:, None])[:, None, None, :]
        return self._attn_out(x, q, cache["k"], cache["v"], keep), cache

    def init_block_pool(self, num_blocks, block_size, dtype,
                        kv_dtype="fp32"):
        """Zeroed paged K/V pools [num_blocks, block_size, d];
        ``kv_dtype="int8"`` stores them int8 with per-row f32 scales
        ``k_scale``/``v_scale`` [num_blocks, block_size] beside them
        (zero scales make the trash block dequantize to exact 0)."""
        self._require_causal()
        if kv_dtype == "fp32":
            return self.init_cache(num_blocks, block_size, dtype)
        if kv_dtype != "int8":
            raise ValueError("kv_dtype must be 'fp32' or 'int8'")
        shape = (num_blocks, block_size, self.d_model)
        pool = {n: torch.zeros(shape, dtype=torch.int8, device=self.device)
                for n in ("k", "v")}
        for n in ("k_scale", "v_scale"):
            pool[n] = torch.zeros((num_blocks, block_size),
                                  dtype=torch.float32, device=self.device)
        return pool

    def apply_step_paged(self, x, pos, tables, pool):
        """Decode ONE position per row against a paged pool: x
        [batch, 1, d] with row n at ``pos[n]``, through ``tables``
        [batch, T].  An int8 pool (``k_scale`` beside the buffers)
        quantizes the new row on the scatter and attends through the
        paged-attention kernel."""
        q, k_new, v_new = self._qkv(x)
        if "k_scale" in pool:
            _, _, _, _, o = paged_decode_attention_q8(
                q, k_new, v_new, pool["k"], pool["v"], pool["k_scale"],
                pool["v_scale"], tables, pos, self.heads)
        else:
            _, _, o = paged_decode_attention(
                q, k_new, v_new, pool["k"], pool["v"], tables, pos,
                self.heads, self.dtype)
        return self._attn_tail(x, o, w8=self.int8_decode), pool

    def apply_verify_paged(self, x, pos, lens, tables, pool,
                           fused_verify=False):
        """Speculative-decoding verify step: score a width-K1 run per
        row — x [batch, K1, d], row n's position j at ``pos[n] + j``,
        ``lens`` [batch] real positions per row (padding scatters into
        the trash block) — against the paged pool in ONE pass; position
        for position :meth:`apply_step_paged`.  int8 pools take the q8
        verify (the paged-attention kernel on the card); fp32 pools the
        two-pass verify, or the single-pass one with
        ``fused_verify``."""
        q, k_new, v_new = self._qkv(x)
        if "k_scale" in pool:
            _, _, _, _, o = paged_verify_attention_q8(
                q, k_new, v_new, pool["k"], pool["v"], pool["k_scale"],
                pool["v_scale"], tables, pos, lens, self.heads)
        else:
            verify = paged_verify_attention_fused if fused_verify \
                else paged_verify_attention
            _, _, o = verify(q, k_new, v_new, pool["k"], pool["v"],
                             tables, pos, lens, self.heads, self.dtype)
        return self._attn_tail(x, o, w8=self.int8_decode), pool


    # -- tensor-parallel serving (serving/tp.py) -------------------------------

    def tp_shardable(self, tp):
        """True when this block's Megatron layout divides over ``tp``
        positions: heads, model dim and FFN hidden all divisible.  MoE
        blocks and ``int8_decode`` ones opt out, as in the reference (the
        weight-only decode's per-column quantization does not commute
        with the row-parallel partial sums)."""
        tp = int(tp)
        if tp < 2 or self.n_experts or self.int8_decode:
            return False
        d = self.d_model
        return self.heads % tp == 0 and d % tp == 0 \
            and int(self.hidden or 4 * d) % tp == 0

    def tp_param_spec(self, name, tp):
        """The Megatron spec of parameter ``name`` under ``tp`` positions,
        or None (replicated): wq/wk/wv and the FFN up-projection (and
        its bias, and an int8 checkpoint's scales of those) split by
        columns, wo and the FFN down-projection by rows; LN parameters,
        output-side biases and the row-parallel weights' scales
        replicate."""
        from veles_tpu_torch.parallel.sharding import P
        if not self.tp_shardable(tp):
            return None
        if name in ("wq", "wk", "wv", "ffn_w1"):
            return P(None, "tp")
        if name in ("wo", "ffn_w2"):
            return P("tp", None)
        if name in ("ffn_b1", "wq_scale", "wk_scale", "wv_scale",
                    "ffn_w1_scale"):
            return P("tp")
        return None

    @staticmethod
    def _tp_tail(views, xs, os):
        """The per-position tail of a tensor-parallel block: each
        position's row-parallel ``wo`` partial over its heads' context
        ``os[p]``, reduced across positions; residual; the FFN's
        column-parallel up-projection and row-parallel down-projection,
        reduced.  Per position the unsharded :meth:`_attn_tail`'s
        arithmetic."""
        from veles_tpu_torch.parallel.collectives import psum
        attn = psum([v._proj(o, "wo") for v, o in zip(views, os)])
        ys = [x + a.to(x.dtype) for x, a in zip(xs, attn)]
        parts = []
        for v, y in zip(views, ys):
            ln = _layer_norm(y, v.params["ln2_scale"], v.params["ln2_bias"])
            h1 = torch.relu(v._proj(ln, "ffn_w1")
                            + v.params["ffn_b1"]).to(v.dtype)
            parts.append(v._proj(h1, "ffn_w2"))
        ffn = psum(parts)
        return [y + (f + v.params["ffn_b2"]).to(y.dtype)
                for v, y, f in zip(views, ys, ffn)]

    @staticmethod
    def _tp_qkv(views, xs, int8):
        """Each position's q/k/v over its heads, and for int8 pools the
        new rows' whole-row amaxes (the max over positions)."""
        from veles_tpu_torch.parallel.collectives import pmax
        from veles_tpu_torch.ops.paged_attention import row_amax
        qkv = [v._qkv(x) for v, x in zip(views, xs)]
        if not int8:
            return qkv, [None] * len(xs), [None] * len(xs)
        return qkv, pmax([row_amax(k) for _, k, _ in qkv]), \
            pmax([row_amax(vv) for _, _, vv in qkv])

    def apply_step_paged_tp(self, views, xs, pos, tables, pools):
        """:meth:`apply_step_paged` over ``tp`` positions: ``views`` the
        block's per-position shards, ``xs`` each position's copy of x,
        ``pos``/``tables`` per position, ``pools`` each position's pool
        dict (its ``d/tp`` columns).  Returns per-position outputs."""
        int8 = "k_scale" in pools[0]
        qkv, ak, av = self._tp_qkv(views, xs, int8)
        os = []
        for j, v in enumerate(views):
            q, k, vv = qkv[j]
            pool = pools[j]
            if int8:
                o = paged_decode_attention_q8(
                    q, k, vv, pool["k"], pool["v"], pool["k_scale"],
                    pool["v_scale"], tables[j], pos[j], v.heads,
                    amax_k=ak[j][:, 0], amax_v=av[j][:, 0])[-1]
            else:
                o = paged_decode_attention(
                    q, k, vv, pool["k"], pool["v"], tables[j], pos[j],
                    v.heads, v.dtype)[-1]
            os.append(o)
        return self._tp_tail(views, xs, os)

    def apply_verify_paged_tp(self, views, xs, pos, lens, tables, pools,
                              fused_verify=False):
        """:meth:`apply_verify_paged` over ``tp`` positions (the
        arguments per position, as :meth:`apply_step_paged_tp`)."""
        int8 = "k_scale" in pools[0]
        qkv, ak, av = self._tp_qkv(views, xs, int8)
        os = []
        for j, v in enumerate(views):
            q, k, vv = qkv[j]
            pool = pools[j]
            if int8:
                o = paged_verify_attention_q8(
                    q, k, vv, pool["k"], pool["v"], pool["k_scale"],
                    pool["v_scale"], tables[j], pos[j], lens[j], v.heads,
                    amax_k=ak[j], amax_v=av[j])[-1]
            else:
                verify = paged_verify_attention_fused if fused_verify \
                    else paged_verify_attention
                o = verify(q, k, vv, pool["k"], pool["v"], tables[j],
                           pos[j], lens[j], v.heads, v.dtype)[-1]
            os.append(o)
        return self._tp_tail(views, xs, os)

    def apply_prefill_chunk_tp(self, views, xs, cache, offset,
                               chunk_lens=None, key_width=None):
        """:meth:`apply_prefill_chunk` (and, at offset 0 over the whole
        prompt, :meth:`apply_prefill`) over ``tp`` positions: position
        ``j`` writes its heads' K/V columns of the whole-width staging
        ``cache`` (on the chain's device) and attends over them."""
        c = xs[0].shape[1]
        offset = int(offset)
        kw = int(key_width or cache["k"].shape[1])
        os = []
        for j, (v, x) in enumerate(zip(views, xs)):
            q, k, vv = v._qkv(x)
            cols = slice(j * k.shape[-1], (j + 1) * k.shape[-1])
            part = {n: cache[n][:, :, cols] for n in ("k", "v")}
            lens = None if chunk_lens is None else chunk_lens.to(x.device)
            self._write_rows(part, k, vv, offset, lens)
            dev = x.device
            keep = (torch.arange(kw, device=dev)[None, :]
                    <= (offset + torch.arange(c, device=dev))[:, None])
            os.append(v._attend(q, part["k"][:, :kw].to(dev),
                                part["v"][:, :kw].to(dev), keep))
        return self._tp_tail(views, xs, os), cache


class MeanPoolSeq(ForwardBase):
    """[batch, seq, d] → [batch, d], the mean over the sequence axis."""

    def export_config(self):
        return {}

    def out_shape(self, in_shape):
        return (in_shape[-1],)

    def apply(self, x):
        return x.mean(dim=1)


class TokenProjection(ForwardBase):
    """Per-token logits head: [batch, seq, d] → [batch, seq, vocab],
    f32 logits."""

    PARAMS = ("weights", "bias")
    #: position-wise: a decode step applies it unchanged
    DECODE_POINTWISE = True

    def __init__(self, vocab=None, device=None, dtype=None, **hyper):
        super().__init__(device=device, dtype=dtype, **hyper)
        if vocab is None:
            raise ValueError("vocab is required")
        self.vocab = int(vocab)

    def export_config(self):
        return {"vocab": self.vocab}

    def param_shapes(self, in_shape, window):
        return {"weights": (in_shape[-1], self.vocab),
                "bias": (self.vocab,)}

    def out_shape(self, in_shape):
        return tuple(in_shape[:-1]) + (self.vocab,)

    def apply(self, x):
        return self.linear(x, "weights") + self.params["bias"]
