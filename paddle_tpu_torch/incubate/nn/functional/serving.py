"""The LLM serving / decode family of the fused functional ops
(counterpart of paddle_tpu/incubate/nn/functional/serving.py):
``masked_multihead_attention`` (:147), ``block_multihead_attention``
(:276, paged caches), ``variable_length_memory_efficient_attention``
(:469) and ``fused_multi_transformer`` (:530, the whole-stack serving
transformer), with their helpers.

Each computes the reference's function in plain torch: the reference's
attention here is plain einsums, at prefill and at decode alike, so no
kernel of the port is on these paths (a decode-attention kernel is
ROADMAP Queue B follow-up 7). Scores and softmax are in f32; the
products of ``fused_multi_transformer`` take bf16/f16 operands in the
weights' dtype and give f32 results (on the card through cuBLAS's
f32-output GEMM, on the CPU as an f32 product of the same values), and
its residual stream stays f32 across the layers, as the reference's
``dense`` (:593) keeps them.

**Caches are written in place.** The reference returns new caches and
leaves its inputs as they were (a jit boundary donates them for an
aliased update); the port writes each step's k and v into the cache
tensors it is given and returns those same tensors, so the returned
caches hold the reference's values. Keep the returned caches, as the
reference's callers do; an input cache is not left as it was.

The functions take torch tensors (and return them) or the eager API's
Tensors and numpy arrays (and return Tensors, as the reference's do).
The decode position (``time_step``, ``sequence_lengths``) is read on
the host, as this eager path may.
"""
from __future__ import annotations

import math

import torch

from ....ops.registry import eager_function

__all__ = ["masked_multihead_attention", "block_multihead_attention",
           "fused_multi_transformer",
           "variable_length_memory_efficient_attention"]


def _check_no_quant(**kw):
    bad = [k for k, v in kw.items() if v is not None and v is not False]
    if bad:
        raise NotImplementedError(
            f"quantised-activation serving arguments {bad} are not "
            "supported: weight-only quantisation lives in "
            "paddle_tpu_torch.nn.quant; int8 KV caches are supported via "
            "cache_k/v_quant_scales + cache_k/v_dequant_scales")


def _f32(x, device):
    return None if x is None else torch.as_tensor(
        x, device=device).to(torch.float32)


def _quant_scales(quant, dequant, heads, what, device):
    """Per-head int8 KV-cache scales (:65): (quant [H], dequant [H]) in
    f32, dequant 1 / quant unless given, or (None, None)."""
    q, dq = _f32(quant, device), _f32(dequant, device)
    if q is None and dq is None:
        return None, None
    if q is None:
        q = 1.0 / dq
    q = q.reshape(-1)
    if dq is None:
        dq = 1.0 / q
    dq = dq.reshape(-1)
    if q.shape[0] != heads or dq.shape[0] != heads:
        raise ValueError(
            f"{what} int8 scales must be per-head [{heads}]; got "
            f"{tuple(q.shape)} / {tuple(dq.shape)}")
    return q, dq


def _scales_pair(k_quant, k_dequant, v_quant, v_dequant, heads, cache_dtype,
                 device):
    kq, kdq = _quant_scales(k_quant, k_dequant, heads, "cache_k", device)
    vq, vdq = _quant_scales(v_quant, v_dequant, heads, "cache_v", device)
    if (kq is None) != (vq is None):
        raise ValueError(
            "int8 KV cache: cache_k and cache_v scales must be supplied "
            f"together (k {'set' if kq is not None else 'absent'}, "
            f"v {'set' if vq is not None else 'absent'})")
    if (kq is not None) != (cache_dtype == torch.int8):
        raise ValueError(
            "int8 KV cache: the cache dtype and cache_k/v_*_scales must be "
            f"given together (cache dtype {cache_dtype}, scales "
            f"{'set' if kq is not None else 'absent'})")
    return kq, kdq, vq, vdq


def _quantize_kv(x, scale, round_type, max_bound, min_bound):
    """serving.py:88. x: [..., H, D] float -> int8 with the per-head
    scale [H]: x in f32 times the scale, rounded (round_type 0 = half
    away from zero, the reference's quant_round_type=0; 1 = half to
    even, the default), clipped to [min_bound, max_bound]."""
    s = scale.reshape((1,) * (x.dim() - 2) + (-1, 1))
    y = x.float() * s
    if round_type == 0:
        y = torch.sign(y) * torch.floor(y.abs() + 0.5)
    else:
        y = torch.round(y)
    return y.clamp(min_bound, max_bound).to(torch.int8)


def _apply_rotary(x, cos, sin, neox):
    """serving.py:101. x: [..., D]; cos/sin: [..., D // 2] (half-width
    tables, unlike fused_rotary_position_embedding's full-width ones).
    neox=True rotates the split halves (GPT-NeoX), else adjacent pairs
    (GPT-J / interleaved). Runs in the promoted dtype of x and the
    tables; the caller casts."""
    d = x.shape[-1]
    if neox:
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape)


def _decode_attn_core(q, kc, vc, t, upto, src_mask=None, k_dequant=None,
                      v_dequant=None):
    """One query token a row against a dense cache (:114), in f32.
    q [B, H, D]; kc / vc [B, H, L, D]; t [B] (the position just written:
    a row attends to positions <= t); `upto` = max(t) + 1, read on the
    host: the positions past it are masked for every row, so only the
    first `upto` are read. src_mask: additive [B, 1, 1, Lm]. k/v_dequant:
    per-head f32 scales of an int8 cache, applied after the upcast."""
    kc, vc = kc[:, :, :upto], vc[:, :, :upto]
    kf, vf = kc.float(), vc.float()
    if k_dequant is not None:
        kf = kf * k_dequant[None, :, None, None]
    if v_dequant is not None:
        vf = vf * v_dequant[None, :, None, None]
    s = torch.einsum("bhd,bhld->bhl", q.float(), kf) \
        * (1.0 / math.sqrt(q.shape[-1]))
    valid = torch.arange(upto, device=q.device)[None, :] <= t[:, None]
    if src_mask is not None:
        m = src_mask.float()[:, 0, 0, :upto]
        if m.shape[-1] < upto:
            m = torch.nn.functional.pad(m, (0, upto - m.shape[-1]))
        s = s + m[:, None, :]
    s = torch.where(valid[:, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,bhld->bhd", p, vf).to(q.dtype)


@eager_function()
def masked_multihead_attention(
    x,
    cache_kv=None,
    bias=None,
    src_mask=None,
    cum_offsets=None,
    sequence_lengths=None,
    rotary_tensor=None,
    beam_cache_offset=None,
    qkv_out_scale=None,
    out_shift=None,
    out_smooth=None,
    seq_len=1,
    rotary_emb_dims=0,
    use_neox_rotary_style=False,
    compute_dtype="default",
    out_scale=-1,
    quant_round_type=1,
    quant_max_bound=127.0,
    quant_min_bound=-127.0,
    cache_k_quant_scales=None,
    cache_v_quant_scales=None,
    cache_k_dequant_scales=None,
    cache_v_dequant_scales=None,
):
    """Decode-phase masked MHA over a dense cache (:147). x: [B, 3*H*D]
    (this step's fused qkv); cache_kv: [2, B, H, max_seq, D], written in
    place at each row's position and returned. sequence_lengths [B, 1]:
    the tokens cached a row (the write position); without it the
    position is src_mask.shape[-1] - 1. rotary_tensor [B, 1, 1,
    max_seq, D] packs cos (first half) and sin. An int8 cache takes
    per-head cache_k/v_quant_scales (dequant 1 / quant unless given):
    k and v are quantised on write, dequantised in the attention.
    Returns (out [B, H*D], cache_kv)."""
    _check_no_quant(beam_cache_offset=beam_cache_offset,
                    qkv_out_scale=qkv_out_scale, out_shift=out_shift,
                    out_smooth=out_smooth)
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv")
    cache = cache_kv
    _, B, H, L, D = cache.shape
    qkv = x.reshape(B, 3, H, D)
    if bias is not None:
        qkv = qkv + bias.reshape(1, 3, H, D).to(qkv.dtype)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    dev = x.device
    if sequence_lengths is not None:
        t = torch.as_tensor(sequence_lengths, device=dev).reshape(-1).long()
    elif src_mask is not None:
        t = torch.full((B,), src_mask.shape[-1] - 1, dtype=torch.long,
                       device=dev)
    else:
        raise ValueError(
            "masked_multihead_attention needs sequence_lengths or "
            "src_mask to locate the decode position")
    if rotary_tensor is not None and rotary_emb_dims > 0:
        rows = rotary_tensor.float()[torch.arange(B, device=dev), 0, 0, t]
        cos, sin = rows[:, None, :D // 2], rows[:, None, D // 2:]
        q = _apply_rotary(q, cos, sin, use_neox_rotary_style).to(q.dtype)
        k = _apply_rotary(k, cos, sin, use_neox_rotary_style).to(k.dtype)
    tmax = int(t.max())
    if tmax >= L:
        raise ValueError(
            f"masked_multihead_attention: sequence_lengths (max {tmax}) "
            f"must be < cache max_seq ({L}); the cache is full — grow it "
            f"before decoding further")
    kq, kdq, vq, vdq = _scales_pair(
        cache_k_quant_scales, cache_k_dequant_scales, cache_v_quant_scales,
        cache_v_dequant_scales, H, cache.dtype, dev)
    if kq is not None:
        kw = _quantize_kv(k, kq, quant_round_type, quant_max_bound,
                          quant_min_bound)
        vw = _quantize_kv(v, vq, quant_round_type, quant_max_bound,
                          quant_min_bound)
    else:
        kw, vw = k.to(cache.dtype), v.to(cache.dtype)
    bidx = torch.arange(B, device=dev)
    cache[0][bidx, :, t, :] = kw
    cache[1][bidx, :, t, :] = vw
    out = _decode_attn_core(q, cache[0], cache[1], t, tmax + 1,
                            src_mask=src_mask, k_dequant=kdq,
                            v_dequant=vdq)
    return out.reshape(B, H * D), cache


def _paged_gather(cache, block_tables):
    """cache [NB, kvH, bs, D]; block_tables [B, npb] -> [B, kvH, npb*bs,
    D] (:264). Unmapped entries (< 0) read block 0; the callers mask by
    length, so those rows are never attended to."""
    B, npb = block_tables.shape
    _, kvH, bs, D = cache.shape
    g = cache[block_tables.clamp(min=0).long()]     # [B, npb, kvH, bs, D]
    return g.permute(0, 2, 1, 3, 4).reshape(B, kvH, npb * bs, D)


@eager_function()
def block_multihead_attention(
    qkv,
    key_cache,
    value_cache,
    seq_lens_encoder,
    seq_lens_decoder,
    seq_lens_this_time,
    padding_offsets,
    cum_offsets,
    cu_seqlens_q,
    cu_seqlens_k,
    block_tables,
    pre_key_cache=None,
    pre_value_cache=None,
    cache_k_quant_scales=None,
    cache_v_quant_scales=None,
    cache_k_dequant_scales=None,
    cache_v_dequant_scales=None,
    qkv_out_scale=None,
    qkv_bias=None,
    out_shift=None,
    out_smooth=None,
    rope_emb=None,
    mask=None,
    tgt_mask=None,
    max_seq_len=-1,
    block_size=64,
    use_neox_style=False,
    use_dynamic_cachekv_quant=False,
    quant_round_type=1,
    quant_max_bound=127.0,
    quant_min_bound=-127.0,
    out_scale=-1,
    compute_dtype="default",
):
    """Paged-KV-cache attention, prefill and decode rows in one call
    (:276). qkv [tokens, (H + 2*kvH) * D] packed by cu_seqlens_q;
    key_cache / value_cache [blocks, kvH, block_size, D], written in
    place and returned; block_tables [B, pages] (-1 unmapped). A row's
    tokens sit at positions seq_lens_decoder[b] + [0, n); attention is
    causal by position, with `mask` / `tgt_mask` added. An int8 cache
    takes per-kv-head scales as masked_multihead_attention does.
    Returns (out [tokens, H*D], qkv, key_cache, value_cache)."""
    _check_no_quant(
        qkv_out_scale=qkv_out_scale, out_shift=out_shift,
        out_smooth=out_smooth,
        use_dynamic_cachekv_quant=use_dynamic_cachekv_quant)
    if pre_key_cache is not None or pre_value_cache is not None:
        raise NotImplementedError(
            "pre_key_cache/pre_value_cache (prompt-tuning prefix) is not "
            "supported; prepend the prefix to the prompt instead")
    kcache, vcache = key_cache, value_cache
    nb, kvH, bs, D = kcache.shape
    if bs != block_size:
        raise ValueError(
            f"block_size arg ({block_size}) disagrees with the cache "
            f"layout ({bs})")
    T = qkv.shape[0]
    H = qkv.shape[1] // D - 2 * kvH
    if H <= 0 or H % kvH:
        raise ValueError(
            f"qkv width {qkv.shape[1]} inconsistent with kv heads "
            f"{kvH} and head_size {D}")
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(1, -1).to(qkv.dtype)
    dev = qkv.device
    qt = qkv[:, :H * D].reshape(T, H, D)
    kt = qkv[:, H * D:(H + kvH) * D].reshape(T, kvH, D)
    vt = qkv[:, (H + kvH) * D:].reshape(T, kvH, D)

    cu_q = torch.as_tensor(cu_seqlens_q, device=dev).reshape(-1).long()
    B = cu_q.shape[0] - 1
    dec = torch.as_tensor(seq_lens_decoder, device=dev).reshape(-1).long()
    tbl = torch.as_tensor(block_tables, device=dev).long()
    npb = tbl.shape[1]
    C = npb * bs
    tok = torch.arange(T, device=dev)
    row = (torch.searchsorted(cu_q, tok, right=True) - 1).clamp(0, B - 1)
    local = tok - cu_q[row]
    gpos = dec[row] + local
    live = tok < cu_q[-1]

    if rope_emb is not None:
        re = rope_emb.float()          # [2, B, max_seq, 1, D // 2]
        cos = re[0, row, gpos, 0][:, None, :]
        sin = re[1, row, gpos, 0][:, None, :]
        qt = _apply_rotary(qt, cos, sin, use_neox_style).to(qt.dtype)
        kt = _apply_rotary(kt, cos, sin, use_neox_style).to(kt.dtype)
    kq, kdq, vq, vdq = _scales_pair(
        cache_k_quant_scales, cache_k_dequant_scales, cache_v_quant_scales,
        cache_v_dequant_scales, kvH, kcache.dtype, dev)

    # the cache write: one scatter a cache, live tokens only (a token
    # past cu_seqlens_q[-1] is dropped, as the reference's out-of-bounds
    # scatter drops it)
    page = (gpos // bs).clamp(0, npb - 1)
    phys = tbl[row, page].clamp(min=0)
    slot = gpos % bs
    if kq is not None:
        ktw = _quantize_kv(kt, kq, quant_round_type, quant_max_bound,
                           quant_min_bound)
        vtw = _quantize_kv(vt, vq, quant_round_type, quant_max_bound,
                           quant_min_bound)
    else:
        ktw, vtw = kt.to(kcache.dtype), vt.to(vcache.dtype)
    kcache[phys[live], :, slot[live], :] = ktw[live]
    vcache[phys[live], :, slot[live], :] = vtw[live]

    # attention: the rows' q padded to [B, Smax, H, D] against their
    # gathered pages
    smax = max(1, int((cu_q[1:] - cu_q[:-1]).max()))
    qpad = torch.zeros((B, smax, H, D), dtype=qt.dtype, device=dev)
    qpad[row[live], local[live]] = qt[live]
    kctx = _paged_gather(kcache, tbl).float()             # [B, kvH, C, D]
    vctx = _paged_gather(vcache, tbl).float()
    if kdq is not None:
        kctx = kctx * kdq[None, :, None, None]
        vctx = vctx * vdq[None, :, None, None]
    rep = H // kvH
    kctx = kctx.repeat_interleave(rep, dim=1)
    vctx = vctx.repeat_interleave(rep, dim=1)
    s = torch.einsum("bshd,bhcd->bhsc", qpad.float(), kctx) \
        * (1.0 / math.sqrt(D))
    cpos = torch.arange(C, device=dev)
    qg = dec[:, None] + torch.arange(smax, device=dev)[None, :]
    causal = cpos[None, None, :] <= qg[:, :, None]        # [B, Smax, C]
    if mask is not None:
        s = s + mask.float()[:, :, :smax, :C]
    if tgt_mask is not None:
        s = s + tgt_mask.float()[:, :, :, :C]
    s = torch.where(causal[:, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    opad = torch.einsum("bhsc,bhcd->bshd", p, vctx)
    out = opad[row, local.clamp(max=smax - 1)]           # [T, H, D]
    out = torch.where(live[:, None, None], out, 0.0)
    return (out.to(qt.dtype).reshape(T, H * D), qkv, kcache, vcache)


@eager_function()
def variable_length_memory_efficient_attention(
    query, key, value, seq_lens, kv_seq_lens, mask=None, scale=None,
    causal=False, pre_cache_length=0,
):
    """Attention with per-row q and kv lengths over padded [B, H, S, D]
    inputs (:469); rows past seq_lens give zeros, a fully masked row
    zeros too. key/value may carry fewer heads. `causal` aligns the last
    q row with the last kv row (row i sees kv <= i + kv_len - q_len)."""
    if pre_cache_length:
        raise NotImplementedError(
            "pre_cache_length: prepend the pre-cache to key/value")
    q, k, v = query, key, value
    B, H, Sq, D = q.shape
    kvH, Sk = k.shape[1], k.shape[2]
    if H != kvH:
        k = k.repeat_interleave(H // kvH, dim=1)
        v = v.repeat_interleave(H // kvH, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    ql = torch.as_tensor(seq_lens, device=dev).reshape(-1).long()
    kl = torch.as_tensor(kv_seq_lens, device=dev).reshape(-1).long()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask.float()
    qpos = torch.arange(Sq, device=dev)
    kpos = torch.arange(Sk, device=dev)
    valid = (kpos[None, None, :] < kl[:, None, None]).expand(B, Sq, Sk)
    if causal:
        off = (kl - ql)[:, None, None]
        valid = valid & (kpos[None, None, :] <= qpos[None, :, None] + off)
    s = torch.where(valid[:, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    qvalid = qpos[None, None, :, None] < ql[:, None, None, None]
    return torch.where(qvalid, out, 0.0).to(q.dtype)


def _act(name, x):
    """:515: jax.nn's activation by name, as the reference's serving and
    fused ops call it: gelu (jax's tanh approximation), relu, silu (or
    swish, fused_bias_act's name for it), or the gated swiglu / geglu
    over the two halves of the last axis."""
    if name == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu":
        return torch.relu(x)
    if name in ("silu", "swish"):
        return torch.nn.functional.silu(x)
    if name in ("swiglu", "geglu"):
        a, b = x.chunk(2, dim=-1)
        g = torch.nn.functional.silu(a) if name == "swiglu" else \
            torch.nn.functional.gelu(a, approximate="tanh")
        return g * b
    raise ValueError(f"unsupported activation {name!r}")


def _f32_product(a, w):
    """a @ w (w [in, out], or any layout reshaped to it by the caller)
    with a cast to w's dtype first and an f32 result (:593's
    preferred_element_type=f32): cuBLAS's f32-output GEMM for bf16/f16
    operands on the card, the f32 product of the same values elsewhere."""
    a = a.to(w.dtype)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if w.dtype in (torch.bfloat16, torch.float16) and a2.is_cuda:
        out = torch.mm(a2, w, out_dtype=torch.float32)
    else:
        out = torch.mm(a2.float(), w.float())
    return out.reshape(*lead, w.shape[-1])


def _dense(a, w, b=None):
    out = _f32_product(a, w)
    if b is not None:
        out = out + b.float()
    return out


def _lnorm(a, scale, bias, eps):
    mu = a.mean(-1, keepdim=True)
    var = torch.square(a - mu).mean(-1, keepdim=True)
    out = (a - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out


def _at(seq, i):
    return None if seq is None else seq[i]


@eager_function()
def fused_multi_transformer(
    x,
    ln_scales,
    ln_biases,
    qkv_weights,
    qkv_biases,
    linear_weights,
    linear_biases,
    ffn_ln_scales,
    ffn_ln_biases,
    ffn1_weights,
    ffn1_biases,
    ffn2_weights,
    ffn2_biases,
    pre_layer_norm=True,
    epsilon=1e-5,
    cache_kvs=None,
    pre_caches=None,
    seq_lens=None,
    rotary_embs=None,
    time_step=None,
    attn_mask=None,
    dropout_rate=0.0,
    rotary_emb_dims=0,
    activation="gelu",
    training=False,
    mode="upscale_in_train",
    trans_qkvw=True,
    ring_id=-1,
    name=None,
):
    """The whole-stack serving transformer (:530): N pre- or post-LN
    blocks of fused-qkv attention and a feed-forward, in one call.

    Prefill (time_step None): x [B, S, d_model]; each layer's k and v
    are written into cache_kvs[i][:, :B, :, :S] (in place) and the
    attention is causal (or `attn_mask`, additive, and `seq_lens`' kv
    lengths). Decode (time_step a 0-d tensor or int, read on the host):
    x [B, 1, d_model]; k and v are written at time_step and the token
    attends to the cache up to it. qkv weights are [3, H, D, dm]
    (trans_qkvw) or [dm, 3, H, D]; the others [in, out]. Returns the
    output in x's dtype, and with cache_kvs the list of caches (the
    tensors given, written in place). Dropout is the serving path's: off
    (training with dropout_rate > 0 raises)."""
    if training and dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_multi_transformer is the serving path: "
            "training-mode dropout is not supported")
    if pre_caches is not None:
        raise NotImplementedError(
            "pre_caches (prompt-tuning prefix) is not supported")
    if ring_id != -1:
        raise NotImplementedError(
            "ring_id tensor-parallel serving is not ported")
    B, S, _ = x.shape
    dev = x.device
    decode = time_step is not None
    ts = int(torch.as_tensor(time_step).reshape(())) if decode else None
    sl = None if seq_lens is None else \
        torch.as_tensor(seq_lens, device=dev).reshape(-1).long()
    rope = None
    if rotary_embs is not None and rotary_emb_dims > 0:
        # [2, B, 1, max_seq, D or D // 2]: cos, sin
        rope = rotary_embs.float()
        pos = (torch.arange(S, device=dev) + (ts if decode else 0))
        pos = pos[None, :].expand(B, S)
        bi = torch.arange(B, device=dev)[:, None]
    new_caches = []
    hf = x.float()
    for i in range(len(ln_scales)):
        ln_b = _at(ln_biases, i)
        residual = hf
        a = _lnorm(hf, ln_scales[i], ln_b, epsilon) if pre_layer_norm \
            else hf
        qkw = qkv_weights[i]
        if trans_qkvw:                                   # [3, H, D, dm]
            _, H, D, dm = qkw.shape
            qkv = _f32_product(a, qkw.reshape(3 * H * D, dm).t())
        else:                                            # [dm, 3, H, D]
            dm, _, H, D = qkw.shape
            qkv = _f32_product(a, qkw.reshape(dm, 3 * H * D))
        qkv = qkv.reshape(B, S, 3, H, D)
        qb = _at(qkv_biases, i)
        if qb is not None:
            qkv = qkv + qb.float()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [B, S, H, D]
        if rope is not None:
            cos = rope[0, bi, 0, pos][..., :D // 2][:, :, None, :]
            sin = rope[1, bi, 0, pos][..., :D // 2][:, :, None, :]
            q = _apply_rotary(q, cos, sin, False)
            k = _apply_rotary(k, cos, sin, False)
        cache = None if cache_kvs is None else cache_kvs[i]
        if decode:
            if cache is None:
                raise ValueError("decode (time_step) requires cache_kvs")
            cache[0, :B, :, ts] = k[:, 0].to(cache.dtype)
            cache[1, :B, :, ts] = v[:, 0].to(cache.dtype)
            t = torch.full((B,), ts, dtype=torch.long, device=dev)
            attn_out = _decode_attn_core(
                q[:, 0], cache[0, :B], cache[1, :B], t, ts + 1,
                src_mask=attn_mask)[:, None]             # [B, 1, H, D]
            new_caches.append(cache)
        else:
            if cache is not None:
                cache[0, :B, :, :S] = k.transpose(1, 2).to(cache.dtype)
                cache[1, :B, :, :S] = v.transpose(1, 2).to(cache.dtype)
                new_caches.append(cache)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(D))
            if attn_mask is not None:
                s = s + attn_mask.float()[:, :, :S, :S]
            else:
                cm = torch.ones((S, S), dtype=torch.bool,
                                device=dev).tril()
                s = torch.where(cm, s, float("-inf"))
            if sl is not None:
                kv_ok = torch.arange(S, device=dev)[None, :] < sl[:, None]
                s = torch.where(kv_ok[:, None, None, :], s, float("-inf"))
            p = torch.softmax(s, dim=-1)
            attn_out = torch.einsum("bhqk,bkhd->bqhd", p, v)
        proj = _dense(attn_out.reshape(B, S, H * D), linear_weights[i],
                      _at(linear_biases, i))
        hf = residual + proj
        if not pre_layer_norm:
            hf = _lnorm(hf, ln_scales[i], ln_b, epsilon)
        ffn_b = _at(ffn_ln_biases, i)
        residual = hf
        a = _lnorm(hf, ffn_ln_scales[i], ffn_b, epsilon) if pre_layer_norm \
            else hf
        a = _act(activation, _dense(a, ffn1_weights[i], _at(ffn1_biases, i)))
        hf = residual + _dense(a, ffn2_weights[i], _at(ffn2_biases, i))
        if not pre_layer_norm:
            hf = _lnorm(hf, ffn_ln_scales[i], ffn_b, epsilon)
    out = hf.to(x.dtype)
    if cache_kvs is not None:
        return out, new_caches
    return out
