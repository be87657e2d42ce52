"""Fused functional ops (counterpart of
paddle_tpu/incubate/nn/functional/__init__.py), cut to the one the
training slice runs: fused_flash_attention."""
from __future__ import annotations

import warnings

from ....amp.state import maybe_cast_inputs as _amp
from ....kernels.flash_attention import attention_path, flash_attention

__all__ = ["fused_flash_attention"]


def fused_flash_attention(query, key, value, attn_mask=None, causal=False,
                          dropout=0.0, training=True, softmax_scale=None,
                          segment_ids=None):
    """Flash attention, [batch, seq, heads, dim] layout (paddle_tpu
    incubate/nn/functional/__init__.py:70); key/value may carry fewer
    heads (GQA/MQA), segment_ids=(q_seg, kv_seg) masks attention to equal
    ids on the kernel path. An AMP-white op.

    On the CUDA card, a fall back to the O(S^2) composite (shapes the
    kernels refuse) is surfaced as a RuntimeWarning naming the reason,
    as the reference does on its device (:90-97); an explicit dense
    attn_mask is the caller's choice and does not warn. Attention
    dropout is not implemented on the flash path: it raises rather than
    training without it (:85-89)."""
    if dropout and training:
        raise NotImplementedError(
            "attention dropout is not implemented on the flash path; set "
            "dropout=0.0")
    query, key, value, attn_mask = _amp(
        "fused_flash_attention", "white", query, key, value, attn_mask)
    if attn_mask is None and query.device.type == "cuda":
        path, why = attention_path(query.shape, key.shape,
                                   device=query.device)
        if path == "composite":
            warnings.warn(
                f"flash_attention fell back to the composite: {why}",
                RuntimeWarning, stacklevel=2)
    return flash_attention(query, key, value, attn_mask=attn_mask,
                           causal=causal, softmax_scale=softmax_scale,
                           segment_ids=segment_ids)
