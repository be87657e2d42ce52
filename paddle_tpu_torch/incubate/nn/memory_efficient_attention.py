"""memory_efficient_attention (counterpart of
paddle_tpu/incubate/nn/memory_efficient_attention.py): the attention-bias
classes lowered onto the flash path where their pattern allows (no bias
and LowerTriangularMask -> B1, causal for the latter; BlockDiagonalMask,
and BlockDiagonalCausalMask with equal q and kv packings -> B1 with
segment ids), and materialised as an additive mask through the
attention composite otherwise (:33-66). B2 runs their backward."""
from __future__ import annotations

from ...ops.registry import eager_function
from . import functional as F
from .attn_bias import (AttentionBias, BlockDiagonalCausalMask,
                        BlockDiagonalMask, LowerTriangularMask, segment_ids)

__all__ = ["memory_efficient_attention"]


@eager_function()
def memory_efficient_attention(query, key, value, attn_bias=None,
                               p=0.0, scale=None, training=True):
    """query / key / value [b, s, h, d]; attn_bias None, an
    attn_bias.AttentionBias, or an additive mask tensor. Attention
    dropout raises, as on the reference's flash path."""
    if p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not implemented on the flash path; set "
            "p=0.0")
    b, sq, h, _ = query.shape
    sk = key.shape[1]
    if attn_bias is None:
        return F.fused_flash_attention(query, key, value, causal=False,
                                       softmax_scale=scale)
    if type(attn_bias) is LowerTriangularMask:
        return F.fused_flash_attention(query, key, value, causal=True,
                                       softmax_scale=scale)
    is_block = type(attn_bias) is BlockDiagonalMask
    is_block_causal = type(attn_bias) is BlockDiagonalCausalMask
    same_packing = (is_block or is_block_causal) and \
        attn_bias.q_seqinfo.seqstart == attn_bias.k_seqinfo.seqstart
    if is_block or (is_block_causal and same_packing):
        # the global diagonal is the per-block causal mask only when the
        # q and kv packings coincide; otherwise materialise below
        dev = query.device
        q_seg = segment_ids(attn_bias.q_seqinfo.seqstart, sq,
                            device=dev)[None].expand(b, sq)
        kv_seg = segment_ids(attn_bias.k_seqinfo.seqstart, sk,
                             device=dev)[None].expand(b, sk)
        return F.fused_flash_attention(
            query, key, value, causal=is_block_causal,
            segment_ids=(q_seg, kv_seg), softmax_scale=scale)
    if isinstance(attn_bias, AttentionBias):
        mask = attn_bias.materialize((b, h, sq, sk), device=query.device)
        if mask.dim() == 2:
            mask = mask[None, None]
        return F.fused_flash_attention(query, key, value, attn_mask=mask,
                                       softmax_scale=scale)
    return F.fused_flash_attention(query, key, value, attn_mask=attn_bias,
                                   softmax_scale=scale)
