"""paddle_tpu_torch's fused incubate layers (FusedMultiHeadAttention,
FusedFeedForward, FusedTransformerEncoderLayer) against paddle_tpu's,
pre-LN and post-LN, in eval, from the same weights (carried by
`fused_params_from_numpy`, names and layouts one for one).

head_dim 64 and 128 tokens: the port's attention runs B1's plain
version on the CPU, and every layer norm runs B4's CPU path. On the card,
a shape B1 refuses raises (tests/test_torch_kernels_cuda.py)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate import nn as jnn
from paddle_tpu_torch import fused_params_from_numpy
from paddle_tpu_torch.incubate import nn as tnn
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import norms
from torch_port_helpers import jax_state_numpy

D_MODEL, HEADS, FFN = 128, 2, 256


def _twins(name, seed=0, **kw):
    pt.seed(seed)
    jl = getattr(jnn, name)(**kw)
    jl.eval()
    tl = getattr(tnn, name)(**kw, device="cpu")
    named = jax_state_numpy(jl)
    # biases and layer-norm scales are constructed as 0 and 1: move them
    # off those values on both sides, so every term of the blocks counts
    rng = np.random.default_rng(seed)
    for k, v in named.items():
        if "bias" in k or "ln_scale" in k:
            named[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                v.dtype)
    jl.set_state_dict({k: pt.to_tensor(v) for k, v in named.items()})
    tl.load_state_dict(fused_params_from_numpy(named))
    tl.eval()
    return jl, tl


def _x(seed=1, b=2, s=128):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D_MODEL)).astype(np.float32)


def _run(jl, tl, x):
    want = np.asarray(jl(pt.to_tensor(x)).numpy())
    n = (norms.layer_norm_fwd.plain_calls, fa.flash_fwd.plain_calls)
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    return got, want, (norms.layer_norm_fwd.plain_calls - n[0],
                       fa.flash_fwd.plain_calls - n[1])


# f32 on both sides; the two packages sum the projections and the
# attention in different orders (outputs of order 1, ~1e-6 apart)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("transpose_qkv_wb", [False, True])
@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
def test_fused_multi_head_attention(pre_ln, transpose_qkv_wb):
    jl, tl = _twins("FusedMultiHeadAttention", embed_dim=D_MODEL,
                    num_heads=HEADS, normalize_before=pre_ln,
                    transpose_qkv_wb=transpose_qkv_wb)
    got, want, (ln, b1) = _run(jl, tl, _x())
    assert (ln, b1) == (1, 1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
def test_fused_feedforward(pre_ln, activation):
    jl, tl = _twins("FusedFeedForward", d_model=D_MODEL,
                    dim_feedforward=FFN, normalize_before=pre_ln,
                    activation=activation)
    got, want, (ln, _) = _run(jl, tl, _x(2))
    assert ln == 1
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
def test_fused_transformer_encoder_layer(pre_ln):
    jl, tl = _twins("FusedTransformerEncoderLayer", d_model=D_MODEL,
                    nhead=HEADS, dim_feedforward=FFN,
                    normalize_before=pre_ln)
    assert sorted(tl.state_dict()) == sorted(jax_state_numpy(jl))
    got, want, (ln, b1) = _run(jl, tl, _x(3))
    assert (ln, b1) == (2, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_short_sequence_takes_the_composite():
    """40 tokens: a length the flash kernels refuse, so on CPU tensors
    both packages run the attention composite (on the card the port
    raises instead: test_torch_kernels_cuda.py)."""
    jl, tl = _twins("FusedTransformerEncoderLayer", d_model=D_MODEL,
                    nhead=HEADS, dim_feedforward=FFN)
    got, want, (_, b1) = _run(jl, tl, _x(4, s=40))
    assert b1 == 0
    np.testing.assert_allclose(got, want, **TOL)


def test_training_dropout_draws_from_the_layer_generator():
    """In training the dropout masks come from the layer's own generator
    (`generator`): two layers of one seed agree, and differ from eval."""
    x = torch.from_numpy(_x(5))
    outs = []
    for _ in range(2):
        layer = tnn.FusedTransformerEncoderLayer(
            D_MODEL, HEADS, FFN, dropout_rate=0.2, attn_dropout_rate=0.0,
            device="cpu", init_generator=torch.Generator().manual_seed(7),
            generator=torch.Generator().manual_seed(8))
        with torch.no_grad():
            outs.append(layer(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    layer.eval()
    with torch.no_grad():
        assert not torch.equal(layer(x), outs[0])


def test_parameter_attrs_are_not_ported():
    """The name predates the port of the ``*_attr`` arguments, which used
    to raise: a ParamAttr's initializer and name now build the weight,
    as in the reference."""
    from paddle_tpu_torch.nn import ParamAttr
    from paddle_tpu_torch.nn.initializer import Constant
    layer = tnn.FusedMultiHeadAttention(
        D_MODEL, HEADS, qkv_weight_attr=ParamAttr(
            name="qkv", initializer=Constant(0.5)), device="cpu")
    w = layer.qkv_weight
    assert w.name == "qkv" and w.shape == [3, HEADS, D_MODEL // HEADS,
                                           D_MODEL]
    assert bool((w._data == 0.5).all())
