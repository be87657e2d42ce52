"""incubate's fused functionals on the eager API's Tensors against the
reference's on the CPU (paddle_tpu_torch.incubate.nn.functional against
paddle_tpu.incubate.nn.functional), memory_efficient_attention and the
attention-bias classes.

Every registered op runs as a case of tests/eager_op_cases.py's
``INCUBATE_CASES`` on both packages from the same numpy inputs, held by
tests/test_torch_ops.py's rule (values within the case's `tol`, rtol =
atol; dtypes and shapes exactly; the inputs' grads through
``backward()`` within `grad_tol`, default 1e-5). f32 throughout unless a
test says otherwise. The flash attention calls run B1/B2's plain
versions here (s = 128, head_dim 64); the reference off its TPU runs its
XLA attention."""
import numpy as np
import pytest
import torch

import eager_op_cases as C
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.incubate.nn import attn_bias as jab
from paddle_tpu_torch.incubate.nn import attn_bias as tab
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import norms
from paddle_tpu_torch.ops import OPS
from test_torch_ops import _close
from torch_port_helpers import cpu_place

CASES = [c for c in C.CASES if c[0] in set(C.INCUBATE_CASES)]
JF = pt.incubate.nn.functional
TF = ptt.incubate.nn.functional


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.mark.parametrize("name,fn,opts", CASES, ids=[c[0] for c in CASES])
def test_incubate_op_matches_reference(name, fn, opts):
    grad = opts.get("grad", True)
    got, got_g = C.run_case(ptt, fn, grad=grad)
    want, want_g = C.run_case(pt, fn, grad=grad)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, np.asarray(w), opts.get("tol", 1e-6), f"{name} out {i}")
    for i in set(got_g) | set(want_g):
        if i not in got_g:
            assert not np.asarray(want_g[i], np.float64).any(), \
                f"{name}: the reference has a nonzero grad of input {i}"
            continue
        assert i in want_g, f"{name}: the port has a grad of input {i}"
        _close(got_g[i], np.asarray(want_g[i]), opts.get("grad_tol", 1e-5),
               f"{name} grad {i}")


def test_registered_under_the_reference_names_and_policies():
    """The ops the reference registers are registered ops of the port,
    under its names and AMP policies (ROADMAP Queue C, fault 1)."""
    from paddle_tpu.ops.registry import OPS as JOPS
    names = {n for n, d in JOPS.items()
             if d.fn.__module__.startswith("paddle_tpu.incubate")}
    assert names == {n for n, d in OPS.items()
                     if d.fn.__module__.startswith("paddle_tpu_torch.incubate")}
    assert len(names) == 16
    for n in names:
        assert OPS[n].amp_policy == JOPS[n].amp_policy, n
        assert OPS[n].amp_in_fn


def test_tensor_calls_return_tensors_and_torch_calls_torch():
    """The five functionals that took no Tensor before (Queue C, fault
    1: each raised AttributeError) return Tensors; a torch-level call
    still returns a torch tensor, through the same body."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    q = rng.standard_normal((1, 128, 2, 64)).astype(np.float32)
    calls = [("fused_rms_norm", (x, w)), ("fused_layer_norm", (x, w, w)),
             ("fused_rotary_position_embedding", (q[:, :4],)),
             ("fused_flash_attention", (q, q, q)),
             ("fused_bias_dropout_residual_layer_norm", (x, x, w, w, w))]
    for name, args in calls:
        kw = {"dropout_rate": 0.0} if "dropout" in name else {}
        got = getattr(TF, name)(*map(ptt.to_tensor, args), **kw)
        want = getattr(JF, name)(*map(pt.to_tensor, args), **kw)
        assert isinstance(got, ptt.Tensor), name
        _close(got.numpy(), np.asarray(want.numpy()), 1e-5, name)
        raw = getattr(TF, name)(*map(torch.from_numpy, args), **kw)
        assert type(raw) is torch.Tensor, name
        torch.testing.assert_close(raw, got._data, rtol=0, atol=0)


def test_amp_cast_once_on_tensor_calls(monkeypatch):
    """Under O1 a Tensor call of a registered fused op is cast once, by
    its body (``amp_in_fn``; the dispatch casts nothing), to the
    reference's dtypes and values."""
    from paddle_tpu_torch.amp import state
    from paddle_tpu_torch.ops import registry
    casts = []

    def spy(where, real):
        def cast(name, policy, dtype):
            out = real(name, policy, dtype)
            if out != dtype:
                casts.append((where, name))
            return out
        return cast

    monkeypatch.setattr(state, "cast_target", spy("body", state.cast_target))
    monkeypatch.setattr(registry, "cast_target",
                        spy("dispatch", registry.cast_target))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    y = rng.standard_normal((4, 5)).astype(np.float32)
    with ptt.amp.auto_cast(level="O1"):
        got = TF.fused_linear(ptt.to_tensor(x), ptt.to_tensor(y))
    with pt.amp.auto_cast(level="O1"):
        want = JF.fused_linear(pt.to_tensor(x), pt.to_tensor(y))
    assert casts == [("body", "fused_linear")] * 2
    assert str(got.dtype) == "torch.bfloat16"
    assert str(want.dtype).endswith("bfloat16")
    np.testing.assert_array_equal(
        got.astype("float32").numpy(),
        np.asarray(want.astype("float32").numpy()))


def _block_inputs(dropout=0.0):
    rng = np.random.default_rng(2)
    dm, h = 128, 2
    a = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    return dict(x=a(2, 128, dm), qkv_w=a(dm, 3 * dm), qkv_b=a(3 * dm),
                lin_w=a(dm, dm), lin_b=a(dm), ln_s=1 + a(dm), ln_b=a(dm),
                w1=a(dm, 256), w2=a(256, dm), b1=a(256), b2=a(dm), h=h)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_blocks_take_tensors(pre_ln):
    """fused_multi_head_attention and fused_feedforward (plain functions
    in both packages) on Tensors, dropout off: Tensors out, within 1e-4
    of the reference (outputs of order 10 after the pre-LN residuals; f32
    sums of 128-wide rows in other orders), the attention through B1's
    plain version and the norms through B4's."""
    d = _block_inputs()

    def run(P):
        T = P.to_tensor
        F = P.incubate.nn.functional
        att = F.fused_multi_head_attention(
            T(d["x"]), T(d["qkv_w"]), T(d["qkv_b"]), T(d["lin_w"]),
            T(d["lin_b"]), d["h"], pre_layer_norm=pre_ln,
            pre_ln_scale=T(d["ln_s"]), pre_ln_bias=T(d["ln_b"]),
            ln_scale=T(d["ln_s"]), ln_bias=T(d["ln_b"]), training=False)
        ffn = F.fused_feedforward(
            att, T(d["w1"]), T(d["w2"]), T(d["b1"]), T(d["b2"]),
            T(d["ln_s"]), T(d["ln_b"]), T(d["ln_s"]), T(d["ln_b"]),
            activation="gelu", pre_layer_norm=pre_ln, training=False)
        return att, ffn

    n = (fa.flash_fwd.plain_calls, norms.layer_norm_fwd.plain_calls)
    got = run(ptt)
    assert (fa.flash_fwd.plain_calls - n[0],
            norms.layer_norm_fwd.plain_calls - n[1]) == (1, 2)
    want = run(pt)
    for g, w in zip(got, want):
        assert isinstance(g, ptt.Tensor)
        _close(g.numpy(), np.asarray(w.numpy()), 1e-4, "block")


# ---------------------------------------------------------------------------
# attention-bias classes and memory_efficient_attention
# ---------------------------------------------------------------------------
PACKED = [48, 16, 40, 24]           # 128 tokens


def _biases(mod, bias_array):
    return {
        "lower": mod.LowerTriangularMask(),
        "lower_tensor": mod.LowerTriangularMaskWithTensorBias(bias_array),
        "block": mod.BlockDiagonalMask.from_seqlens(PACKED),
        "block_causal": mod.BlockDiagonalMask.from_seqlens(
            PACKED).make_causal(),
        "block_causal_kv": mod.BlockDiagonalCausalMask.from_seqlens(
            PACKED, [32, 32, 32, 32]),
    }


def test_attention_biases_materialize_as_the_reference():
    """Masks and keeps exactly: each class materialised at [1, 2, 128,
    128], segment ids and packing offsets."""
    rng = np.random.default_rng(3)
    alibi = rng.standard_normal((1, 2, 128, 128)).astype(np.float32)
    want = _biases(jab, pt.to_tensor(alibi))
    got = _biases(tab, torch.from_numpy(alibi))
    for k in want:
        w = np.asarray(want[k].materialize((1, 2, 128, 128)))
        g = got[k].materialize((1, 2, 128, 128)).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    info = tab.SeqLenInfo.from_seqlens(PACKED)
    assert info.seqstart == jab.SeqLenInfo.from_seqlens(PACKED).seqstart
    assert info.seqlens == PACKED
    np.testing.assert_array_equal(
        tab.segment_ids(info.seqstart, 128).numpy(),
        np.asarray(jab.segment_ids(info.seqstart, 128)))
    with pytest.raises(ValueError, match="seqlens sum"):
        tab.segment_ids(info.seqstart, 130)


@pytest.mark.parametrize("kind", [None, "lower", "lower_tensor", "block",
                                  "block_causal", "block_causal_kv",
                                  "raw"])
def test_memory_efficient_attention_matches_reference(kind):
    """Each bias kind on Tensors, forward and grads within 1e-4 (B1/B2's
    plain versions here against the reference's XLA attention): no bias
    and the lower triangle go to B1 (causal), the block-diagonal masks
    with equal packings to B1 with segment ids, the rest materialise a
    mask for the composite."""
    rng = np.random.default_rng(4)
    q, k, v = ((rng.standard_normal((2, 128, 2, 64)) * 0.5).astype(
        np.float32) for _ in range(3))
    alibi = rng.standard_normal((1, 2, 128, 128)).astype(np.float32)
    raw = np.where(rng.random((2, 1, 128, 128)) < 0.2, -1e30,
                   0.0).astype(np.float32)

    def run(P, mod):
        ts = [P.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        bias = None if kind is None else (
            P.to_tensor(raw) if kind == "raw" else
            _biases(mod, P.to_tensor(alibi))[kind])
        out = P.incubate.nn.memory_efficient_attention(*ts, attn_bias=bias,
                                                       scale=0.1)
        (out * P.to_tensor(alibi[0, :, :, :64].transpose(1, 0, 2))).sum() \
            .backward()
        return [out.numpy()] + [t.grad.numpy() for t in ts]

    n = fa.flash_fwd.plain_calls
    got = run(ptt, tab)
    b1 = fa.flash_fwd.plain_calls - n
    assert b1 == (1 if kind in (None, "lower", "block", "block_causal")
                  else 0)
    want = run(pt, jab)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, np.asarray(w), 1e-4, f"{kind} {i}")


def test_memory_efficient_attention_refuses_dropout():
    q = ptt.to_tensor(np.zeros((1, 128, 2, 64), np.float32))
    with pytest.raises(NotImplementedError, match="dropout"):
        ptt.incubate.nn.memory_efficient_attention(q, q, q, p=0.1)
