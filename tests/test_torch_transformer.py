"""paddle_tpu_torch.nn's transformer layers and containers against
paddle_tpu's.

Each layer is built by paddle_tpu (weights from ``pt.seed``), loaded
into the port's by name, and both run the same numpy inputs in f32 on
the CPU: the attention is the composite on both sides (no TPU kernel
there, no card here)."""
import copy
from collections import OrderedDict

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.nn.layers import common as jcommon
from paddle_tpu.nn.layers import container as jcontainer
from paddle_tpu.nn.layers import transformer as jt
from paddle_tpu_torch.convert import gpt_params_from_numpy
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Linear, container as tcontainer
from paddle_tpu_torch.nn.layers import transformer as tt
from torch_port_helpers import jax_state_numpy

D_MODEL, NHEAD, FFN = 32, 4, 64
B, S, S_MEM = 2, 8, 6
# f32 on both sides, the same math summed in other orders (XLA against
# torch): ~1e-7 relative per product, a few ulps after the layer norms
TOL = dict(rtol=1e-5, atol=2e-6)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, torch.Tensor) else x.detach().numpy())


def _twin(build_ref, build_port, seed=0):
    """(reference layer, port layer) with the reference's weights."""
    pt.seed(seed)
    ref = build_ref()
    ref.eval()
    port = build_port()
    port.load_state_dict(gpt_params_from_numpy(jax_state_numpy(ref)))
    port.eval()
    return ref, port


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _masks(kind, sq, sk):
    """(reference mask, port mask) of `kind`: None, an additive f32
    [b, 1, sq, sk] mask with a few -1e9 entries, or a boolean one."""
    if kind is None:
        return None, None
    rng = np.random.default_rng(7)
    keep = rng.random((B, 1, sq, sk)) > 0.25
    keep[..., 0] = True                      # no row masked out entirely
    m = keep if kind == "bool" else np.where(keep, 0.0, -1e9).astype(
        np.float32)
    return pt.to_tensor(m), torch.as_tensor(m)


def _encoder_layer(pkg, normalize_before, **kw):
    mod = jt if pkg == "ref" else tt
    extra = {} if pkg == "ref" else {"device": "cpu"}
    return mod.TransformerEncoderLayer(
        D_MODEL, NHEAD, FFN, dropout=0.0, activation="gelu",
        normalize_before=normalize_before, **kw, **extra)


@pytest.mark.parametrize("mask", [None, "additive", "bool"])
@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_encoder_matches_reference(normalize_before, mask):
    ref, port = _twin(
        lambda: jt.TransformerEncoder(
            _encoder_layer("ref", normalize_before), 3),
        lambda: tt.TransformerEncoder(
            _encoder_layer("port", normalize_before), 3))
    x = _x((B, S, D_MODEL), 1)
    jm, tm = _masks(mask, S, S)
    want = ref(pt.to_tensor(x), jm)
    got = port(torch.as_tensor(x), tm)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_encoder_incremental_cache_matches_reference(normalize_before):
    """Two chunks through gen_cache's incremental caches: outputs and
    the caches' k/v against the reference's."""
    ref, port = _twin(
        lambda: jt.TransformerEncoder(
            _encoder_layer("ref", normalize_before), 2),
        lambda: tt.TransformerEncoder(
            _encoder_layer("port", normalize_before), 2))
    x = _x((B, S, D_MODEL), 2)
    jc = ref.gen_cache(pt.to_tensor(x))
    tc = port.gen_cache(torch.as_tensor(x))
    assert [tuple(c.k.shape) for c in tc] == [tuple(c.k.shape) for c in jc]
    for lo, hi in ((0, 5), (5, S)):
        want, jc = ref(pt.to_tensor(x[:, lo:hi]), None, jc)
        got, tc = port(torch.as_tensor(x[:, lo:hi]), None, tc)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        for a, b in zip(tc, jc):
            assert isinstance(a, tt.MultiHeadAttention.Cache)
            np.testing.assert_allclose(_np(a.k), _np(b.k), **TOL)
            np.testing.assert_allclose(_np(a.v), _np(b.v), **TOL)
    assert tc[0].k.shape[1] == S


def _decoder_layer(pkg, normalize_before):
    mod = jt if pkg == "ref" else tt
    extra = {} if pkg == "ref" else {"device": "cpu"}
    return mod.TransformerDecoderLayer(
        D_MODEL, NHEAD, FFN, dropout=0.0, normalize_before=normalize_before,
        **extra)


@pytest.mark.parametrize("masks", [False, True], ids=["no_mask", "masks"])
@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_decoder_matches_reference(normalize_before, masks):
    ref, port = _twin(
        lambda: jt.TransformerDecoder(
            _decoder_layer("ref", normalize_before), 2),
        lambda: tt.TransformerDecoder(
            _decoder_layer("port", normalize_before), 2))
    tgt, mem = _x((B, S, D_MODEL), 3), _x((B, S_MEM, D_MODEL), 4)
    jargs, targs = [], []
    if masks:
        jargs = [jt.Transformer.generate_square_subsequent_mask(S),
                 _masks("additive", S, S_MEM)[0]]
        targs = [tt.Transformer.generate_square_subsequent_mask(
            S, device="cpu"), _masks("additive", S, S_MEM)[1]]
    want = ref(pt.to_tensor(tgt), pt.to_tensor(mem), *jargs)
    got = port(torch.as_tensor(tgt), torch.as_tensor(mem), *targs)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_decoder_caches_match_reference(normalize_before):
    """Token-by-token decoding through gen_cache (an incremental cache
    for the self-attention, a StaticCache of the memory for the cross
    attention) against the reference's, and against one masked pass
    over the whole target on the port."""
    ref, port = _twin(
        lambda: jt.TransformerDecoder(
            _decoder_layer("ref", normalize_before), 2),
        lambda: tt.TransformerDecoder(
            _decoder_layer("port", normalize_before), 2))
    tgt, mem = _x((B, S, D_MODEL), 5), _x((B, S_MEM, D_MODEL), 6)
    jmem, tmem = pt.to_tensor(mem), torch.as_tensor(mem)
    jc, tc = ref.gen_cache(jmem), port.gen_cache(tmem)
    assert isinstance(tc[0][1], tt.MultiHeadAttention.StaticCache)
    steps = []
    for i in range(S):
        want, jc = ref(pt.to_tensor(tgt[:, i:i + 1]), jmem, None, None, jc)
        got, tc = port(torch.as_tensor(tgt[:, i:i + 1]), tmem, None, None,
                       tc)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        steps.append(_np(got))
    assert tc[1][0].k.shape[1] == S
    whole = port(torch.as_tensor(tgt), tmem,
                 tt.Transformer.generate_square_subsequent_mask(
                     S, device="cpu"))
    np.testing.assert_allclose(np.concatenate(steps, axis=1), _np(whole),
                               **TOL)


@pytest.mark.parametrize("masks", [False, True], ids=["no_mask", "masks"])
@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_transformer_matches_reference(normalize_before, masks):
    kw = dict(d_model=D_MODEL, nhead=NHEAD, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FFN, dropout=0.0,
              normalize_before=normalize_before)
    ref, port = _twin(lambda: jt.Transformer(**kw),
                      lambda: tt.Transformer(**kw, device="cpu"))
    assert (port.encoder.norm is None) == (not normalize_before)
    src, tgt = _x((B, S_MEM, D_MODEL), 8), _x((B, S, D_MODEL), 9)
    jargs, targs = [], []
    if masks:
        js, ts = _masks("bool", S_MEM, S_MEM)
        jargs = [js, jt.Transformer.generate_square_subsequent_mask(S)]
        targs = [ts, tt.Transformer.generate_square_subsequent_mask(
            S, device="cpu")]
    want = ref(pt.to_tensor(src), pt.to_tensor(tgt), *jargs)
    got = port(torch.as_tensor(src), torch.as_tensor(tgt), *targs)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_square_subsequent_mask_equals_reference():
    want = jt.Transformer.generate_square_subsequent_mask(5).numpy()
    got = tt.Transformer.generate_square_subsequent_mask(5, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cache", [None, "incremental", "static"])
def test_multi_head_attention_matches_reference(cache):
    """Cross attention with kdim/vdim other than embed_dim, without a
    cache, with an incremental Cache (k/v appended) and with a
    StaticCache (k/v given)."""
    kw = dict(embed_dim=D_MODEL, num_heads=NHEAD, kdim=24, vdim=16)
    ref, port = _twin(lambda: jt.MultiHeadAttention(**kw),
                      lambda: tt.MultiHeadAttention(**kw, device="cpu"))
    q, k, v = (_x((B, S, D_MODEL), 10), _x((B, S_MEM, 24), 11),
               _x((B, S_MEM, 16), 12))
    jq, jk, jv = map(pt.to_tensor, (q, k, v))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    if cache is None:
        np.testing.assert_allclose(_np(port(tq, tk, tv)),
                                   _np(ref(jq, jk, jv)), **TOL)
        return
    if cache == "static":
        jc = ref.gen_cache(jk, jv, jt.MultiHeadAttention.StaticCache)
        tc = port.gen_cache(tk, tv, tt.MultiHeadAttention.StaticCache)
        np.testing.assert_allclose(_np(port(tq, None, None, None, tc)),
                                   _np(ref(jq, None, None, None, jc)), **TOL)
        return
    jc, tc = ref.gen_cache(jk), port.gen_cache(tk)
    assert tc.k.shape == (B, 0, NHEAD, D_MODEL // NHEAD)
    for _ in range(2):
        want, jc = ref(jq, jk, jv, None, jc)
        got, tc = port(tq, tk, tv, None, tc)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tc.v), _np(jc.v), **TOL)
    assert tc.k.shape[1] == 2 * S_MEM


def test_encoder_layers_start_identical_as_in_reference():
    """TransformerEncoder deep-copies the one layer it is given, in both
    packages: every layer's weights equal the first's, and the copies
    are separate parameters."""
    pt.seed(0)
    ref = jt.TransformerEncoder(_encoder_layer("ref", False), 3)
    port = tt.TransformerEncoder(_encoder_layer("port", False), 3)
    for enc, state in ((ref, jax_state_numpy(ref)),
                       ({k: v.numpy() for k, v in port.state_dict().items()},
                        None)):
        sd = state if state is not None else enc
        for name, val in sd.items():
            if name.startswith("layers.0."):
                for i in (1, 2):
                    np.testing.assert_array_equal(
                        sd[name.replace("layers.0.", f"layers.{i}.")], val)
    ptrs = {p.data_ptr() for p in torch.nn.Module.parameters(port)}
    assert len(ptrs) == len(list(torch.nn.Module.parameters(port)))
    decoder = tt.TransformerDecoder(_decoder_layer("port", False), 2)
    for a, b in zip(torch.nn.Module.parameters(decoder.layers[0]),
                    torch.nn.Module.parameters(decoder.layers[1])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_layers_draw_the_reference_defaults():
    """Linear weights XavierUniform (within sqrt(6 / (in + out))),
    biases 0, LayerNorm 1 and 0; weight_attr / bias_attr initializers
    and bias_attr=False as in the reference; draws follow the
    generator given."""
    from paddle_tpu_torch.nn import initializer as I
    gen = torch.Generator().manual_seed(0)
    layer = tt.TransformerEncoderLayer(D_MODEL, NHEAD, FFN, device="cpu",
                                       init_generator=gen)
    w = layer.linear1.weight.detach()
    limit = np.sqrt(6.0 / (D_MODEL + FFN))
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > \
        0.9 * limit
    assert float(layer.linear1.bias.abs().max()) == 0.0
    assert torch.equal(layer.norm1.weight._data, torch.ones(D_MODEL))
    again = tt.TransformerEncoderLayer(
        D_MODEL, NHEAD, FFN, device="cpu",
        init_generator=torch.Generator().manual_seed(0))
    for a, b in zip(torch.nn.Module.parameters(layer),
                    torch.nn.Module.parameters(again)):
        assert torch.equal(a, b)
    mha = tt.MultiHeadAttention(D_MODEL, NHEAD, weight_attr=I.Constant(0.5),
                                bias_attr=False, device="cpu")
    assert mha.q_proj.bias is None
    assert torch.equal(mha.out_proj.weight._data,
                       torch.full((D_MODEL, D_MODEL), 0.5))
    jm = jt.MultiHeadAttention(D_MODEL, NHEAD, bias_attr=False)
    assert sorted(jax_state_numpy(jm)) == sorted(mha.state_dict())


@pytest.mark.parametrize("attr", [True, "w"], ids=["true", "string"])
def test_other_attrs_take_the_defaults_as_in_reference(attr):
    """The reference's create_parameter (nn/layer.py:143-158) gives the
    default initializer for a weight_attr / bias_attr that is neither
    None, False, a ParamAttr nor callable: both packages build such a
    layer with the same names, Xavier-bounded weights and zero biases.
    A ParamAttr's initializer is taken, as in the reference's."""
    from paddle_tpu.nn.param_attr import ParamAttr
    from paddle_tpu_torch.nn import initializer as I
    pt.seed(0)
    want = jax_state_numpy(jt.MultiHeadAttention(
        D_MODEL, NHEAD, weight_attr=attr, bias_attr=attr))
    got = {k: v.numpy() for k, v in tt.MultiHeadAttention(
        D_MODEL, NHEAD, weight_attr=attr, bias_attr=attr, device="cpu",
        init_generator=torch.Generator().manual_seed(0)).state_dict().items()}
    assert sorted(got) == sorted(want)
    limit = np.sqrt(6.0 / (2 * D_MODEL))
    for name in want:
        for x in (got[name], want[name]):
            if name.endswith("bias"):
                assert not x.any()
            else:
                assert 0.9 * limit < np.abs(x).max() <= limit
    from paddle_tpu.nn import initializer as JI
    from paddle_tpu_torch.nn import ParamAttr as TParamAttr
    got = tt.MultiHeadAttention(
        D_MODEL, NHEAD, weight_attr=TParamAttr(initializer=I.Constant(0.5)),
        device="cpu")
    want = jt.MultiHeadAttention(
        D_MODEL, NHEAD, weight_attr=ParamAttr(initializer=JI.Constant(0.5)))
    for (n, a), (_, b) in zip(got.named_parameters(),
                              want.named_parameters()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b._data),
                                      err_msg=n)


def test_transformer_layers_need_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.TransformerEncoderLayer(D_MODEL, NHEAD, FFN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.Transformer(D_MODEL, NHEAD, 1, 1, FFN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.Transformer.generate_square_subsequent_mask(4)


def test_tanh_follows_its_input_under_amp():
    from paddle_tpu_torch import amp
    x = torch.linspace(-3, 3, 7)
    np.testing.assert_allclose(F.tanh(x).numpy(),
                               pt.ops.tanh(pt.to_tensor(x.numpy())).numpy(),
                               rtol=1e-6)
    for level in ("O1", "O2"):
        with amp.auto_cast(level=level), pt.amp.auto_cast(level=level):
            got = F.tanh(x)
            want = pt.ops.tanh(pt.to_tensor(x.numpy()))
        # f32 stays f32 under O1 (neither list), goes low under O2
        assert str(got.dtype).split(".")[-1] == str(want.dtype).split(
            ".")[-1] == {"O1": "float32", "O2": "bfloat16"}[level]


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------
def _linears(pkg, n):
    if pkg == "ref":
        return [jcommon.Linear(2, 3) for _ in range(n)]
    return [Linear(2, 3, device="cpu") for _ in range(n)]


def _names(m):
    return [n for n, _ in m.named_parameters()]


@pytest.mark.parametrize("form", ["positional", "pairs", "ordered_dict"])
def test_sequential_matches_reference(form):
    built = {}
    for pkg, mod in (("ref", jcontainer), ("port", tcontainer)):
        ls = _linears(pkg, 3)
        if form == "positional":
            seq = mod.Sequential(*ls)
        elif form == "pairs":
            seq = mod.Sequential(("a", ls[0]), ("b", ls[1]), ("c", ls[2]))
        else:
            seq = mod.Sequential(OrderedDict(zip("xyz", ls)))
        built[pkg] = (seq, ls)
    (jseq, jls), (tseq, tls) = built["ref"], built["port"]
    assert _names(tseq) == _names(jseq)
    assert len(tseq) == len(jseq) == 3
    assert [tls.index(m) for m in tseq] == [jls.index(m) for m in jseq]
    assert tseq[-1] is tls[2] and jseq[-1] is jls[2]
    tsl, jsl = tseq[1:], jseq[1:]
    assert isinstance(tsl, tcontainer.Sequential)
    assert _names(tsl) == _names(jsl) == ["0.weight", "0.bias", "1.weight",
                                          "1.bias"]
    # forward: each layer in turn, as the reference's
    chain = [Linear(2, 3, device="cpu"), Linear(3, 3, device="cpu")]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in (p for lin in chain
                  for p in torch.nn.Module.parameters(lin)):
            p.normal_(generator=gen)
    x = torch.as_tensor(_x((4, 2), 13))
    torch.testing.assert_close(tcontainer.Sequential(*chain)(x),
                               chain[1](chain[0](x)), rtol=0, atol=0)


def test_layer_list_matches_reference():
    built = {}
    for pkg, mod in (("ref", jcontainer), ("port", tcontainer)):
        ls = _linears(pkg, 4)
        lst = mod.LayerList(ls[:2])
        lst.append(ls[2])
        lst.insert(1, ls[3])
        built[pkg] = (lst, ls)
    (jl, jls), (tl, tls) = built["ref"], built["port"]
    assert _names(tl) == _names(jl)
    assert [tls.index(m) for m in tl] == [jls.index(m) for m in jl] \
        == [0, 3, 1, 2]
    assert tl[-1] is tls[2] and jl[-1] is jls[2]
    assert isinstance(tl[1:3], tcontainer.LayerList)
    assert [tls.index(m) for m in tl[1:3]] == [3, 1]
    extra = _linears("port", 1)[0]
    tl[0] = extra
    assert tl[0] is extra and len(tl) == 4
    tl.extend(_linears("port", 2))
    assert len(tl) == 6 and _names(tl)[-2:] == ["5.weight", "5.bias"]


def test_parameter_list_matches_reference():
    vals = [np.full((2,), i, np.float32) for i in range(3)]
    jp = jcontainer.ParameterList([pt.to_tensor(v) for v in vals[:2]])
    jp.append(pt.to_tensor(vals[2]))
    tp = tcontainer.ParameterList([torch.as_tensor(v) for v in vals[:2]])
    tp.append(torch.as_tensor(vals[2]))
    assert len(tp) == len(jp) == 3
    assert _names(tp) == _names(jp) == ["0", "1", "2"]
    # the reference's Parameters, each over a torch parameter
    assert all(isinstance(p, ptt.nn.Parameter) for p in tp)
    assert all(isinstance(p._data, torch.nn.Parameter) for p in tp)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.detach().numpy(), b.numpy())
    np.testing.assert_array_equal(tp[1].detach().numpy(), jp[1].numpy())


def test_layer_dict_matches_reference():
    built = {}
    for pkg, mod in (("ref", jcontainer), ("port", tcontainer)):
        ls = _linears(pkg, 4)
        d = mod.LayerDict({"b": ls[0], "a": ls[1]})
        d.update([("c", ls[2])])
        d["d"] = ls[3]
        popped = d.pop("a")
        built[pkg] = (d, ls, popped)
    (jd, jls, jpop), (td, tls, tpop) = built["ref"], built["port"]
    assert tpop is tls[1] and jpop is jls[1]
    assert list(td.keys()) == list(jd.keys()) == ["b", "c", "d"]
    assert list(td) == list(jd)
    assert [tls.index(m) for m in td.values()] == \
        [jls.index(m) for m in jd.values()]
    assert [(k, tls.index(m)) for k, m in td.items()] == \
        [(k, jls.index(m)) for k, m in jd.items()]
    assert ("c" in td) == ("c" in jd) and ("a" in td) == ("a" in jd)
    assert td["d"] is tls[3] and len(td) == len(jd) == 3
    del td["b"]
    del jd["b"]
    assert _names(td) == _names(jd)


def test_containers_deep_copy_with_their_children():
    seq = tcontainer.Sequential(*_linears("port", 2))
    twin = copy.deepcopy(seq)
    for a, b in zip(torch.nn.Module.parameters(seq),
                    torch.nn.Module.parameters(twin)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
