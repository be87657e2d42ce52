"""jit.save -> torch.export -> jit.load / inference.Predictor on the
port, held to paddle_tpu's StableHLO round trip.

Mirrors tests/test_inference_export.py (all ten cases) on both packages
from the same weights (the reference draws them, the port loads them by
name) and the same numpy inputs; adds bert_tiny's encoder saved with a
symbolic batch and served by both packages' Predictors, the B1 operator
in the port's exported graph, a reference params-only artifact read by
the port's ``jit.load``, and the three files' form.

Tolerances (f32): ``TOL`` for the products of an MLP, GPT or BERT,
whose sums XLA and torch run in other orders (measured <= 1.7e-6, on
bert_tiny's hidden states); the port's loaded program against the port's own
eager model is bit-equal (the same torch ops on one thread)."""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import bert_params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from torch_port_helpers import cpu_place, jax_state_numpy, twin_gpts

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = [pytest.param(pt, id="ref"), pytest.param(ptt, id="port")]


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.fixture
def one_thread():
    """Bit-equality needs one summation order: torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(getattr(x, "numpy", lambda: x)(), np.float32)


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 32), P.nn.GELU(),
                           P.nn.Linear(32, 4))


def _twin_mlps(seed=3):
    """(reference MLP, port MLP) with the reference's weights."""
    pt.seed(seed)
    ref = _mlp(pt)
    port = _mlp(ptt)
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    return ref, port


def _saved(tmp_path, models, spec, name="m"):
    """Each package's model saved with its own InputSpec of `spec`
    ([(shape, dtype)]): {package: path}."""
    paths = {}
    for P, m in models.items():
        path = str(tmp_path / f"{name}_{P.__name__}")
        P.jit.save(m, path, input_spec=[P.jit.InputSpec(s, d)
                                        for s, d in spec])
        paths[P] = path
    return paths


# ---------------------------------------------------------------------------
# TestExportRoundTrip
# ---------------------------------------------------------------------------
def test_save_load_identical_logits(tmp_path):
    ref, port = _twin_mlps()
    paths = _saved(tmp_path, {pt: ref, ptt: port}, [([None, 8], "float32")])
    x = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    loaded = ptt.jit.load(paths[ptt])
    assert isinstance(loaded, ptt.jit.TranslatedLayer)
    got = _np(loaded(ptt.to_tensor(x)))
    np.testing.assert_array_equal(got, _np(port(ptt.to_tensor(x))))
    want = _np(pt.jit.load(paths[pt])(pt.to_tensor(x)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _np(ref(pt.to_tensor(x))), **TOL)


def test_symbolic_batch_serves_any_size(tmp_path):
    ref, port = _twin_mlps()
    paths = _saved(tmp_path, {pt: ref, ptt: port}, [([None, 8], "float32")])
    loaded = {P: P.jit.load(p) for P, p in paths.items()}
    rng = np.random.default_rng(1)
    for bs in (1, 3, 17):
        x = rng.standard_normal((bs, 8)).astype(np.float32)
        got = loaded[ptt](ptt.to_tensor(x))
        assert got.shape == [bs, 4]
        np.testing.assert_allclose(_np(got),
                                   _np(loaded[pt](pt.to_tensor(x))), **TOL)


def test_gpt_logits_roundtrip(tmp_path, one_thread):
    jm, tm = twin_gpts("gpt_tiny", seed=1, hidden_dropout_prob=0.0,
                       attention_dropout_prob=0.0)
    paths = _saved(tmp_path, {pt: jm, ptt: tm}, [([1, 16], "int32")], "gpt")
    ids = np.random.default_rng(0).integers(0, 1000, (1, 16)) \
        .astype(np.int32)
    got = _np(ptt.jit.load(paths[ptt])(ptt.to_tensor(ids)))
    np.testing.assert_array_equal(
        got, tm(torch.as_tensor(ids)).detach().numpy())
    want = _np(pt.jit.load(paths[pt])(pt.to_tensor(ids)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("P", PKGS)
def test_params_only_save_without_spec(tmp_path, P):
    m = _mlp(P)
    path = str(tmp_path / "m")
    P.jit.save(m, path)
    state = P.jit.load(path)
    assert isinstance(state, dict)
    assert any(k.endswith("weight") for k in state)
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(state[k], v.numpy())


def test_state_dict_exposed(tmp_path):
    ref, port = _twin_mlps()
    paths = _saved(tmp_path, {pt: ref, ptt: port}, [([2, 8], "float32")])
    sd = ptt.jit.load(paths[ptt]).state_dict()
    assert set(sd) == set(k for k, _ in port.named_parameters())
    want = pt.jit.load(paths[pt]).state_dict()
    assert set(sd) == set(want)
    for k in sd:
        np.testing.assert_array_equal(_np(sd[k]), _np(want[k]))


# ---------------------------------------------------------------------------
# TestPredictor
# ---------------------------------------------------------------------------
def test_handle_api(tmp_path):
    ref, port = _twin_mlps()
    paths = _saved(tmp_path, {pt: ref, ptt: port}, [([None, 8], "float32")])
    x = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)
    outs = {}
    for P, path in paths.items():
        cfg = P.inference.Config(path + ".pdmodel", path + ".pdiparams")
        pred = P.inference.create_predictor(cfg)
        assert pred.get_input_names() == ["x0"]
        pred.get_input_handle("x0").copy_from_cpu(x)
        pred.run()
        names = pred.get_output_names()
        assert names == ["out0"]
        outs[P] = pred.get_output_handle(names[0]).copy_to_cpu()
    np.testing.assert_array_equal(outs[ptt], _np(port(ptt.to_tensor(x))))
    np.testing.assert_allclose(outs[ptt], outs[pt], **TOL)


def test_direct_run(tmp_path):
    ref, port = _twin_mlps()
    paths = _saved(tmp_path, {pt: ref, ptt: port}, [([2, 8], "float32")])
    x = np.ones((2, 8), np.float32)
    outs = {}
    for P, path in paths.items():
        (outs[P],) = P.inference.create_predictor(
            P.inference.Config(path)).run([x])
    np.testing.assert_array_equal(outs[ptt], _np(port(ptt.to_tensor(x))))
    np.testing.assert_allclose(outs[ptt], outs[pt], **TOL)


@pytest.mark.parametrize("P", PKGS)
def test_missing_program_raises(tmp_path, P):
    path = str(tmp_path / "m")
    P.jit.save(_mlp(P), path)  # params only
    with pytest.raises(ValueError, match="no serialized program"):
        P.inference.create_predictor(P.inference.Config(path))


# ---------------------------------------------------------------------------
# TestSymbolicDims
# ---------------------------------------------------------------------------
def test_multiple_dynamic_dims_one_scope(tmp_path):
    pt.seed(4)
    ref = pt.nn.Sequential(pt.nn.Linear(8, 8))
    port = ptt.nn.Sequential(ptt.nn.Linear(8, 8))
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    paths = _saved(tmp_path, {pt: ref, ptt: port},
                   [([None, None, 8], "float32")])
    loaded = {P: P.jit.load(p) for P, p in paths.items()}
    rng = np.random.default_rng(2)
    for shp in ((2, 3, 8), (5, 7, 8)):
        x = rng.standard_normal(shp).astype(np.float32)
        got = loaded[ptt](ptt.to_tensor(x))
        assert got.shape == list(shp)
        np.testing.assert_allclose(_np(got),
                                   _np(loaded[pt](pt.to_tensor(x))), **TOL)


def _cat(P):
    class Cat(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = P.nn.Linear(8, 2)

        def forward(self, a, b):
            return self.lin(P.ops.concat([a, b], axis=0))
    return Cat()


def test_two_dynamic_inputs_independent_sizes(tmp_path):
    pt.seed(4)
    ref, port = _cat(pt), _cat(ptt)
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    paths = _saved(tmp_path, {pt: ref, ptt: port},
                   [([None, 8], "float32"), ([None, 8], "float32")])
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 8)).astype(np.float32)
    b = rng.standard_normal((5, 8)).astype(np.float32)
    outs = {P: P.jit.load(p)(P.to_tensor(a), P.to_tensor(b))
            for P, p in paths.items()}
    assert outs[ptt].shape == [7, 2]
    np.testing.assert_allclose(_np(outs[ptt]), _np(outs[pt]), **TOL)


# ---------------------------------------------------------------------------
# the port's own: BERT served by both Predictors, B1's operator, the
# artifact's form, the reference's artifacts
# ---------------------------------------------------------------------------
def test_bert_tiny_encoder_served_by_both_predictors(tmp_path):
    """bert_tiny's encoder (BertModel: hidden states and pooled output)
    saved once by the port with a symbolic batch and served at batches
    1, 3 and 17. The reference's own export cannot take a symbolic
    batch through BERT (its shape polymorphism raises
    InconclusiveDimensionOperation), so it saves one artifact a batch
    size; both are served by their package's Predictor."""
    cfg = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    pt.seed(0)
    jm = jbert.BertModel(jbert.bert_tiny(**cfg))
    jm.eval()
    tm = tbert.BertModel(tbert.bert_tiny(**cfg), device="cpu")
    tm.load_state_dict(bert_params_from_numpy(jax_state_numpy(jm)))
    tm.train()
    path = _saved(tmp_path, {ptt: tm}, [([None, 64], "int32")], "bert")[ptt]
    assert tm.training        # save runs eval and puts the mode back
    pred = ptt.inference.create_predictor(ptt.inference.Config(
        path + ".pdmodel", path + ".pdiparams"))
    rng = np.random.default_rng(0)
    for bs in (1, 3, 17):
        ids = rng.integers(0, 1024, (bs, 64)).astype(np.int32)
        ref_path = _saved(tmp_path, {pt: jm}, [([bs, 64], "int32")],
                          f"bert{bs}")[pt]
        ref_pred = pt.inference.create_predictor(pt.inference.Config(
            ref_path + ".pdmodel", ref_path + ".pdiparams"))
        outs = []
        for p in (pred, ref_pred):
            p.get_input_handle("x0").copy_from_cpu(ids)
            p.run()
            assert p.get_output_names() == ["out0", "out1"]
            outs.append([p.get_output_handle(n).copy_to_cpu()
                         for n in ("out0", "out1")])
        got, want = outs
        assert got[0].shape == (bs, 64, 128) and got[1].shape == (bs, 128)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


def test_exported_graph_holds_the_b1_operator(tmp_path, one_thread):
    """gpt_tiny at head_dim 64 with flash attention, seq 128: the saved
    program calls ``paddle_tpu_torch::flash_fwd`` (B1's operator, its
    plain version on the CPU) where the composite would be, and serves
    the eager model's logits bit for bit and the reference's (whose
    attention off the TPU is the composite) within TOL."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    kw = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
              max_position_embeddings=256, use_flash_attention=True,
              hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    jm, tm = twin_gpts("GPTConfig", seed=2, **kw)
    paths = _saved(tmp_path, {ptt: tm}, [([None, 128], "int32")],
                   "gpt_flash")
    # the reference's export takes no symbolic batch through GPT
    paths.update(_saved(tmp_path, {pt: jm}, [([3, 128], "int32")],
                        "gpt_flash"))
    with open(paths[ptt] + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    import io
    ep = torch.export.load(io.BytesIO(meta["program"]))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    flash = torch.ops.paddle_tpu_torch.flash_fwd.default
    assert targets.count(flash) == tm.config.num_layers
    ids = np.random.default_rng(4).integers(0, 1024, (3, 128)).astype(
        np.int32)
    loaded = ptt.jit.load(paths[ptt])
    before = fa.flash_fwd.plain_calls
    got = _np(loaded(ptt.to_tensor(ids)))
    assert fa.flash_fwd.plain_calls - before == tm.config.num_layers
    with torch.no_grad():
        np.testing.assert_array_equal(got, tm(torch.as_tensor(ids)).numpy())
    want = _np(pt.jit.load(paths[pt])(pt.to_tensor(ids)))
    np.testing.assert_allclose(got, want, **TOL)


def test_artifact_form(tmp_path):
    """The reference's three files: .pdiparams the state dict as numpy,
    .pdmodel a meta dict naming the port's format, .pdconsts the
    program's constants as numpy."""
    ref, port = _twin_mlps()
    path = _saved(tmp_path, {ptt: port}, [([None, 8], "float32")])[ptt]
    with open(path + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    with open(path + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    with open(path + ".pdconsts", "rb") as f:
        consts = pickle.load(f)
    assert set(state) == set(port.state_dict())
    assert meta["format"] == "paddle_tpu_torch.export.v1"
    assert meta["input_spec"] == [([None, 8], "float32")]
    assert meta["n_consts"] == len(consts) == 4
    assert all(isinstance(c, np.ndarray) for c in consts)
    assert sorted(c.size for c in consts) == sorted(
        v.size for v in state.values())


def test_reference_params_only_artifact_loads(tmp_path):
    ref, _ = _twin_mlps()
    path = str(tmp_path / "ref")
    pt.jit.save(ref, path)
    state = ptt.jit.load(path)
    assert isinstance(state, dict)
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(state[k], v.numpy())


def test_reference_program_is_refused(tmp_path):
    ref, _ = _twin_mlps()
    path = str(tmp_path / "ref")
    pt.jit.save(ref, path, input_spec=[pt.jit.InputSpec([2, 8])])
    with pytest.raises(ValueError, match="cannot run"):
        ptt.jit.load(path)


class _MixedNorms(torch.nn.Module):
    """B4 and B5 over bf16 activations with f32 affine parameters (an
    O1 model keeps its norms' parameters in f32)."""

    def __init__(self, h=64, seed=0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.w = torch.nn.Parameter(torch.as_tensor(
            rng.uniform(0.5, 1.5, h).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.as_tensor(
            rng.standard_normal(h).astype(np.float32)))
        self.g = torch.nn.Parameter(torch.as_tensor(
            rng.uniform(0.5, 1.5, h).astype(np.float32)))

    def forward(self, x):
        from paddle_tpu_torch.kernels import norms
        return norms.layer_norm(x, self.w, self.b), norms.rms_norm(x, self.g)


def test_norm_operators_keep_the_input_dtype(tmp_path):
    """The saved program holds B4's and B5's operators, and their output
    is x's dtype (bf16 here, f32 parameters) on the CPU as the kernels'
    is on the card, so the graph's recorded dtypes hold on every device:
    the CPU implementation is the kernels' plain version, bit for bit."""
    from paddle_tpu_torch.kernels import norms
    m = _MixedNorms().eval()
    path = _saved(tmp_path, {ptt: m}, [([None, 64], "bfloat16")],
                  "norms")[ptt]
    with open(path + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    import io
    ep = torch.export.load(io.BytesIO(meta["program"]))
    calls = {n.target: n for n in ep.graph.nodes if n.op == "call_function"}
    for op in (torch.ops.paddle_tpu_torch.layer_norm.default,
               torch.ops.paddle_tpu_torch.rms_norm.default):
        assert calls[op].meta["val"].dtype == torch.bfloat16
    x = torch.as_tensor((np.random.default_rng(1).standard_normal(
        (5, 64)) * 2 + 1).astype(np.float32)).to(torch.bfloat16)
    got = [t._data for t in ptt.jit.load(path)(x)]
    with torch.no_grad():
        want = (norms._ln_plain(x, m.w, m.b, 1e-5),
                norms._rms_plain(x, m.g, 1e-6))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w, rtol=0, atol=0)
