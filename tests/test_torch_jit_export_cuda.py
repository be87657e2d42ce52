"""jit.save / jit.load and the inference Predictor on the card, at small
sizes (chip_smoke.py's phase 27 runs bert_base at full width). Every
test here is marked `cuda` and skips without one.

This file imports neither jax nor paddle_tpu, so it runs on a machine
that has only the port's dependencies:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_jit_export_cuda.py
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels and graphs have "
                    "no CPU mode)")
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as tdevice
    saved = tdevice._current_place
    P.set_device("gpu:0")
    yield P
    tdevice._current_place = saved


def _bert(P, layers=2):
    """A bf16 BertModel at bert_base's widths, `layers` deep, eval."""
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(num_layers=layers, hidden_dropout_prob=0.0,
                         attention_dropout_prob=0.0)
    torch.manual_seed(0)
    m = bert.BertModel(cfg, device="cuda")
    P.amp.decorate(models=m, level="O2", dtype="bfloat16")
    return m.eval()


def _ids(b, s=512, seed=0):
    return np.random.default_rng(seed).integers(0, 30522, (b, s)).astype(
        np.int64)


@pytest.mark.cuda
def test_loaded_program_launches_b1(card, tmp_path):
    """The loaded program's B1 calls go through the operator to the sm90
    kernel, one a layer, counted; its outputs equal the eager model's."""
    P = card
    from paddle_tpu_torch.kernels import flash_attention as fa
    m = _bert(P)
    path = str(tmp_path / "bert")
    P.jit.save(m, path, input_spec=[P.jit.InputSpec([None, 512], "int64")])
    loaded = P.jit.load(path)
    ids = _ids(4)
    fa.reset_counters()
    out = loaded(P.to_tensor(ids, dtype="int64"))
    torch.cuda.synchronize()
    assert fa.flash_fwd.design_launches == {"sm90": 2, "simple": 0}
    assert fa.flash_fwd.plain_calls == 0
    with torch.no_grad():
        want = m(torch.as_tensor(ids, device="cuda"))
    for g, w in zip(out, want):
        torch.testing.assert_close(g._data, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_operators_equal_the_launchers(card, dtype):
    """B1's, B4's and B5's operators return what their launchers return,
    bit for bit (the operators call them)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import norms
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 256, 4, 64, device="cuda", generator=g,
                           dtype=dtype) for _ in range(3))
    seg = torch.zeros(2, 256, dtype=torch.int32, device="cuda")
    seg[:, 128:] = 1
    for s in (None, (seg, seg)):
        want = fa._fwd_cuda(q, k, v, True, s)
        got = torch.ops.paddle_tpu_torch.flash_fwd(
            q, k, v, None if s is None else seg, None if s is None else seg,
            True)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = torch.randn(64, 768, device="cuda", generator=g, dtype=dtype)
    w, b = (torch.randn(768, device="cuda", generator=g, dtype=dtype)
            for _ in range(2))
    torch.testing.assert_close(
        torch.ops.paddle_tpu_torch.layer_norm(x, w, b, 1e-5),
        norms._norm_cuda(False, x, w, b, 1e-5), rtol=0, atol=0)
    torch.testing.assert_close(
        torch.ops.paddle_tpu_torch.rms_norm(x, w, 1e-6),
        norms._norm_cuda(True, x, w, None, 1e-6), rtol=0, atol=0)


@pytest.mark.cuda
def test_predictor_replay_equals_the_loaded_module(card, tmp_path):
    """The Predictor's graph replays equal the loaded program's eager
    call bit for bit, at two batch sizes (one capture each) and on a
    repeated size (a replay of the first graph)."""
    P = card
    from paddle_tpu_torch.jit import cuda_graph
    m = _bert(P)
    path = str(tmp_path / "bert")
    P.jit.save(m, path, input_spec=[P.jit.InputSpec([None, 512], "int64")])
    pred = P.inference.create_predictor(P.inference.Config(
        path + ".pdmodel", path + ".pdiparams"))
    cuda_graph.reset_counters()
    for b, seed in ((4, 0), (2, 1), (4, 2)):
        ids = _ids(b, seed=seed)
        got = pred.run([ids])
        want = pred._layer(P.to_tensor(ids, dtype="int64"))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.uint16),
                                          w.numpy().view(np.uint16))
    assert cuda_graph.captures["predictor"] == 2
    assert cuda_graph.replays["predictor"] == 3


@pytest.mark.cuda
def test_program_saved_on_the_cpu_serves_on_the_card(card, tmp_path):
    """A program exported from CPU tensors is moved to the card at load
    and agrees with its CPU run (f32, TF32 off)."""
    P = card
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    torch.manual_seed(0)
    m = bert.BertModel(cfg, device="cpu").eval()
    path = str(tmp_path / "tiny")
    P.jit.save(m, path, input_spec=[P.jit.InputSpec([None, 128], "int64")])
    ids = np.random.default_rng(0).integers(0, 1024, (3, 128))
    cpu = P.jit.load(path, device="cpu")(ids)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = P.inference.create_predictor(P.inference.Config(path)).run(
            [ids])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for g, c in zip(gpu, cpu):
        np.testing.assert_allclose(g, c.numpy(), rtol=1e-5, atol=1e-5)


class _MixedNorms(torch.nn.Module):
    """B4 and B5 over bf16 activations with f32 affine parameters."""

    def __init__(self, h=768, seed=0):
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


@pytest.mark.cuda
def test_mixed_dtype_norms_saved_on_the_cpu_serve_on_the_card(card,
                                                              tmp_path):
    """A bf16-input LayerNorm and RMSNorm with f32 weights, saved on the
    CPU and served on the card: B4 and B5 launch from the loaded program
    and return bf16, the dtype the program recorded, as its CPU run
    does. Each value agrees with the CPU run's within one bf16 ulp
    (2^-7 relative: both sides round the f32 value once), or, near 0
    after centring, within f32 noise of its row (2^-8 of the row's rms),
    the limit tests/test_torch_kernels_cuda.py holds B4/B5 to."""
    P = card
    from paddle_tpu_torch.kernels import norms
    path = str(tmp_path / "norms")
    P.jit.save(_MixedNorms().eval(), path,
               input_spec=[P.jit.InputSpec([None, 768], "bfloat16")])
    x = torch.as_tensor((np.random.default_rng(1).standard_normal(
        (40, 768)) * 2 + 1).astype(np.float32)).to(torch.bfloat16)
    cpu = [t._data for t in P.jit.load(path, device="cpu")(x)]
    for f in (norms.layer_norm_fwd, norms.rms_norm_fwd):
        f.kernel_launches = f.plain_calls = 0
    served = [t._data for t in P.jit.load(path)(x.cuda())]
    torch.cuda.synchronize()
    assert norms.layer_norm_fwd.kernel_launches == 1
    assert norms.rms_norm_fwd.kernel_launches == 1
    assert norms.layer_norm_fwd.plain_calls == 0
    assert norms.rms_norm_fwd.plain_calls == 0
    for name, got, want in zip(("layer_norm", "rms_norm"), served, cpu):
        assert got.dtype == want.dtype == torch.bfloat16, name
        got, want = got.float().cpu(), want.float()
        row = want.pow(2).mean(-1, keepdim=True).sqrt()
        ratio = (got - want).abs() / (2.0 ** -7 * (want.abs()
                                                  + 2.0 ** -8 * row))
        assert float(ratio.max()) <= 1.0, (name, float(ratio.max()))
