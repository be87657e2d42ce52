"""paddle_tpu_torch's hub, onnx and utils.cpp_extension against
paddle_tpu's: hub's list / help / load from a local hubconf.py (the
github and gitee sources download, which nothing here can test), onnx's
export raising with guidance, and a g++ host op built by both packages
from the same source, giving the same values (on a CUDA tensor:
chip_smoke.py's phase 35)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import hub as jhub
from paddle_tpu import onnx as jonnx
from paddle_tpu.utils import cpp_extension as jcpp
from paddle_tpu_torch import hub as thub
from paddle_tpu_torch import onnx as tonnx
from paddle_tpu_torch.utils import build as tbuild
from paddle_tpu_torch.utils import cpp_extension as tcpp
from torch_port_helpers import cpu_place

HUBCONF = '''
def tiny(width=4):
    """A tiny model: a list of `width` zeros."""
    return [0.0] * width


def _hidden():
    return None

NOT_CALLABLE = 3
'''

SRC = r'''
#include <cmath>
extern "C" void axpb(const void* const* in, const long long* sizes,
                     int n, void* out, long long n_out) {
  const float* x = static_cast<const float*>(in[0]);
  const float* y = static_cast<const float*>(in[1]);
  float* o = static_cast<float*>(out);
  for (long long i = 0; i < n_out; ++i) o[i] = 2.f * x[i] + std::sqrt(y[i]);
}
// PT_EXPORT_OP(total): the declaration form the reference's discovery
// also reads
extern "C" void total(const void* const* in, const long long* sizes,
                      int n, void* out, long long n_out) {
  const float* x = static_cast<const float*>(in[0]);
  float s = 0.f;
  for (long long i = 0; i < sizes[0]; ++i) s += x[i];
  static_cast<float*>(out)[0] = s;
}
'''


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.fixture
def repo(tmp_path):
    d = tmp_path / "hubrepo"
    d.mkdir()
    (d / "hubconf.py").write_text(HUBCONF)
    return str(d)


def test_hub_local_equals_the_reference(repo):
    for hub in (jhub, thub):
        assert hub.list(repo, source="local") == ["tiny"]
        assert "tiny model" in hub.help(repo, "tiny", source="local")
        assert hub.load(repo, "tiny", source="local", width=3) == [0.0] * 3
        with pytest.raises(RuntimeError, match="not found"):
            hub.load(repo, "NOT_CALLABLE", source="local")
        with pytest.raises(ValueError, match="unknown hub source"):
            hub.list(repo, source="ftp")
        with pytest.raises(FileNotFoundError, match="hubconf.py"):
            hub.list(repo + "/missing", source="local")


def test_hub_cache_lies_in_the_checkout(monkeypatch):
    monkeypatch.delenv("PADDLE_HUB_DIR", raising=False)
    assert thub._hub_dir() == str(tbuild.build_dir() / "hub")
    monkeypatch.setenv("PADDLE_HUB_DIR", "/elsewhere")
    assert thub._hub_dir() == "/elsewhere"


def test_onnx_export_raises_with_guidance():
    with pytest.raises(NotImplementedError, match="jit.save"):
        jonnx.export(None, "x")
    with pytest.raises(NotImplementedError,
                       match="paddle_tpu_torch.jit.save.*torch.export"):
        tonnx.export(ptt.nn.Linear(2, 2), "x")


@pytest.fixture
def sources(tmp_path):
    src = tmp_path / "ops.cc"
    src.write_text(SRC)
    return [str(src)]


def _port_module(sources, tmp_path):
    return tcpp.load("ptt_test_ops", sources,
                     build_directory=str(tmp_path / "build"))


def test_cpp_extension_equals_the_reference(sources, tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    y = rng.random((3, 5)).astype(np.float32)
    (tmp_path / "jbuild").mkdir()      # the reference's load makes none
    jm = jcpp.load("pt_test_ops", sources,
                   build_directory=str(tmp_path / "jbuild"))
    tm = _port_module(sources, tmp_path)
    want = jm.axpb(pt.to_tensor(x), pt.to_tensor(y)).numpy()
    got = tm.axpb(ptt.to_tensor(x), ptt.to_tensor(y))
    assert isinstance(got, ptt.Tensor) and got.stop_gradient
    np.testing.assert_array_equal(got.numpy(), want)
    # torch tensors and arrays are taken too; an output shape of its own
    s = tm.total(torch.from_numpy(x), out_shape=(1,))
    np.testing.assert_array_equal(
        s.numpy(), jm.total(pt.to_tensor(x), out_shape=(1,)).numpy())
    with pytest.raises(AttributeError, match="loaded ops"):
        tm.missing_op


def test_cpp_extension_builds_once_into_its_directory(sources, tmp_path):
    a = _port_module(sources, tmp_path)
    built = list((tmp_path / "build").glob("ptt_test_ops_*.so"))
    b = _port_module(sources, tmp_path)
    assert len(built) == 1
    assert list((tmp_path / "build").glob("ptt_test_ops_*.so")) == built
    assert a._ops.keys() == b._ops.keys() == {"axpb", "total"}
    assert tcpp.get_build_directory() == str(tbuild.build_dir())


def test_cpp_extension_refuses_device_code(sources, tmp_path):
    for m in (jcpp, tcpp):
        with pytest.raises(RuntimeError):
            m.CUDAExtension(sources=sources)
        with pytest.raises(RuntimeError):
            m.load("x", sources, extra_cuda_cflags=["-O3"],
                   build_directory=str(tmp_path))
    with pytest.raises(RuntimeError, match="utils.build"):
        tcpp.CUDAExtension(sources=sources)
    spec = tcpp.CppExtension(sources, extra_compile_args=["-O2"])
    assert spec.sources == sources and spec.kwargs == {
        "extra_compile_args": ["-O2"]}
    (tmp_path / "empty.cc").write_text("int f() { return 1; }\n")
    with pytest.raises(RuntimeError, match="no extern"):
        tcpp.load("empty", [str(tmp_path / "empty.cc")],
                  build_directory=str(tmp_path))

