"""save / load against the reference's (paddle_tpu/framework_io.py) on
the CPU: a file either package saves loads in the other, with equal
keys, arrays (bit for bit, bf16 included), stop_gradient and names; the
port's torch-level state_dicts are written in the same form; the save
is atomic under the ``framework_io.before_rename`` fault point (the
port's copy of tests/test_resilience.py's
``test_framework_io_atomic_save``) and a failed save leaves no temp
file."""
import os
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.resilience import faults
from torch_port_helpers import cpu_place


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _payload(P):
    rng = np.random.default_rng(5)
    w = P.to_tensor(rng.standard_normal((3, 4)).astype(np.float32),
                    stop_gradient=False)
    w.name = "w_0"
    return {"model": {"w": w,
                      "b": P.to_tensor(np.arange(4, dtype=np.int32)),
                      "h": P.to_tensor(rng.standard_normal(5).astype(
                          np.float32)).astype("bfloat16")},
            "step": 7, "tags": ["a", P.to_tensor(np.float32(2.5))],
            "pair": (1, "x")}


def _check_loaded(got, want_P):
    want = _payload(want_P)
    assert set(got) == set(want) and set(got["model"]) == {"w", "b", "h"}
    for k in ("w", "b", "h"):
        g, w = got["model"][k], want["model"][k]
        assert str(g.dtype).split(".")[-1] == str(w.dtype).split(".")[-1]
        np.testing.assert_array_equal(np.asarray(g.numpy()),
                                      np.asarray(w.numpy()))
        assert g.stop_gradient == w.stop_gradient
    assert got["model"]["w"].name == "w_0"
    assert got["step"] == 7 and got["pair"] == (1, "x")
    assert got["tags"][0] == "a" and float(got["tags"][1]) == 2.5


@pytest.mark.parametrize("saver,loader", [(ptt, pt), (pt, ptt), (ptt, ptt)],
                         ids=["port_to_reference", "reference_to_port",
                              "port_to_port"])
def test_a_file_loads_in_either_package(tmp_path, saver, loader):
    path = str(tmp_path / "obj.pdparams")
    saver.save(_payload(saver), path)
    _check_loaded(loader.load(path), saver)
    arrays = loader.load(path, return_numpy=True)
    assert isinstance(arrays["model"]["w"], np.ndarray)
    assert arrays["model"]["h"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(arrays["model"]["w"],
                                  _payload(saver)["model"]["w"].numpy())


def test_layer_state_dict_round_trips_through_the_reference(tmp_path):
    """A port Layer's state_dict saved by the port loads into the
    reference's same Layer, and back, with equal arrays."""
    path = str(tmp_path / "lin.pdparams")
    ptt.seed(3)
    tl = ptt.nn.Sequential(ptt.nn.Linear(4, 3), ptt.nn.LayerNorm(3))
    ptt.save(tl.state_dict(), path)
    jl = pt.nn.Sequential(pt.nn.Linear(4, 3), pt.nn.LayerNorm(3))
    assert jl.set_state_dict(pt.load(path)) == ([], [])
    for (k, a), (_, b) in zip(tl.state_dict().items(),
                              jl.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    pt.save(jl.state_dict(), path)
    fresh = ptt.nn.Sequential(ptt.nn.Linear(4, 3), ptt.nn.LayerNorm(3))
    ptr = fresh[0].weight._data.data_ptr()
    assert fresh.set_state_dict(ptt.load(path)) == ([], [])
    assert fresh[0].weight._data.data_ptr() == ptr
    np.testing.assert_array_equal(fresh[0].weight.numpy(),
                                  tl[0].weight.numpy())


def test_torch_state_dicts_are_written_in_the_reference_form(tmp_path):
    """``save(model.state_dict())`` of a torch-level model writes the
    entries the reference writes for the same values: the saved-Tensor
    dict with the array, stop_gradient and a name (None: a torch tensor
    has none); the reference loads them as Tensors."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    model = GPTForCausalLM(gpt_tiny(), device="cpu")
    sd = model.state_dict()
    ours, theirs = str(tmp_path / "port.pdparams"), str(tmp_path / "ref")
    ptt.save(sd, ours)
    pt.save({k: pt.to_tensor(v.numpy()) for k, v in sd.items()}, theirs)
    with open(ours, "rb") as f:
        a = pickle.load(f)
    with open(theirs, "rb") as f:
        b = pickle.load(f)
    assert list(a) == list(b) == list(sd)
    for k in sd:
        assert set(a[k]) == set(b[k]) == {"__paddle_tpu_tensor__", "data",
                                          "stop_gradient", "name"}
        assert a[k]["data"].dtype == b[k]["data"].dtype == np.float32
        np.testing.assert_array_equal(a[k]["data"], b[k]["data"])
        assert a[k]["stop_gradient"] is not sd[k].requires_grad
        assert a[k]["name"] is None
    loaded = pt.load(ours)
    np.testing.assert_array_equal(
        loaded["gpt.final_norm.weight"].numpy(),
        sd["gpt.final_norm.weight"].numpy())
    # and back into the torch-level model by torch's own load_state_dict
    back = ptt.load(ours, return_numpy=True)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in back.items()})


def test_framework_io_atomic_save(tmp_path):
    fp = str(tmp_path / "model.pdparams")
    a = np.arange(6, dtype=np.float32)
    ptt.save({"a": ptt.to_tensor(a)}, fp)
    with pytest.raises(KeyboardInterrupt):
        with faults.inject("framework_io.before_rename",
                           exc=KeyboardInterrupt("crash")):
            ptt.save({"a": ptt.to_tensor(a * 9)}, fp)
    # crash mid-save: the previous pickle is intact, not torn, and the
    # temp file is gone
    np.testing.assert_array_equal(ptt.load(fp)["a"].numpy(), a)
    assert os.listdir(tmp_path) == ["model.pdparams"]
    assert faults.fired("framework_io.before_rename") >= 1


def test_a_failed_save_leaves_no_temp_file(tmp_path):
    fp = str(tmp_path / "sub" / "x.pdparams")
    with pytest.raises(Exception):
        ptt.save({"f": lambda: 0}, fp)         # a lambda does not pickle
    assert os.listdir(tmp_path / "sub") == []


def test_fsync_dir_is_the_reference_helper():
    from paddle_tpu.utils import fs as jfs
    from paddle_tpu_torch.utils import fs as tfs
    import inspect
    assert inspect.signature(tfs.fsync_dir) == inspect.signature(
        jfs.fsync_dir)
    tfs.fsync_dir(".")
    tfs.fsync_dir("/no/such/dir")              # best effort: no raise
