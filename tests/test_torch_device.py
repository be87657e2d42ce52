"""paddle_tpu_torch.device and device.memory against paddle_tpu.device on
the CPU: the reference's names, the memory functions' shapes and their
CPU answers (zeros, an empty memory_stats), state_bytes_per_device
exact on the same arrays, streams and events inert on the CPU place,
the entry-point rule (the default place is the card: without one the
functions raise until set_device("cpu")), and FLAGS_allocator_strategy.
The card's answers against torch.cuda's: tests/test_torch_obs_cuda.py."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import device as jdev
from paddle_tpu.device import memory as jmem
import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as tdev
from paddle_tpu_torch.device import memory as tmem
from torch_port_helpers import cpu_place

MEMORY_FNS = ("memory_allocated", "max_memory_allocated",
              "memory_reserved", "max_memory_reserved")


def test_memory_functions_on_the_cpu_answer_as_the_reference():
    with cpu_place():
        for name in MEMORY_FNS:
            got = getattr(tmem, name)()
            assert isinstance(got, int) and got == 0, name
            assert isinstance(getattr(jmem, name)(), int)
        assert tmem.memory_stats() == {}
        assert isinstance(jmem.memory_stats(), dict)
        tmem.reset_max_memory_allocated()
        tmem.reset_peak_memory_stats()
        tmem.empty_cache()
        for name in MEMORY_FNS + ("memory_stats",):
            assert getattr(tdev.cuda, name)("cpu") == getattr(tmem, name)()


def test_state_bytes_per_device_exact():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(dt) for s, dt in (
        ((3, 5), np.float32), ((7,), np.float16), ((2, 2, 2), np.int32))]
    with cpu_place():
        got = tmem.state_bytes_per_device(
            [ptt.to_tensor(a) for a in arrays[:2]]
            + [torch.from_numpy(arrays[2])])
    want = jmem.state_bytes_per_device(
        [pt.to_tensor(a) for a in arrays])
    assert got == want == {0: 15 * 4 + 7 * 2 + 8 * 4}


def test_streams_events_and_synchronize_on_the_cpu():
    with cpu_place():
        s = tdev.Stream()
        e = tdev.Event(enable_timing=True)
        assert s.torch_stream is None and e.torch_event is None
        s.wait_event(e)
        s.wait_stream(tdev.current_stream())
        assert s.record_event(e) is e and e.query() and s.query()
        e.synchronize()
        s.synchronize()
        tdev.synchronize()
        tdev.cuda.synchronize()
        assert tdev.set_stream(s) is s
        with tdev.stream_guard(s) as g:
            assert g is s
        assert tdev.cuda.Stream is tdev.Stream
        assert tdev.cuda.Event is tdev.Event
    assert tdev.get_all_device_type() == (
        ["gpu"] if torch.cuda.is_available() else ["cpu"])
    assert tdev.get_available_device()[0].split(":")[1] == "0"
    assert tdev.cuda.device_count() == ptt.device_count()
    assert tdev.set_device is ptt.set_device


def test_functions_need_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    for fn in [getattr(tmem, n) for n in MEMORY_FNS + ("memory_stats",)] \
            + [tmem.reset_max_memory_allocated, tdev.synchronize,
               tdev.Stream, tdev.Event, tdev.current_stream]:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    assert tmem.memory_allocated("cpu") == 0
    assert tdev.Stream("cpu").torch_stream is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmem.memory_allocated("gpu:0")


def test_reference_names_and_flag():
    for n in ("Stream", "Event", "current_stream", "set_stream",
              "stream_guard", "synchronize", "get_all_device_type",
              "get_available_device", "cuda", "memory"):
        assert hasattr(jdev, n) and hasattr(tdev, n), n
    assert ptt.get_flags("FLAGS_allocator_strategy") == {
        "FLAGS_allocator_strategy": "auto_growth"}
    ptt.set_flags({"FLAGS_allocator_strategy": "naive_best_fit"})
    assert ptt.get_flags("FLAGS_allocator_strategy") == {
        "FLAGS_allocator_strategy": "naive_best_fit"}
    ptt.set_flags({"FLAGS_allocator_strategy": "auto_growth"})
