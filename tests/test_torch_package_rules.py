"""paddle_tpu_torch's package rules: it never imports jax or anything of
paddle_tpu (chip_smoke.py neither), serving GPT and LLaMA, training (a
ResNet too), the fused incubate ops, the input path (io, the vision
transforms and datasets, the DataLoader's spawned workers), the vision
zoo, vision.ops, the op-parity audit, TensorArray, the op surfaces
(fft, signal, sparse, distribution, geometric, quantization, audio),
observability, the profiler and device included, and
its entry points run on the CUDA card unless the caller asks for the
CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     generate, gpt_tiny, llama_tiny)

ROOT = Path(__file__).resolve().parents[1]

_SERVE = """
import sys
import numpy as np
import paddle_tpu_torch
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.inference import LLMEngine
m = GPTForCausalLM(gpt_tiny(), device="cpu")
eng = LLMEngine(m, max_batch=2, block_size=16, max_model_len=64,
                prompt_quantum=16, decode_chunk=2, device="cpu")
res = eng.generate([np.arange(5, dtype=np.int32)], max_new_tokens=3)
assert len(res[0].output_ids) == 3
from paddle_tpu_torch import TrainStep, amp
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.optimizer import AdamW
tm = GPTForCausalLM(gpt_tiny(hidden_dropout_prob=0.0,
                             attention_dropout_prob=0.0), device="cpu")
crit = GPTPretrainingCriterion()
def loss_fn(model, ids, labels):
    with amp.auto_cast(level="O1"):
        logits = model(ids)
    return crit(logits, labels)
step = TrainStep(tm, AdamW(learning_rate=1e-4,
                           parameters=tm.parameters()), loss_fn)
ids = np.arange(32, dtype=np.int32).reshape(2, 16)
assert np.isfinite(float(step(ids, ids)))
import torch
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.nn import functional as F
lm = LlamaForCausalLM(llama_tiny(), device="cpu")
eng = LLMEngine(lm, max_batch=2, block_size=16, max_model_len=64,
                prompt_quantum=16, decode_chunk=2, device="cpu")
res = eng.generate([np.arange(7, dtype=np.int32)], max_new_tokens=3)
assert len(res[0].output_ids) == 3
x = torch.randn(4, 64)
assert IF.fused_rms_norm(x, torch.ones(64)).shape == (4, 64)
assert IF.fused_layer_norm(x, torch.ones(64), torch.zeros(64)).shape \
    == (4, 64)
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet18
set_flags({"FLAGS_fast_bn_stats": True})
rm = resnet18(num_classes=10, data_format="NHWC", space_to_depth_stem=True,
              device="cpu")
step = TrainStep(rm, Momentum(learning_rate=0.1, momentum=0.9,
                              parameters=rm.parameters(),
                              weight_decay=1e-4),
                 lambda m, x, y: F.cross_entropy(m(x), y))
img = np.random.default_rng(0).standard_normal((2, 32, 32, 3))
assert np.isfinite(float(step(img.astype(np.float32),
                              np.array([1, 2], np.int32))))
from paddle_tpu_torch import io
from paddle_tpu_torch.vision import datasets, transforms
paddle_tpu_torch.set_device("cpu")
pipe = transforms.Compose([transforms.RandomResizedCrop(8),
                           transforms.Normalize(0.5, 0.5, data_format="HWC")])
imgs = [(pipe(np.full((12, 12, 3), k, np.uint8)), k) for k in range(4)]
x, y = next(iter(io.DataLoader(imgs, batch_size=4)))
assert x.shape == [4, 8, 8, 3] and y.dtype == paddle_tpu_torch.int32
from paddle_tpu_torch.vision.models import mobilenet_v3_small
from paddle_tpu_torch.vision import ops as vops
from paddle_tpu_torch.ops import parity
mb = mobilenet_v3_small(num_classes=10, device="cpu").eval()
assert tuple(mb(torch.randn(1, 3, 32, 32)).shape) == (1, 10)
keep = vops.nms(torch.tensor([[0., 0, 4, 4], [0, 0, 4, 5], [9, 9, 12, 12]]),
                0.5, torch.tensor([0.9, 0.8, 0.7]))
assert keep.tolist() == [0, 2]
arr = paddle_tpu_torch.create_array()
paddle_tpu_torch.array_write(paddle_tpu_torch.to_tensor([1.0]), 0, arr)
assert int(paddle_tpu_torch.array_length(arr).numpy()) == 1
assert parity.classify()[0]
from paddle_tpu_torch import (audio, distribution, fft, geometric,
                              quantization, signal, sparse)
x = paddle_tpu_torch.to_tensor(np.random.default_rng(0).standard_normal(
    (2, 1024)).astype(np.float32))
assert audio.MFCC(sr=16000, n_fft=256, device="cpu")(x).shape[1] == 40
assert fft.rfft(x).shape == [2, 513] and signal.frame(x, 64, 32).shape[0] == 2
assert float(distribution.Normal(0.0, 1.0).entropy()) > 1.4
src = paddle_tpu_torch.to_tensor(np.array([0, 1], np.int32))
assert geometric.send_u_recv(x, src, src).shape == [2, 1024]
assert sparse.matmul(x.to_sparse_coo(), x.t()).shape == [2, 2]
assert quantization.quantize_linear(x, 1.0).dtype == paddle_tpu_torch.int8
from paddle_tpu_torch import device, observability, profiler
observability.enable()
with profiler.Profiler() as prof:
    eng = LLMEngine(m, max_batch=2, block_size=16, max_model_len=64,
                    prompt_quantum=16, decode_chunk=2, device="cpu")
    eng.generate([np.arange(5, dtype=np.int32)], max_new_tokens=3)
observability.disable()
assert "engine.step" in {e["name"] for e in prof.events()}
assert observability.snapshot()["paddle_tpu_request_e2e_seconds"][
    "series"][()]["count"] == 1
assert device.memory.memory_allocated() == 0        # the CPU place
# the fleet, and the model builder a spawned replica process imports
sys.path.insert(0, "tests")
import torch_fleet_cases
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.inference import DisaggRouter, Router, TrafficModel
from paddle_tpu_torch.inference import exec_cache, replica_proc
from paddle_tpu_torch.observability import fleet, slo_fleet
fm = torch_fleet_cases.tiny_gpt()
make = lambda _i: LLMEngine(fm, device="cpu", **torch_fleet_cases.ENGINE_KW)
p = [np.arange(20, dtype=np.int32)]
assert Router(make, n_replicas=2).generate(p, 2)[0].ok
assert DisaggRouter(make).generate(p, 2)[0].ok
# model parallelism: fleet, a pipeline of the hybrid GPT under 1F1B
from paddle_tpu_torch.distributed import fleet as dfleet
from paddle_tpu_torch.distributed.meta_parallel import PipelineParallel
from paddle_tpu_torch.models.gpt_hybrid import gpt_pipeline_model
paddle_tpu_torch.set_device("cpu")
s = dfleet.DistributedStrategy()
s.pipeline_configs = {"accumulate_steps": 2, "schedule_mode": "1F1B"}
dfleet.init(strategy=s)
pm = gpt_pipeline_model(gpt_tiny(hidden_dropout_prob=0.0,
                                 attention_dropout_prob=0.0),
                        recompute_interval=1)
pp = PipelineParallel(pm, dfleet.get_hybrid_communicate_group(), s)
popt = dfleet.distributed_optimizer(AdamW(learning_rate=1e-4,
                                          parameters=pm.parameters()))
assert np.isfinite(float(pp.train_batch([ids, ids], popt)))
bad = [k for k in sys.modules
       if k == "jax" or k.startswith("jax.") or k == "paddle_tpu"
       or k.startswith("paddle_tpu.")]
print("LOADED", bad)
"""


def test_serving_in_a_fresh_process_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _SERVE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def test_sources_import_no_jax_or_paddle_tpu():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    pat = re.compile(r"import jax|from jax|(import|from) paddle_tpu\b"
                     r"|paddle_tpu\.")
    for f in files:
        text = f.read_text()
        hits = [m.group(0) for m in pat.finditer(text)]
        assert not hits, f"{f.relative_to(ROOT)}: {hits}"


def test_loader_workers_load_no_jax_and_make_no_cuda_context():
    """The DataLoader's spawned workers import the port, never JAX or
    paddle_tpu, and never create a CUDA context: the env guard hides the
    card before the dataset is unpickled (on a box with a card too:
    tests/test_torch_io_cuda.py)."""
    import torch_io_cases as C
    from paddle_tpu_torch.io import DataLoader
    from torch_port_helpers import cpu_place
    with cpu_place():
        rows = np.concatenate([b.numpy() for b in DataLoader(
            C.ModulesProbeDs(n=4), batch_size=2, num_workers=2)])
    assert rows.tolist() == [[0, 0]] * 4


def test_entry_points_need_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(m, np.zeros((1, 4), np.int32), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny())
    lm = LlamaForCausalLM(llama_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(lm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(lm, np.zeros((1, 4), np.int32), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedTransformerEncoderLayer(64, 4, 128)
    layer = FusedTransformerEncoderLayer(64, 4, 128, device="cpu")
    assert {p.device.type for p in torch.nn.Module.parameters(layer)} \
        == {"cpu"}
    from paddle_tpu_torch.nn import BatchNorm2D, Conv2D
    from paddle_tpu_torch.vision.models import mobilenet_v2, resnet18
    for make in (lambda **kw: resnet18(**kw),
                 lambda **kw: mobilenet_v2(**kw),
                 lambda **kw: Conv2D(3, 4, 3, **kw),
                 lambda **kw: BatchNorm2D(4, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        made = make(device="cpu")
        assert {p.device.type for p in torch.nn.Module.parameters(made)} \
            == {"cpu"}


def test_model_parallel_layers_need_cuda_unless_cpu():
    """The model-parallel layers make their parameters on the eager
    default place, as the reference's create_parameter does: the card,
    which raises without one, unless the CPU is asked for
    (``set_device("cpu")``)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.meta_parallel import MoELayer
    from paddle_tpu_torch.models.gpt_hybrid import GPTForCausalLMHybrid
    from paddle_tpu_torch.distributed.topology import \
        set_hybrid_communicate_group
    saved = tdevice._current_place
    try:
        fleet.init()
        with pytest.raises(RuntimeError, match="cpu"):
            GPTForCausalLMHybrid(gpt_tiny())
        with pytest.raises(RuntimeError, match="cpu"):
            MoELayer(8, 16, num_experts=2)
        import paddle_tpu_torch as ptt
        ptt.set_device("cpu")
        made = GPTForCausalLMHybrid(gpt_tiny())
        assert {p.device.type for p in torch.nn.Module.parameters(made)} \
            == {"cpu"}
    finally:
        tdevice._current_place = saved
        set_hybrid_communicate_group(None)


def test_opsurf_creation_needs_cuda_unless_cpu():
    """The op surfaces' creation entry points (the sparse constructors,
    the distributions' parameters, the audio matrices and feature layers'
    buffers, the quanters' parameters, fftfreq) put their results on the
    eager default place: the card, which raises without one, unless the
    CPU is asked for (``place=`` / ``device=`` "cpu", or
    ``set_device("cpu")``)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from paddle_tpu_torch import (audio, distribution, fft, quantization,
                                  sparse)
    from torch_port_helpers import cpu_place
    idx, vals = np.array([[0, 1]]), np.ones(2, np.float32)
    # each gives a torch tensor it made, on `place` (None: the default)
    makers = [
        lambda place=None: sparse.sparse_coo_tensor(
            idx, vals, place=place)._vals,
        lambda place=None: sparse.sparse_csr_tensor(
            [0, 1, 2], [1, 0], vals, [2, 2], place=place)._vals,
        lambda place=None: audio.functional.get_window(
            "hann", 8, device=place)._data,
        lambda place=None: audio.functional.compute_fbank_matrix(
            16000, 64, 8, device=place)._data,
        lambda place=None: next(torch.nn.Module.buffers(
            audio.MelSpectrogram(n_fft=64, n_mels=8, device=place)))]
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert make("cpu").device.type == "cpu"
    for make in (lambda: distribution.Normal(0.0, 1.0).loc,
                 lambda: fft.fftfreq(8)._data,
                 lambda: quantization.FakeQuanterWithAbsMaxObserverLayer()
                 ._parameters["scale"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        with cpu_place():
            assert make().device.type == "cpu"


def test_chip_smoke_defines_each_name_once():
    """chip_smoke.py is one long module of phases: a helper defined twice
    silently replaces the first for every earlier phase."""
    import ast
    from collections import Counter
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            names.update(e.id for t in node.targets for e in ast.walk(t)
                         if isinstance(e, ast.Name))
    assert not sorted(n for n, k in names.items() if k > 1)


def test_device_and_profiler_need_cuda_unless_cpu():
    """device's functions take the default place, the card: without one
    they raise until set_device("cpu"), as the creation ops do, and then
    answer as the reference's CPU run (zeros). A Profiler session on a
    box without a card records no device timeline and raises nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from paddle_tpu_torch import device, profiler
    from torch_port_helpers import cpu_place
    for fn in (device.synchronize, device.Stream, device.Event,
               device.current_stream, device.memory.memory_allocated,
               device.memory.max_memory_allocated,
               device.memory.memory_stats, device.cuda.memory_reserved):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    with cpu_place():
        assert device.memory.max_memory_allocated() == 0
        assert device.memory.memory_stats() == {}
        device.synchronize()
    with profiler.Profiler() as prof:
        pass
    assert not [e for e in prof.events() if "cat" in e]
