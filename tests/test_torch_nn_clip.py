"""paddle_tpu_torch.nn.clip.clip_grad_norm_ and the gpt3_6p7b preset
against paddle_tpu's, and the public names of each module the port calls
ported against its reference module's."""
import functools
import importlib
import inspect
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt3_6p7b as j_gpt3_6p7b
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch.models import gpt3_6p7b
from paddle_tpu_torch.nn import clip_grad_norm_

# both sides sum the same f32 values in another order (XLA on the CPU
# against torch), a few ulps of the total apart; the grads are scaled by
# one f32 factor each side
CLIP_TOL = dict(rtol=2e-6, atol=1e-7)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((4, 8), (8,), (3, 5, 2))]


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
@pytest.mark.parametrize("max_norm", [0.5, 1e4], ids=["clips", "no-clip"])
def test_clip_grad_norm_matches_reference(norm_type, max_norm):
    gs = _grads()
    jps = [pt.to_tensor(np.zeros_like(g)) for g in gs]
    for p, g in zip(jps, gs):
        p.grad = pt.to_tensor(g)
    # a parameter with no grad is skipped on both sides
    jps.append(pt.to_tensor(np.zeros((2,), np.float32)))
    tps = [torch.zeros(g.shape, requires_grad=True) for g in gs]
    for p, g in zip(tps, gs):
        p.grad = torch.from_numpy(g.copy())
    tps.append(torch.zeros(2, requires_grad=True))

    want = jclip.clip_grad_norm_(jps, max_norm, norm_type=norm_type)
    got = clip_grad_norm_(tps, max_norm, norm_type=norm_type)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               **CLIP_TOL)
    for tp, jp, g in zip(tps, jps, gs):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad._data),
                                   **CLIP_TOL)
        if max_norm > 1e3:
            np.testing.assert_array_equal(tp.grad.numpy(), g)
    assert tps[-1].grad is None
    if max_norm < 1:
        # the clipped grads have the norm asked for
        flat = np.concatenate([p.grad.numpy().ravel() for p in tps[:-1]])
        np.testing.assert_allclose(
            np.linalg.norm(flat.astype(np.float64), ord=norm_type),
            max_norm, rtol=1e-5)


def test_clip_grad_norm_without_grads_returns_zero():
    want = jclip.clip_grad_norm_([pt.to_tensor(np.ones(3, np.float32))], 1.0)
    got = clip_grad_norm_([torch.ones(3, requires_grad=True)], 1.0)
    assert got.shape == () and float(got) == float(want.numpy()) == 0.0
    # a single tensor is taken as a list of one; error_if_nonfinite is
    # accepted and ignored, as the reference does
    p = torch.ones(3, requires_grad=True)
    p.grad = torch.full((3,), 4.0)
    total = clip_grad_norm_(p, 1.0, error_if_nonfinite=True)
    np.testing.assert_allclose(float(total), np.sqrt(48.0), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.full(3, 1 / np.sqrt(3)),
                               rtol=1e-6)


def test_gpt3_6p7b_equals_the_reference():
    want, got = j_gpt3_6p7b(), gpt3_6p7b()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "max_position_embeddings", "head_dim"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.hidden_size, got.num_layers, got.num_heads) == (4096, 32, 32)


# reference module -> (port module, public names still to port)
PORTED_MODULES = {
    "paddle_tpu.models": ("paddle_tpu_torch.models", set()),
    "paddle_tpu.models.bert": ("paddle_tpu_torch.models.bert", set()),
    "paddle_tpu.models.gpt": ("paddle_tpu_torch.models.gpt", set()),
    "paddle_tpu.models.llama": ("paddle_tpu_torch.models.llama", set()),
    "paddle_tpu.models.generation": ("paddle_tpu_torch.models.generation",
                                     set()),
    "paddle_tpu.nn.clip": ("paddle_tpu_torch.nn.clip", set()),
    "paddle_tpu.nn.initializer": ("paddle_tpu_torch.nn.initializer", set()),
    "paddle_tpu.nn.layers.container": ("paddle_tpu_torch.nn.layers.container",
                                       set()),
    "paddle_tpu.nn.layers.transformer": (
        "paddle_tpu_torch.nn.layers.transformer", set()),
    "paddle_tpu.distributed.meta_parallel.recompute": (
        "paddle_tpu_torch.distributed.meta_parallel.recompute", set()),
    "paddle_tpu.optimizer.lr": ("paddle_tpu_torch.optimizer.lr", set()),
    "paddle_tpu.optimizer.optimizer": ("paddle_tpu_torch.optimizer.optimizer",
                                       set()),
    "paddle_tpu.optimizer.optimizers": (
        "paddle_tpu_torch.optimizer.optimizers", set()),
    "paddle_tpu.core.flags": ("paddle_tpu_torch.core.flags", set()),
    "paddle_tpu.nn.layers.conv": ("paddle_tpu_torch.nn.layers.conv", set()),
    # nn.Layer, Parameter, ParamAttr, save / load (ROADMAP item 14)
    "paddle_tpu.nn.layer": ("paddle_tpu_torch.nn.layer", set()),
    "paddle_tpu.nn.param_attr": ("paddle_tpu_torch.nn.param_attr", set()),
    "paddle_tpu.framework_io": ("paddle_tpu_torch.framework_io", set()),
    "paddle_tpu.utils.fs": ("paddle_tpu_torch.utils.fs", set()),
    # the rest of nn (ROADMAP item 25's nn part): the layer zoo, the RNN
    # layers, nn.functional's own names, nn.utils, nn.quant, and LBFGS
    "paddle_tpu.nn.layers.common": ("paddle_tpu_torch.nn.layers.common",
                                    set()),
    "paddle_tpu.nn.layers.pooling": ("paddle_tpu_torch.nn.layers.pooling",
                                     set()),
    "paddle_tpu.nn.layers.norm": ("paddle_tpu_torch.nn.layers.norm", set()),
    "paddle_tpu.nn.layers.activation": (
        "paddle_tpu_torch.nn.layers.activation", set()),
    "paddle_tpu.nn.layers.loss": ("paddle_tpu_torch.nn.layers.loss", set()),
    "paddle_tpu.nn.layers.rnn": ("paddle_tpu_torch.nn.layers.rnn", set()),
    "paddle_tpu.nn": ("paddle_tpu_torch.nn", set()),
    "paddle_tpu.nn.functional": ("paddle_tpu_torch.nn.functional", set()),
    "paddle_tpu.nn.utils": ("paddle_tpu_torch.nn.utils", set()),
    "paddle_tpu.nn.quant": ("paddle_tpu_torch.nn.quant", set()),
    "paddle_tpu.optimizer": ("paddle_tpu_torch.optimizer", set()),
    "paddle_tpu.optimizer.lbfgs": ("paddle_tpu_torch.optimizer.lbfgs",
                                   set()),
    # the vision zoo (ROADMAP item 25's vision part)
    "paddle_tpu.vision.models": ("paddle_tpu_torch.vision.models", set()),
    "paddle_tpu.vision.models.extra": (
        "paddle_tpu_torch.vision.models.extra", set()),
    "paddle_tpu.vision.models.lenet_vgg_mobilenet": (
        "paddle_tpu_torch.vision.models.lenet_vgg_mobilenet", set()),
    "paddle_tpu.vision.models.resnet": (
        "paddle_tpu_torch.vision.models.resnet", set()),
    # io and the vision input path (ROADMAP item 27), vision.ops
    "paddle_tpu.io": ("paddle_tpu_torch.io", set()),
    "paddle_tpu.io.native": ("paddle_tpu_torch.io.native", set()),
    "paddle_tpu.io._process_worker": ("paddle_tpu_torch.io._process_worker",
                                      set()),
    "paddle_tpu.vision": ("paddle_tpu_torch.vision", set()),
    "paddle_tpu.vision.ops": ("paddle_tpu_torch.vision.ops", set()),
    "paddle_tpu.vision.transforms": ("paddle_tpu_torch.vision.transforms",
                                     set()),
    "paddle_tpu.vision.datasets": ("paddle_tpu_torch.vision.datasets",
                                   set()),
    "paddle_tpu.kernels.pallas.flash_attention": (
        "paddle_tpu_torch.kernels.flash_attention", set()),
    "paddle_tpu.kernels.pallas.norms": ("paddle_tpu_torch.kernels.norms",
                                        set()),
    "paddle_tpu.kernels.pallas.ragged_paged_attention": (
        "paddle_tpu_torch.kernels.ragged_paged_attention", set()),
    "paddle_tpu.inference.paged_cache": (
        "paddle_tpu_torch.inference.paged_cache", set()),
    "paddle_tpu.inference.llm_engine": (
        "paddle_tpu_torch.inference.llm_engine", set()),
    "paddle_tpu.inference.speculative": (
        "paddle_tpu_torch.inference.speculative", set()),
    "paddle_tpu.resilience.faults": ("paddle_tpu_torch.resilience.faults",
                                     set()),
    "paddle_tpu.utils.watchdog": ("paddle_tpu_torch.utils.watchdog", set()),
    # to_jnp is JAX's own
    "paddle_tpu.core.dtype": ("paddle_tpu_torch.core.dtype", {"to_jnp"}),
    "paddle_tpu.amp": ("paddle_tpu_torch.amp", set()),
    # the eager API (ROADMAP items 20-22); what is left is JAX's own:
    # TPUPlace (CUDAPlace is its counterpart), next_key (a jax.random
    # key), the JAX tape's nodes, the dispatch queue's float0 and fused
    # chain caches, and XLA's executable cache
    "paddle_tpu.core.tensor": ("paddle_tpu_torch.core.tensor", set()),
    "paddle_tpu.core.device": ("paddle_tpu_torch.core.device", {"TPUPlace"}),
    "paddle_tpu.core.generator": ("paddle_tpu_torch.core.generator",
                                  {"next_key"}),
    "paddle_tpu.autograd": ("paddle_tpu_torch.autograd",
                            {"GradNode", "InputEdge"}),
    "paddle_tpu.autograd.tape": ("paddle_tpu_torch.autograd.tape", {
        "GradNode", "InputEdge", "build_node", "record_apply"}),
    "paddle_tpu.autograd.dispatch_queue": (
        "paddle_tpu_torch.autograd.dispatch_queue", {
            "chain_cache_size", "clear_chain_cache", "clear_const_caches",
            "is_float0", "ones_seed_array", "run_batched",
            "zero_cotangent_array"}),
    "paddle_tpu.ops.registry": ("paddle_tpu_torch.ops.registry",
                                {"exec_cache_size"}),
    "paddle_tpu.ops.creation": ("paddle_tpu_torch.ops.creation", set()),
    "paddle_tpu.ops.math": ("paddle_tpu_torch.ops.math", set()),
    "paddle_tpu.ops.reduction": ("paddle_tpu_torch.ops.reduction", set()),
    "paddle_tpu.ops.manipulation": ("paddle_tpu_torch.ops.manipulation",
                                    set()),
    "paddle_tpu.ops.logic": ("paddle_tpu_torch.ops.logic", set()),
    "paddle_tpu.ops.search": ("paddle_tpu_torch.ops.search", set()),
    "paddle_tpu.ops.random": ("paddle_tpu_torch.ops.random", set()),
    "paddle_tpu.ops.linalg": ("paddle_tpu_torch.ops.linalg", set()),
    # every op module, the long tail (ROADMAP item 25's ops part) and the
    # op-parity audit
    "paddle_tpu.ops": ("paddle_tpu_torch.ops", set()),
    "paddle_tpu.ops.longtail": ("paddle_tpu_torch.ops.longtail", set()),
    "paddle_tpu.ops.sequence_ops": ("paddle_tpu_torch.ops.sequence_ops",
                                    set()),
    "paddle_tpu.ops.vision_ops": ("paddle_tpu_torch.ops.vision_ops", set()),
    "paddle_tpu.ops.parity": ("paddle_tpu_torch.ops.parity", set()),
    "paddle_tpu.tensor_array": ("paddle_tpu_torch.tensor_array", set()),
    "paddle_tpu.ops.nn_ops": ("paddle_tpu_torch.ops.nn_ops", set()),
    # jit, the inference Predictor and hapi (ROADMAP item 25's part); the
    # inference fleet (router, autoscaler, traffic, disaggregation) takes
    # ROADMAP item 24
    "paddle_tpu.jit": ("paddle_tpu_torch.jit", set()),
    "paddle_tpu.jit.dy2static": ("paddle_tpu_torch.jit.dy2static", set()),
    "paddle_tpu.inference": ("paddle_tpu_torch.inference", {
        "Autoscaler", "Cohort", "DisaggActuator", "DisaggRouter",
        "ReplicaGone", "ReplicaHandle", "ReplicaSet", "Router",
        "RouterActuator", "TrafficEvent", "TrafficModel", "autoscaler",
        "disagg", "router", "run_traffic", "traffic"}),
    "paddle_tpu.hapi": ("paddle_tpu_torch.hapi", set()),
    "paddle_tpu.hapi.model_api": ("paddle_tpu_torch.hapi.model_api", set()),
    "paddle_tpu.hapi.summary_writer": ("paddle_tpu_torch.hapi.summary_writer",
                                       set()),
    "paddle_tpu.callbacks": ("paddle_tpu_torch.callbacks", set()),
    "paddle_tpu.metric": ("paddle_tpu_torch.metric", set()),
    "paddle_tpu.utils": ("paddle_tpu_torch.utils", set()),
    # incubate whole, but autotune (it goes with the kernels' autotune
    # cache, ROADMAP Queue A item 23)
    "paddle_tpu.incubate": ("paddle_tpu_torch.incubate", {"autotune"}),
    "paddle_tpu.incubate.nn": ("paddle_tpu_torch.incubate.nn", set()),
    "paddle_tpu.incubate.nn.functional": (
        "paddle_tpu_torch.incubate.nn.functional", set()),
    "paddle_tpu.incubate.nn.functional.serving": (
        "paddle_tpu_torch.incubate.nn.functional.serving", set()),
    "paddle_tpu.incubate.nn.layer": ("paddle_tpu_torch.incubate.nn.layer",
                                     set()),
    "paddle_tpu.incubate.nn.attn_bias": (
        "paddle_tpu_torch.incubate.nn.attn_bias", set()),
    "paddle_tpu.incubate.nn.memory_efficient_attention": (
        "paddle_tpu_torch.incubate.nn.memory_efficient_attention", set()),
    "paddle_tpu.incubate.nn.loss": ("paddle_tpu_torch.incubate.nn.loss",
                                    set()),
    "paddle_tpu.incubate.optimizer": ("paddle_tpu_torch.incubate.optimizer",
                                      set()),
    "paddle_tpu.incubate.asp": ("paddle_tpu_torch.incubate.asp", set()),
    # the op surfaces and audio (ROADMAP item 25's next part)
    "paddle_tpu.fft": ("paddle_tpu_torch.fft", set()),
    "paddle_tpu.signal": ("paddle_tpu_torch.signal", set()),
    "paddle_tpu.sparse": ("paddle_tpu_torch.sparse", set()),
    "paddle_tpu.sparse.nn": ("paddle_tpu_torch.sparse.nn", set()),
    "paddle_tpu.sparse.nn.functional": (
        "paddle_tpu_torch.sparse.nn.functional", set()),
    "paddle_tpu.distribution": ("paddle_tpu_torch.distribution", set()),
    "paddle_tpu.geometric": ("paddle_tpu_torch.geometric", set()),
    "paddle_tpu.quantization": ("paddle_tpu_torch.quantization", set()),
    "paddle_tpu.audio": ("paddle_tpu_torch.audio", set()),
    "paddle_tpu.audio.functional": ("paddle_tpu_torch.audio.functional",
                                    set()),
    "paddle_tpu.audio.features": ("paddle_tpu_torch.audio.features", set()),
    "paddle_tpu.audio.datasets": ("paddle_tpu_torch.audio.datasets", set()),
}


def _public_names(mod):
    """Names a module defines or re-exports from its own submodules, and
    its submodules: not its imports from elsewhere."""
    out = set()
    for n in dir(mod):
        if n.startswith("_"):
            continue
        o = getattr(mod, n)
        where = o.__name__ if isinstance(o, types.ModuleType) \
            else getattr(o, "__module__", None)
        if where and (where == mod.__name__ and not isinstance(
                o, types.ModuleType) or where.startswith(mod.__name__ + ".")):
            out.add(n)
    return out


@functools.lru_cache(maxsize=None)
def _reference_names():
    """{reference module: _public_names} as a fresh process sees them,
    importing the modules in this file's order: in this process a
    submodule that another test file imported earlier (say
    paddle_tpu.models.gpt_hybrid) is an attribute of its package, which
    would make the answer depend on which files ran before."""
    script = (f"import importlib, json, types\n"
              f"{inspect.getsource(_public_names)}\n"
              f"print(json.dumps({{m: sorted(_public_names("
              f"importlib.import_module(m))) for m in "
              f"{sorted(PORTED_MODULES)!r}}}))")
    out = subprocess.run([sys.executable, "-c", script],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return {m: set(v) for m, v in
            json.loads(out.stdout.splitlines()[-1]).items()}


@pytest.mark.parametrize("ref_name", sorted(PORTED_MODULES))
def test_ported_module_carries_reference_names(ref_name):
    port_name, todo = PORTED_MODULES[ref_name]
    port = importlib.import_module(port_name)
    want = _reference_names()[ref_name]
    assert todo <= want, f"names listed as still to port that {ref_name} " \
                         f"does not have: {sorted(todo - want)}"
    missing = sorted(n for n in want - todo if not hasattr(port, n))
    assert not missing, f"{port_name} lacks {missing} of {ref_name}"
    # a name listed as still to port that the port now has is crossed off
    done = sorted(n for n in todo if hasattr(port, n))
    assert not done, f"{port_name} now has {done}: take them off the list"


def test_nn_exports_the_clips():
    from paddle_tpu_torch import nn
    for n in ("ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
              "clip_grad_norm_"):
        assert getattr(nn, n) is getattr(nn.clip, n)
