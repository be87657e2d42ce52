"""Shared helpers for the paddle_tpu_torch parity tests
(tests/test_torch_*.py): build one GPT or LLaMA in both packages from
the same weights, and compare greedy tokens under a logit-margin
guard."""
import contextlib
import dataclasses

import numpy as np
import torch

import paddle_tpu as pt
# the eager GPT loop both packages run (written once, package-neutral,
# in a module without JAX that chip_smoke.py's phase 22 imports too)
from eager_gpt_script import eager_gpt_steps, gpt_loss  # noqa: F401
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import gpt_params_from_numpy, llama_params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM as TorchGPT
from paddle_tpu_torch.models import LlamaForCausalLM as TorchLlama
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

@contextlib.contextmanager
def cpu_place():
    """The eager API's default place set to the CPU for the block, and
    the place it had put back after: pytest-xdist runs many test files
    in one process, and a default left behind would change where a later
    file's layers and Tensors are made (and whether they raise without a
    card)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core import device as tdevice
    saved = tdevice._current_place
    ptt.set_device("cpu")
    try:
        yield
    finally:
        tdevice._current_place = saved


# greedy tokens are compared up to the first position whose top-1/top-2
# logit margin falls below this: f32 sums in XLA and in torch run in
# different orders (~1e-6 apart at these sizes), so a closer race may
# legitimately flip
MARGIN = 1e-3


def jax_state_numpy(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def twin_gpts(cfg_name="gpt_tiny", seed=0, **cfg_kw):
    """(paddle_tpu model, paddle_tpu_torch model) with identical f32
    weights: paddle_tpu draws them, the port loads them by name."""
    from paddle_tpu.models import gpt as jgpt
    pt.seed(seed)
    jm = JaxGPT(getattr(jgpt, cfg_name)(**cfg_kw))
    jm.eval()
    tm = TorchGPT(getattr(tgpt, cfg_name)(**cfg_kw), device="cpu")
    tm.load_state_dict(gpt_params_from_numpy(jax_state_numpy(jm)))
    tm.eval()
    return jm, tm


# llama_tiny (4 heads, 2 kv heads, head_dim 32) and two variants at
# head_dim 64, which the flash kernels' plain versions take
LLAMA_CONFIGS = {
    "tiny_gqa": dict(),
    "d64_gqa": dict(hidden_size=256, num_heads=4, num_kv_heads=2),
    "d64_mha": dict(hidden_size=256, num_heads=4, num_kv_heads=4),
}


def twin_llamas(name="tiny_gqa", seed=0, dtype="float32", **kw):
    """(paddle_tpu model, port model) with identical weights: paddle_tpu
    draws them, the port loads them by name."""
    pt.seed(seed)
    over = LLAMA_CONFIGS[name]
    jcfg = dataclasses.replace(jllama.llama_tiny(**kw), **over)
    tcfg = dataclasses.replace(tllama.llama_tiny(**kw), **over)
    jm = jllama.LlamaForCausalLM(jcfg)
    named = jax_state_numpy(jm)
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
        named = jax_state_numpy(jm)
    jm.eval()
    tm = TorchLlama(tcfg, device="cpu", dtype=dtype)
    tm.load_state_dict(llama_params_from_numpy(named))
    tm.eval()
    return jm, tm


@torch.no_grad()
def guarded_len(torch_model, prompt, tokens, margin=MARGIN):
    """How many leading generated `tokens` (after `prompt`) sit at
    positions whose top-1/top-2 margin is >= `margin`, with the logits
    taken from a full forward of the port model over prompt+tokens."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens)])
    ids = torch.as_tensor(seq[None].astype(np.int64))
    lg = torch_model(ids)[0, len(prompt) - 1:len(seq) - 1]
    top2 = torch.topk(lg.float(), 2, dim=-1).values
    low = np.flatnonzero((top2[:, 0] - top2[:, 1]).numpy() < margin)
    return int(low[0]) if len(low) else len(tokens)


def assert_tokens_equal_guarded(torch_model, prompt, want, got,
                                margin=MARGIN):
    """`got` equals `want` at every position before the first one where
    `want`'s own margin is below `margin`; returns that guarded length."""
    n = guarded_len(torch_model, prompt, want, margin)
    np.testing.assert_array_equal(np.asarray(got)[:n],
                                  np.asarray(want)[:n])
    return n


# the ResNet parity tests' size: batch 2 x 64 x 64, 10 classes (layer4 is
# 2x2 there, so its batch norms see 8 values a channel)
RESNET_BATCH, RESNET_HW, RESNET_CLASSES = 2, 64, 10
RESNET_LAYOUTS = {"nchw": ("NCHW", False), "nhwc": ("NHWC", False),
                  "nhwc_s2d": ("NHWC", True)}


def twin_resnets(block="BasicBlock", layout="nhwc_s2d", seed=0,
                 dtype="float32"):
    """(paddle_tpu ResNet, port ResNet) of `block` at resnet18's block
    counts in `layout`, the port's loaded with the reference's weights
    and batch-norm buffers (in `dtype`), both in train mode."""
    from paddle_tpu.vision.models import resnet as jres
    from paddle_tpu_torch import resnet_params_from_numpy
    from paddle_tpu_torch.vision.models import resnet as tres
    df, s2d = RESNET_LAYOUTS[layout]
    pt.seed(seed)
    jm = jres.ResNet(getattr(jres, block), 18, num_classes=RESNET_CLASSES,
                     data_format=df, space_to_depth_stem=s2d)
    tm = tres.ResNet(getattr(tres, block), 18, num_classes=RESNET_CLASSES,
                     data_format=df, space_to_depth_stem=s2d, device="cpu",
                     dtype=dtype)
    tm.load_state_dict(resnet_params_from_numpy(jax_state_numpy(jm)))
    jm.train()
    tm.train()
    return jm, tm


def resnet_batch(layout, seed=0):
    """Images in `layout` and int32 labels, from a numpy seed."""
    rng = np.random.default_rng(seed)
    b, hw = RESNET_BATCH, RESNET_HW
    shape = (b, 3, hw, hw) if layout == "nchw" else (b, hw, hw, 3)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, RESNET_CLASSES, (b,)).astype(np.int32))


def resnet_stages(m, flatten):
    """A ResNet's forward (either package's; `flatten` its flatten op)
    cut into (name, callable) stages: the stem (stem conv, bn1, ReLU,
    max pool), each residual block, and the head (average pool,
    flatten, fc)."""
    out = [("stem", lambda v: m.maxpool(m.relu(m.bn1(m._stem_conv(v)))))]
    for i in range(1, 5):
        layer = getattr(m, f"layer{i}")
        out += [(f"layer{i}.{j}", layer[j]) for j in range(len(layer))]
    out.append(("head", lambda v: m.fc(flatten(m.avgpool(v), 1))))
    return out


def _stage_of(param_name):
    """The stage (resnet_stages' name) that owns a ResNet parameter."""
    head = param_name.split(".")[0]
    if head in ("conv1", "bn1"):
        return "stem"
    if head == "fc":
        return "head"
    return ".".join(param_name.split(".")[:2])


def _autocast(module, o1):
    return module.amp.auto_cast(level="O1", dtype="bfloat16") if o1 \
        else contextlib.nullcontext()


def reference_stages(jm, x, y, o1=False):
    """The reference's train-mode step of ResNet `jm` (f32, or bf16 O1),
    run stage by stage (resnet_stages), each stage's input a leaf: the
    same forward and gradients as one call of the model. Returns the
    loss, {stage: (input, output, output's cotangent, input's
    gradient)} as numpy, and the parameters' gradients by name."""
    import paddle_tpu.nn.functional as JF
    stages = resnet_stages(jm, pt.flatten)
    leaves, outs, cur = [], [], x
    with _autocast(pt, o1):
        for _, f in stages:
            leaves.append(pt.to_tensor(np.asarray(cur), stop_gradient=False))
            outs.append(f(leaves[-1]))
            cur = outs[-1]._data
    loss = JF.cross_entropy(outs[-1], pt.to_tensor(y))
    loss.backward()
    cots = [None] * len(stages)
    for k in reversed(range(len(stages) - 1)):
        cots[k] = np.asarray(leaves[k + 1].grad._data)
        (outs[k] * pt.to_tensor(cots[k])).sum().backward()
    return float(loss.numpy()), {
        name: (np.asarray(leaf._data), np.asarray(out._data), cot,
               np.asarray(leaf.grad._data))
        for (name, _), leaf, out, cot in zip(stages, leaves, outs, cots)}, \
        {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}


def stage_grads(tm, ref_stages, y, o1=False):
    """Each stage of the port's ResNet `tm` run on the reference's input
    to that stage (reference_stages, cast to `tm`'s dtype) and
    differentiated against the reference's cotangent of its output (the
    head: against the loss). Returns {stage: (output, {tensor:
    gradient})} in float64 numpy, the tensors being the stage's
    parameters and its input ("<stage> input")."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn.functional as TF
    dtype = next(tm.parameters()).dtype
    tm.zero_grad(set_to_none=True)
    out = {}
    for name, f in resnet_stages(tm, TF.flatten):
        x, want, cot, _ = ref_stages[name]
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        with _autocast(ptt, o1):
            got = f(xt)
        if dtype == torch.float32:
            assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        if name == "head":
            TF.cross_entropy(got, torch.from_numpy(y)).backward()
        else:
            (got * torch.from_numpy(cot).to(got.dtype)).sum().backward()
        grads = {f"{name} input": xt.grad}
        grads.update((n, p.grad) for n, p in tm.named_parameters()
                     if _stage_of(n) == name)
        out[name] = (got.detach().double().numpy(),
                     {n: g.double().numpy() for n, g in grads.items()})
    return out


def stage_distances(tm, ref_stages, ref_grads, y, o1=False):
    """stage_grads held to the reference's: {stage: (output error over
    the output's largest, {tensor: its gradient's distance from the
    reference's over the reference's norm})}."""
    out = {}
    for name, (got, grads) in stage_grads(tm, ref_stages, y, o1).items():
        want = ref_stages[name][1].astype(np.float64)
        refs = dict(ref_grads, **{f"{name} input": ref_stages[name][3]})
        out[name] = (float(np.abs(got - want).max() / np.abs(want).max()),
                     {n: float(np.linalg.norm(g - refs[n])
                               / np.linalg.norm(refs[n]))
                      for n, g in grads.items()})
    return out


def _flat_grads(grads, names):
    return np.concatenate([grads[n].ravel() for n in names])


def _output_dtypes(model, port):
    """Record every sublayer's output dtype, call by call, while the
    model runs; returns (the record, a function that stops it)."""
    seen, handles = {}, []
    for name, sub in (model.named_modules() if port
                      else model.named_sublayers()):
        def hook(layer, inputs, out, name=name):
            seen.setdefault(name, []).append(
                str(getattr(out, "dtype", None)).split(".")[-1])
        handles.append(sub.register_forward_hook(hook) if port
                       else sub.register_forward_post_hook(hook))
    return seen, lambda: [h.remove() for h in handles]


# tests/test_torch_resnet_o1.py's limits on each stage run from the
# reference's input, by block (its docstring gives the readings)
O1_STAGE_OUT = 1e-2
O1_STAGE_GRAD = {"BasicBlock": 2.5e-2, "BottleneckBlock": 5e-2}


def check_resnet_o1(block, layout):
    """tests/test_torch_resnet_o1.py's comparison (its docstring gives
    the tolerances): one bf16 O1 train-mode step of the twin ResNets,
    whole and stage by stage, and the port's f64 run, then eval logits.
    Returns what it measured."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn.functional as TF
    jm, tm = twin_resnets(block, layout)
    _, t64 = twin_resnets(block, layout, dtype="float64")
    x, y = resnet_batch(layout)
    start = [b.clone() for b in tm.buffers()]
    jdt, stop = _output_dtypes(jm, port=False)
    jl, ref_stages, ref_grads = reference_stages(jm, x, y, o1=True)
    stop()
    tdt, stop = _output_dtypes(tm, port=True)
    with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
        tlogits = tm(torch.from_numpy(x))
    stop()
    tl = TF.cross_entropy(tlogits, torch.from_numpy(y))
    tl.backward()
    TF.cross_entropy(t64(torch.from_numpy(x).double()),
                     torch.from_numpy(y)).backward()
    # every sublayer returns what the reference's returns, call by call:
    # the O1 lists and each layer's rule for the dtype it is given (the
    # reference ran stage by stage, so its model and its four Sequential
    # stacks were never called as a whole)
    assert {n: tdt.get(n) for n in jdt} == jdt, (tdt, jdt)
    assert set(tdt) - set(jdt) == {"", "layer1", "layer2", "layer3",
                                   "layer4"}
    assert tlogits.dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), jl, rtol=3e-2)

    names = [n for n, _ in tm.named_parameters()]
    exact = _flat_grads({n: p.grad.numpy()
                         for n, p in t64.named_parameters()}, names)
    mine = _flat_grads({n: p.grad.double().numpy()
                        for n, p in tm.named_parameters()}, names)
    ref = _flat_grads({n: ref_grads[n].astype(np.float64)
                       for n in names}, names)
    scale = np.linalg.norm(exact)
    d_mine = np.linalg.norm(mine - exact) / scale
    d_ref = np.linalg.norm(ref - exact) / scale
    assert d_mine <= 1.3 * d_ref, (d_mine, d_ref)

    jb = {n: np.asarray(b._data) for n, b in jm.named_buffers()}
    stats = 0.0
    for n, b in tm.named_buffers():
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), jb[n], rtol=0, atol=2e-2)
        stats = max(stats, float(np.abs(b.numpy() - jb[n]).max()))

    jm.eval()
    tm.eval()
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        want = np.asarray(jm(pt.to_tensor(x))._data, np.float32)
    with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
        got = tm(torch.from_numpy(x)).float().detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())

    # each stage from the reference's input and cotangent, in train mode
    # with the running statistics the reference's stages started from
    tm.train()
    with torch.no_grad():
        for b, b0 in zip(tm.buffers(), start):
            b.copy_(b0)
    dist = stage_distances(tm, ref_stages, ref_grads, y, o1=True)
    assert len([n for d in dist.values() for n in d[1]]) == \
        len(names) + len(dist)
    for name, (err, grads) in dist.items():
        assert err <= O1_STAGE_OUT, (name, err)
        for n, d in grads.items():
            assert d <= O1_STAGE_GRAD[block], (n, d)

    return dict(loss=abs(float(tl) / jl - 1),
                grads_port=d_mine, grads_ref=d_ref, stats=stats,
                logits=float(np.abs(got - want).max() / np.abs(want).max()),
                stage_out=max(d[0] for d in dist.values()),
                stage_grad=max(v for d in dist.values()
                               for v in d[1].values()))


def fast_bn_flag(value):
    """Set FLAGS_fast_bn_stats to `value` in both packages; returns a
    function that puts the old values back."""
    import paddle_tpu_torch as ptt
    flag = "FLAGS_fast_bn_stats"
    saved = pt.get_flags(flag), ptt.get_flags(flag)
    pt.set_flags({flag: value})
    ptt.set_flags({flag: value})

    def restore():
        pt.set_flags(saved[0])
        ptt.set_flags(saved[1])
    return restore
