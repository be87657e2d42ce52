"""Hand-written Hopper kernels (CUDA C++ under csrc/), each beside its
plain PyTorch version; see each module's docstring.

B1 (``flash_attention.flash_fwd``), B4 (``norms.layer_norm_fwd``) and B5
(``norms.rms_norm_fwd``) are also registered as operators under the
namespace ``paddle_tpu_torch`` (``torch.ops.paddle_tpu_torch.flash_fwd``,
``.layer_norm``, ``.rms_norm``), each with a fake implementation for
shapes. A trace (``torch.export``, ``make_fx``) cannot run a ctypes
launch on its fake tensors; through the operator it records one node,
and a loaded program calls the operator, whose implementation is the
dispatcher's own path: the kernel's launcher on CUDA tensors (counted as
every launch is), the plain version on CPU tensors. Eager and CUDA-graph
calls never go through the operator: their tensors are real, so they
keep calling the launcher directly and pay no dispatcher cost."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = ["tracing"]


def tracing(t) -> bool:
    """True when `t` is a fake tensor of a trace (``torch.export``,
    ``make_fx``): a kernel's dispatcher then calls its operator, and
    jit's converted control flow stages into torch's cond /
    while_loop."""
    return isinstance(t, torch.Tensor) and is_fake(t)
