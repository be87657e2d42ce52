"""AMP autocast state read by the port's functional ops (counterpart of
paddle_tpu/amp/state.py).

The lists are paddle_tpu's own (amp/state.py:18-30), copied so the port
computes what the reference computes: ``torch.autocast`` keeps other
lists and would cast other ops. Each functional op names itself and its
per-op policy (the reference registry's ``amp_policy``) and passes its
tensor arguments through ``maybe_cast_inputs`` first.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "amp_state", "amp_dtype",
           "is_auto_cast_enabled", "maybe_cast_inputs"]

# ops that benefit from low precision (tensor-core bound)
WHITE_LIST = {
    "matmul", "conv2d", "conv1d", "conv3d", "conv2d_transpose", "mm", "bmm",
    "einsum", "addmm", "linear", "flash_attention", "fused_linear",
}
# ops that need fp32 accumulate / are numerically sensitive
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "square", "reciprocal", "rsqrt",
    "pow", "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "mean", "sum", "norm", "cumsum", "cumprod", "layer_norm", "rms_norm",
    "batch_norm", "group_norm", "instance_norm", "sigmoid_cross_entropy_with_logits",
    "binary_cross_entropy", "nll_loss", "kl_div", "erf", "erfinv", "expm1",
    "logsumexp", "var", "std",
}

_CASTABLE = (torch.float32, torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.level = "O1"
        self.dtype = torch.bfloat16
        self.custom_white = set()
        self.custom_black = set()

    def snapshot(self):
        """(enabled, level, dtype, custom white list, custom black list):
        what ``restore`` puts back."""
        return (self.enabled, self.level, self.dtype, self.custom_white,
                self.custom_black)

    def restore(self, snap):
        (self.enabled, self.level, self.dtype, self.custom_white,
         self.custom_black) = snap


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def amp_dtype() -> torch.dtype:
    return _state.dtype


def is_auto_cast_enabled() -> bool:
    return _state.enabled


def maybe_cast_inputs(name, policy, *args):
    """The reference's AMP rule (amp/state.py:57) for op `name` with
    per-op `policy` (None = follow the input, "white", "black", "keep"):
    O1 casts a white op's float inputs to the low dtype and a black op's
    to f32, and leaves the rest; O2 casts every op's inputs to the low
    dtype except a black op's, which go to f32. Only f32/bf16/f16
    tensors are cast, through ``Tensor.to`` so autograd carries the
    gradient back to the original (f32 master) tensor. Returns the
    arguments as a tuple, non-tensors untouched."""
    st = _state
    if not st.enabled or policy == "keep":
        return args
    in_white = policy == "white" or name in WHITE_LIST \
        or name in st.custom_white
    in_black = policy == "black" or name in BLACK_LIST \
        or name in st.custom_black
    if st.level == "O2":
        target = torch.float32 if in_black else st.dtype
    elif in_white:
        target = st.dtype
    elif in_black:
        target = torch.float32
    else:
        return args
    return tuple(
        a.to(target) if isinstance(a, torch.Tensor) and a.dtype in _CASTABLE
        and a.dtype != target else a for a in args)
