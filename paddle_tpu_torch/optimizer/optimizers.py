"""Adam and AdamW (counterparts of paddle_tpu/optimizer/optimizers.py:56,
:123), op for op: f32 moment math (moments stored in `moment_dtype`,
else in the work array's dtype: the master's under multi_precision,
:83-92), bias-correction powers kept as f32 scalar tensors on the
device, the update cast to the parameter's dtype before it is
subtracted, and AdamW's decoupled decay taken from the OLD parameter
after the Adam step (:150-154). Their multi-tensor form is
``kernels/multi_tensor_adam.py`` (one CUDA launch for every f32 work
array). ``torch.optim.AdamW`` rounds in another order (it decays first,
in place), so it is not used."""
from __future__ import annotations

import torch

from ..core.dtype import to_dtype
from ..kernels.multi_tensor_adam import AdamSlot, multi_tensor_adam
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        # moment_dtype="bfloat16" (or "float16") stores m/v in that type;
        # the update math stays f32 (:66-72)
        self.moment_dtype = moment_dtype

    def _state_names(self):
        return ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def _init_state(self, p):
        mw = self._master(p)
        base = p if mw is None else mw
        mdt = base.dtype if self.moment_dtype is None \
            else to_dtype(self.moment_dtype)
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros(p.shape, dtype=mdt, device=p.device),
                "moment2": torch.zeros(p.shape, dtype=mdt, device=p.device),
                "beta1_pow": one, "beta2_pow": one.clone()}

    # Adam's decay is coupled L2 into the gradient; AdamW's is decoupled
    _decoupled = False

    def _decay(self, group):
        """The group's weight decay as a float (0: none)."""
        wd = group.get("weight_decay", self.weight_decay)
        return float(getattr(wd, "_coeff", wd)) if wd else 0.0

    def _multi_tensor_update(self, items, lr):
        """The rule over every (work, grad, state, group, out) item in one
        multi_tensor_adam call: one launch on the card."""
        multi_tensor_adam(
            [AdamSlot(w, g, st["moment1"], st["moment2"], st["beta1_pow"],
                      st["beta2_pow"], self._decay(grp), out)
             for w, g, st, grp, out in items], lr, beta1=self.beta1,
            beta2=self.beta2, eps=self.epsilon, decoupled=self._decoupled)

    def _decayed_grad(self, param, grad, group):
        return self._apply_decay(param, grad, group)

    def _update_rule(self, param, grad, state, lr, group):
        grad = self._decayed_grad(param, grad, group)
        mdt = state["moment1"].dtype
        m = state["moment1"].float()
        v = state["moment2"].float()
        grad32 = grad.float()
        b1p = state["beta1_pow"] * self.beta1
        b2p = state["beta2_pow"] * self.beta2
        m = self.beta1 * m + (1 - self.beta1) * grad32
        v = self.beta2 * v + (1 - self.beta2) * torch.square(grad32)
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        upd = (lr * m_hat / (torch.sqrt(v_hat) + self.epsilon)).to(
            param.dtype)
        new_param = param - upd
        new_param = self._post_update(new_param, param, lr, group)
        return new_param, {"moment1": m.to(mdt), "moment2": v.to(mdt),
                           "beta1_pow": b1p, "beta2_pow": b2p}

    def _post_update(self, new_param, param, lr, group):
        return new_param


class AdamW(Adam):
    """Decoupled weight decay (paddle_tpu optimizers.py:123).

    As in the reference, the decay applies to every parameter, biases
    and LayerNorm weights included: its ``apply_decay_param_fun`` is
    consulted only for a current parameter name that the reference never
    sets (:156-161), so the function is accepted and never called here
    either."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         moment_dtype=moment_dtype)
        self.weight_decay = weight_decay or 0.0
        self.apply_decay_param_fun = apply_decay_param_fun

    _decoupled = True

    def _decayed_grad(self, param, grad, group):
        return grad  # decoupled: no L2 into grad

    def _post_update(self, new_param, param, lr, group):
        wd = group.get("weight_decay", self.weight_decay) or 0.0
        if wd:
            new_param = new_param - lr * wd * param
        return new_param
