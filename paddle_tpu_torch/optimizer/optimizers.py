"""The optimizers of paddle_tpu/optimizer/optimizers.py, each rule op for
op as the reference writes it in jnp (coupled L2 decay through
``_apply_decay`` where the reference applies it, masters under
``multi_precision`` where the reference takes it).

SGD, Momentum, Adamax, Adagrad, RMSProp, Lamb and Adadelta (:11-55,
:174-326) run the per-tensor path of ``Optimizer._update_in_place``
(inside TrainStep's graph too); the reference runs them in its one
XLA optimizer executable (``_fused_step_apply``), which is no TPU
kernel. The update's launches and time on the card are in PERF.md.

Adam and AdamW (:56, :123), op for op: f32 moment math (moments stored in `moment_dtype`,
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

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "RMSProp", "Lamb", "AdamW8bitStub", "Adadelta"]


def _zeros(p):
    return torch.zeros_like(p.detach())


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update_rule(self, param, grad, state, lr, group):
        grad = self._apply_decay(param, grad, group)
        return param - lr * grad, state


class Momentum(Optimizer):
    """v = momentum * v + g; the step lr * v, or lr * (g + momentum * v)
    with ``use_nesterov``; the velocity in the work array's dtype (the
    master's under multi_precision)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _state_names(self):
        return ["velocity"]

    def _init_state(self, p):
        mw = self._master(p)
        return {"velocity": _zeros(p if mw is None else mw)}

    def _update_rule(self, param, grad, state, lr, group):
        grad = self._apply_decay(param, grad, group)
        v = self.momentum * state["velocity"] + grad
        update = grad + self.momentum * v if self.use_nesterov else v
        return param - lr * update, {"velocity": v}


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

    def _multi_tensor_update(self, items, lr, stats=None, positions=None,
                             scratch=None):
        """The rule over every (work, grad, state, group, out) item in one
        multi_tensor_adam call: one launch on the card (its statistics
        variant with `stats` and its `scratch`, each item's row at its
        `positions` entry)."""
        multi_tensor_adam(
            [AdamSlot(w, g, st["moment1"], st["moment2"], st["beta1_pow"],
                      st["beta2_pow"], self._decay(grp), out)
             for w, g, st, grp, out in items], lr, beta1=self.beta1,
            beta2=self.beta2, eps=self.epsilon, decoupled=self._decoupled,
            stats=stats, positions=positions, scratch=scratch)

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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _state_names(self):
        return ["moment", "inf_norm", "beta1_pow"]

    def _init_state(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _update_rule(self, param, grad, state, lr, group):
        grad = self._apply_decay(param, grad, group)
        m = self.beta1 * state["moment"] + (1 - self.beta1) * grad
        u = torch.maximum(self.beta2 * state["inf_norm"], torch.abs(grad))
        b1p = state["beta1_pow"] * self.beta1
        new_param = param - lr / (1 - b1p) * m / (u + self.epsilon)
        return new_param, {"moment": m, "inf_norm": u, "beta1_pow": b1p}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _state_names(self):
        return ["moment"]

    def _init_state(self, p):
        return {"moment": torch.full_like(p.detach(),
                                          self.initial_accumulator_value)}

    def _update_rule(self, param, grad, state, lr, group):
        grad = self._apply_decay(param, grad, group)
        mom = state["moment"] + torch.square(grad)
        return param - lr * grad / (torch.sqrt(mom) + self.epsilon), {
            "moment": mom}


class RMSProp(Optimizer):
    """The mean square (and with ``centered`` the mean gradient) decays
    by rho; the step, lr * g / sqrt(ms [- mg^2] + eps), accumulates with
    ``momentum`` and is subtracted."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def _state_names(self):
        return ["mean_square", "mean_grad", "momentum_acc"]

    def _init_state(self, p):
        return {"mean_square": _zeros(p), "mean_grad": _zeros(p),
                "momentum_acc": _zeros(p)}

    def _update_rule(self, param, grad, state, lr, group):
        grad = self._apply_decay(param, grad, group)
        ms = self.rho * state["mean_square"] \
            + (1 - self.rho) * torch.square(grad)
        if self.centered:
            mg = self.rho * state["mean_grad"] + (1 - self.rho) * grad
            denom = torch.sqrt(ms - torch.square(mg) + self.epsilon)
        else:
            mg = state["mean_grad"]
            denom = torch.sqrt(ms + self.epsilon)
        mom = self.momentum * state["momentum_acc"] + lr * grad / denom
        return param - mom, {"mean_square": ms, "mean_grad": mg,
                             "momentum_acc": mom}


class Lamb(Optimizer):
    """Adam's bias-corrected step plus ``lamb_weight_decay`` * param,
    scaled by the trust ratio ||param|| / ||step|| (1 where either norm
    is 0). As in the reference, no coupled decay is applied and
    ``exclude_from_weight_decay_fn`` is kept and not consulted. Under
    multi_precision the update runs on the f32 master; the reference
    makes the moments in the parameter's dtype and they come out of the
    first step in f32 (jnp's promotion), so the port makes them f32 (the
    same zeros) to keep them in place."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self.lamb_weight_decay = lamb_weight_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn

    def _state_names(self):
        return ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def _init_state(self, p):
        mw = self._master(p)
        base = p if mw is None else mw
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": _zeros(base), "moment2": _zeros(base),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _update_rule(self, param, grad, state, lr, group):
        m = self.beta1 * state["moment1"] + (1 - self.beta1) * grad
        v = self.beta2 * state["moment2"] \
            + (1 - self.beta2) * torch.square(grad)
        b1p = state["beta1_pow"] * self.beta1
        b2p = state["beta2_pow"] * self.beta2
        r = (m / (1 - b1p)) / (torch.sqrt(v / (1 - b2p)) + self.epsilon)
        r = r + self.lamb_weight_decay * param
        w_norm = torch.linalg.vector_norm(param.reshape(-1))
        r_norm = torch.linalg.vector_norm(r.reshape(-1))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return param - lr * trust * r, {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p}


class AdamW8bitStub(AdamW):
    pass


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.epsilon, self.rho = epsilon, rho

    def _state_names(self):
        return ["avg_squared_grad", "avg_squared_update"]

    def _init_state(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _update_rule(self, param, grad, state, lr, group):
        grad = self._apply_decay(param, grad, group)
        asg = self.rho * state["avg_squared_grad"] \
            + (1 - self.rho) * torch.square(grad)
        update = -torch.sqrt(state["avg_squared_update"] + self.epsilon) \
            / torch.sqrt(asg + self.epsilon) * grad
        asu = self.rho * state["avg_squared_update"] \
            + (1 - self.rho) * torch.square(update)
        return param + lr * update, {"avg_squared_grad": asg,
                                     "avg_squared_update": asu}
