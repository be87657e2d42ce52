"""AMP: autocast, O2 decoration and loss scaling (counterpart of
paddle_tpu/amp/__init__.py). bf16 is the default low precision, as on
the reference's device; f16 is the other one. The lists and the O1/O2
rules are the reference's (amp/state.py), applied by the port's
functional ops, not by ``torch.autocast``. Loss scaling does something
only under f16: bf16 has f32's exponent range."""
from __future__ import annotations

import torch

from ..core.dtype import to_dtype
from .state import (BLACK_LIST, WHITE_LIST, amp_dtype, amp_state,
                    is_auto_cast_enabled, maybe_cast_inputs)

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported", "WHITE_LIST",
           "BLACK_LIST", "amp_dtype", "amp_state", "is_auto_cast_enabled",
           "maybe_cast_inputs"]


class auto_cast:
    """Context manager enabling the per-op autocast of the port's ops."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        self.enable = enable
        self.level = level
        self.dtype = to_dtype(dtype)
        self.custom_white = set(custom_white_list or ())
        self.custom_black = set(custom_black_list or ())

    def __enter__(self):
        st = amp_state()
        self._saved = st.snapshot()
        st.restore((self.enable, self.level, self.dtype, self.custom_white,
                    self.custom_black))
        return self

    def __exit__(self, *exc):
        amp_state().restore(self._saved)
        return False


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration (reference :71-92): cast the models' floating
    parameters and buffers to `dtype` (a name or a torch dtype, through
    ``to_dtype``), and set ``_multi_precision`` on the optimizers, so
    their update runs on f32 masters and writes the cast into the
    parameters."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=to_dtype(dtype))
    if optimizers is not None:
        single_opt = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if single_opt else list(optimizers)
        for o in opt_list:
            o._multi_precision = True
        if single_model and single_opt:
            return models, optimizers
        return model_list, opt_list
    return models if single_model else model_list


class GradScaler:
    """Dynamic loss scaling (reference :119-368, after
    python/paddle/amp/grad_scaler.py).

    ``unscale_`` is one pass of ``_foreach`` ops over every gradient,
    in the reference's order (:186-193): each gradient widened to f32 and
    multiplied by 1/scale (an f32 scalar on the card, made once per
    scale value), checked for finiteness after the unscale, and cast
    back to its dtype in place. One flag comes back to the host: exactly
    one sync a step, as the reference's single ``bool(found)``.
    ``_unscale_stats`` counts the passes ("dispatches") and the syncs.
    ``step`` skips the optimizer when the flag is set; ``update`` halves
    the scale after ``decr_every_n_nan_or_inf`` bad steps in a row (never
    below 1.0) and grows it after ``incr_every_n_steps`` good ones. An
    explicit ``unscale_`` before ``step`` (the clipping pattern) is not
    repeated by ``step``.

    The reference's unscale is an XLA executable, not a TPU kernel, so
    plain torch ops compute it here. Its observability hooks (the AMP
    metrics, ``numerics`` notes and the ``numerics.check`` fault point)
    come with the port's observability (ROADMAP Queue A item 8)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        # (scale, device, 1/scale as an f32 scalar there)
        self._inv_cache = None
        self._unscale_stats = {"dispatches": 0, "syncs": 0}

    def is_enable(self):
        return self._enable

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _inv32(self, device):
        """1/scale as an f32 scalar on `device`, made by a fill (no host
        round trip) once per scale value."""
        hit = self._inv_cache
        if hit is None or hit[:2] != (self._scale, device):
            hit = self._inv_cache = (
                self._scale, device,
                torch.full((), 1.0 / self._scale, dtype=torch.float32,
                           device=device))
        return hit[2]

    def _grads(self, optimizer):
        seen, out = set(), []
        for p in optimizer._all_params():
            if p.grad is None or id(p) in seen:
                continue
            seen.add(id(p))
            out.append(p.grad)
        return out

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        grads = self._grads(optimizer)
        if not grads:
            self._found_inf = False
            return
        dev = grads[0].device
        if any(g.device != dev for g in grads):
            raise ValueError("GradScaler: the gradients lie on more than "
                             "one device")
        # f32 gradients are unscaled in place; the others in f32 copies,
        # cast back after the check
        work = [g if g.dtype == torch.float32 else g.float() for g in grads]
        torch._foreach_mul_(work, self._inv32(dev))
        finite = torch.isfinite(torch.stack(
            torch._foreach_norm(work, float("inf")))).all()
        low = [(g, w) for g, w in zip(grads, work) if w is not g]
        if low:
            torch._foreach_copy_([g for g, _ in low], [w for _, w in low])
        st = self._unscale_stats
        st["dispatches"] += 1
        # the one host sync of a step: the step/skip decision is host
        # control flow
        self._found_inf = not bool(finite)
        st["syncs"] += 1
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def get_loss_scaling(self):
        """The scale as a 0-d f32 tensor."""
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_loss_scaling(self, scale: float):
        """Pin the scale to `scale` and reset the good/bad step counts
        (reference :321-340)."""
        self._scale = float(scale)
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps,
                "found_inf": self._found_inf,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, sd):
        self._scale = float(sd.get("scale", self._scale))
        self._incr_ratio = sd.get("incr_ratio", self._incr_ratio)
        self._decr_ratio = sd.get("decr_ratio", self._decr_ratio)
        self._incr_every = sd.get("incr_every_n_steps", self._incr_every)
        self._decr_every = sd.get("decr_every_n_nan_or_inf",
                                  self._decr_every)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)
        self._found_inf = bool(sd.get("found_inf", False))
        self._dynamic = sd.get("use_dynamic_loss_scaling", self._dynamic)

    set_state_dict = load_state_dict


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True
