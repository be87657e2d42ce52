"""Random number generators (counterpart of paddle_tpu/core/generator.py).

The reference's ``Generator`` owns a JAX root key and an offset counter.
The port's owns one ``torch.Generator`` per device, made at first use
and seeded with the generator's seed, so ``seed(n)`` seeds every device
at once: the same seed gives the same draws on a device, run after run.
The draws are torch's (Philox on the card, mt19937 on the CPU), not
``jax.random``'s, so no test compares them across the packages.

``rng_scope(seed)`` makes the eager random ops draw from a generator of
its own while it is active (the reference threads a traced key through
it; the port's traced steps are CUDA graphs, which draw from registered
generators instead). ``next_key`` is JAX's own and is not ported.
``FLAGS_seed`` (default 0) seeds the default generator at import.
"""
from __future__ import annotations

import threading

import torch

from .flags import define_flag, flag_value

__all__ = ["Generator", "default_generator", "seed", "rng_scope",
           "torch_generator"]

define_flag("FLAGS_seed", 0, "global RNG seed: the default generator's "
            "seed at import")


def _key(device) -> tuple:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device.type, device.index


class Generator:
    """A seed and one torch.Generator per device, each seeded with it."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._gens = {}
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            for g in self._gens.values():
                g.manual_seed(self._seed)
        return self

    def seed(self):
        return self._seed

    def torch_generator(self, device) -> torch.Generator:
        """The torch.Generator this generator draws from on `device`."""
        key = _key(device)
        g = self._gens.get(key)
        if g is None:
            with self._lock:
                g = self._gens.get(key)
                if g is None:
                    g = torch.Generator(device=torch.device(*key))
                    g.manual_seed(self._seed)
                    self._gens[key] = g
        return g

    def get_state(self):
        """(seed, {device key: torch generator state})."""
        with self._lock:
            return self._seed, {k: g.get_state()
                                for k, g in self._gens.items()}

    def set_state(self, state):
        seed, states = state
        with self._lock:
            self._seed = int(seed)
            for k, g in self._gens.items():
                if k in states:
                    g.set_state(states[k])
                else:
                    g.manual_seed(self._seed)
        for k, st in states.items():
            if k not in self._gens:
                self.torch_generator(torch.device(*k)).set_state(st)
        return self


_default_generator = Generator(flag_value("FLAGS_seed"))
_scope_stack: list = []


def default_generator() -> Generator:
    return _default_generator


def seed(value: int) -> Generator:
    """paddle.seed: reseed the default generator on every device."""
    return _default_generator.manual_seed(value)


class rng_scope:
    """While active, the eager random ops draw from a Generator of their
    own, seeded with `base_seed` (an int or a Generator)."""

    def __init__(self, base_seed):
        self._gen = base_seed if isinstance(base_seed, Generator) \
            else Generator(int(base_seed))

    def __enter__(self):
        _scope_stack.append(self._gen)
        return self._gen

    def __exit__(self, *exc):
        _scope_stack.pop()
        return False


def torch_generator(device) -> torch.Generator:
    """The torch.Generator the eager random ops draw from on `device`:
    the innermost ``rng_scope``'s, else the default generator's."""
    gen = _scope_stack[-1] if _scope_stack else _default_generator
    return gen.torch_generator(device)
