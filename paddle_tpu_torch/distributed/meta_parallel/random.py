"""Tensor-parallel randomness (counterpart of
paddle_tpu/distributed/meta_parallel/random.py).

The reference's tracker keeps named PRNG keys and swaps the framework
generator's key while a context is active. The port's keeps named
states of its own `Generator` (``get_state`` / ``set_state``): entering
``rng_state(name)`` sets the default generator to the tracked state, and
leaving it stores the advanced state and puts the caller's back, so
draws inside continue one stream across entries. The draws are torch's,
not ``jax.random``'s.
"""
from __future__ import annotations

import contextlib

from ...core.generator import Generator, default_generator

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "determinate_seed",
           "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.states_[name] = Generator(seed).get_state()

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        gen = default_generator()
        orig = gen.get_state()
        gen.set_state(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = gen.get_state()
            gen.set_state(orig)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    """Distinct global and tensor-parallel streams from one base seed
    (the reference's mpu/random.py model_parallel_random_seed)."""
    from ...core.generator import seed as _seed
    seed = seed if seed is not None else 1024
    global_seed = seed
    local_seed = seed + 1024 + 1    # the tensor-parallel stream's seed
    tracker = get_rng_state_tracker()
    tracker.reset()
    _seed(global_seed)
    tracker.add(MODEL_PARALLEL_RNG, local_seed)


def determinate_seed(name):
    tracker = get_rng_state_tracker()
    return tracker.states_.get(name)
