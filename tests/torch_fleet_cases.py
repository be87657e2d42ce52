"""Shared cases of the port's fleet tests (tests/test_torch_kv_pages.py,
test_torch_router.py, test_torch_disagg.py, test_torch_fleet_control.py,
test_torch_replica_proc.py). This module imports no JAX and nothing of
paddle_tpu: a spawned replica process imports it to build its model."""
import numpy as np

# the reference's fleet tests' engine shapes (tests/test_disagg.py)
ENGINE_KW = dict(max_batch=2, block_size=16, decode_chunk=4,
                 prompt_quantum=16, max_model_len=96)


def tiny_gpt(device="cpu", seed=0):
    """gpt_tiny with weights drawn from `seed` on `device`: the model
    builder a spawned replica calls (module-level, so spawn pickles it
    by reference)."""
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.models.gpt import gpt_tiny
    m = GPTForCausalLM(gpt_tiny(), device=device, seed=seed)
    m.eval()
    return m


def rejected_frames():
    """{reason: count} of the frames this process's RPC servers refused
    (called in a replica process over its RPC layer)."""
    from paddle_tpu_torch import observability as obs
    snap = obs.snapshot().get("paddle_tpu_rpc_rejected_frames_total",
                              {"series": {}})
    return {k[0]: v for k, v in snap["series"].items()}


def prompts(lengths, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(n),)).astype(np.int32)
            for n in lengths]


def session_prompts(n_sessions, turns, prefix_len, seed=0, vocab=1024):
    """Multi-turn sessions: each session's turns extend its own prefix
    by a fresh tail. Returns [(session, turn, prompt)] in turn-major
    order."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, (prefix_len,)).astype(np.int32)
                for _ in range(n_sessions)]
    out = []
    for t in range(turns):
        for s in range(n_sessions):
            tail = rng.integers(0, vocab, (int(rng.integers(3, 9)),))
            out.append((s, t, np.concatenate([prefixes[s], tail])
                        .astype(np.int32)))
    return out


def reconciled(engine):
    """Idle-pool invariant: every page is free or parked reusable; only
    the engine's trash page stays leased."""
    c = engine.cache
    return c.available_blocks == c.allocator.num_blocks - 1


def pool_state(cache):
    """The integer state of a paged pool (the same attributes in both
    packages): the prefix index both ways, the LRU in order, every
    block's refcount, the free count and the live page tables."""
    return dict(
        hash_to_page=dict(cache._hash_to_page),
        page_hash=dict(cache._page_hash),
        lru=list(cache._lru.items()),
        refcounts=[cache.allocator.refcount(b)
                   for b in range(cache.allocator.num_blocks)],
        num_free=cache.allocator.num_free,
        pages={s: cache.pages(s) for s in cache._pages})


def serve(engine, prompts_, n_new, **add_kw):
    """{request index: output token tuple} of one engine run."""
    for i, p in enumerate(prompts_):
        engine.add_request(i, p, n_new, **add_kw)
    out = {}
    while engine.has_unfinished:
        for r in engine.step():
            assert r.ok, r.error
            out[r.request_id] = tuple(int(t) for t in r.output_ids)
    return out


class FakeClock:
    """A deterministic stand-in for the `time` module of a router: every
    read advances it by `tick` seconds, and `jump` moves it on. Patched
    into both packages' router modules so their breakers, EMAs and
    step timings read the same numbers."""

    def __init__(self, tick=1e-3):
        self.t = 1000.0
        self.tick = tick

    def perf_counter(self):
        self.t += self.tick
        return self.t

    monotonic = perf_counter

    def time(self):
        return self.perf_counter()

    def jump(self, seconds):
        self.t += seconds
        return True
