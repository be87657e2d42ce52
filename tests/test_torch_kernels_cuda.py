"""paddle_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card. Every test here is marked `cuda` and skips without one.

This file imports neither jax nor paddle_tpu, so it runs on a machine
that has only the port's dependencies:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _packed_case(H=4, Hk=2, D=128, bs=8, NB=16, int8=False, dtype=np.float32,
                 interleave=False, seed=0):
    """Rows of every kind the engine ships (fresh prefill, one decode
    token, a short window, a prefix-resume tail, an empty slot) on
    randomly placed pages, with dead padding at the end; `interleave`
    shuffles the packed tokens so rows are not contiguous."""
    rng = np.random.default_rng(seed)
    spec = [(0, 20), (24, 1), (10, 5), (16, 7), (0, 0)]
    B = len(spec)
    T = 64
    rows = np.full((T,), -1, np.int32)
    pos = np.zeros((T,), np.int32)
    kv_start = np.zeros((B,), np.int32)
    off = np.full((B, NB), -1, np.int32)
    free = list(rng.permutation(NB))
    c = 0
    for b, (cached, m) in enumerate(spec):
        if not m:
            continue
        rows[c:c + m] = b
        pos[c:c + m] = cached + np.arange(m)
        kv_start[b] = cached
        pages = [free.pop() for _ in range(-(-(cached + m) // bs))]
        off[b, pages] = np.arange(len(pages)) * bs
        c += m
    if interleave:
        order = rng.permutation(T)
        rows, pos = rows[order], pos[order]

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)

    case = dict(q=rnd(T, H, D), k_new=rnd(T, Hk, D), v_new=rnd(T, Hk, D),
                rows=rows, pos=pos, kv_start=kv_start, off=off, kdq=None,
                vdq=None)
    if int8:
        for k in ("kpool", "vpool"):
            case[k] = rng.integers(-127, 128, (NB * bs, Hk, D)).astype(
                np.int8)
        case["kdq"] = rng.uniform(0.01, 0.05, (Hk,)).astype(np.float32)
        case["vdq"] = rng.uniform(0.01, 0.05, (Hk,)).astype(np.float32)
    else:
        case["kpool"] = rnd(NB * bs, Hk, D)
        case["vpool"] = rnd(NB * bs, Hk, D)
    return case, dict(block_size=bs, scale=1.0 / np.sqrt(D))


_ARR = ("q", "k_new", "v_new", "kpool", "vpool", "rows", "pos",
        "kv_start", "off")


def _run(case, kw, dev, path, torch_dtype, with_pool=True, upcast=False):
    def t(a):
        x = torch.as_tensor(a.astype(np.float32) if a.dtype.kind == "f"
                            else a, device=dev)
        if a.dtype.kind == "f" and a.ndim == 3:
            x = x.to(torch.float32 if upcast else torch_dtype)
        return x
    args = [t(case[k]) for k in _ARR]
    dq = {k: None if case[k] is None else t(case[k]) for k in ("kdq", "vdq")}
    return ragged_paged_attention(*args, **kw, **dq, with_pool=with_pool,
                                  path=path)


KINDS = {
    "f32": dict(dtype=torch.float32),
    "bf16": dict(dtype=torch.bfloat16),
    "bf16_int8_pool": dict(dtype=torch.bfloat16, int8=True),
    "f32_int8_pool": dict(dtype=torch.float32, int8=True),
    "gqa_d64": dict(dtype=torch.bfloat16, H=8, Hk=2, D=64),
    "mqa_d256": dict(dtype=torch.bfloat16, H=4, Hk=1, D=256),
    "interleaved": dict(dtype=torch.bfloat16, interleave=True),
    "no_pool": dict(dtype=torch.bfloat16, with_pool=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_ragged_kernel_matches_plain(cuda_device, kind):
    spec = dict(KINDS[kind])
    tdt = spec.pop("dtype")
    with_pool = spec.pop("with_pool", True)
    case, kw = _packed_case(**spec)
    n0 = ragged_paged_attention.kernel_launches
    got = _run(case, kw, cuda_device, "cuda", tdt, with_pool)
    torch.cuda.synchronize()
    assert ragged_paged_attention.kernel_launches == n0 + 1
    # the plain version in f32 on the same (bf16-rounded) values: the
    # kernel computes in f32 too, so only the summation order differs
    rounded = {k: (torch.as_tensor(v).to(tdt).float().numpy()
                   if isinstance(v, np.ndarray) and v.dtype.kind == "f"
                   and v.ndim == 3 else v) for k, v in case.items()}
    want = _run(rounded, kw, cuda_device, "torch", tdt, with_pool,
                upcast=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    dead = torch.as_tensor(case["rows"] < 0, device=cuda_device)
    assert (got[dead] == 0).all()


@pytest.mark.cuda
def test_ragged_kernel_reads_strided_token_views(cuda_device):
    """The engine hands q/k/v as views into the fused qkv projection."""
    case, kw = _packed_case()
    T, H, D = case["q"].shape
    Hk = case["k_new"].shape[1]
    qkv = torch.as_tensor(np.concatenate(
        [case["q"].reshape(T, -1), case["k_new"].reshape(T, -1),
         case["v_new"].reshape(T, -1)], axis=1), device=cuda_device)
    q = qkv[:, :H * D].reshape(T, H, D)
    k = qkv[:, H * D:(H + Hk) * D].reshape(T, Hk, D)
    v = qkv[:, (H + Hk) * D:].reshape(T, Hk, D)
    assert not q.is_contiguous()
    rest = [torch.as_tensor(case[n], device=cuda_device)
            for n in _ARR[3:]]
    got = ragged_paged_attention(q, k, v, *rest, **kw, path="cuda")
    want = ragged_paged_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), *rest, **kw,
                                  path="torch")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
