"""The detection ops on the card against the CPU (marked cuda: they
skip without a card). This file imports no JAX: the card's machine has
none.

roi_pool and psroi_pool quantise each bin's edges with floor / ceil of a
quotient, and distribute_fpn_proposals takes the floor of a log2 of one:
PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, which rounds an integer quotient (a bin edge, a RoI of
exactly refer_scale) to just below it; the ops divide by a tensor on the
device, and these tests hold their outputs on the card equal to the
CPU's."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _boxes(rng, n, w, h):
    xy = rng.uniform(0, max(w, h), (n, 2))
    wh = rng.uniform(10, 600, (n, 2))
    return torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(
        np.float32))


@pytest.mark.parametrize("channels", [8, 1024])
def test_roi_pools_on_the_card_equal_the_cpu(channels):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, channels, 50, 84)).astype(
        np.float32))
    boxes = _boxes(rng, 200, 1333, 800)
    num = torch.tensor([100, 100], dtype=torch.int32)
    for fn in (ops.roi_pool, ops.psroi_pool):
        if fn is ops.psroi_pool:
            x = torch.from_numpy(rng.standard_normal(
                (2, 2 * 49, 50, 84)).astype(np.float32))
        want = fn(x, boxes, num, 7, 1 / 16)
        got = fn(x.cuda(), boxes.cuda(), num.cuda(), 7, 1 / 16)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_fpn_levels_of_exact_scales_equal_the_cpu():
    """RoIs whose scale is 224 times a power of two (56, 112, ..., 896)
    land on the same level on the card as on the CPU."""
    side = torch.tensor([56.0, 112.0, 224.0, 448.0, 896.0])
    rois = torch.stack([torch.zeros(5), torch.zeros(5), side, side], 1)
    want = ops.distribute_fpn_proposals(rois, 2, 5, 4, 224)
    got = ops.distribute_fpn_proposals(rois.cuda(), 2, 5, 4, 224)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
