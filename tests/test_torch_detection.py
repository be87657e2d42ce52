"""The detection and sequence ops beyond tests/eager_op_cases.py's
cases, against paddle_tpu's on the CPU.

Integer results equal exactly: NMS keeps and class ids
(multiclass_nms, matrix_nms, nms), generate_proposals' order and
counts, distribute_fpn_proposals' levels and restore index, pooling
indices, viterbi paths, gather_tree and edit distances, at sizes where
greedy suppression chains run long. The rule holds where no IoU or
score lies within float rounding of its threshold and no two scores tie
(the two packages round the same boxes differently, a few ulps apart):
each test asserts that margin on its data (``_assert_margin``), and
does not pick its data to avoid a mismatch.

Gradients of ctc_loss, deformable_conv, yolo_loss and roi_align
against ``jax.vjp`` of the reference's functions, within 1e-4 of each
gradient's largest element (f32 sums in other orders), one
configuration each (the op cases hold their other configurations'
gradients through the reference's tape).

The random ops (top_p_sampling, class_center_sample) are held to their
invariants and moments, not to the reference's draws (jax.random and
torch draw differently by design). take's bounds check, the
tensor_split family's gradients and read_file / decode_jpeg round
trips are here too."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_port_helpers import cpu_place

GRAD_TOL = 1e-4
MARGIN = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return pt.to_tensor(np.asarray(a))


def _np(x):
    return np.asarray(x._data) if hasattr(x, "_data") else np.asarray(x)


def _boxes(rng, shape, size, lo, hi):
    xy = rng.uniform(0, size - hi, shape + (2,))
    wh = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _iou64(a, b, off=0.0):
    a, b = a.astype(np.float64), b.astype(np.float64)
    area = lambda v: (np.clip(v[..., 2] - v[..., 0] + off, 0, None)
                      * np.clip(v[..., 3] - v[..., 1] + off, 0, None))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + off, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter,
                              1e-10)


def _assert_margin(values, thresholds, what):
    """No value within MARGIN of any threshold."""
    v = np.asarray(values, np.float64).ravel()
    for t in np.atleast_1d(thresholds):
        near = np.abs(v - t) < MARGIN
        assert not near.any(), f"{what}: {near.sum()} within {MARGIN} of {t}"


def _assert_no_ties(scores, what):
    s = np.sort(np.asarray(scores, np.float64).ravel())
    assert (np.diff(s) > 0).all(), f"{what}: tied scores"


def test_multiclass_nms_keeps_equal_at_long_chains():
    rng = np.random.default_rng(0)
    n, c, m = 2, 4, 60
    boxes = _boxes(rng, (n, m), 100.0, 10.0, 45.0)
    scores = rng.uniform(0.0, 1.0, (n, c, m)).astype(np.float32)
    for i in range(n):
        _assert_margin(_iou64(boxes[i], boxes[i]), [0.45, 0.5], "iou")
    _assert_margin(scores, 0.05, "score")
    _assert_no_ties(scores, "scores")
    for kw in (dict(nms_threshold=0.45), dict(nms_threshold=0.45,
                                               background_label=1),
               dict(nms_threshold=0.5, nms_eta=0.9, nms_top_k=40)):
        want = pt.ops.multiclass_nms(_j(boxes), _j(scores),
                                     score_threshold=0.05, keep_top_k=80,
                                     **kw)
        got = ptt.ops.multiclass_nms(_t(boxes), _t(scores),
                                     score_threshold=0.05, keep_top_k=80,
                                     **kw)
        np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
        np.testing.assert_array_equal(got[0][..., 0].numpy(),
                                      _np(want[0])[..., 0])
        np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=0,
                                   atol=1e-6)
        assert int(got[1].sum()) > 20


def test_matrix_nms_keeps_equal():
    rng = np.random.default_rng(1)
    n, c, m = 2, 3, 40
    boxes = _boxes(rng, (n, m), 100.0, 10.0, 45.0)
    scores = rng.uniform(0.0, 1.0, (n, c, m)).astype(np.float32)
    _assert_margin(scores, 0.3, "score")
    _assert_no_ties(scores, "scores")
    want = pt.ops.matrix_nms(_j(boxes), _j(scores), score_threshold=0.3,
                             post_threshold=0.1, nms_top_k=30,
                             keep_top_k=50)
    got = ptt.ops.matrix_nms(_t(boxes), _t(scores), score_threshold=0.3,
                             post_threshold=0.1, nms_top_k=30,
                             keep_top_k=50)
    # the decayed scores against post_threshold, and their order
    _assert_margin(_np(want[0])[..., 1], 0.1, "decayed score")
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_array_equal(got[0][..., 0].numpy(),
                                  _np(want[0])[..., 0])
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=1e-5,
                               atol=1e-6)


def test_eager_nms_keeps_equal():
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, (300,), 200.0, 10.0, 60.0)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    iou = _iou64(boxes, boxes)
    _assert_margin(iou / (1 + 1e-10 / np.maximum(iou, 1e-30)), 0.5, "iou")
    _assert_no_ties(scores, "scores")
    want = _np(pt.vision.ops.nms(_j(boxes), 0.5, _j(scores), top_k=100))
    got = ptt.vision.ops.nms(_t(boxes), 0.5, _t(scores), top_k=100)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the eager API narrows the indices to int32, as the reference does
    got_e = ptt.vision.ops.nms(ptt.to_tensor(boxes), 0.5,
                               ptt.to_tensor(scores), top_k=100)
    assert str(got_e.dtype).endswith("int32")
    np.testing.assert_array_equal(got_e.numpy(), want)


def test_generate_proposals_order_and_counts_equal():
    rng = np.random.default_rng(3)
    n, a, h, w = 2, 3, 8, 10
    anchors = _boxes(rng, (h, w, a), 160.0, 8.0, 60.0)
    var = np.broadcast_to(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                          (h, w, a, 4)).copy()
    scores = rng.standard_normal((n, a, h, w)).astype(np.float32)
    deltas = (rng.standard_normal((n, 4 * a, h, w)) * 0.5).astype(
        np.float32)
    im = np.array([[160, 150], [140, 160]], np.float32)
    _assert_no_ties(scores, "scores")
    args = dict(pre_nms_top_n=200, post_nms_top_n=60, nms_thresh=0.6,
                min_size=3.0)
    want = pt.ops.generate_proposals(_j(scores), _j(deltas), _j(im),
                                     _j(anchors), _j(var), **args)
    got = ptt.ops.generate_proposals(_t(scores), _t(deltas), _t(im),
                                     _t(anchors), _t(var), **args)
    rois = _np(want[0])
    for i in range(n):
        live = rois[i][: int(_np(want[2])[i])]
        _assert_margin(_iou64(live, live), 0.6, "iou of kept proposals")
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), rtol=0,
                               atol=0)
    np.testing.assert_allclose(got[0].numpy(), rois, rtol=1e-6, atol=1e-4)
    assert int(got[2].min()) > 20


def test_distribute_fpn_levels_and_restore_index_equal():
    rng = np.random.default_rng(4)
    rois = _boxes(rng, (200,), 1333.0, 4.0, 700.0)
    off = 0.0
    scale = np.sqrt((rois[:, 2] - rois[:, 0] + off)
                    * (rois[:, 3] - rois[:, 1] + off))
    level = 4 + np.log2(scale.astype(np.float64) / 224 + 1e-12)
    _assert_margin(level - np.floor(level), [0.0, 1.0], "level boundary")
    want = pt.ops.distribute_fpn_proposals(_j(rois), 2, 5, 4, 224,
                                           rois_num=_j(np.array(
                                               [120, 80], np.int32)))
    got = ptt.ops.distribute_fpn_proposals(_t(rois), 2, 5, 4, 224,
                                           rois_num=_t(np.array(
                                               [120, 80], np.int32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_pool_indices_paths_and_distances_equal():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 17, 15)).astype(np.float32)
    for kw in (dict(kernel_size=3, stride=2, padding=1),
               dict(kernel_size=(2, 3), stride=(2, 1), padding=[0, 1])):
        want = pt.ops.max_pool2d_with_index(_j(x), **kw)
        got = ptt.ops.max_pool2d_with_index(_t(x), **kw)
        np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    pots = rng.standard_normal((4, 12, 6)).astype(np.float32)
    trans = rng.standard_normal((6, 6)).astype(np.float32)
    lens = np.array([12, 7, 1, 10], np.int32)
    for bos in (True, False):
        want = pt.ops.viterbi_decode(_j(pots), _j(trans), _j(lens), bos)
        got = ptt.ops.viterbi_decode(_t(pots), _t(trans), _t(lens), bos)
        np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
        np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=1e-6)
    ids = rng.integers(0, 50, (7, 3, 4)).astype(np.int32)
    parents = rng.integers(0, 4, (7, 3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        ptt.ops.gather_tree(_t(ids), _t(parents)).numpy(),
        _np(pt.ops.gather_tree(_j(ids), _j(parents))))
    hyp = rng.integers(0, 5, (6, 9)).astype(np.int32)
    ref = rng.integers(0, 5, (6, 11)).astype(np.int32)
    hl = rng.integers(0, 10, 6).astype(np.int32)
    rl = rng.integers(1, 12, 6).astype(np.int32)
    want = pt.ops.edit_distance(_j(hyp), _j(ref), _j(hl), _j(rl),
                                normalized=False)
    got = ptt.ops.edit_distance(_t(hyp), _t(ref), _t(hl), _t(rl),
                                normalized=False)
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))


# ---------------------------------------------------------------- grads
def _vjp_check(ref_fn, port_fn, arrays, diff, cot_seed=0):
    """ref_fn's jax.vjp (of its jax.jit: one compiled program, where the
    eager trace compiles each primitive on its own) against port_fn's
    torch.autograd on `arrays`, differentiated at the positions `diff`."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [_t(a).requires_grad_(i in diff) for i, a in enumerate(arrays)]

    def f(*d):
        full = list(jargs)
        for i, v in zip(diff, d):
            full[i] = v
        return ref_fn(*full)

    want, vjp = jax.vjp(jax.jit(f), *[jargs[i] for i in diff])
    cot = np.random.default_rng(cot_seed).standard_normal(
        np.shape(want)).astype(np.float32)
    want_g = vjp(jnp.asarray(cot))
    got = port_fn(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    got_g = torch.autograd.grad(got, [targs[i] for i in diff], _t(cot))
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


def test_ctc_loss_gradient_against_jax_vjp():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((20, 3, 6)).astype(np.float32)
    labels = rng.integers(1, 6, (3, 5)).astype(np.int32)
    in_len, lab_len = np.array([20, 15, 9], np.int32), \
        np.array([5, 3, 2], np.int32)
    _vjp_check(lambda *a: pt.ops.ctc_loss.raw_fn(*a, reduction="none"),
               lambda *a: ptt.ops.ctc_loss(*a, reduction="none"),
               [logits, labels, in_len, lab_len], [0])


def test_deformable_conv_gradient_against_jax_vjp():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 7, 7)).astype(np.float32)
    off = (rng.standard_normal((2, 2 * 2 * 9, 7, 7)) * 0.8).astype(
        np.float32)
    w = rng.standard_normal((5, 4, 3, 3)).astype(np.float32)
    mask = rng.uniform(0.2, 1.0, (2, 2 * 9, 7, 7)).astype(np.float32)
    _vjp_check(lambda *a: pt.ops.deformable_conv.raw_fn(
                   *a, padding=1, deformable_groups=2),
               lambda *a: ptt.ops.deformable_conv(*a, padding=1,
                                                  deformable_groups=2),
               [x, off, w, mask], [0, 1, 2, 3])


def test_yolo_loss_gradient_against_jax_vjp():
    rng = np.random.default_rng(8)
    n, b, c, h, w = 2, 6, 4, 6, 5
    x = (rng.standard_normal((n, 3 * (5 + c), h, w)) * 2).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.05, 0.95, (n, b, 2)),
                         rng.uniform(0.02, 0.7, (n, b, 2))], -1).astype(
        np.float32)
    label = rng.integers(0, c, (n, b)).astype(np.int32)
    score = rng.uniform(0.3, 1.0, (n, b)).astype(np.float32)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    _vjp_check(lambda *a: pt.vision.ops.yolo_loss.raw_fn(
                   *a[:3], anchors, [3, 4, 5], c, 0.5, 32, gt_score=a[3]),
               lambda *a: ptt.vision.ops.yolo_loss(
                   *a[:3], anchors, [3, 4, 5], c, 0.5, 32, gt_score=a[3]),
               [x, gt, label, score], [0, 3])


def test_roi_align_gradient_against_jax_vjp():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 12, 14)).astype(np.float32)
    boxes = _boxes(rng, (7,), 48.0, 4.0, 30.0)
    num = np.array([3, 4], np.int32)
    _vjp_check(lambda *a: pt.vision.ops.roi_align.raw_fn(
                   *a, output_size=(3, 4), spatial_scale=0.25),
               lambda *a: ptt.vision.ops.roi_align(
                   *a, output_size=(3, 4), spatial_scale=0.25),
               [x, boxes, num], [0, 1])


# ---------------------------------------------------------------- random
def test_top_p_sampling_draws_from_the_nucleus_in_proportion():
    """Every draw inside its row's nucleus (the smallest prefix of the
    sorted probabilities whose mass reaches ps); over 4000 draws each
    token's frequency within 5 standard errors of its renormalised
    probability; a seed repeats its draws; ids int32, values the
    probabilities drawn."""
    probs = np.array([[0.4, 0.3, 0.2, 0.1], [0.05, 0.6, 0.05, 0.3]],
                     np.float32)
    ps = np.array([0.65, 0.85], np.float32)
    nucleus = [{0: 0.4, 1: 0.3}, {1: 0.6, 3: 0.3}]
    x = _t(np.repeat(probs, 2000, 0))
    p = _t(np.repeat(ps, 2000))
    g = torch.Generator().manual_seed(0)
    vals, ids = ptt.ops.top_p_sampling(x, p, generator=g)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (4000, 1)
    np.testing.assert_array_equal(vals.numpy()[:, 0], x.numpy()[
        np.arange(4000), ids.numpy()[:, 0]])
    for r in range(2):
        row = ids.numpy()[r * 2000:(r + 1) * 2000, 0]
        assert set(row.tolist()) <= set(nucleus[r])
        mass = sum(nucleus[r].values())
        for tok, pr in nucleus[r].items():
            q = pr / mass
            se = np.sqrt(q * (1 - q) / 2000)
            assert abs((row == tok).mean() - q) < 5 * se, (r, tok)
    a = ptt.ops.top_p_sampling(x[:8], p[:8], seed=5)[1]
    b = ptt.ops.top_p_sampling(x[:8], p[:8], seed=5)[1]
    assert torch.equal(a, b)


def test_class_center_sample_invariants():
    """Every positive class sampled, labels remapped onto it, the rest
    distinct negatives; over 2000 draws each negative class sampled
    about equally often (within 5 standard errors)."""
    label = np.array([3, 7, 3, 1, 12], np.int64)
    g = torch.Generator().manual_seed(1)
    counts = np.zeros(20)
    for _ in range(2000):
        remapped, sampled = ptt.ops.class_center_sample(
            _t(label), 20, 8, generator=g)
        s = sampled.numpy()
        assert len(set(s.tolist())) == 8
        assert sorted(s[:4].tolist()) == [1, 3, 7, 12]
        np.testing.assert_array_equal(s[remapped.numpy()], label)
        counts[s[4:]] += 1
    neg = np.setdiff1d(np.arange(20), [1, 3, 7, 12])
    q = 4 / 16
    se = np.sqrt(q * (1 - q) / 2000)
    assert (np.abs(counts[neg] / 2000 - q) < 5 * se).all()
    assert counts[[1, 3, 7, 12]].sum() == 0


# ---------------------------------------------------------------- misc
def test_take_raises_out_of_range_as_the_reference():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for idx in ([12], [-13]):
        with pytest.raises(IndexError):
            pt.ops.take(_j(x), _j(np.array(idx, np.int32)))
        with pytest.raises(IndexError):
            ptt.ops.take(ptt.to_tensor(x), ptt.to_tensor(np.array(
                idx, np.int32)))
    got = ptt.ops.take(ptt.to_tensor(x), ptt.to_tensor(np.array(
        [-12, 11], np.int32)))
    np.testing.assert_array_equal(got.numpy(), [0.0, 11.0])


def test_tensor_split_pieces_carry_gradients():
    """The port's pieces are views of the input, so a gradient reaches
    it (the reference's pieces are detached copies)."""
    x = ptt.to_tensor(np.arange(10, dtype=np.float32), stop_gradient=False)
    pieces = ptt.ops.tensor_split(x, [3, 7])
    assert [p.shape[0] for p in pieces] == [3, 4, 3]
    (pieces[1] * 2).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(),
                                  [0, 0, 0, 2, 2, 2, 2, 0, 0, 0])


def test_check_numerics_raises():
    with pytest.raises(FloatingPointError):
        ptt.ops.check_numerics(ptt.to_tensor(np.array([1.0, np.nan],
                                                      np.float32)))


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(10)
    img = rng.integers(0, 255, (12, 16, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    path = tmp_path / "a.jpg"
    path.write_bytes(buf.getvalue())
    got_bytes = ptt.vision.ops.read_file(str(path))
    want_bytes = pt.vision.ops.read_file(str(path))
    np.testing.assert_array_equal(got_bytes.numpy(), want_bytes.numpy())
    for mode in ("unchanged", "gray", "rgb"):
        got = ptt.vision.ops.decode_jpeg(got_bytes, mode=mode)
        want = pt.vision.ops.decode_jpeg(want_bytes, mode=mode)
        assert str(got.dtype).endswith("uint8")
        np.testing.assert_array_equal(got.numpy(), want.numpy())
