"""paddle_tpu_torch.geometric against paddle_tpu.geometric on the CPU:
the registered message-passing ops and segment pools as cases of
tests/eager_op_cases.py's ``OPSURF_CASES`` (values and the inputs'
gradients through ``backward()``, f32, rtol = atol 1e-6; a
division's within 1e-5), max / min reductions equal and their gradients
split evenly among tied messages on both sides, out-of-range indices
handled as XLA handles them, the genuine-infinity quirk, reindex_graph
equal, the samplers' rule, and a two-layer GraphSAGE-mean's loss and
gradients within 1e-5."""
import numpy as np
import pytest

import eager_op_cases as C
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_ops import check_case
from torch_port_helpers import cpu_place

CASES = [c for c in C.CASES if c[0] in set(C.OPSURF_CASES)
         and c[0].startswith(("send_", "segment_"))]
JG, TG = pt.geometric, ptt.geometric


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.mark.parametrize("name,fn,opts", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(name, fn, opts):
    check_case(name, fn, opts)


def _run(P, G, x, src, dst, op, out_size=None, grad=True):
    t = P.to_tensor(x, stop_gradient=not grad)
    out = G.send_u_recv(t, P.to_tensor(src), P.to_tensor(dst), op,
                        out_size=out_size)
    if grad:
        (out * P.to_tensor(np.arange(out.size, dtype=np.float32)
                           .reshape(out.shape))).sum().backward()
        return out.numpy(), t.grad.numpy()
    return out.numpy(), None


@pytest.mark.parametrize("op", ["max", "min"])
def test_ties_split_the_gradient_evenly(op):
    """Integer-valued features: two tied messages into one segment get
    half the segment's gradient each, on both sides."""
    x = np.array([[2.0, 1.0], [2.0, 3.0], [1.0, 1.0], [5.0, 1.0]],
                 np.float32)
    src = np.array([0, 1, 2, 3, 0], np.int32)
    dst = np.array([0, 0, 0, 1, 1], np.int32)
    got, got_g = _run(ptt, TG, x, src, dst, op)
    want, want_g = _run(pt, JG, x, src, dst, op)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_g, want_g)
    # each row sent once, a cotangent of ones: rows 0 and 1 tie in
    # segment 0
    x = np.array([[2.0], [2.0], [1.0]], np.float32)
    if op == "min":
        x = -x
    for P, G in ((ptt, TG), (pt, JG)):
        t = P.to_tensor(x, stop_gradient=False)
        G.send_u_recv(t, P.to_tensor(np.array([0, 1, 2], np.int32)),
                      P.to_tensor(np.array([0, 0, 1], np.int32)),
                      op).sum().backward()
        assert t.grad.numpy()[:, 0].tolist() == [0.5, 0.5, 1.0]


def test_out_of_range_indices_follow_xla():
    """A negative gather index wraps once, then every index is clamped
    into range (jnp's x[idx]); a message to a node outside [0, out_size)
    is dropped (segment_sum). The port does the same on the device, with
    no host read and no error."""
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    src = np.array([-1, 5, 7, -7, 2, 0], np.int32)
    dst = np.array([0, 1, -1, 3, 9, 3], np.int32)
    for op in ("sum", "mean", "max", "min"):
        got, _ = _run(ptt, TG, x, src, dst, op, out_size=4, grad=False)
        want, _ = _run(pt, JG, x, src, dst, op, out_size=4, grad=False)
        np.testing.assert_array_equal(got, want)
    got = TG.send_uv(ptt.to_tensor(x), ptt.to_tensor(x), ptt.to_tensor(src),
                     ptt.to_tensor(dst)).numpy()
    want = JG.send_uv(pt.to_tensor(x), pt.to_tensor(x), pt.to_tensor(src),
                      pt.to_tensor(dst)).numpy()
    np.testing.assert_array_equal(got, want)


def test_genuine_infinity_is_zeroed_as_the_reference_zeroes_it():
    """The reference finds empty max / min segments by testing for ±inf,
    so a segment whose max is a genuine +inf (min: -inf) comes out 0;
    the port computes the same function (ROADMAP Queue C, known gaps)."""
    x = np.array([[np.inf, 1.0], [1.0, -np.inf], [2.0, 3.0]], np.float32)
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([0, 0, 2], np.int32)
    for op in ("max", "min"):
        got, _ = _run(ptt, TG, x, src, dst, op, out_size=4, grad=False)
        want, _ = _run(pt, JG, x, src, dst, op, out_size=4, grad=False)
        np.testing.assert_array_equal(got, want)
        assert got[0, 0 if op == "max" else 1] == 0.0
        assert (got[[1, 3]] == 0).all()          # empty segments


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_integer_features(op):
    x = np.array([[3, -2], [7, 5], [-4, 1]], np.int32)
    src = np.array([0, 1, 2, 1], np.int32)
    dst = np.array([0, 0, 2, 2], np.int32)
    got, _ = _run(ptt, TG, x, src, dst, op, out_size=4, grad=False)
    want, _ = _run(pt, JG, x, src, dst, op, out_size=4, grad=False)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _graph(n=40, e=200, seed=0):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    colptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    return src, dst, colptr.astype(np.int32)


def test_reindex_graph_equal():
    rng = np.random.default_rng(1)
    x = np.array([7, 3, 11], np.int32)
    nb = rng.integers(0, 20, 12).astype(np.int32)
    cnt = np.array([5, 3, 4], np.int32)
    got = TG.reindex_graph(ptt.to_tensor(x), ptt.to_tensor(nb),
                           ptt.to_tensor(cnt))
    want = JG.reindex_graph(pt.to_tensor(x), pt.to_tensor(nb),
                            pt.to_tensor(cnt))
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.numpy().dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_sample_neighbors_rule(weighted):
    row, dst, colptr = _graph()
    nodes = np.array([0, 5, 17, 33, 39], np.int32)
    eids = np.arange(len(row), dtype=np.int32)
    w = np.random.default_rng(2).uniform(0.1, 1, len(row)).astype(np.float32)
    T, J = ptt.to_tensor, pt.to_tensor

    def port(k, seed):
        ptt.seed(seed)
        if weighted:
            return TG.weighted_sample_neighbors(
                T(row), T(colptr), T(w), T(nodes), k, T(eids), True)
        return TG.sample_neighbors(T(row), T(colptr), T(nodes), k, T(eids),
                                   True)

    out, cnt, oe = (t.numpy() for t in port(3, 0))
    deg = np.diff(colptr)[nodes]
    np.testing.assert_array_equal(cnt, np.minimum(deg, 3))
    off = np.concatenate([[0], np.cumsum(cnt)])
    for i, n in enumerate(nodes):
        picks = oe[off[i]:off[i + 1]]
        assert len(set(picks.tolist())) == len(picks)     # no repeats
        assert ((picks >= colptr[n]) & (picks < colptr[n + 1])).all()
        np.testing.assert_array_equal(out[off[i]:off[i + 1]], row[picks])
    # the same seed samples the same; every neighbour when k is -1, as the
    # reference gives them
    again = [t.numpy() for t in port(3, 0)]
    np.testing.assert_array_equal(again[2], oe)
    full = [t.numpy() for t in port(-1, 4)]
    ref = JG.sample_neighbors(J(row), J(colptr), J(nodes), -1, J(eids),
                              True)
    for g, r in zip(full, ref):
        np.testing.assert_array_equal(g, r.numpy())


def _sage(P, G, x, src, dst, ws, n):
    """Two GraphSAGE-mean layers: h' = relu(h W_self + mean_nbr(h) W_nbr)."""
    h = x
    for i, (ws_, wn) in enumerate(ws):
        agg = G.send_u_recv(h, src, dst, "mean", out_size=n)
        h = P.matmul(h, ws_) + P.matmul(agg, wn)
        if i == 0:
            h = P.nn.functional.relu(h)
    return h


def test_graphsage_mean_matches_reference():
    n, f, hid, cls = 40, 8, 16, 5
    src, dst, _ = _graph(n, 300, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, f)).astype(np.float32)
    shapes = [(f, hid), (f, hid), (hid, cls), (hid, cls)]
    wts = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
           for s in shapes]
    out = {}
    for P, G in ((ptt, TG), (pt, JG)):
        ws = [P.to_tensor(w, stop_gradient=False) for w in wts]
        logits = _sage(P, G, P.to_tensor(x), P.to_tensor(src),
                       P.to_tensor(dst), [(ws[0], ws[1]), (ws[2], ws[3])], n)
        loss = (logits * logits).mean()
        loss.backward()
        out[P.__name__] = (logits.numpy(), [w.grad.numpy() for w in ws])
    (got, got_g), (want, want_g) = out["paddle_tpu_torch"], out["paddle_tpu"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
