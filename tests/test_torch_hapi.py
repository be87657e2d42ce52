"""hapi (Model, summary, the callbacks, VisualDL), metric and utils of
the port against paddle_tpu's.

The nn.Layer GPT of tests/eager_gpt_layer_script.py, on
tests/test_torch_eager_gpt.py's tiny config and batches, trained one
epoch by ``Model.fit`` over a DataLoader (tests/hapi_gpt_script.py) on
each package from the same weights: losses and parameters within that
file's ``TOLS`` (f32, and bf16 O1 under ``auto_cast``), the logged
accuracies equal; on the port the fit is bit-equal to
``layer_gpt_steps`` (the same ops in the same order, one thread), and a
``Model.save`` / ``load`` round trip gives a model whose next
``train_batch`` equals the original's bit for bit. ``evaluate`` and
``predict`` within ``TOLS``. The metrics, ``flops``, ``summary``'s
counts and VisualDL's records (tag, step, value) are held to the
reference's exactly, but for values computed from a training run
(``TOLS``)."""
import glob
import struct

import numpy as np
import pytest
import torch

import eager_gpt_layer_script as LS
import hapi_gpt_script as H
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_eager_gpt import LR, TOLS, _setup
from torch_port_helpers import cpu_place

PKGS = [pytest.param(pt, id="ref"), pytest.param(ptt, id="port")]


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.fixture
def one_thread():
    """Bit-equality needs one summation order: torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _fit(P, amp=False, **kw):
    cfg, _, weights, batches = _setup()
    return H.hapi_fit(P, LS, weights, batches, cfg.num_layers,
                      cfg.num_heads, lr=LR, amp=amp, **kw)


# ---------------------------------------------------------------------------
# Model.fit / evaluate / predict / save / load
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16_o1"])
def test_fit_matches_reference(amp):
    got_l, got_a, got_m = _fit(ptt, amp)
    want_l, want_a, want_m = _fit(pt, amp)
    tol = TOLS[amp]
    np.testing.assert_allclose(got_l, want_l, rtol=tol["loss"])
    assert got_a == want_a
    got, want = got_m.network.state_dict(), want_m.network.state_dict()
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                   atol=tol["param"], rtol=0, err_msg=k)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16_o1"])
def test_fit_equals_layer_gpt_steps(amp, one_thread):
    cfg, _, weights, batches = _setup()
    got_l, _, got_m = _fit(ptt, amp)
    want_l, want_m, _ = LS.layer_gpt_steps(ptt, weights, batches,
                                           cfg.num_layers, cfg.num_heads,
                                           lr=LR, amp=amp)
    assert got_l == want_l
    got, want = got_m.network.state_dict(), want_m.state_dict()
    for k in weights:
        torch.testing.assert_close(got[k]._data, want[k]._data, rtol=0,
                                   atol=0)


def test_evaluate_and_predict_match_reference():
    cfg, _, weights, batches = _setup()
    results = {}
    for P in (pt, ptt):
        _, _, model = H.hapi_fit(P, LS, weights, batches[:2],
                                 cfg.num_layers, cfg.num_heads, lr=LR)
        logs = model.evaluate(H.batch_loader(P, batches[2:]))
        (logits,) = model.predict(H.batch_loader(P, batches[2:]))
        results[P] = logs, _np(logits)
    (got_logs, got), (want_logs, want) = results[ptt], results[pt]
    assert set(got_logs) == set(want_logs) == {"loss", "acc"}
    np.testing.assert_allclose(got_logs["loss"], want_logs["loss"],
                               rtol=TOLS[False]["loss"])
    assert got_logs["acc"] == want_logs["acc"]
    np.testing.assert_allclose(got, want, atol=TOLS[False]["param"],
                               rtol=0)


def test_save_load_round_trip(tmp_path, one_thread):
    cfg, _, weights, batches = _setup()
    losses = {}
    for P in (pt, ptt):
        _, _, model = H.hapi_fit(P, LS, weights, batches[:2],
                                 cfg.num_layers, cfg.num_heads, lr=LR)
        fresh, loss_fresh, loss_orig = H.round_trip(
            P, LS, model, str(tmp_path / P.__name__), batches[2], weights,
            cfg.num_layers, cfg.num_heads, lr=LR)
        losses[P] = loss_fresh, loss_orig
        if P is ptt:
            assert loss_fresh == loss_orig
            a, b = fresh.network.state_dict(), model.network.state_dict()
            for k in a:
                torch.testing.assert_close(a[k]._data, b[k]._data, rtol=0,
                                           atol=0)
    for P in (pt, ptt):
        assert sorted(p.name for p in tmp_path.glob(f"{P.__name__}.pd*")) \
            == [f"{P.__name__}.pdopt", f"{P.__name__}.pdparams"]
    np.testing.assert_allclose(losses[ptt], losses[pt],
                               rtol=TOLS[False]["loss"])


def _mlp_model(P, lr=0.1, sched=False):
    pt.seed(0)
    net = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                           pt.nn.Linear(8, 1))
    if P is ptt:
        port = ptt.nn.Sequential(ptt.nn.Linear(4, 8), ptt.nn.ReLU(),
                                 ptt.nn.Linear(8, 1))
        port.set_state_dict({k: v.numpy()
                             for k, v in net.state_dict().items()})
        net = port
    lr = P.optimizer.lr.StepDecay(lr, step_size=1, gamma=0.5) if sched \
        else lr
    model = P.Model(net)
    model.prepare(P.optimizer.SGD(learning_rate=lr,
                                  parameters=net.parameters()),
                  P.nn.MSELoss())
    return model


def _regression(P, n=8):
    class Ds(P.io.Dataset):
        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            return (rng.standard_normal(4).astype(np.float32),
                    rng.standard_normal(1).astype(np.float32))

        def __len__(self):
            return n

    return Ds()


def test_callbacks_match_reference(tmp_path):
    """EarlyStopping stops at the reference's epoch, ModelCheckpoint
    writes the reference's files, the LR scheduler steps a batch."""
    seen = {}
    for P in (pt, ptt):
        model = _mlp_model(P, sched=True)
        stop = P.callbacks.EarlyStopping(monitor="loss", patience=0,
                                         min_delta=10.0)
        rec = H.step_recorder(P)
        lrs = []

        class Lr(P.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                lrs.append(model._optimizer.get_lr())

        d = tmp_path / P.__name__
        model.fit(_regression(P), eval_data=_regression(P, 4), batch_size=4,
                  epochs=5, verbose=0, shuffle=False, save_dir=str(d),
                  callbacks=[stop, rec, Lr(),
                             P.callbacks.LRScheduler(by_step=True)])
        seen[P] = (stop.stopped, stop.wait, [r["loss"] for r in rec.logs],
                   lrs, sorted(p.name for p in d.iterdir()))
    got, want = seen[ptt], seen[pt]
    assert got[0] and got[0] == want[0] and got[1] == want[1]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    assert got[3] == want[3]
    assert got[4] == want[4] and got[4]


def _records(path):
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (n,) = struct.unpack("<Q", header)
            f.read(4)
            out.append(f.read(n))
            f.read(4)


def _varint(b, i):
    v = shift = 0
    while True:
        c = b[i]
        i += 1
        v |= (c & 0x7F) << shift
        shift += 7
        if not c & 0x80:
            return v, i


def _fields(b):
    """{field number: [values]} of a protobuf message (varint, 64-bit,
    length-delimited and 32-bit fields)."""
    out, i = {}, 0
    while i < len(b):
        key, i = _varint(b, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(b, i)
        elif wire == 1:
            v, i = struct.unpack("<d", b[i:i + 8])[0], i + 8
        elif wire == 5:
            v, i = struct.unpack("<f", b[i:i + 4])[0], i + 4
        else:
            n, i = _varint(b, i)
            v, i = b[i:i + n], i + n
        out.setdefault(num, []).append(v)
    return out


def _scalars(logdir):
    """(tag, step, value) of every scalar event a SummaryWriter wrote."""
    (path,) = glob.glob(f"{logdir}/events.out.tfevents.*")
    rows = []
    for rec in _records(path):
        ev = _fields(rec)
        if 5 not in ev:
            assert ev[3] == [b"brain.Event:2"]
            continue
        val = _fields(_fields(ev[5][0])[1][0])
        rows.append((val[1][0].decode(), ev.get(2, [0])[0], val[2][0]))
    return rows


def test_visualdl_records_match_reference(tmp_path):
    rows = {}
    for P in (pt, ptt):
        model = _mlp_model(P)
        cb = P.callbacks.VisualDL(str(tmp_path / P.__name__))
        model.fit(_regression(P), eval_data=_regression(P, 4), batch_size=4,
                  epochs=2, verbose=0, shuffle=False, callbacks=[cb])
        rows[P] = _scalars(tmp_path / P.__name__)
    got, want = rows[ptt], rows[pt]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert {r[0] for r in got} >= {"train/loss", "eval/loss"}
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-5)


@pytest.mark.parametrize("P", PKGS)
def test_summary_writer_scalars(tmp_path, P):
    with P.callbacks.SummaryWriter(str(tmp_path)) as w:
        w.add_scalar("train/loss", 0.5, step=1)
        w.add_scalar("train/loss", 0.25, step=2)
        w.add_scalar("eval/acc", np.float32(0.9), step=2)
    assert _scalars(tmp_path) == [("train/loss", 1, 0.5),
                                  ("train/loss", 2, 0.25),
                                  ("eval/acc", 2, np.float32(0.9))]


# ---------------------------------------------------------------------------
# metric
# ---------------------------------------------------------------------------
def _pred_label(seed=0, n=64, c=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, c)).astype(np.float32),
            rng.integers(0, c, (n, 1)).astype(np.int32))


@pytest.mark.parametrize("topk", [1, (1, 5)])
def test_accuracy_metric_matches_reference(topk):
    out = {}
    for P in (pt, ptt):
        m = P.metric.Accuracy(topk=topk)
        accs = []
        for seed in range(3):
            pred, label = _pred_label(seed)
            accs.append(m.update(m.compute(P.to_tensor(pred),
                                           P.to_tensor(label))))
        out[P] = accs, m.accumulate(), m.name()
    assert out[ptt] == out[pt]


def test_binary_metrics_match_reference():
    rng = np.random.default_rng(0)
    probs = rng.random((3, 200)).astype(np.float32)
    labels = rng.integers(0, 2, (3, 200))
    out = {}
    for P in (pt, ptt):
        ms = [P.metric.Precision(), P.metric.Recall(), P.metric.Auc()]
        for p, l in zip(probs, labels):
            for m in ms:
                m.update(p, l)
        out[P] = [(m.name(), m.accumulate()) for m in ms]
    assert out[ptt] == out[pt]


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_function_matches_reference(k):
    pred, label = _pred_label(1)
    got = ptt.metric.accuracy(ptt.to_tensor(pred), ptt.to_tensor(label), k=k)
    want = pt.metric.accuracy(pt.to_tensor(pred), pt.to_tensor(label), k=k)
    assert float(got.numpy()) == float(want.numpy())


# ---------------------------------------------------------------------------
# summary, flops, utils
# ---------------------------------------------------------------------------
def _cnn(P):
    nn = P.nn
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8),
                         nn.ReLU(), nn.MaxPool2D(2), nn.Conv2D(8, 4, 3),
                         nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                         nn.Linear(4, 10), nn.Softmax())


@pytest.mark.parametrize("build,size", [
    (_cnn, (2, 3, 16, 16)),
    (lambda P: P.nn.Sequential(P.nn.Linear(8, 32), P.nn.GELU(),
                               P.nn.LayerNorm(32), P.nn.Linear(32, 4),
                               P.nn.Tanh(), P.nn.Sigmoid()), (5, 8))],
    ids=["cnn", "mlp"])
def test_flops_and_summary_match_reference(build, size):
    res = {}
    for P in (pt, ptt):
        net = build(P)
        res[P] = (P.utils.flops(net, list(size)),
                  P.summary(net, list(size)),
                  P.Model(net).summary(list(size)))
    assert res[ptt] == res[pt]
    assert res[ptt][0] > 0 and res[ptt][1]["total_flops"] == res[ptt][0]


def test_summary_of_an_int_input_model():
    """The reference's summary reads no `dtypes`, so a model of token ids
    gets no FLOPs row there; the port's forwards zeros of that dtype."""
    cfg, _, weights, _ = _setup()
    rows = {}
    for P in (pt, ptt):
        net = LS.gpt_from_weights(P, weights, cfg.num_layers, cfg.num_heads)
        rows[P] = P.summary(net, (2, 32), dtypes="int32")
    assert "total_flops" not in rows[pt]
    assert rows[ptt]["total_params"] == rows[pt]["total_params"]
    assert rows[ptt]["total_flops"] > 0


def test_utils():
    u = ptt.utils
    assert u.try_import("math").pi == np.pi
    with pytest.raises(ImportError, match="no_such"):
        u.try_import("no_such_module_here", "no_such")
    x = ptt.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    y = u.from_dlpack(u.to_dlpack(x))
    np.testing.assert_array_equal(y.numpy(), x.numpy())
    assert y._data.data_ptr() == x._data.data_ptr()
    assert u.dlpack.from_dlpack(u.dlpack.to_dlpack(x)).shape == [2, 3]
    with u.unique_name_guard("p"):
        pass
    f = u.deprecated(update_to="g")(len)
    assert f is len
    assert u.run_check() is True
