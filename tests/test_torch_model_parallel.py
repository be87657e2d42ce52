"""Model parallelism (paddle_tpu_torch.distributed.fleet and
meta_parallel, ROADMAP item 26b) against the reference's, one controller
on the CPU world of 8 ranks: tests/test_distributed.py's
``TestTopologyFleet``, ``TestMpuLayers``, ``TestRecompute::test_rng_tracker``,
``TestMoE``, ``TestPipeline``, ``TestShardingStage1`` and
``TestShardingWithPipeline``.

Each case builds the layer or model in both packages under the same
fleet degrees, carries the reference's weights into the port by name,
and holds the port's outputs and gradients to the reference's (f32,
rtol = atol = 1e-5 unless stated: XLA and torch sum in other orders).
Placement is compared as data: each parameter's recorded PartitionSpec
(and the optimizer states') equals the spec of the reference's
``NamedSharding``; the reference's bytes are not compared. Where the
reference case is slow (a GSPMD compile per step), the reference runs
one step and the port the case's whole loop."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as tdist
from paddle_tpu.distributed.topology import \
    set_hybrid_communicate_group as jset_hcg
from paddle_tpu_torch.distributed.topology import placement
from paddle_tpu_torch.distributed.topology import \
    set_hybrid_communicate_group as tset_hcg
from torch_port_helpers import cpu_place

TOL = dict(rtol=1e-5, atol=1e-5)
SIDES = {"ref": (pt, jdist), "port": (ptt, tdist)}


@pytest.fixture(autouse=True)
def _reset_groups():
    for _, d in SIDES.values():
        d.destroy_process_group()
    jset_hcg(None)
    tset_hcg(None)
    with cpu_place():
        yield
    for _, d in SIDES.values():
        d.destroy_process_group()
    jset_hcg(None)
    tset_hcg(None)


def _init_fleet(d, dp=1, mp=1, pp=1, sharding=1, accumulate_steps=1):
    strategy = d.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": pp,
                               "sharding_degree": sharding}
    strategy.pipeline_configs = {"accumulate_steps": accumulate_steps}
    d.fleet.init(strategy=strategy)
    return strategy


def _both_fleets(**kw):
    return [_init_fleet(d, **kw) for _, d in SIDES.values()]


def _carry(jm, tm):
    """The reference layer's weights into the port's, by name."""
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert sorted(sd) == sorted(torch.nn.Module.state_dict(tm))
    tm.set_state_dict({k: ptt.to_tensor(v) for k, v in sd.items()})


def _specs_equal(jm, tm):
    """Every parameter's recorded spec equals the reference's."""
    want = {n: tuple(p._dist_attr) if p._dist_attr is not None else None
            for n, p in jm.named_parameters()}
    got = {n: tuple(p._dist_attr) if p._dist_attr is not None else None
           for n, p in tm.named_parameters()}
    assert got == want


def _grads(m):
    return {n: p.grad.numpy() for n, p in m.named_parameters()
            if p.grad is not None}


def _close_grads(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _reference_grads(named, loss_of, *inputs):
    """The reference's loss, outputs and gradients (to the parameters of
    `named`, (name, Parameter) pairs, by name, and to `inputs`) through
    its own functional form (its TrainStep's): one jit of forward and
    backward, not a compile per eager op. `loss_of(*Tensors)` returns
    (loss, *outputs)."""
    import jax
    from paddle_tpu.autograd import tape
    from paddle_tpu.core.tensor import Tensor as JTensor
    from paddle_tpu.jit import _functional_params
    named = list(named)
    tensors = [p for _, p in named]

    def f(params, xs):
        with _functional_params(tensors, list(params)), tape.no_grad():
            out = loss_of(*[JTensor._wrap(x) for x in xs])
        return out[0]._data, [o._data for o in out[1:]]

    (loss, outs), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
        [t._data for t in tensors], [np.asarray(x) for x in inputs])
    return (float(loss), [np.asarray(o) for o in outs],
            {n: np.asarray(g) for (n, _), g in zip(named, gp)},
            [np.asarray(g) for g in gx])


# ---- TestTopologyFleet ----------------------------------------------------
def test_hcg_axes():
    for _, d in SIDES.values():
        hcg = d.HybridCommunicateGroup(dp=2, mp=2, pp=2)
        assert hcg.get_data_parallel_world_size() == 2
        assert hcg.get_model_parallel_world_size() == 2
        assert hcg.get_pipe_parallel_world_size() == 2
        assert hcg.mesh.shape == {"dp": 2, "pp": 2, "sharding": 1,
                                  "sep": 1, "mp": 2}


def test_fleet_init():
    for _, d in SIDES.values():
        strategy = d.fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 4}
        d.fleet.init(is_collective=True, strategy=strategy)
        hcg = d.fleet.get_hybrid_communicate_group()
        assert hcg.get_model_parallel_world_size() == 4
        assert hcg.get_data_parallel_world_size() == 2
        assert strategy.hybrid_configs["pp_degree"] == 1
        assert d.fleet.worker_num() == 8 and d.fleet.worker_index() == 0
    assert repr(tdist.fleet.DistributedStrategy()) == repr(
        jdist.fleet.DistributedStrategy())


def test_fleet_dp_absorbs():
    for _, d in SIDES.values():
        strategy = d.fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": -1, "mp_degree": 2}
        d.fleet.init(strategy=strategy)
        hcg = d.fleet.get_hybrid_communicate_group()
        assert hcg.get_data_parallel_world_size() == 4


# ---- TestMpuLayers --------------------------------------------------------
def _mpu(P):
    return P.distributed.meta_parallel


def test_column_row_match_dense():
    _both_fleets(dp=2, mp=4)
    pt.seed(3)
    jcol = _mpu(pt).ColumnParallelLinear(16, 32, gather_output=False)
    jrow = _mpu(pt).RowParallelLinear(32, 16)
    tcol = _mpu(ptt).ColumnParallelLinear(16, 32, gather_output=False)
    trow = _mpu(ptt).RowParallelLinear(32, 16)
    _carry(jcol, tcol)
    _carry(jrow, trow)
    x = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
    want = jrow(jcol(pt.to_tensor(x))).numpy()
    got = trow(tcol(ptt.to_tensor(x))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ref = (x @ tcol.weight.numpy() + tcol.bias.numpy()) \
        @ trow.weight.numpy() + trow.bias.numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    _specs_equal(jcol, tcol)
    _specs_equal(jrow, trow)
    assert tcol.weight._dist_attr == ptt.distributed.topology.PartitionSpec(
        None, "mp")
    assert placement(trow.weight).mesh is tdist.fleet.fleet \
        .get_hybrid_communicate_group().mesh
    # gather_output's reshard: the same values, recorded replicated
    jg = _mpu(pt).ColumnParallelLinear(16, 32)
    tg = _mpu(ptt).ColumnParallelLinear(16, 32)
    _carry(jg, tg)
    out = tg(ptt.to_tensor(x))
    np.testing.assert_allclose(out.numpy(), jg(pt.to_tensor(x)).numpy(),
                               **TOL)
    assert out._dist_attr == ()


def test_mp_backward():
    """mp 4 x dp 2: the input's and both weights' gradients equal the
    reference layers' (on a one-device group, through its functional
    form: the function is the same)."""
    _init_fleet(tdist, mp=4, dp=2)
    _init_fleet(jdist)
    mods = {}
    for name, P in (("ref", pt), ("port", ptt)):
        mods[name] = (_mpu(P).ColumnParallelLinear(8, 16,
                                                   gather_output=False),
                      _mpu(P).RowParallelLinear(16, 8))
    for j, t in zip(mods["ref"], mods["port"]):
        _carry(j, t)
    x = np.random.default_rng(1).standard_normal((2, 8)).astype(np.float32)
    jcol, jrow = mods["ref"]
    want_loss, _, want, (want_x,) = _reference_grads(
        [("col", jcol.weight), ("col_b", jcol.bias), ("row", jrow.weight),
         ("row_b", jrow.bias)],
        lambda xt: (pt.ops.mean(jrow(jcol(xt)) ** 2),), x)
    col, row = mods["port"]
    xt = ptt.to_tensor(x, stop_gradient=False)
    loss = ptt.ops.mean(row(col(xt)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    got = dict(col=col.weight.grad.numpy(), col_b=col.bias.grad.numpy(),
               row=row.weight.grad.numpy(), row_b=row.bias.grad.numpy())
    _close_grads(dict(got, x=xt.grad.numpy()), dict(want, x=want_x))
    assert np.isfinite(got["col"]).all()


def test_vocab_parallel_embedding():
    _both_fleets(mp=8)
    jemb = _mpu(pt).VocabParallelEmbedding(64, 16)
    temb = _mpu(ptt).VocabParallelEmbedding(64, 16)
    _carry(jemb, temb)
    ids = np.array([[1, 5, 63]], np.int32)
    out = temb(ptt.to_tensor(ids))
    assert out.shape == [1, 3, 16]
    np.testing.assert_allclose(out.numpy()[0, 0], temb.weight.numpy()[1],
                               rtol=1e-6)
    np.testing.assert_array_equal(out.numpy(),
                                  jemb(pt.to_tensor(ids)).numpy())
    _specs_equal(jemb, temb)


def test_parallel_cross_entropy():
    """mp 8: the per-token loss over the column-parallel logits equals
    cross_entropy on the same logits in each package, and the port's
    equals the reference's (its layers on a one-device group), with and
    without ignored tokens."""
    _init_fleet(tdist, mp=8)
    _init_fleet(jdist)
    jlin = _mpu(pt).ColumnParallelLinear(16, 64, gather_output=False)
    tlin = _mpu(ptt).ColumnParallelLinear(16, 64, gather_output=False)
    _carry(jlin, tlin)
    x = np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32)
    out = {}
    for label in (np.array([1, 2, 3, 4], np.int32),
                  np.array([1, -100, 3, -100], np.int32)):
        for name, P, lin in (("ref", pt, jlin), ("port", ptt, tlin)):
            logits = lin(P.to_tensor(x))
            loss = _mpu(P).ParallelCrossEntropy()(logits,
                                                  P.to_tensor(label))
            ref = P.ops.cross_entropy(P.to_tensor(logits.numpy()),
                                      P.to_tensor(label), reduction="none",
                                      ignore_index=-100)
            np.testing.assert_allclose(loss.numpy(), ref.numpy(), **TOL)
            out[name] = loss.numpy()
        np.testing.assert_allclose(out["port"], out["ref"], **TOL)
    assert out["port"][1] == 0.0


# ---- TestRecompute::test_rng_tracker -------------------------------------
def test_rng_tracker():
    """Sequential draws from the tracked stream differ, and draws
    outside it are unaffected by it (draws are never compared across
    the packages)."""
    from paddle_tpu_torch.distributed.meta_parallel import (
        get_rng_state_tracker, model_parallel_random_seed)
    model_parallel_random_seed(42)
    tr = get_rng_state_tracker()
    with tr.rng_state():
        a = ptt.ops.dropout(ptt.ones([100]), p=0.5)
    with tr.rng_state():
        b = ptt.ops.dropout(ptt.ones([100]), p=0.5)
    assert not np.allclose(a.numpy(), b.numpy())
    outside = ptt.ops.dropout(ptt.ones([100]), p=0.5).numpy()
    model_parallel_random_seed(42)
    with tr.rng_state():
        a2 = ptt.ops.dropout(ptt.ones([100]), p=0.5)
    np.testing.assert_array_equal(a2.numpy(), a.numpy())
    np.testing.assert_array_equal(
        ptt.ops.dropout(ptt.ones([100]), p=0.5).numpy(), outside)
    with pytest.raises(ValueError, match="already exists"):
        tr.add("other", 42 + 1024 + 1)
    assert sorted(tr.get_states_tracker()) == ["model_parallel_rng"]


# ---- TestMoE --------------------------------------------------------------
def _moe_routing_margin(x, gate_w, k):
    """The smallest gap in each token's sorted gate probabilities around
    its k chosen experts (ranks 1..k+1): a gap below f32 noise could
    flip a choice between the packages."""
    logits = x.astype(np.float64) @ gate_w.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    s = -np.sort(-p, axis=-1)
    return float(np.min(s[:, :k] - s[:, 1:k + 1]))


def test_moe_forward_backward():
    """At mp 4 x dp 2 the expert weights' recorded specs equal the
    reference's. The output, the auxiliary loss and every gradient
    equal the reference layer's on the same weights (the reference's
    computed unplaced, on one device: the function is the same and a
    GSPMD compile per op is not), and the routing decisions (experts,
    buffer slots, capacity drops) are equal under a margin guard on the
    gate probabilities."""
    _both_fleets(mp=4, dp=2)
    kw = dict(d_model=16, d_hidden=32, num_experts=8, top_k=2)
    jplaced = _mpu(pt).MoELayer(**kw)
    tmoe = _mpu(ptt).MoELayer(**kw)
    _carry(jplaced, tmoe)
    _specs_equal(jplaced, tmoe)
    jset_hcg(None)
    jmoe = _mpu(pt).MoELayer(**kw)
    jmoe.eval()
    jmoe.set_state_dict({k: pt.to_tensor(np.asarray(v._data))
                         for k, v in jplaced.state_dict().items()})
    x = np.random.default_rng(3).standard_normal((2, 8, 16)).astype(
        np.float32)
    flat = x.reshape(-1, 16)
    gw = tmoe.gate_weight.numpy()
    assert _moe_routing_margin(flat, gw, 2) > 1e-4
    want_loss, (want_out, want_aux), want_g, (want_x,) = _reference_grads(
        jmoe.named_parameters(), lambda xt: (lambda out: (
            pt.ops.mean(out ** 2) + 0.01 * pt.ops.mean(jmoe.aux_loss),
            out, jmoe.aux_loss))(jmoe(xt)), x)
    xt = ptt.to_tensor(x, stop_gradient=False)
    out = tmoe(xt)
    assert out.shape == [2, 8, 16]
    loss = ptt.ops.mean(out ** 2) + 0.01 * ptt.ops.mean(tmoe.aux_loss)
    loss.backward()
    res = {"ref": dict(loss=want_loss, out=want_out, aux=want_aux, x=want_x,
                       **want_g),
           "port": dict(loss=float(loss), out=out.numpy(),
                        aux=tmoe.aux_loss.numpy(), x=xt.grad.numpy(),
                        **_grads(tmoe))}
    _close_grads(res["port"], res["ref"])
    assert np.isfinite(res["port"]["w1"]).all()
    # the routing integers, against the reference's rule in jax
    import jax
    import jax.numpy as jnp
    from paddle_tpu_torch.distributed.meta_parallel.moe_layer import _route
    _p, _v, topi, pos, keep, _g, cap = _route(
        torch.from_numpy(flat), torch.from_numpy(gw), 2, 1.5)
    probs = jax.nn.softmax(jnp.asarray(flat) @ jnp.asarray(gw), axis=-1)
    _, jtopi = jax.lax.top_k(probs, 2)
    oh = jax.nn.one_hot(jtopi, 8, dtype=jnp.int32)
    jpos = jnp.sum((jnp.cumsum(oh.reshape(-1, 8), 0) - 1).reshape(
        oh.shape) * oh, -1)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jpos) < cap)


def test_moe_routes_all_tokens_with_capacity():
    jmoe = _mpu(pt).MoELayer(d_model=8, d_hidden=16, num_experts=4,
                             top_k=1, capacity_factor=4.0)
    tmoe = _mpu(ptt).MoELayer(d_model=8, d_hidden=16, num_experts=4,
                              top_k=1, capacity_factor=4.0)
    _carry(jmoe, tmoe)
    x = np.random.default_rng(4).standard_normal((1, 16, 8)).astype(
        np.float32)
    out = tmoe(ptt.to_tensor(x))
    # with a huge capacity nothing is dropped: the output is not zero
    assert float(ptt.ops.mean(out ** 2).numpy()) > 0
    np.testing.assert_allclose(out.numpy(),
                               jmoe(pt.to_tensor(x)).numpy(), **TOL)
    # the tie rule: equal gate probabilities rank the lower expert first
    from paddle_tpu_torch.distributed.meta_parallel.moe_layer import _route
    _p, _v, topi, *_ = _route(torch.ones(3, 8), torch.zeros(8, 4), 2, 1.0)
    np.testing.assert_array_equal(topi.numpy(), [[0, 1]] * 3)


# ---- TestPipeline ---------------------------------------------------------
def _blk_class(P):
    class Blk(P.nn.Layer):
        def __init__(self, d):
            super().__init__()
            self.lin = P.nn.Linear(d, d)

        def forward(self, x):
            return P.ops.relu(self.lin(x))
    return Blk


def _blk_pipe(P, num_stages=None):
    mp = P.distributed.meta_parallel
    Blk = _blk_class(P)
    descs = [mp.LayerDesc(Blk, 16) for _ in range(4)] + \
        [mp.LayerDesc(P.nn.Linear, 16, 4)]
    return mp.PipelineLayer(
        layers=descs, loss_fn=lambda out, lbl: P.ops.cross_entropy(out, lbl),
        seg_method="uniform", num_stages=num_stages)


def _unplaced_reference(build, placed, accumulate_steps, **cfg):
    """The reference's pipeline over `placed`'s weights with no hybrid
    group (`build(num_stages=...)` gives its parts): a PipelineParallel
    over a one-device group. Its ops run unplaced, so a case pays no
    GSPMD compile per op; the function is the placed model's."""
    jset_hcg(None)
    jm = build(num_stages=placed._num_stages)
    jm.set_state_dict({k: pt.to_tensor(np.asarray(v._data))
                       for k, v in placed.state_dict().items()})
    strategy = jdist.fleet.DistributedStrategy()
    strategy.pipeline_configs = dict(accumulate_steps=accumulate_steps,
                                     **cfg)
    return jm, jdist.meta_parallel.PipelineParallel(
        jm, jdist.HybridCommunicateGroup(), strategy)


def _twin_pipes(accumulate_steps=2):
    for P in (pt, ptt):
        _init_fleet(P.distributed, pp=2, dp=2, mp=2,
                    accumulate_steps=accumulate_steps)
    pt.seed(5)
    jm = _blk_pipe(pt)
    tm = _blk_pipe(ptt)
    _carry(jm, tm)
    return jm, tm


def test_pipeline_layer_stages():
    jm, tm = _twin_pipes()
    assert len(tm.stages) == 2
    assert tm.segment_parts == jm.segment_parts == [0, 3, 5]
    # each stage's parameters are placed on its stage's sub-mesh
    p0 = tm.stages[0][0].lin.weight
    p1 = tm.stages[1][0].lin.weight
    assert placement(p0).mesh is not placement(p1).mesh
    for part in range(2):
        want = jm.stages[part][0].lin.weight._data.sharding.mesh
        got = placement(tm.stages[part][0].lin.weight).mesh
        assert got.axis_names == want.axis_names
        np.testing.assert_array_equal(
            got.devices, np.vectorize(lambda d: d.id)(want.devices))
    _specs_equal(jm, tm)


def test_train_batch():
    """The first train_batch's loss and gradients equal the reference's;
    over 8 the loss falls."""
    jplaced, tm = _twin_pipes(accumulate_steps=2)
    jm, jp = _unplaced_reference(lambda **kw: _blk_pipe(pt, **kw),
                                 jplaced, 2)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.integers(0, 4, (8,)).astype(np.int32)
    want = float(jp.forward_backward_pipeline(
        [pt.to_tensor(x), pt.to_tensor(y)]).numpy())
    want_g = _grads(jm)
    tp = tdist.fleet.distributed_model(tm)
    opt = tdist.fleet.distributed_optimizer(ptt.optimizer.AdamW(
        learning_rate=1e-2, parameters=tm.parameters()))
    got = float(tp.forward_backward_pipeline(
        [ptt.to_tensor(x), ptt.to_tensor(y)]).numpy())
    np.testing.assert_allclose(got, want, **TOL)
    _close_grads(_grads(tm), want_g)
    opt.clear_grad()
    losses = [float(tp.train_batch([ptt.to_tensor(x), ptt.to_tensor(y)],
                                   opt).numpy()) for _ in range(8)]
    np.testing.assert_allclose(losses[0], want, **TOL)
    assert losses[-1] < losses[0]


def _shared_pipe(P, num_stages=None):
    mp = P.distributed.meta_parallel

    def head(layer, x):
        return P.ops.matmul(x, layer.weight, transpose_y=True)

    descs = [mp.SharedLayerDesc("emb", P.nn.Embedding, 32, 16),
             mp.LayerDesc(P.nn.Linear, 16, 16),
             mp.SharedLayerDesc("emb", P.nn.Embedding, 32, 16,
                                forward_func=head)]
    return mp.PipelineLayer(layers=descs, loss_fn=None,
                            num_stages=num_stages)


def test_shared_layer_desc():
    for P in (pt, ptt):
        _init_fleet(P.distributed, pp=2, dp=4)
    pt.seed(8)
    jplaced = _shared_pipe(pt)
    tm = _shared_pipe(ptt)
    _carry(jplaced, tm)
    _specs_equal(jplaced, tm)
    # the shared layer is built once: one embedding weight, at home
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jplaced.named_parameters()]
    assert placement(tm._shared["emb"][0].weight).mesh is \
        tm._stage_meshes[0]
    jm, _ = _unplaced_reference(lambda **kw: _shared_pipe(pt, **kw),
                                jplaced, 1)
    ids = np.array([[1, 2]], np.int32)
    outs = {}
    for name, P, m in (("ref", pt, jm), ("port", ptt, tm)):
        out = m(P.to_tensor(ids))
        assert out.shape == [1, 2, 32]
        P.ops.mean(out ** 2).backward()
        outs[name] = dict(out=out.numpy(), **_grads(m))
    _close_grads(outs["port"], outs["ref"])
    # the home copy's gradient gathers both uses
    assert tm._shared["emb"][0].weight.grad is not None


# ---- TestShardingStage1 / TestShardingWithPipeline -------------------------
def _spec(s):
    """A spec as a tuple without trailing Nones: JAX gives an array that
    a compiled update produced the shortest spec of its placement
    (``P("sharding")`` for ``P("sharding", None)``)."""
    s = tuple(s)
    while s and s[-1] is None:
        s = s[:-1]
    return s


def _state_specs(opt, p):
    """{accumulator: spec} the port's optimizer recorded for `p`."""
    return {k: _spec(v.spec) for k, v in
            opt.state_shardings.get(id(p._data), {}).items()}


def test_opt_states_sharded():
    """dp 2 x sharding 4: after a step the port's AdamW states are
    recorded with the specs the reference's optimizer commits them to
    (its `_commit_states`, the placement step of its `step`), split on
    the sharding axis; clear_grad clears."""
    _both_fleets(dp=2, sharding=4)
    jm, tm = pt.nn.Linear(16, 64), ptt.nn.Linear(16, 64)
    _carry(jm, tm)
    jdist.fleet.distributed_model(jm)
    jopt = jdist.fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    jopt._inner_opt._get_state(jm.weight)
    jopt._commit_states()
    model = tdist.fleet.distributed_model(tm)
    opt = tdist.fleet.distributed_optimizer(ptt.optimizer.AdamW(
        learning_rate=1e-3, parameters=tm.parameters()))
    x = np.random.default_rng(9).standard_normal((8, 16)).astype(np.float32)
    ptt.ops.mean(model(ptt.to_tensor(x)) ** 2).backward()
    opt.step()
    st = jopt._inner_opt._accumulators[id(jm.weight)]
    want = {k: _spec(v.sharding.spec) for k, v in st.items()
            if getattr(v, "ndim", 0) > 0}
    got = _state_specs(opt, tm.weight)
    assert got == want and any("sharding" in s for s in got.values())
    _specs_equal(jm, tm)
    opt.clear_grad()
    assert tm.weight.grad is None


def _linear_pipe(P, num_stages=None):
    mp = P.distributed.meta_parallel
    descs = [mp.LayerDesc(P.nn.Linear, 16, 32),
             mp.LayerDesc(P.nn.Linear, 32, 32),
             mp.LayerDesc(P.nn.Linear, 32, 16),
             mp.LayerDesc(P.nn.Linear, 16, 8)]
    return mp.PipelineLayer(
        layers=descs, loss_fn=lambda out, lbl: P.ops.mean((out - lbl) ** 2),
        num_stages=num_stages)


def test_opt_states_follow_stage_submesh():
    """pp 2 x sharding 2 x mp 2: the accumulators of a stage's parameter
    are recorded on that parameter's stage sub-mesh, with the specs the
    reference's optimizer commits them to (its `_commit_states`, the
    placement step of its `step`); a second train_batch runs on the
    recorded states."""
    for P in (pt, ptt):
        _init_fleet(P.distributed, mp=2, pp=2, sharding=2,
                    accumulate_steps=2)
    jplaced = _linear_pipe(pt)
    tm = _linear_pipe(ptt)
    _carry(jplaced, tm)
    jopt = jdist.fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=jplaced.parameters()))
    for p in jplaced.parameters():
        jopt._inner_opt._get_state(p)
    jopt._commit_states()
    pipe = tdist.fleet.distributed_model(tm)
    opt = tdist.fleet.distributed_optimizer(ptt.optimizer.AdamW(
        learning_rate=1e-3, parameters=tm.parameters()))
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    y = rng.standard_normal((4, 8)).astype(np.float32)
    loss = pipe.train_batch([ptt.to_tensor(x), ptt.to_tensor(y)], opt)
    assert np.isfinite(float(loss.numpy()))
    for (n, jp), (_, tp) in zip(jplaced.named_parameters(),
                                tm.named_parameters()):
        st = jopt._inner_opt._accumulators.get(id(jp))
        specs = opt.state_shardings.get(id(tp._data), {})
        assert {k: _spec(v.sharding.spec) for k, v in st.items()
                if getattr(v, "ndim", 0) > 0} == \
            {k: _spec(v.spec) for k, v in specs.items()}, n
        for v in specs.values():
            assert v.mesh is placement(tp).mesh
    loss = pipe.train_batch([ptt.to_tensor(x), ptt.to_tensor(y)], opt)
    assert np.isfinite(float(loss.numpy()))
