"""The hybrid GPT and process-group tensor parallelism
(paddle_tpu_torch.models.gpt_hybrid, shard_plans, convert's mp helpers
and meta_parallel's process-group mode, ROADMAP item 26b) against the
reference's.

One controller: tests/test_auto_parallel.py's ``TestHybridGPT`` (the
``slow`` pipeline-training case stays ``slow``) and the pipeline form's
names and single pass.

Process groups: one job of two ranks over gloo in spawned processes
(tests/torch_hybrid_cases.py, which imports no JAX), mp_degree 2. Each
mpu and sequence-parallel layer on its shard equals its dense function
(numpy, f64 products; rtol = atol = 1e-5), and GPTForCausalLMHybrid's
logits and its gradients, gathered from both ranks
(``convert.mp_gather_state``), equal the reference's on the whole
weights (rtol = atol = 1e-5). Each option process-group mode does not
port raises NotImplementedError naming its ROADMAP item."""
import multiprocessing
import socket

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as tdist
from paddle_tpu.distributed.topology import \
    set_hybrid_communicate_group as jset_hcg
from paddle_tpu_torch.distributed.topology import \
    set_hybrid_communicate_group as tset_hcg
from torch_port_helpers import cpu_place

TOL = dict(rtol=1e-5, atol=1e-5)
SIDES = {"ref": (pt, jdist), "port": (ptt, tdist)}


@pytest.fixture(autouse=True)
def _reset():
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


def _init(d, **degrees):
    strategy = d.fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    strategy.pipeline_configs = {"accumulate_steps": 2}
    d.fleet.init(strategy=strategy)


def _cfg(P):
    return P.models.gpt.gpt_tiny(hidden_dropout_prob=0.0,
                                 attention_dropout_prob=0.0)


def _numpy_state(m):
    return {k: np.asarray(v._data) for k, v in m.state_dict().items()}


# ---- TestHybridGPT --------------------------------------------------------
@pytest.mark.slow  # as the reference's: >25 s there
def test_tp_pp_dp_pipeline_training():
    """dp 2 x mp 2 x pp 2, recompute every block: 4 train_batch calls
    whose losses equal the reference's (rtol 1e-4 over the steps) and
    fall."""
    from paddle_tpu.models.gpt_hybrid import gpt_pipeline_model as jgpm
    from paddle_tpu_torch.models.gpt_hybrid import gpt_pipeline_model
    losses = {}
    ids = np.random.default_rng(0).integers(0, 1024, (4, 16)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1)
    weights = None
    for name, (P, d) in SIDES.items():
        _init(d, dp=2, mp=2, pp=2)
        build = jgpm if name == "ref" else gpt_pipeline_model
        model = build(_cfg(P), recompute_interval=1)
        if weights is None:
            weights = _numpy_state(model)
        else:
            model.set_state_dict({k: P.to_tensor(v)
                                  for k, v in weights.items()})
        pp = d.fleet.distributed_model(model)
        opt = d.fleet.distributed_optimizer(P.optimizer.AdamW(
            learning_rate=1e-3, parameters=model.parameters()))
        losses[name] = [float(pp.train_batch(
            [P.to_tensor(ids), P.to_tensor(labels)], opt).numpy())
            for _ in range(4)]
    assert losses["port"][-1] < losses["port"][0]
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-4)


def test_hybrid_flat_model_matches_dense(two_ranks):
    """dp 2 x mp 4: the recorded specs equal the reference's, the logits
    equal the reference model's on the same weights (the `two_ranks`
    fixture's, computed on a one-device group: the function is the
    same), and the TP QKV projection equals its dense product."""
    from paddle_tpu.models.gpt_hybrid import GPTForCausalLMHybrid as JHybrid
    from paddle_tpu_torch.models.gpt_hybrid import GPTForCausalLMHybrid
    ref, _ = two_ranks
    for _, d in SIDES.values():
        _init(d, dp=2, mp=4)
    jplaced = JHybrid(_cfg(pt))
    m = GPTForCausalLMHybrid(_cfg(ptt))
    assert sorted(_numpy_state(jplaced)) == \
        sorted(torch.nn.Module.state_dict(m))
    assert {n: p._dist_attr for n, p in m.named_parameters()} == \
        {n: None if p._dist_attr is None else tuple(p._dist_attr)
         for n, p in jplaced.named_parameters()}
    m.set_state_dict({k: ptt.to_tensor(v)
                      for k, v in ref["weights"].items()})
    m.eval()
    ids = ref["ids"]
    logits = m(ptt.to_tensor(ids))
    assert logits.shape == [2, 8, 1024]
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    # the TP projection equals the dense product on the same weights
    x = m.embeddings.word_embeddings.weight.numpy()[ids] + \
        m.embeddings.position_embeddings.weight.numpy()[np.arange(8)][None]
    first = m.layers[0].ln1(ptt.to_tensor(x))
    qkv_ref = first.numpy() @ m.layers[0].attn.qkv_proj.weight.numpy() + \
        m.layers[0].attn.qkv_proj.bias.numpy()
    qkv_tp = m.layers[0].attn.qkv_proj(first).numpy()
    np.testing.assert_allclose(qkv_tp, qkv_ref, rtol=2e-4, atol=2e-4)


def _pipeline_name(flat, layers):
    """A GPTForCausalLMHybrid parameter's name in gpt_pipeline_model."""
    head, _, rest = flat.partition(".")
    if head == "embeddings":
        return f"stages.0.0.layer.{rest}"
    if head == "layers":
        i, _, rest = rest.partition(".")
        return f"stages.0.{int(i) + 1}.{rest}"
    return f"stages.0.{layers + 1}.{rest}"


def test_pipeline_model_keys_and_loss(two_ranks):
    """gpt_pipeline_model's state_dict keys (stages.<part>.<i>., the tied
    embedding under its home position) equal the reference's, and its
    single pass (forward_part chained, every block recomputed, the
    default loss) equals the reference model's loss on the same
    weights."""
    from paddle_tpu.models.gpt_hybrid import gpt_pipeline_model as jgpm
    from paddle_tpu_torch import hybrid_gpt_params_from_numpy
    from paddle_tpu_torch.models.gpt_hybrid import gpt_pipeline_model
    ref, _ = two_ranks
    for _, d in SIDES.values():
        _init(d)
    tm = gpt_pipeline_model(_cfg(ptt), recompute_interval=1)
    assert list(_numpy_state(jgpm(_cfg(pt)))) == \
        list(torch.nn.Module.state_dict(tm))
    torch.nn.Module.load_state_dict(tm, hybrid_gpt_params_from_numpy(
        {_pipeline_name(k, 2): v for k, v in ref["weights"].items()}))
    x = ptt.to_tensor(ref["ids"])
    for part in range(tm.num_parts):
        x = tm.forward_part(x, part)
    loss = tm._loss_fn(x, ptt.to_tensor(ref["labels"]))
    np.testing.assert_allclose(float(loss.numpy()), ref["loss"], **TOL)
    loss.backward()
    np.testing.assert_allclose(
        tm.stages[0][0].layer.word_embeddings.weight.grad.numpy(),
        ref["grads"]["embeddings.word_embeddings.weight"], **TOL)


# ---- two ranks over gloo --------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks():
    """The reference's GPTForCausalLMHybrid (gpt_tiny, dropout 0, on a
    one-device group): its whole weights, a batch, its logits, loss and
    gradients (through its functional form, jitted); and the two-rank
    job's results ({rank: {case: results}}). The reference computes
    while the ranks start."""
    import jax
    from paddle_tpu.autograd import tape as jtape
    from paddle_tpu.core.tensor import Tensor as JTensor
    from paddle_tpu.jit import _functional_params
    from paddle_tpu.models.gpt_hybrid import GPTForCausalLMHybrid as JHybrid
    from torch_hybrid_cases import two_rank_worker
    jset_hcg(None)
    _init(jdist)
    pt.seed(4)
    jm = JHybrid(_cfg(pt))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 1024, (2, 8)).astype(np.int32)
    labels = rng.integers(0, 1024, (2, 8)).astype(np.int32)
    ref = dict(ids=ids, labels=labels, weights=_numpy_state(jm))
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=two_rank_worker,
                         args=(r, port, ref["weights"], (ids, labels), out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        jm.eval()
        names, tensors = zip(*jm.named_parameters())

        def loss_of(params):
            # the reference's own functional form (its TrainStep's): one
            # jit of the forward and backward, not a compile per op
            with _functional_params(list(tensors), list(params)), \
                    jtape.no_grad():
                logits = jm(JTensor._wrap(ids))
                loss = pt.ops.mean(pt.ops.cross_entropy(
                    logits, JTensor._wrap(labels), reduction="none"))
            return loss._data, logits._data

        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_of, has_aux=True))([t._data for t in tensors])
        ref.update(logits=np.asarray(logits), loss=float(loss),
                   grads={n: np.asarray(g) for n, g in zip(names, grads)})
        jset_hcg(None)
        jdist.destroy_process_group()
        res = dict(out.get(timeout=90) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
    for r in range(2):
        assert isinstance(res[r], dict), res[r]
    return ref, res


def _f64(a):
    return np.asarray(a, np.float64)


def test_two_ranks_column_parallel(two_ranks):
    from torch_hybrid_cases import layer_arrays
    A = layer_arrays()
    _, res = two_ranks
    x, w, b = _f64(A["x16"]), _f64(A["col_w"]), _f64(A["col_b"])
    y = x @ w + b
    for r in range(2):
        half = slice(16 * r, 16 * r + 16)
        g = res[r]["col_gather"]
        assert g["shape"] == [16, 16]
        np.testing.assert_allclose(g["y"], y, **TOL)
        np.testing.assert_allclose(g["x_grad"], _f64(A["cot32"]) @ w.T,
                                   **TOL)
        np.testing.assert_allclose(g["w_grad"],
                                   (x.T @ _f64(A["cot32"]))[:, half], **TOL)
        np.testing.assert_allclose(g["b_grad"], _f64(A["cot32"]).sum(0)[
            half], **TOL)
        loc = res[r]["col_local"]
        np.testing.assert_allclose(loc["y"], y[:, half], **TOL)
        # both ranks' column blocks of the cotangent reach x
        np.testing.assert_allclose(loc["x_grad"], _f64(A["cot32"]) @ w.T,
                                   **TOL)


def test_two_ranks_row_parallel(two_ranks):
    from torch_hybrid_cases import layer_arrays
    A = layer_arrays()
    _, res = two_ranks
    x, w, cot = _f64(A["x32"]), _f64(A["row_w"]), _f64(A["cot16"])
    y = x @ w + _f64(A["row_b"])
    for r in range(2):
        half = slice(16 * r, 16 * r + 16)
        for case in ("row_whole", "row_split"):
            g = res[r][case]
            np.testing.assert_allclose(g["y"], y, **TOL)
            xg = cot @ w.T
            np.testing.assert_allclose(
                g["x_grad"], xg if case == "row_whole" else xg[:, half],
                **TOL)
            np.testing.assert_allclose(g["w_grad"], (x.T @ cot)[half],
                                       **TOL)
            np.testing.assert_allclose(g["b_grad"], cot.sum(0), **TOL)


def test_two_ranks_vocab_parallel_embedding(two_ranks):
    from torch_hybrid_cases import layer_arrays
    A = layer_arrays()
    _, res = two_ranks
    w = A["emb_w"]
    wg = np.zeros_like(w, np.float64)
    np.add.at(wg, A["ids"].ravel(), _f64(A["cot_emb"]).reshape(-1, 16))
    for r in range(2):
        g = res[r]["vocab"]
        np.testing.assert_allclose(g["y"], w[A["ids"]], **TOL)
        np.testing.assert_allclose(g["w_grad"], wg[32 * r:32 * r + 32],
                                   **TOL)


def test_two_ranks_parallel_cross_entropy(two_ranks):
    """ParallelCrossEntropy over vocab-split logits equals the reference's
    cross_entropy on the whole logits (ignore_index kept), and so does
    its gradient."""
    from torch_hybrid_cases import layer_arrays
    A = layer_arrays()
    _, res = two_ranks
    logits = pt.to_tensor(A["logits"], stop_gradient=False)
    loss = pt.ops.cross_entropy(logits, pt.to_tensor(A["labels"]),
                                reduction="none")
    (loss * pt.to_tensor(A["cot_ce"])).sum().backward()
    for r in range(2):
        g = res[r]["cross_entropy"]
        np.testing.assert_allclose(g["loss"], loss.numpy(), **TOL)
        np.testing.assert_allclose(
            g["grad"], logits.grad.numpy()[:, 32 * r:32 * r + 32], **TOL)
    assert res[0]["cross_entropy"]["loss"][2] == 0.0    # ignore_index


def test_two_ranks_sequence_parallel(two_ranks):
    from torch_hybrid_cases import layer_arrays
    A = layer_arrays()
    _, res = two_ranks
    seq, cot = _f64(A["seq"]), _f64(A["seq_cot"])
    cot2 = np.concatenate([cot, cot], axis=1)
    # the dense function of the sequence-parallel linears
    h = np.tanh(seq @ _f64(A["sp_col_w"]) + _f64(A["sp_col_b"]))
    y = h @ _f64(A["sp_row_w"]) + _f64(A["sp_row_b"])
    dh = (cot2 @ _f64(A["sp_row_w"]).T) * (1 - h ** 2)
    for r in range(2):
        chunk = slice(4 * r, 4 * r + 4)
        half = slice(16 * r, 16 * r + 16)
        g = res[r]
        np.testing.assert_allclose(g["scatter"]["y"], seq[:, chunk], **TOL)
        np.testing.assert_allclose(g["scatter"]["grad"], cot2, **TOL)
        np.testing.assert_allclose(g["all_gather"]["y"], seq, **TOL)
        np.testing.assert_allclose(g["all_gather"]["grad"],
                                   _f64(A["seq_cot_full"])[:, chunk], **TOL)
        np.testing.assert_allclose(g["reduce_scatter"]["y"],
                                   3 * seq[:, chunk], **TOL)
        np.testing.assert_allclose(g["reduce_scatter"]["grad"], cot2,
                                   **TOL)
        s = g["sp_linears"]
        np.testing.assert_allclose(s["y"], y[:, chunk], **TOL)
        np.testing.assert_allclose(
            s["x_grad"], (dh @ _f64(A["sp_col_w"]).T)[:, chunk], **TOL)
        np.testing.assert_allclose(
            s["col_w_grad"], np.einsum("bsi,bso->io", seq, dh)[:, half],
            **TOL)
        np.testing.assert_allclose(s["col_b_grad"], dh.sum((0, 1))[half],
                                   **TOL)
        np.testing.assert_allclose(
            s["row_w_grad"], np.einsum("bsi,bso->io", h, cot2)[half], **TOL)
        np.testing.assert_allclose(s["row_b_grad"], cot2.sum((0, 1)),
                                   **TOL)


def test_two_ranks_hybrid_gpt_logits_and_gradients(two_ranks):
    """mp 2 over gloo: the ranks' logits are whole and equal the
    reference's; their gradients, gathered by the QKV head rule, equal
    the reference's on the whole weights."""
    from paddle_tpu_torch.convert import mp_gather_state
    ref, res = two_ranks
    for r in range(2):
        np.testing.assert_allclose(res[r]["gpt"]["logits"], ref["logits"],
                                   **TOL)
        np.testing.assert_allclose(res[r]["gpt"]["loss"], ref["loss"],
                                   **TOL)
    grads = mp_gather_state([res[r]["gpt"]["grads"] for r in range(2)])
    assert sorted(grads) == sorted(ref["grads"])
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(grads[k], want, err_msg=k, **TOL)
    # a replicated parameter's gradient is the same on both ranks
    np.testing.assert_allclose(
        res[1]["gpt"]["grads"]["final_norm.norm.weight"],
        res[0]["gpt"]["grads"]["final_norm.norm.weight"], **TOL)


def test_two_ranks_tensor_parallel_broadcasts(two_ranks):
    """fleet.distributed_model wraps in TensorParallel, which makes the
    ranks' replicated parameters agree (rank 0's, broadcast)."""
    _, res = two_ranks
    assert res[0]["mp_rank"] == 0 and res[1]["mp_rank"] == 1
    for r in range(2):
        assert res[r]["wrapper"]["kind"] == "TensorParallel"
        np.testing.assert_array_equal(res[r]["wrapper"]["after"],
                                      res[0]["wrapper"]["before"])
    assert not np.array_equal(res[1]["wrapper"]["before"],
                              res[0]["wrapper"]["before"])


@pytest.mark.parametrize("key", ["pp_degree", "sharding_degree",
                                 "sep_degree"])
def test_process_groups_raise_on_unported_degrees(two_ranks, key):
    _, res = two_ranks
    for r in range(2):
        msg = res[r][f"raises_{key}"]
        assert key in msg and "ROADMAP item 26b2" in msg, msg


def test_process_groups_raise_on_dp_with_mp(two_ranks):
    """dp > 1 beside mp > 1 would leave the dp replicas' gradients
    unaveraged: it raises instead."""
    _, res = two_ranks
    for r in range(2):
        msg = res[r]["raises_dp_mp"]
        assert "dp_degree" in msg and "mp_degree" in msg, msg
        assert "ROADMAP item 26b2" in msg, msg


def test_process_groups_raise_on_moe_at_mp2(two_ranks):
    _, res = two_ranks
    for r in range(2):
        msg = res[r]["raises_moe"]
        assert "MoELayer" in msg and "ROADMAP item 26b2" in msg, msg
