"""The two-rank gloo case of tests/test_torch_hybrid_gpt.py: the function
each spawned process runs (this module imports no JAX: a spawned child
imports it to unpickle the function).

Each rank starts as the launcher would start it (PADDLE_TRAINERS_NUM,
PADDLE_MASTER, PADDLE_TRAINER_ID), checks that the options process-group
mode does not port raise, calls ``fleet.init`` with mp_degree 2, and
runs every tensor-parallel and sequence-parallel layer and the hybrid
GPT on ITS shard of whole weights the parent made: the results (outputs,
this rank's gradients) go back to the parent, which holds them to the
dense function."""
import os


def _seeded(shape, seed):
    import numpy as np
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# the layer cases' whole weights and inputs (each rank and the parent
# draw the same from these seeds)
def layer_arrays():
    import numpy as np
    return dict(
        col_w=_seeded((16, 32), 1), col_b=_seeded((32,), 2),
        row_w=_seeded((32, 16), 3), row_b=_seeded((16,), 4),
        x16=_seeded((4, 16), 5), x32=_seeded((4, 32), 6),
        cot32=_seeded((4, 32), 7), cot16=_seeded((4, 16), 8),
        emb_w=_seeded((64, 16), 9),
        ids=np.array([[1, 40, 63], [0, 31, 32]], np.int32),
        cot_emb=_seeded((2, 3, 16), 10),
        logits=_seeded((4, 64), 11),
        labels=np.array([3, 40, -100, 63], np.int32),
        cot_ce=_seeded((4,), 12),
        seq=_seeded((2, 8, 16), 13), seq_cot=_seeded((2, 4, 16), 14),
        seq_cot_full=_seeded((2, 8, 16), 15),
        sp_col_w=_seeded((16, 32), 16), sp_col_b=_seeded((32,), 17),
        sp_row_w=_seeded((32, 16), 18), sp_row_b=_seeded((16,), 19))


def _layer_cases(ptt, dist, rank, res):
    mp = dist.meta_parallel
    A = layer_arrays()
    half = slice(16 * rank, 16 * rank + 16)

    def leaf(a):
        return ptt.to_tensor(a, stop_gradient=False)

    # ColumnParallelLinear, gathered and not
    for gather in (True, False):
        col = mp.ColumnParallelLinear(16, 32, gather_output=gather)
        col.weight.set_value(A["col_w"][:, half])
        col.bias.set_value(A["col_b"][half])
        x = leaf(A["x16"])
        y = col(x)
        cot = A["cot32"] if gather else A["cot32"][:, half]
        (y * ptt.to_tensor(cot)).sum().backward()
        tag = "col_gather" if gather else "col_local"
        res[tag] = dict(y=y.numpy(), x_grad=x.grad.numpy(),
                        w_grad=col.weight.grad.numpy(),
                        b_grad=col.bias.grad.numpy(),
                        shape=list(col.weight.shape))
    # RowParallelLinear, the input whole and split
    for parallel_in in (False, True):
        row = mp.RowParallelLinear(32, 16, input_is_parallel=parallel_in)
        row.weight.set_value(A["row_w"][half])
        row.bias.set_value(A["row_b"])
        x = leaf(A["x32"][:, half] if parallel_in else A["x32"])
        y = row(x)
        (y * ptt.to_tensor(A["cot16"])).sum().backward()
        res["row_split" if parallel_in else "row_whole"] = dict(
            y=y.numpy(), x_grad=x.grad.numpy(),
            w_grad=row.weight.grad.numpy(), b_grad=row.bias.grad.numpy())
    # VocabParallelEmbedding (c_embedding)
    emb = mp.VocabParallelEmbedding(64, 16)
    emb.weight.set_value(A["emb_w"][32 * rank:32 * rank + 32])
    out = emb(ptt.to_tensor(A["ids"]))
    (out * ptt.to_tensor(A["cot_emb"])).sum().backward()
    res["vocab"] = dict(y=out.numpy(), w_grad=emb.weight.grad.numpy())
    # ParallelCrossEntropy over this rank's vocab columns
    logits = leaf(A["logits"][:, 32 * rank:32 * rank + 32])
    loss = mp.ParallelCrossEntropy()(logits, ptt.to_tensor(A["labels"]))
    (loss * ptt.to_tensor(A["cot_ce"])).sum().backward()
    res["cross_entropy"] = dict(loss=loss.numpy(),
                                grad=logits.grad.numpy())
    # the sequence-parallel boundary ops
    from paddle_tpu_torch.distributed.meta_parallel import \
        sequence_parallel as sp
    x = leaf(A["seq"])
    part = sp.scatter(x)
    (part * ptt.to_tensor(A["seq_cot"])).sum().backward()
    res["scatter"] = dict(y=part.numpy(), grad=x.grad.numpy())
    chunk = leaf(A["seq"][:, 4 * rank:4 * rank + 4])
    whole = sp.all_gather(chunk)
    (whole * ptt.to_tensor(A["seq_cot_full"])).sum().backward()
    res["all_gather"] = dict(y=whole.numpy(), grad=chunk.grad.numpy())
    partial = leaf(A["seq"] * (rank + 1))
    red = sp.reduce_scatter(partial)
    (red * ptt.to_tensor(A["seq_cot"])).sum().backward()
    res["reduce_scatter"] = dict(y=red.numpy(), grad=partial.grad.numpy())
    # the sequence-parallel linears: [b, s/2, 16] -> all-gather -> the
    # column product (this rank's columns) -> the row product ->
    # reduce-scatter onto [b, s/2, 16]
    scol = mp.ColumnSequenceParallelLinear(16, 32)
    scol.weight.set_value(A["sp_col_w"][:, half])
    scol.bias.set_value(A["sp_col_b"][half])
    srow = mp.RowSequenceParallelLinear(32, 16)
    srow.weight.set_value(A["sp_row_w"][half])
    srow.bias.set_value(A["sp_row_b"])
    xs = leaf(A["seq"][:, 4 * rank:4 * rank + 4])
    ys = srow(scol(xs).tanh())
    (ys * ptt.to_tensor(A["seq_cot"])).sum().backward()
    res["sp_linears"] = dict(
        y=ys.numpy(), x_grad=xs.grad.numpy(),
        col_w_grad=scol.weight.grad.numpy(),
        col_b_grad=scol.bias.grad.numpy(),
        row_w_grad=srow.weight.grad.numpy(),
        row_b_grad=srow.bias.grad.numpy())


def _gpt_case(ptt, dist, rank, gpt_full, gpt_batch, res):
    """GPTForCausalLMHybrid (gpt_tiny, dropout 0) on this rank's shard of
    the parent's whole weights: the logits (gathered) and this rank's
    gradients of the mean cross-entropy."""
    from paddle_tpu_torch.convert import mp_shard_state
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.models.gpt_hybrid import GPTForCausalLMHybrid
    cfg = gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    ptt.seed(100 + rank)    # the ranks' own draws, made to agree below
    model = GPTForCausalLMHybrid(cfg)
    before = model.embeddings.position_embeddings.weight.numpy().copy()
    wrapped = dist.fleet.distributed_model(model)
    after = model.embeddings.position_embeddings.weight.numpy()
    res["wrapper"] = dict(kind=type(wrapped).__name__, before=before,
                          after=after)
    model.set_state_dict({k: ptt.to_tensor(v.numpy()) for k, v in
                          mp_shard_state(gpt_full, rank, 2,
                                         cfg.num_heads).items()})
    model.eval()
    ids, labels = gpt_batch
    logits = wrapped(ptt.to_tensor(ids))
    loss = ptt.nn.functional.cross_entropy(
        logits, ptt.to_tensor(labels), reduction="none").mean()
    loss.backward()
    res["gpt"] = dict(logits=logits.numpy(), loss=loss.numpy(),
                      grads={n: p.grad.numpy()
                             for n, p in model.named_parameters()})


def two_rank_worker(rank, port, gpt_full, gpt_batch, out):
    """One rank of a two-process job over gloo on the CPU (module
    docstring). Puts (rank, {case: results}) on `out`, or (rank, the
    error's text)."""
    os.environ.update(PADDLE_TRAINERS_NUM="2", PADDLE_TRAINER_ID=str(rank),
                      PADDLE_MASTER=f"127.0.0.1:{port}",
                      CUDA_VISIBLE_DEVICES="")
    import traceback

    import torch

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    ptt.set_device("cpu")
    torch.set_num_threads(1)
    res = {}
    try:
        dist.init_parallel_env()
        # the options process-group mode does not port
        for key in ("pp_degree", "sharding_degree", "sep_degree"):
            s = dist.fleet.DistributedStrategy()
            s.hybrid_configs = {"dp_degree": 1, key: 2}
            try:
                dist.fleet.init(strategy=s)
                res[f"raises_{key}"] = ""
            except NotImplementedError as e:
                res[f"raises_{key}"] = str(e)
        s = dist.fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
        try:
            dist.fleet.init(strategy=s)
            res["raises_dp_mp"] = ""
        except NotImplementedError as e:
            res["raises_dp_mp"] = str(e)
        s = dist.fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
        dist.fleet.init(strategy=s)
        hcg = dist.fleet.get_hybrid_communicate_group()
        res["mp_rank"] = hcg.get_model_parallel_rank()
        try:
            dist.meta_parallel.MoELayer(16, 32, num_experts=4)
            res["raises_moe"] = ""
        except NotImplementedError as e:
            res["raises_moe"] = str(e)
        _layer_cases(ptt, dist, rank, res)
        _gpt_case(ptt, dist, rank, gpt_full, gpt_batch, res)
        dist.destroy_process_group()
        out.put((rank, res))
    except Exception:
        out.put((rank, traceback.format_exc()))
