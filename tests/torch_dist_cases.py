"""The two-rank gloo case of tests/test_torch_distributed.py: the
function each spawned process runs (this module imports no JAX: a spawned
child imports it to unpickle the function)."""
import os


def two_rank_worker(rank, port, out):
    """One rank of a two-process job over gloo on the CPU, started as the
    launcher would start it (PADDLE_TRAINERS_NUM, PADDLE_MASTER,
    PADDLE_TRAINER_ID): every collective on per-rank tensors, a
    DataParallel gradient average and the hybrid topology's groups. Puts
    (rank, {name: numpy result}) on `out`."""
    os.environ.update(PADDLE_TRAINERS_NUM="2", PADDLE_TRAINER_ID=str(rank),
                      PADDLE_MASTER=f"127.0.0.1:{port}",
                      CUDA_VISIBLE_DEVICES="")
    import numpy as np
    import torch

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    ptt.set_device("cpu")
    torch.set_num_threads(1)
    res = {}
    try:
        g = dist.init_parallel_env()
        res["world"] = np.array([dist.get_world_size(), dist.get_rank(),
                                 g.nranks, g.rank()])
        x = torch.arange(6, dtype=torch.float32) + 10 * rank
        for name, op in (("sum", dist.ReduceOp.SUM),
                         ("max", dist.ReduceOp.MAX),
                         ("min", dist.ReduceOp.MIN),
                         ("prod", dist.ReduceOp.PROD),
                         ("avg", dist.ReduceOp.AVG)):
            t = x.clone()
            dist.all_reduce(t, op=op)
            res[f"all_reduce_{name}"] = t.numpy()
        t = ptt.to_tensor(x.numpy())
        dist.all_reduce(t)
        res["all_reduce_tensor"] = t.numpy()
        w = x.clone()
        dist.all_reduce(w, sync_op=False).wait()
        res["all_reduce_async"] = w.numpy()
        t = x.clone()
        dist.reduce(t, dst=1)
        res["reduce"] = t.numpy()
        t = x.clone()
        dist.broadcast(t, src=1)
        res["broadcast"] = t.numpy()
        parts = []
        dist.all_gather(parts, x)
        res["all_gather_list"] = torch.stack(parts).numpy()
        res["all_gather"] = dist.all_gather(x).numpy()
        res["reduce_scatter"] = dist.reduce_scatter(x).numpy()
        res["all_to_all"] = dist.all_to_all(x).numpy()
        outs = []
        dist.all_to_all(outs, [x[:3], x[3:]])
        res["all_to_all_list"] = torch.stack(outs).numpy()
        t = torch.zeros(3)
        dist.scatter(t, [x[:3] + 100, x[3:] + 200] if rank == 0 else None,
                     src=0)
        res["scatter"] = t.numpy()
        if rank == 0:
            dist.send(x, dst=1)
        else:
            t = torch.zeros(6)
            dist.recv(t, src=0)
            res["recv"] = t.numpy()
        dist.barrier()
        # DataParallel: each rank's gradients averaged over the group
        lin = ptt.nn.Linear(3, 2)
        lin.weight.set_value(np.ones((3, 2), np.float32))
        dp = dist.DataParallel(lin)
        inp = ptt.to_tensor(np.full((4, 3), rank + 1.0, np.float32))
        (dp(inp) ** 2).mean().backward()
        res["grad_before"] = lin.weight.grad.numpy().copy()
        dp.apply_collective_grads()
        res["grad_after"] = lin.weight.grad.numpy()
        hcg = dist.HybridCommunicateGroup(dp=2)
        res["hcg"] = np.array([hcg.get_data_parallel_rank(),
                               hcg.get_data_parallel_group().nranks,
                               hcg.get_model_parallel_group().nranks])
        t = x.clone()
        dist.all_reduce(t, group=hcg.get_data_parallel_group())
        res["hcg_dp_all_reduce"] = t.numpy()
        dist.destroy_process_group()
        res["destroyed"] = np.array([int(dist.is_initialized())])
        out.put((rank, res))
    except BaseException as e:      # the parent reports it
        out.put((rank, repr(e)))
        raise
