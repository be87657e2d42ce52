"""The op-parity audit restated for the port (counterpart of
paddle_tpu/ops/parity.py): every forward op of the reference's five PHI
YAML files (``_yaml_ops.py``, the reference's snapshot) maps to one of

- an op of the port's registry (``ops.registry.OPS``),
- an API path of the port (``paddle_tpu_torch....``) that carries the
  capability under another, usually higher-level, name, or
- a documented exclusion with its reason,

or it is unmapped: its reference counterpart lives in a module the port
has not ported yet (sparse, fft and signal, geometric, distribution,
the collectives, incubate's ModelAverage). An alias counts only where
its path resolves in the port, so the unmapped list shrinks as modules
are ported (tests/test_torch_parity.py holds it).
"""
from __future__ import annotations

import importlib

from ._yaml_ops import YAML_OPS

__all__ = ["YAML_OPS", "EXCLUDED", "ALIASES", "resolve_api", "classify",
           "R_XPU", "R_ONEDNN", "R_PIR", "R_SELROWS", "R_STREAM",
           "R_AUTOGRAD", "R_QUANT"]

# Exclusion reason classes
R_XPU = ("backend-specific: XPU-only kernel; this port has one backend, "
         "CUDA on an NVIDIA H100")
R_ONEDNN = ("backend-specific: oneDNN/x86 (or cuDNN-pattern) inference "
            "fusion kernel; the port computes the unfused ops on the card")
R_PIR = ("program-IR infrastructure node; the port's saved programs are "
         "torch.export graphs (jit.save), which have no such node")
R_SELROWS = "SelectedRows storage designed out (dense tensors only)"
R_STREAM = ("CUDA stream/event op; the port orders work with PyTorch "
            "streams and events, not with ops")
R_AUTOGRAD = ("autograd-internal helper op; torch.autograd builds the "
              "gradient graph")
R_QUANT = ("int8 serving-quant variant; weight-only quant lives in "
           "nn.quant, int8 KV-cache pools in inference.paged_cache")

EXCLUDED = {
    # --- XPU-only kernels ---
    "add_act_xpu": R_XPU, "add_layernorm_xpu": R_XPU,
    "addcmul_xpu": R_XPU, "bn_act_xpu": R_XPU, "conv1d_xpu": R_XPU,
    "conv2d_transpose_xpu": R_XPU, "conv2d_xpu": R_XPU,
    "dequantize_xpu": R_XPU, "embedding_with_eltwise_add_xpu": R_XPU,
    "fast_layernorm_xpu": R_XPU, "fast_where_xpu": R_XPU,
    "fc_xpu": R_XPU, "fused_multi_transformer_int8_xpu": R_XPU,
    "fused_multi_transformer_xpu": R_XPU,
    "generate_sequence_xpu": R_XPU, "layer_norm_act_xpu": R_XPU,
    "multi_encoder_xpu": R_XPU, "qkv_attention_xpu": R_XPU,
    "quantize_xpu": R_XPU, "squeeze_excitation_block": R_XPU,
    "yolo_box_xpu": R_XPU,
    # --- oneDNN / x86 inference fusions ---
    "fc": R_ONEDNN, "fusion_gru": R_ONEDNN,
    "fusion_repeated_fc_relu": R_ONEDNN,
    "fusion_seqconv_eltadd_relu": R_ONEDNN,
    "fusion_seqexpand_concat_fc": R_ONEDNN,
    "fusion_squared_mat_sub": R_ONEDNN,
    "fusion_transpose_flatten_concat": R_ONEDNN,
    "self_dp_attention": R_ONEDNN, "skip_layernorm": R_ONEDNN,
    "multihead_matmul": R_ONEDNN,
    "fused_embedding_eltwise_layernorm": R_ONEDNN,
    "fused_fc_elementwise_layernorm": R_ONEDNN,
    # --- cuDNN-pattern conv fusions ---
    "fused_batch_norm_act": R_ONEDNN, "fused_bn_add_activation": R_ONEDNN,
    "fused_conv2d_add_act": R_ONEDNN, "fused_dconv_drelu_dbn": R_ONEDNN,
    "fused_scale_bias_add_relu": R_ONEDNN,
    "fused_scale_bias_relu_conv_bn": R_ONEDNN,
    # --- PIR / program infrastructure ---
    "data": R_PIR, "shadow_output": R_PIR, "share_buffer": R_PIR,
    "coalesce_tensor": R_PIR, "npu_identity": R_PIR,
    "memcpy_d2h": R_STREAM, "memcpy_h2d": R_STREAM,
    "c_sync_calc_stream": R_STREAM, "c_sync_comm_stream": R_STREAM,
    # --- autograd internals ---
    "embedding_grad_dense": R_AUTOGRAD,
    "fused_linear_param_grad_add": R_AUTOGRAD,
    # --- SelectedRows ---
    "merge_selected_rows": R_SELROWS,
}

# yaml op name -> importable API path ("module.attr" or
# "module.Class.method") that carries the capability.
ALIASES = {
    # optimizer kernels -> optimizer classes (the YAML names are the
    # per-kernel spellings of Optimizer.step)
    "adadelta_": "paddle_tpu_torch.optimizer.Adadelta",
    "adagrad_": "paddle_tpu_torch.optimizer.Adagrad",
    "adam_": "paddle_tpu_torch.optimizer.Adam",
    "adamax_": "paddle_tpu_torch.optimizer.Adamax",
    "adamw_": "paddle_tpu_torch.optimizer.AdamW",
    "lamb_": "paddle_tpu_torch.optimizer.Lamb",
    "momentum_": "paddle_tpu_torch.optimizer.Momentum",
    "rmsprop_": "paddle_tpu_torch.optimizer.RMSProp",
    "sgd_": "paddle_tpu_torch.optimizer.SGD",
    "fused_adam_": "paddle_tpu_torch.optimizer.Adam",
    "merged_adam_": "paddle_tpu_torch.optimizer.Adam",
    "merged_momentum_": "paddle_tpu_torch.optimizer.Momentum",
    "average_accumulates_": "paddle_tpu_torch.incubate.ModelAverage",
    # collectives -> distributed
    "all_gather": "paddle_tpu_torch.distributed.all_gather",
    "all_reduce": "paddle_tpu_torch.distributed.all_reduce",
    "all_to_all": "paddle_tpu_torch.distributed.alltoall",
    "broadcast": "paddle_tpu_torch.distributed.broadcast",
    "reduce": "paddle_tpu_torch.distributed.reduce",
    "reduce_scatter": "paddle_tpu_torch.distributed.reduce_scatter",
    "p_recv": "paddle_tpu_torch.distributed.recv",
    "p_recv_array": "paddle_tpu_torch.distributed.recv",
    "dist_concat": "paddle_tpu_torch.distributed.all_gather",
    "c_allgather": "paddle_tpu_torch.distributed.all_gather",
    "c_allreduce_max": "paddle_tpu_torch.distributed.all_reduce",
    "c_allreduce_sum": "paddle_tpu_torch.distributed.all_reduce",
    "c_broadcast": "paddle_tpu_torch.distributed.broadcast",
    "c_concat": "paddle_tpu_torch.distributed.all_gather",
    "c_reduce_sum": "paddle_tpu_torch.distributed.reduce",
    "c_identity":
        "paddle_tpu_torch.distributed.meta_parallel.ColumnParallelLinear",
    "c_embedding":
        "paddle_tpu_torch.distributed.meta_parallel.VocabParallelEmbedding",
    # creation / random
    "arange": "paddle_tpu_torch.arange", "ones": "paddle_tpu_torch.ones",
    "zeros": "paddle_tpu_torch.zeros", "eye": "paddle_tpu_torch.eye",
    "full": "paddle_tpu_torch.full", "full_": "paddle_tpu_torch.full",
    "full_int_array": "paddle_tpu_torch.full",
    "full_with_tensor": "paddle_tpu_torch.full",
    "empty": "paddle_tpu_torch.empty", "empty_like": "paddle_tpu_torch.empty_like",
    "linspace": "paddle_tpu_torch.linspace",
    "logspace": "paddle_tpu_torch.logspace",
    "meshgrid": "paddle_tpu_torch.meshgrid", "randint": "paddle_tpu_torch.randint",
    "randperm": "paddle_tpu_torch.randperm", "uniform": "paddle_tpu_torch.uniform",
    "gaussian": "paddle_tpu_torch.normal",
    "bernoulli": "paddle_tpu_torch.bernoulli",
    "multinomial": "paddle_tpu_torch.multinomial",
    "poisson": "paddle_tpu_torch.poisson",
    "dirichlet": "paddle_tpu_torch.distribution.Dirichlet",
    "binomial": "paddle_tpu_torch.distribution.Binomial",
    "truncated_gaussian_random":
        "paddle_tpu_torch.nn.initializer.TruncatedNormal",
    "exponential_": "paddle_tpu_torch.Tensor.exponential_",
    "gaussian_inplace": "paddle_tpu_torch.Tensor.normal_",
    "uniform_inplace": "paddle_tpu_torch.Tensor.uniform_",
    # assignment / movement
    "assign_out_": "paddle_tpu_torch.assign",
    "assign_value_": "paddle_tpu_torch.ops.assign_value",
    "copy_to": "paddle_tpu_torch.Tensor.to",
    "set_value": "paddle_tpu_torch.Tensor.__setitem__",
    "set_value_with_tensor": "paddle_tpu_torch.Tensor.__setitem__",
    "view_dtype": "paddle_tpu_torch.ops.view_dtype",
    "view_shape": "paddle_tpu_torch.Tensor.view",
    "tensor_unfold": "paddle_tpu_torch.Tensor.unfold",
    "shape": "paddle_tpu_torch.ops.shape_op",
    "slice": "paddle_tpu_torch.slice",
    # norm / loss / nn
    "batch_norm_": "paddle_tpu_torch.nn.BatchNorm2D",
    "sync_batch_norm_": "paddle_tpu_torch.nn.SyncBatchNorm",
    "bce_loss": "paddle_tpu_torch.nn.functional.binary_cross_entropy",
    "kldiv_loss": "paddle_tpu_torch.nn.functional.kl_div",
    "cross_entropy_with_softmax":
        "paddle_tpu_torch.nn.functional.cross_entropy",
    "warpctc": "paddle_tpu_torch.ops.ctc_loss",
    "accuracy": "paddle_tpu_torch.metric.accuracy",
    "auc": "paddle_tpu_torch.metric.Auc",
    "swish": "paddle_tpu_torch.nn.functional.swish",
    "tanh_shrink": "paddle_tpu_torch.nn.functional.tanhshrink",
    "rnn": "paddle_tpu_torch.nn.RNN",
    "depthwise_conv2d_transpose":
        "paddle_tpu_torch.nn.functional.conv2d_transpose",
    # interpolation family -> one functional
    "bicubic_interp": "paddle_tpu_torch.nn.functional.interpolate",
    "bilinear_interp": "paddle_tpu_torch.nn.functional.interpolate",
    "linear_interp": "paddle_tpu_torch.nn.functional.interpolate",
    "nearest_interp": "paddle_tpu_torch.nn.functional.interpolate",
    "trilinear_interp": "paddle_tpu_torch.nn.functional.interpolate",
    # pooling
    "pool2d": "paddle_tpu_torch.nn.functional.max_pool2d",
    "pool3d": "paddle_tpu_torch.nn.functional.max_pool3d",
    "maxpool": "paddle_tpu_torch.sparse.nn.MaxPool3D",
    # fft / signal
    "fft_c2c": "paddle_tpu_torch.fft.fft", "fft_c2r": "paddle_tpu_torch.fft.irfft",
    "fft_r2c": "paddle_tpu_torch.fft.rfft",
    "frame": "paddle_tpu_torch.signal.frame",
    "overlap_add": "paddle_tpu_torch.signal.overlap_add",
    # attention / serving family
    "flash_attn": "paddle_tpu_torch.nn.functional.flash_attention",
    "memory_efficient_attention":
        "paddle_tpu_torch.incubate.nn.memory_efficient_attention",
    "variable_length_memory_efficient_attention":
        "paddle_tpu_torch.incubate.nn.functional."
        "variable_length_memory_efficient_attention",
    "masked_multihead_attention_":
        "paddle_tpu_torch.incubate.nn.functional.masked_multihead_attention",
    "block_multihead_attention_":
        "paddle_tpu_torch.incubate.nn.functional.block_multihead_attention",
    "fused_attention":
        "paddle_tpu_torch.incubate.nn.functional.fused_multi_head_attention",
    "fused_bias_residual_layernorm":
        "paddle_tpu_torch.incubate.nn.functional."
        "fused_bias_dropout_residual_layer_norm",
    "quant_linear": "paddle_tpu_torch.nn.quant.weight_only_linear",
    # math aliases
    "einsum": "paddle_tpu_torch.einsum",
    "elementwise_pow": "paddle_tpu_torch.pow",
    "divide_scalar": "paddle_tpu_torch.divide",
    "remainder": "paddle_tpu_torch.mod",
    "frobenius_norm": "paddle_tpu_torch.norm",
    "matrix_rank_tol": "paddle_tpu_torch.matrix_rank",
    "broadcast_tensors": "paddle_tpu_torch.broadcast_tensors",
    "tril_triu": "paddle_tpu_torch.tril",
    "tril_indices": "paddle_tpu_torch.tril_indices",
    "triu_indices": "paddle_tpu_torch.triu_indices",
    "unbind": "paddle_tpu_torch.unbind", "unique": "paddle_tpu_torch.unique",
    "split": "paddle_tpu_torch.split",
    "split_with_num": "paddle_tpu_torch.split",
    "pad": "paddle_tpu_torch.nn.functional.pad",
    "pad3d": "paddle_tpu_torch.nn.functional.pad",
    "repeat_interleave_with_tensor_index":
        "paddle_tpu_torch.repeat_interleave",
    # vision
    "decode_jpeg": "paddle_tpu_torch.vision.ops.decode_jpeg",
    "read_file": "paddle_tpu_torch.vision.ops.read_file",
    "multiclass_nms3": "paddle_tpu_torch.ops.multiclass_nms",
    # graph
    "reindex_graph": "paddle_tpu_torch.geometric.reindex_graph",
    "weighted_sample_neighbors":
        "paddle_tpu_torch.geometric.weighted_sample_neighbors",
    # sparse
    "coalesce": "paddle_tpu_torch.sparse.coalesce",
    "to_dense": "paddle_tpu_torch.sparse.SparseCooTensor.to_dense",
    "to_sparse_coo": "paddle_tpu_torch.Tensor.to_sparse_coo",
    "to_sparse_csr": "paddle_tpu_torch.Tensor.to_sparse_csr",
    "values": "paddle_tpu_torch.sparse.SparseCooTensor.values",
    "sparse_coo_tensor": "paddle_tpu_torch.sparse.sparse_coo_tensor",
    "masked_matmul": "paddle_tpu_torch.sparse.masked_matmul",
    # amp / debugging
    "check_finite_and_unscale_": "paddle_tpu_torch.amp.GradScaler",
    "update_loss_scaling_": "paddle_tpu_torch.amp.GradScaler",
    "disable_check_model_nan_inf": "paddle_tpu_torch.set_flags",
    "enable_check_model_nan_inf": "paddle_tpu_torch.set_flags",
}


def resolve_api(path: str) -> bool:
    """True iff `module.attr(.attr2)` imports and resolves."""
    parts = path.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        mod_name = ".".join(parts[:cut])
        try:
            obj = importlib.import_module(mod_name)
        except ImportError:
            continue
        try:
            for attr in parts[cut:]:
                obj = getattr(obj, attr)
            return True
        except AttributeError:
            return False
    return False


def classify():
    """(table, unmapped): table maps a YAML op to (kind, detail, yaml
    files), kind one of registry, alias and excluded; unmapped lists the
    YAML ops that map to none of them in the port (an alias whose path
    does not resolve yet among them)."""
    for m in ("paddle_tpu_torch", "paddle_tpu_torch.vision",
              "paddle_tpu_torch.incubate.nn.functional"):
        importlib.import_module(m)
    from .registry import OPS
    where = {}
    for fname, names in YAML_OPS.items():
        for o in names:
            where.setdefault(o, []).append(fname)
    table = {}
    unmapped = []
    for name, files in sorted(where.items()):
        if name in OPS:
            table[name] = ("registry", name, files)
        elif name in ALIASES and resolve_api(ALIASES[name]):
            table[name] = ("alias", ALIASES[name], files)
        elif name in EXCLUDED:
            table[name] = ("excluded", EXCLUDED[name], files)
        else:
            unmapped.append(name)
    return table, unmapped
