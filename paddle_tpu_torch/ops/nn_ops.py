"""Neural-net ops (counterpart of paddle_tpu/ops/nn_ops.py): the ones
the port's ``nn/functional.py`` and ``nn/cnn_ops.py`` compute, which are
registered ops there (they take Tensors, and torch tensors as the
models call them). The reference's other nn ops are still to port
(ROADMAP item 25)."""
from __future__ import annotations

from ..nn.functional import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool2d, avg_pool1d, avg_pool2d, avg_pool3d, batch_norm,
    conv1d, conv2d, conv2d_transpose, conv3d, cross_entropy, dropout,
    embedding, gelu, layer_norm, linear, max_pool1d, max_pool2d, max_pool3d,
    relu, rms_norm, scaled_dot_product_attention, silu)

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool2d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "batch_norm", "conv1d", "conv2d",
           "conv2d_transpose", "conv3d", "cross_entropy", "dropout",
           "embedding", "gelu", "layer_norm", "linear", "max_pool1d",
           "max_pool2d", "max_pool3d", "relu", "rms_norm",
           "scaled_dot_product_attention", "silu"]
