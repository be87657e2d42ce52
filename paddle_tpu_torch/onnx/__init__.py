"""paddle.onnx surface (counterpart of paddle_tpu/onnx/__init__.py, whose
reference, python/paddle/onnx/export.py, delegates to the external
paddle2onnx converter).

As in the reference, `export` raises with guidance instead of being
absent: the port's portable artifact is `paddle_tpu_torch.jit.save`, a
``torch.export`` program (reloadable without the Python class by
`jit.load`, servable by `inference.Predictor`)."""
from __future__ import annotations

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=9, **configs):
    """ref API: paddle.onnx.export(layer, path, input_spec, ...)."""
    raise NotImplementedError(
        "paddle_tpu_torch does not emit ONNX. Use "
        "paddle_tpu_torch.jit.save(layer, path, input_spec) to export a "
        "torch.export program (reloadable without the Python class by "
        "jit.load, servable by paddle_tpu_torch.inference.Predictor); "
        "torch.onnx can convert the exported program if a runtime "
        "requires ONNX specifically.")
