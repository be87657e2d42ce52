"""ParamAttr (counterpart of paddle_tpu/nn/param_attr.py).

It stores what it is given. ``Layer.create_parameter`` acts on its
``initializer`` and ``name`` only, as the reference's does
(nn/layer.py:147-161); ``learning_rate``, ``regularizer``,
``trainable``, ``do_model_average`` and ``need_clip`` are kept and not
read, as there."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip
