"""LayerList (counterpart of paddle_tpu/nn/layers/container.py): a
``ModuleList`` whose children are named 0, 1, ... as paddle_tpu's are."""
from torch import nn


class LayerList(nn.ModuleList):
    pass
