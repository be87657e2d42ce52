"""Container layers (counterpart of paddle_tpu/nn/layers/container.py):
``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict`` on
torch's ``nn.Sequential``, ``nn.ModuleList``, ``nn.ParameterList`` and
``nn.ModuleDict``. Children are named as the reference names them
(0, 1, ... for the lists; the given names otherwise), so a reference
state_dict loads name for name."""
from collections import OrderedDict

from torch import nn

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(nn.Sequential):
    """Layers called in order. Built from layers (named 0, 1, ...), from
    (name, layer) pairs, or from one OrderedDict of them."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if (isinstance(layer, tuple) and len(layer) == 2
                    and isinstance(layer[0], str)):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)

    def __getitem__(self, idx):
        # a slice is a new Sequential named 0, 1, ... (the reference's)
        if isinstance(idx, slice):
            return Sequential(*list(self)[idx])
        return super().__getitem__(idx)


class LayerList(nn.ModuleList):
    pass


class ParameterList(nn.ParameterList):
    pass


class LayerDict(nn.ModuleDict):
    pass
