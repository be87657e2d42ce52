"""Container layers (counterpart of paddle_tpu/nn/layers/container.py):
``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict`` as
``Layer``s over torch's module and parameter registries. Children are
named as the reference names them (0, 1, ... for the lists; the given
names otherwise), so a reference state_dict loads name for name."""
from collections import OrderedDict

from torch import nn

from ..layer import Layer, Parameter

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer):
    """Layers called in order. Built from layers (named 0, 1, ...), from
    (name, layer) pairs, or from one OrderedDict of them."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if (isinstance(layer, tuple) and len(layer) == 2
                        and isinstance(layer[0], str)):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        # a slice is a new Sequential named 0, 1, ... (the reference's)
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return self._modules[list(self._modules)[idx]]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self._modules[str(i)] = layer

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx % len(self._modules)
                                 if idx < 0 else idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    """Parameters named 0, 1, ...; an entry that is not a Parameter (a
    Tensor, a torch tensor, an array) becomes one, as ``add_parameter``
    makes it. Indexing and iteration give the Parameters."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), _as_parameter(p))

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)),
                           _as_parameter(parameter))
        return self

    def __getitem__(self, idx):
        return getattr(self, str(idx))

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter([getattr(self, k) for k in self._parameters])


def _as_parameter(p):
    """A torch.nn.Parameter is kept as it is (its storage shared)."""
    return Parameter._of(p) if isinstance(p, nn.Parameter) else p


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for name, layer in items:
            self.add_sublayer(name, layer)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def pop(self, key):
        layer = self._modules[key]
        del self._modules[key]
        return layer
