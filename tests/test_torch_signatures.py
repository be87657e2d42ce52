"""Signatures against the reference's: every layer class
``paddle_tpu_torch.nn`` exports that the reference's ``nn`` has, and
the functional ops ``flash_attention``, ``layer_norm`` and
``embedding``, take the reference's parameters: the same names, in the
same order, of the same kinds, with the same defaults. The port may add
keyword-only parameters after them, and only its own: ``device``,
``dtype``, ``generator`` and ``init_generator`` (the generator a
layer's initial weights are drawn from)."""
import inspect

import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt

PORT_EXTRAS = {"device", "dtype", "generator", "init_generator"}


def _layer_names():
    return sorted(n for n in ptt.nn.__all__
                  if inspect.isclass(getattr(ptt.nn, n))
                  and hasattr(pt.nn, n))


def _split(sig):
    """(the parameters a caller may pass positionally or by name, in
    order, as (name, kind, default); the keyword-only names)."""
    head, kw_only = [], []
    for p in sig.parameters.values():
        if p.kind == p.KEYWORD_ONLY:
            kw_only.append(p)
        else:
            head.append((p.name, p.kind, p.default))
    return head, kw_only


def _check(port_fn, ref_fn):
    port_head, port_kw = _split(inspect.signature(port_fn))
    ref_head, ref_kw = _split(inspect.signature(ref_fn))
    assert port_head == ref_head
    ref_kw_names = [p.name for p in ref_kw]
    assert [p.name for p in port_kw][:len(ref_kw)] == ref_kw_names
    extras = {p.name for p in port_kw} - set(ref_kw_names)
    assert extras <= PORT_EXTRAS, extras


def test_every_exported_layer_is_checked():
    names = _layer_names()
    assert {"Linear", "Embedding", "Dropout", "LayerNorm", "RMSNorm",
            "LayerList", "LayerDict", "ParameterList", "Conv2D",
            "BatchNorm2D", "MultiHeadAttention", "Layer"} <= set(names)
    # a Layer class the port exports without the reference having it
    # would escape the check: there is none
    assert not [n for n in ptt.nn.__all__
                if inspect.isclass(getattr(ptt.nn, n))
                and not hasattr(pt.nn, n)]


@pytest.mark.parametrize("name", _layer_names())
def test_layer_constructor_matches_the_reference(name):
    _check(getattr(ptt.nn, name).__init__, getattr(pt.nn, name).__init__)


@pytest.mark.parametrize("name", ["flash_attention", "layer_norm",
                                  "embedding"])
def test_functional_matches_the_reference(name):
    _check(getattr(ptt.nn.functional, name),
           getattr(pt.nn.functional, name))


@pytest.mark.parametrize("name", ["create_parameter", "state_dict",
                                  "set_state_dict", "named_parameters",
                                  "parameters", "named_buffers", "buffers",
                                  "register_buffer", "add_parameter",
                                  "add_sublayer", "sublayers",
                                  "named_sublayers", "to", "astype",
                                  "register_forward_pre_hook",
                                  "register_forward_post_hook",
                                  "full_name", "create_tensor"])
def test_layer_method_matches_the_reference(name):
    """The Layer methods keep the reference's parameters; the port adds
    torch's own keyword-only ones where a torch caller passes them
    (``state_dict(prefix=, keep_vars=)``, ``named_parameters(recurse=,
    remove_duplicate=)``) and the device and generator of
    ``create_parameter``."""
    port = inspect.signature(getattr(ptt.nn.Layer, name))
    ref = inspect.signature(getattr(pt.nn.Layer, name))
    port_head, port_kw = _split(port)
    assert port_head == _split(ref)[0]
    assert {p.name for p in port_kw} <= PORT_EXTRAS | {
        "prefix", "keep_vars", "recurse", "remove_duplicate"}


def test_parameter_param_attr_and_io_match_the_reference():
    for port, ref in ((ptt.nn.Parameter.__init__, pt.nn.Parameter.__init__),
                      (ptt.nn.ParamAttr.__init__, pt.nn.ParamAttr.__init__),
                      (ptt.save, pt.save)):
        assert inspect.signature(port) == inspect.signature(ref)
    port_head, _ = _split(inspect.signature(ptt.load))
    assert port_head[0][0] == "path"


IO_NAMES = ["DataLoader", "Dataset", "TensorDataset", "ComposeDataset",
            "ChainDataset", "Subset", "random_split", "Sampler",
            "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
            "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
            "get_worker_info"]
TRANSFORM_NAMES = ["Compose", "ToTensor", "Normalize", "Resize",
                   "CenterCrop", "RandomCrop", "RandomHorizontalFlip",
                   "RandomVerticalFlip", "RandomResizedCrop", "Transpose",
                   "to_tensor", "normalize", "resize", "hflip", "vflip",
                   "center_crop"]
DATASET_NAMES = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
                 "DatasetFolder"]


def _callable_sig(obj):
    return inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)


@pytest.mark.parametrize("module,name", [
    *(("io", n) for n in IO_NAMES),
    *(("vision.transforms", n) for n in TRANSFORM_NAMES),
    *(("vision.datasets", n) for n in DATASET_NAMES)])
def test_io_and_vision_match_the_reference(module, name):
    """The loader, its datasets and samplers, the transforms and the
    vision datasets take the reference's parameters exactly."""
    import importlib
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    ref = importlib.import_module(f"paddle_tpu.{module}")
    assert _callable_sig(getattr(port, name)) == \
        _callable_sig(getattr(ref, name))
