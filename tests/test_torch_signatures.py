"""Signatures against the reference's: every layer class
``paddle_tpu_torch.nn`` exports that the reference's ``nn`` has, and
the functional ops (``flash_attention``, ``layer_norm``, ``embedding``,
nn.functional's own functions and every op of ops/nn_ops.py), nn.utils,
nn.quant, LBFGS, jit, the inference Predictor, hapi's Model and
summary, the callbacks, the metrics and utils take the reference's
parameters: the same names, in the
same order, of the same kinds, with the same defaults. The port may add
keyword-only parameters after them, and only its own: ``device``,
``dtype``, ``generator`` and ``init_generator`` (the generator a
layer's initial weights are drawn from). A random op's ``generator``
takes the place of the reference's ``key``."""
import inspect

import pytest
import torch

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


# nn.functional's own functions, and the ops of ops/nn_ops.py
OWN_FUNCTIONALS = ["cosine_similarity", "normalize", "grid_sample",
                   "sequence_mask", "softmax_", "flash_attn_unpadded",
                   "rnnt_loss"]


def _nn_op_names():
    from paddle_tpu.ops import nn_ops
    return sorted(n for n in ptt.ops.nn_ops.__all__
                  if callable(getattr(nn_ops, n, None)))


@pytest.mark.parametrize("name", OWN_FUNCTIONALS)
def test_own_functional_matches_the_reference(name):
    _check_sigs(inspect.signature(getattr(ptt.nn.functional, name)),
                inspect.signature(getattr(pt.nn.functional, name)))


@pytest.mark.parametrize("name", _nn_op_names())
def test_nn_op_matches_the_reference(name):
    """A random op (``OpDef.random``) takes the port's ``generator``
    where the reference takes ``key`` (rrelu, the dropouts), or after
    the reference's parameters when the reference draws from its global
    key (scaled_dot_product_attention)."""
    from paddle_tpu.ops import nn_ops
    port = inspect.signature(getattr(ptt.ops.nn_ops, name))
    ref = inspect.signature(getattr(nn_ops, name))
    if ptt.ops.OPS.get(name) is not None and ptt.ops.OPS[name].random:
        params = [p.replace(name="generator")
                  if p.name == "key" and p.default is None else p
                  for p in ref.parameters.values()]
        if "generator" not in [p.name for p in params]:
            last = list(port.parameters.values())[-1]
            assert last.name == "generator" and last.default is None
            port = port.replace(
                parameters=list(port.parameters.values())[:-1])
        ref = ref.replace(parameters=params)
    _check_sigs(port, ref)


def _check_sigs(port, ref):
    port_head, port_kw = _split(port)
    ref_head, ref_kw = _split(ref)
    assert port_head == ref_head
    assert [p.name for p in port_kw][:len(ref_kw)] == [p.name
                                                       for p in ref_kw]
    assert {p.name for p in port_kw} - {p.name for p in ref_kw} \
        <= PORT_EXTRAS


@pytest.mark.parametrize("module,name", [
    ("nn.utils", n) for n in ("spectral_norm", "weight_norm",
                              "remove_weight_norm", "clip_grad_norm_",
                              "clip_grad_value_", "parameters_to_vector",
                              "vector_to_parameters")] + [
    ("nn.quant", n) for n in ("weight_quantize", "weight_dequantize",
                              "weight_only_linear", "llm_int8_linear")] + [
    ("optimizer", "LBFGS"), ("ops", "rnnt_loss_op"), ("ops", "fold"),
    ("ops", "unpool")])
def test_utils_quant_lbfgs_match_the_reference(module, name):
    import importlib
    port = getattr(importlib.import_module(f"paddle_tpu_torch.{module}"),
                   name)
    ref = getattr(importlib.import_module(f"paddle_tpu.{module}"), name)
    _check_sigs(_callable_sig(port), _callable_sig(ref))


def test_rnn_scans_match_the_reference():
    from paddle_tpu.nn.layers import rnn as jrnn
    from paddle_tpu_torch.nn.layers import rnn as trnn
    for name in ("_lstm_scan", "_gru_scan", "_rnn_scan"):
        _check_sigs(inspect.signature(getattr(trnn, name)),
                    inspect.signature(getattr(jrnn, name)))


# jit, the inference Predictor, hapi, the callbacks, metric and utils
# (ROADMAP item 25's jit / inference / hapi part): exactly the
# reference's parameters
FACADE_NAMES = [
    *(("jit", n) for n in ("to_static", "save", "load", "InputSpec",
                           "not_to_static", "ignore_module",
                           "StaticFunction", "GraphBreakFunction")),
    *(("jit.dy2static", n) for n in ("convert_ifelse", "convert_while",
                                     "ast_transform", "pack",
                                     "graph_break_transform")),
    *(("inference", n) for n in ("Config", "create_predictor",
                                 "Predictor")),
    *(("hapi.model_api", n) for n in ("Model", "summary", "Callback",
                                      "ProgBarLogger", "ModelCheckpoint",
                                      "EarlyStopping",
                                      "LRSchedulerCallback")),
    *(("hapi.summary_writer", n) for n in ("SummaryWriter", "VisualDL")),
    *(("metric", n) for n in ("Accuracy", "Precision", "Recall", "Auc",
                              "accuracy")),
    *(("utils", n) for n in ("try_import", "unique_name_guard",
                             "to_dlpack", "from_dlpack", "run_check",
                             "flops", "deprecated"))]
MODEL_METHODS = ["prepare", "train_batch", "eval_batch", "predict_batch",
                 "fit", "evaluate", "predict", "save", "load", "parameters",
                 "summary"]
CONFIG_METHODS = ["set_prog_file", "prog_file", "enable_use_gpu",
                  "disable_gpu", "enable_memory_optim", "switch_ir_optim",
                  "set_cpu_math_library_num_threads"]
PREDICTOR_METHODS = ["get_input_names", "get_input_handle", "run",
                     "get_output_names", "get_output_handle"]


def _params(sig):
    """(name, kind, default) of each parameter: the annotations may name
    the port's own types (a layer is any torch.nn.Module)."""
    return [(p.name, p.kind, p.default) for p in sig.parameters.values()]


@pytest.mark.parametrize("module,name", FACADE_NAMES)
def test_facade_matches_the_reference(module, name):
    import importlib
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    ref = importlib.import_module(f"paddle_tpu.{module}")
    assert _params(_callable_sig(getattr(port, name))) == \
        _params(_callable_sig(getattr(ref, name)))


@pytest.mark.parametrize("cls,name", [
    *(("Model", n) for n in MODEL_METHODS),
    *(("Config", n) for n in CONFIG_METHODS),
    *(("Predictor", n) for n in PREDICTOR_METHODS)])
def test_facade_method_matches_the_reference(cls, name):
    port = {"Model": ptt.Model, "Config": ptt.inference.Config,
            "Predictor": ptt.inference.Predictor}[cls]
    ref = {"Model": pt.Model, "Config": pt.inference.Config,
           "Predictor": pt.inference.Predictor}[cls]
    assert _params(inspect.signature(getattr(port, name))) == \
        _params(inspect.signature(getattr(ref, name)))


# ROADMAP item 25's ops and vision part: the long-tail, sequence and
# detection ops, vision.ops, TensorArray and the vision zoo
def _own_functions(module_name):
    import importlib
    ref = importlib.import_module(f"paddle_tpu.{module_name}")
    return sorted(n for n, v in vars(ref).items() if not n.startswith("_")
                  and callable(v) and getattr(v, "__module__", None)
                  == ref.__name__)


LONGTAIL_NAMES = [(m, n) for m in ("ops.longtail", "ops.sequence_ops",
                                   "ops.vision_ops")
                  for n in _own_functions(m)] + [
    ("vision.ops", n) for n in ("nms", "roi_align", "box_coder",
                                "deform_conv2d", "read_file", "decode_jpeg",
                                "yolo_loss")] + [
    ("tensor_array", n) for n in ("create_array", "array_write",
                                  "array_read", "array_length")]


@pytest.mark.parametrize("module,name", LONGTAIL_NAMES)
def test_longtail_function_matches_the_reference(module, name):
    """The reference's parameters; a random op takes the port's
    ``generator`` where the reference takes ``key`` (top_p_sampling), or
    after the reference's parameters where it draws from its global key
    (class_center_sample)."""
    import importlib
    port = inspect.signature(getattr(importlib.import_module(
        f"paddle_tpu_torch.{module}"), name))
    ref = inspect.signature(getattr(importlib.import_module(
        f"paddle_tpu.{module}"), name))
    op = getattr(getattr(importlib.import_module(
        f"paddle_tpu_torch.{module}"), name), "op_def", None)
    if op is not None and op.random:
        params = [p.replace(name="generator")
                  if p.name == "key" and p.default is None else p
                  for p in ref.parameters.values()]
        if "generator" not in [p.name for p in params]:
            last = list(port.parameters.values())[-1]
            assert last.name == "generator" and last.default is None
            port = port.replace(
                parameters=list(port.parameters.values())[:-1])
        ref = ref.replace(parameters=params)
    _check_sigs(port, ref)


ZOO_NAMES = sorted(n for n in pt.vision.models.__dict__
                   if not n.startswith("_") and callable(
                       getattr(pt.vision.models, n))
                   and not n.startswith("resnet") and n not in (
                       "ResNet", "BasicBlock", "BottleneckBlock",
                       "wide_resnet50_2", "resnext50_32x4d"))


def test_every_zoo_name_is_checked():
    assert len(ZOO_NAMES) == 33 - 2   # less the modules extra and
    # lenet_vgg_mobilenet, which are not callable


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_zoo_constructor_matches_the_reference(name):
    """The reference's parameters, then the port's keyword-only device,
    dtype and seed (the ResNets' own)."""
    port = _callable_sig(getattr(ptt.vision.models, name))
    ref = _callable_sig(getattr(pt.vision.models, name))
    port_head, port_kw = _split(port)
    ref_head, ref_kw = _split(ref)
    assert port_head == ref_head
    assert not ref_kw
    assert [p.name for p in port_kw] in ([], ["device", "dtype", "seed"])


# incubate whole (but autotune): the fused functionals, the serving
# family, memory_efficient_attention, identity_loss, LookAhead /
# ModelAverage, asp, and the fused layers' constructors
def _incubate_names():
    import importlib
    out = []
    for mod in ("incubate.nn.functional", "incubate.nn.functional.serving",
                "incubate.nn.attn_bias", "incubate.nn.memory_efficient_attention",
                "incubate.nn.loss", "incubate.optimizer", "incubate.asp",
                "incubate.nn.layer"):
        ref = importlib.import_module(f"paddle_tpu.{mod}")
        for n in sorted(vars(ref)):
            v = getattr(ref, n)
            if not n.startswith("_") and callable(v) and getattr(
                    v, "__module__", None) == ref.__name__:
                out.append((mod, n))
    return out


INCUBATE_NAMES = _incubate_names()


def test_every_incubate_name_is_checked():
    names = {n for _, n in INCUBATE_NAMES}
    assert {"fused_multi_transformer", "memory_efficient_attention",
            "FusedMultiTransformer", "FusedTransformerEncoderLayer",
            "LookAhead", "ModelAverage", "prune_model", "identity_loss",
            "BlockDiagonalCausalMask", "fused_gate_attention"} <= names
    assert len(INCUBATE_NAMES) == 46


@pytest.mark.parametrize("module,name", INCUBATE_NAMES,
                         ids=[f"{m}.{n}" for m, n in INCUBATE_NAMES])
def test_incubate_name_matches_the_reference(module, name):
    """The reference's parameters, the port's keyword-only device,
    dtype, init_generator and generator after them (a random op's
    generator in place of the reference's key, or after its parameters
    where it draws from its global key), for functions, classes and each
    method a class defines."""
    import importlib
    port_obj = getattr(importlib.import_module(f"paddle_tpu_torch.{module}"),
                       name)
    ref_obj = getattr(importlib.import_module(f"paddle_tpu.{module}"), name)
    pairs = [(port_obj, ref_obj)]
    if inspect.isclass(ref_obj):
        pairs = [(port_obj.__init__, ref_obj.__init__)] + [
            (getattr(port_obj, m), f) for m, f in vars(ref_obj).items()
            if inspect.isfunction(f) and not m.startswith("_")]
    op = getattr(port_obj, "op_def", None)
    for port_fn, ref_fn in pairs:
        port, ref = inspect.signature(port_fn), inspect.signature(ref_fn)
        if op is not None and op.random:
            params = [p.replace(name="generator")
                      if p.name == "key" and p.default is None else p
                      for p in ref.parameters.values()]
            if "generator" not in [p.name for p in params]:
                last = list(port.parameters.values())[-1]
                assert last.name == "generator" and last.default is None
                port = port.replace(
                    parameters=list(port.parameters.values())[:-1])
            ref = ref.replace(parameters=params)
        # a jnp dtype default (attn_bias' materialize) is torch's own
        ref = ref.replace(parameters=[
            p.replace(default=getattr(torch, p.default.__name__))
            if isinstance(p.default, type) and p.default.__module__
            .startswith("jax") else p for p in ref.parameters.values()])
        _check_sigs(port, ref)


# the op surfaces and audio: fft, signal, sparse (with nn and
# nn.functional), distribution, geometric, quantization and audio's
# functional, features and datasets
OPSURF_MODULES = ("fft", "signal", "sparse", "sparse.nn",
                  "sparse.nn.functional", "distribution", "geometric",
                  "quantization", "audio.functional", "audio.features",
                  "audio.datasets")
# the sparse tensors' constructors take the reference's JAX storage (a
# BCOO / BCSR); the port's take torch tensors (indices, values, shape)
OPSURF_SKIP = {("sparse", "SparseCooTensor", "__init__"),
               ("sparse", "SparseCsrTensor", "__init__")}


def _opsurf_names():
    import importlib
    out = []
    for mod in OPSURF_MODULES:
        ref = importlib.import_module(f"paddle_tpu.{mod}")
        for n in sorted(vars(ref)):
            v = getattr(ref, n)
            if not n.startswith("_") and callable(v) and getattr(
                    v, "__module__", None) == ref.__name__:
                out.append((mod, n))
    return out


OPSURF_NAMES = _opsurf_names()


def test_every_opsurf_name_is_checked():
    names = {n for _, n in OPSURF_NAMES}
    assert {"stft", "istft", "fft", "hfftn", "Normal", "Binomial",
            "StickBreakingTransform", "kl_divergence", "send_u_recv",
            "reindex_graph", "SparseCooTensor", "sparse_coo_tensor",
            "SubmConv3D", "attention", "QAT", "QuantedLayer",
            "FakeQuanterWithAbsMaxObserver", "MFCC", "get_window",
            "ESC50"} <= names
    assert len(OPSURF_NAMES) > 120


@pytest.mark.parametrize("module,name", OPSURF_NAMES,
                         ids=[f"{m}.{n}" for m, n in OPSURF_NAMES])
def test_opsurf_name_matches_the_reference(module, name):
    """The reference's parameters, then the port's keyword-only device
    and init_generator (the creation functions' and layers' place, a
    layer's initial weights' generator), for functions, classes and each
    method a class defines."""
    import importlib
    port_obj = getattr(importlib.import_module(f"paddle_tpu_torch.{module}"),
                       name)
    ref_obj = getattr(importlib.import_module(f"paddle_tpu.{module}"), name)
    pairs = [("", port_obj, ref_obj)]
    if inspect.isclass(ref_obj):
        pairs = [("__init__", port_obj.__init__, ref_obj.__init__)] + [
            (m, getattr(port_obj, m), f) for m, f in vars(ref_obj).items()
            if inspect.isfunction(f) and not m.startswith("_")]
    for meth, port_fn, ref_fn in pairs:
        if (module, name, meth) in OPSURF_SKIP:
            continue
        _check_sigs(inspect.signature(port_fn), inspect.signature(ref_fn))
