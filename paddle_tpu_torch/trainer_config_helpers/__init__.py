"""trainer_config_helpers: the legacy config DSL (reference
python/paddle/trainer_config_helpers/ — 137 layer wrappers feeding
config_parser.py's ModelConfig protobuf; SURVEY §1.1).

Here the DSL is a thin second surface over the SAME lazy layer graph the
v2 API uses (paddle_tpu_torch.v2.layer) — both replay into one fluid Program
(SURVEY §7.1: "two API surfaces, one core"). Configs written for
`paddle train --config=cfg.py` run via `python -m paddle_tpu_torch.trainer`,
which execs the config with this module star-imported, then trains the
recorded outputs with the recorded settings.

Image-layer geometry: the legacy stack carries (channels, height, width)
through layer configs (config_parser.py); here each DSL node records
`im_shape`, and the first img_conv on a flat data layer inserts a reshape
node (square images inferred as sqrt(size/channels), matching
config_parser's default).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from ..v2.layer import Layer

__all__ = [
    # config-level
    "get_config_arg", "settings", "define_py_data_sources2", "outputs",
    "Inputs", "Outputs", "TrainData", "TestData", "SimpleData",
    "ParamAttr", "ExtraAttr", "ExtraLayerAttribute",
    # layers
    "data_layer", "fc_layer", "img_conv_layer", "img_pool_layer",
    "img_conv_group",
    "batch_norm_layer", "concat_layer", "addto_layer", "dropout_layer",
    "embedding_layer", "img_cmrnorm_layer", "simple_lstm", "lstmemory",
    "grumemory", "last_seq", "first_seq", "max_id", "maxid_layer",
    "eos_layer", "expand_layer", "pooling_layer", "seq_concat_layer",
    "classification_cost", "cross_entropy", "regression_cost", "mse_cost",
    # mixed layer + projections
    "mixed_layer", "full_matrix_projection", "trans_full_matrix_projection",
    "identity_projection", "table_projection", "context_projection",
    "dotmul_projection", "scaling_projection",
    # recurrent machinery + generation
    "recurrent_group", "memory", "StaticInput", "GeneratedInput",
    "SubsequenceInput", "beam_search",
    # activations
    "ReluActivation", "SoftmaxActivation", "LinearActivation",
    "TanhActivation", "SigmoidActivation", "IdentityActivation",
    "BReluActivation", "SoftReluActivation", "SquareActivation",
    "ExpActivation", "STanhActivation", "AbsActivation", "LogActivation",
    "SequenceSoftmaxActivation", "SqrtActivation", "ReciprocalActivation",
    "SoftSignActivation", "BaseActivation",
    # layer-surface compatibility objects
    "AggregateLevel", "ExpandLevel", "LayerType", "LayerOutput",
    "BaseGeneratedInput", "layer_support", "print_layer",
    "convex_comb_layer",
    # pooling types
    "MaxPooling", "AvgPooling", "SumPooling",
    # optimizers / regularization
    "MomentumOptimizer", "AdamOptimizer", "AdaGradOptimizer",
    "RMSPropOptimizer", "L2Regularization",
]


# ---------------------------------------------------------------------
# parse-time config state (reset by the CLI before exec'ing a config)
# ---------------------------------------------------------------------

_state: Dict[str, Any] = {}


def reset_config(config_args: Optional[Dict[str, str]] = None):
    _state.clear()
    _state.update(
        settings={}, outputs=[], data_sources=None,
        config_args=dict(config_args or {}),
    )
    Layer._registry = _state["layers_by_name"] = {}


reset_config()


def get_config_state() -> Dict[str, Any]:
    return _state


def get_config_arg(name, type_=str, default=None):
    """CLI --config_args overrides (reference config_parser get_config_arg,
    used by every benchmark script e.g. benchmark/paddle/image/resnet.py:7)."""
    v = _state["config_args"].get(name)
    if v is None:
        return default
    if type_ is bool:
        return str(v) not in ("0", "False", "false", "")
    return type_(v)


def settings(batch_size=256, learning_rate=1e-3, learning_method=None,
             regularization=None, gradient_clipping_threshold=None, **kwargs):
    _state["settings"] = dict(
        batch_size=int(batch_size),
        learning_rate=float(learning_rate),
        learning_method=learning_method,
        regularization=regularization,
        gradient_clipping_threshold=gradient_clipping_threshold,
        extra=kwargs,
    )


def define_py_data_sources2(train_list, test_list, module, obj, args=None):
    _state["data_sources"] = dict(
        train_list=train_list, test_list=test_list, module=module, obj=obj,
        args=dict(args or {}),
    )


def outputs(*layers):
    _state["outputs"].extend(layers)


def Inputs(*names):
    """Legacy config_parser Inputs(): declares feed order; recorded so the
    CLI can validate provider slots (the graph itself already knows its
    data layers)."""
    _state["input_names"] = list(names)


def Outputs(*names):
    """Legacy config_parser Outputs(): outputs by layer NAME."""
    _state["output_names"] = list(names)


class SimpleData(object):
    """Legacy SimpleData provider config (reference
    trainer/tests/sample_trainer_config.conf): dense rows of `feat_dim`
    floats read from `files`."""

    def __init__(self, files=None, feat_dim=1, context_len=0,
                 buffer_capacity=0, **kwargs):
        self.files = files
        self.feat_dim = feat_dim


def TrainData(provider):
    _state["train_data"] = provider


def TestData(provider):
    _state["test_data"] = provider


# ---------------------------------------------------------------------
# activations / pooling / optimizers (reference activations.py,
# poolings.py, optimizers.py)
# ---------------------------------------------------------------------


class _Act(object):
    name: Optional[str] = None


def _mkact(cls_name, act):
    return type(cls_name, (_Act,), {"name": act})


ReluActivation = _mkact("ReluActivation", "relu")
SoftmaxActivation = _mkact("SoftmaxActivation", "softmax")
LinearActivation = _mkact("LinearActivation", None)
IdentityActivation = LinearActivation
TanhActivation = _mkact("TanhActivation", "tanh")
SigmoidActivation = _mkact("SigmoidActivation", "sigmoid")
BReluActivation = _mkact("BReluActivation", "brelu")
# reference SoftRelu = ln(1 + e^x) (activations.py SoftReluActivation),
# which is softplus in fluid terms
SoftReluActivation = _mkact("SoftReluActivation", "softplus")
SquareActivation = _mkact("SquareActivation", "square")
SequenceSoftmaxActivation = _mkact("SequenceSoftmaxActivation", "sequence_softmax")
ExpActivation = _mkact("ExpActivation", "exp")
STanhActivation = _mkact("STanhActivation", "stanh")
AbsActivation = _mkact("AbsActivation", "abs")
LogActivation = _mkact("LogActivation", "log")
SqrtActivation = _mkact("SqrtActivation", "sqrt")
ReciprocalActivation = _mkact("ReciprocalActivation", "reciprocal")
SoftSignActivation = _mkact("SoftSignActivation", "softsign")
# reference activations.py exports the base class too
BaseActivation = _Act


class ParamAttr(object):
    """Legacy attrs.py ParameterAttribute: the subset that affects this
    core — `name` gives deterministic (shareable) parameter identity;
    initialization spread/learning-rate fields are accepted and recorded."""

    def __init__(self, name=None, is_static=False, initial_std=None,
                 initial_mean=None, initial_max=None, initial_min=None,
                 l1_rate=None, l2_rate=None, learning_rate=None,
                 momentum=None, gradient_clipping_threshold=None,
                 sparse_update=False, update_hooks=None, **kwargs):
        self.name = name
        self.is_static = is_static
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        self.learning_rate = learning_rate
        self.update_hooks = update_hooks
        # legacy sparse-row updates (reference attrs.py:130, the
        # SparseRemoteParameterUpdater surface) select the SelectedRows
        # sparse-gradient path when the parameter feeds an embedding
        self.sparse_update = sparse_update


class ExtraLayerAttribute(object):
    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None, **kwargs):
        self.drop_rate = drop_rate


ExtraAttr = ExtraLayerAttribute


class _Pooling(object):
    name = "max"


class MaxPooling(_Pooling):
    name = "max"


class AvgPooling(_Pooling):
    name = "avg"


class SumPooling(_Pooling):
    name = "sum"


class MomentumOptimizer(object):
    def __init__(self, momentum=0.9, sparse=False):
        self.momentum = momentum

    def make(self, lr):
        from .. import fluid

        return fluid.optimizer.Momentum(learning_rate=lr, momentum=self.momentum)


class AdamOptimizer(object):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def make(self, lr):
        from .. import fluid

        return fluid.optimizer.Adam(
            learning_rate=lr, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon,
        )


class AdaGradOptimizer(object):
    def make(self, lr):
        from .. import fluid

        return fluid.optimizer.Adagrad(learning_rate=lr)


class RMSPropOptimizer(object):
    def __init__(self, rho=0.95, epsilon=1e-6):
        self.rho, self.epsilon = rho, epsilon

    def make(self, lr):
        from .. import fluid

        return fluid.optimizer.RMSProp(
            learning_rate=lr, rho=self.rho, epsilon=self.epsilon
        )


# L2Regularization is defined further down, under BaseRegularization


# ---------------------------------------------------------------------
# layers — legacy names over the shared lazy node graph
# ---------------------------------------------------------------------


def _act_name(act):
    if act is None:
        return None
    if isinstance(act, type):
        act = act()
    return act.name


def data_layer(name, size, height=None, width=None, **kwargs):
    t = _DataType(size)
    node = Layer("data", name, [], {"type": t})
    node.im_shape = None
    if height and width:
        node.im_shape = (size // (height * width), height, width)
    return node


class _DataType(object):
    """Minimal stand-in for v2 data_type: dense flat vector of `dim`
    (legacy data_layer is untyped; label layers are int by usage)."""

    def __init__(self, dim, seq=0, is_index=False):
        self.dim = dim
        self.seq_type = seq
        self.type = 3 if is_index else 0  # DataType.Index / Dense


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _apply_layer_attr(node, kwargs):
    """Honor ExtraLayerAttribute knobs that change the graph: drop_rate
    wraps the layer in dropout (reference config_parser applies
    layer_attr.drop_rate to any layer's output); device hints are
    accepted and ignored (the executor places the whole program)."""
    attr = kwargs.get("layer_attr")
    rate = getattr(attr, "drop_rate", None)
    if rate:
        return dropout_layer(input=node, dropout_rate=float(rate))
    return node


def fc_layer(input, size, act=None, name=None, bias_attr=None,
             param_attr=None, **kwargs):
    node = Layer("fc", name, _as_list(input), {
        "size": size, "act": _act_name(act), "param_attr": param_attr,
        "bias_attr": bias_attr,
    })
    return _apply_layer_attr(node, kwargs)


def _node_flat_width(node):
    a = getattr(node, "attrs", {})
    if a.get("size"):
        return int(a["size"])
    t = a.get("type")
    if t is not None:
        return int(t.dim)
    return None


def _factor_hw(size, c):
    """Reference config_parser geometry fallback (config_parser.py:1210):
    width = floor(sqrt(pixels)), height = pixels / width."""
    pixels = size // c
    w = int(math.sqrt(pixels))
    h = pixels // max(w, 1)
    if h * w * c != size:
        raise ValueError(
            "cannot factor size %d into %d channels x H x W" % (size, c)
        )
    return h, w


def _ensure_image(node, num_channels):
    """Insert a reshape node when the input is still flat (data layers —
    and any flat layer given an explicit num_channels — are [N, size];
    geometry follows config_parser's inference) and return
    (input_node, (c, h, w))."""
    shape = getattr(node, "im_shape", None)
    if shape is not None and node.kind != "data":
        return node, shape
    size = _node_flat_width(node)
    if node.kind == "data" or (num_channels and size):
        if shape is None:
            c = num_channels or 3
            h, w = _factor_hw(size, c)
            shape = (c, h, w)
        r = Layer("im_reshape", None, [node], {"shape": list(shape)})
        r.im_shape = shape
        return r, shape
    raise ValueError(
        "img layer input %r has no image shape; give num_channels on the "
        "first conv/pool or height/width on the data layer" % node.name
    )


def _conv_out(h, f, s, p):
    return (h + 2 * p - f) // s + 1


def _pool_out(d, ps, st, pd, ceil_mode):
    """Pooling output extent (shared by img_pool_layer / img_pool3d_layer;
    reference parse_pool ceil/floor semantics)."""
    span = d + 2 * pd - ps
    return (-(-span // st) if ceil_mode else span // st) + 1


def img_conv_layer(input, filter_size, num_filters, num_channels=None,
                   stride=1, padding=0, groups=1, act=None, bias_attr=None,
                   name=None, **kwargs):
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], num_channels)
    node = Layer("img_conv", name, [inp], {
        "filter_size": filter_size, "num_filters": num_filters,
        "num_channels": c, "stride": stride, "padding": padding,
        "groups": groups, "act": _act_name(act),
        "bias": bias_attr is not False,
    })
    node.im_shape = (
        num_filters,
        _conv_out(h, filter_size, stride, padding),
        _conv_out(w, filter_size, stride, padding),
    )
    return node


def img_pool_layer(input, pool_size, stride=1, padding=0, pool_type=None,
                   name=None, pool_size_y=None, stride_y=None,
                   padding_y=None, num_channels=None, ceil_mode=True,
                   **kwargs):
    """Image pooling, rectangular windows supported via the *_y params
    (reference img_pool_layer / config_parser parse_pool; legacy default
    is ceil_mode=True)."""
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], num_channels)
    ptype = "max"
    if pool_type is not None:
        p = pool_type if isinstance(pool_type, _Pooling) else pool_type()
        ptype = "avg" if p.name in ("avg", "sum") else "max"
    ph = pool_size_y if pool_size_y is not None else pool_size
    sh = stride_y if stride_y is not None else stride
    dh = padding_y if padding_y is not None else padding
    node = Layer("img_pool", name, [inp], {
        "pool_size": [ph, pool_size], "stride": [sh, stride],
        "padding": [dh, padding], "pool_type": ptype,
        "ceil_mode": bool(ceil_mode),
    })

    node.im_shape = (
        c, _pool_out(h, ph, sh, dh, ceil_mode),
        _pool_out(w, pool_size, stride, padding, ceil_mode),
    )
    return node


def batch_norm_layer(input, act=None, name=None, **kwargs):
    inp = _as_list(input)[0]
    node = Layer("batch_norm", name, [inp], {"act": _act_name(act)})
    node.im_shape = getattr(inp, "im_shape", None)
    return node


def img_cmrnorm_layer(input, size=5, scale=0.0001, power=0.75, name=None,
                      **kwargs):
    """Cross-map response normalization = LRN (reference img_cmrnorm_layer
    -> NormLayer; fluid lrn_op)."""
    inp = _as_list(input)[0]
    node = Layer("lrn", name, [inp], {
        "size": size, "scale": scale, "power": power,
    })
    node.im_shape = getattr(inp, "im_shape", None)
    return node


def addto_layer(input, act=None, name=None, bias_attr=None, **kwargs):
    nodes = _as_list(input)
    node = Layer("addto", name, nodes, {"act": _act_name(act)})
    node.im_shape = getattr(nodes[0], "im_shape", None)
    return node


def concat_layer(input, name=None, **kwargs):
    nodes = _as_list(input)
    node = Layer("concat", name, nodes, {})
    shapes = [getattr(n, "im_shape", None) for n in nodes]
    if all(s is not None for s in shapes):
        node.im_shape = (
            sum(s[0] for s in shapes), shapes[0][1], shapes[0][2],
        )
        node.attrs["concat_images"] = True  # channel concat, not flat
    return node


def dropout_layer(input, dropout_rate, name=None, **kwargs):
    inp = _as_list(input)[0]
    node = Layer("dropout", name, [inp], {"rate": dropout_rate})
    node.im_shape = getattr(inp, "im_shape", None)
    return node


def embedding_layer(input, size, name=None, param_attr=None, **kwargs):
    node = _as_list(input)[0]
    # legacy: a data layer feeding an embedding is an id sequence
    t = node.attrs["type"]
    t.type = 3  # Index
    t.seq_type = 1
    return Layer("embedding", name, [node], {
        "size": size, "param_attr": param_attr,
    })


def lstmemory(input, size=None, reverse=False, act=None, name=None, **kwargs):
    return Layer("lstmemory", name, _as_list(input), {
        "size": size, "reverse": reverse,
    })


def simple_lstm(input, size, name=None, **kwargs):
    f = fc_layer(input=input, size=size * 4)
    return Layer("lstmemory", name, [f], {"size": size, "reverse": False})


def grumemory(input, size=None, reverse=False, name=None, **kwargs):
    return Layer("gru", name, _as_list(input), {"size": size, "reverse": reverse})


def last_seq(input, name=None, **kwargs):
    return Layer("last_seq", name, _as_list(input), {})


def first_seq(input, name=None, **kwargs):
    return Layer("first_seq", name, _as_list(input), {})


def max_id(input, name=None, **kwargs):
    return Layer("max_id", name, _as_list(input), {})


def _label_node(label):
    t = label.attrs["type"]
    t.type = 3  # Index; legacy label layers are integer slots sized n_class
    t.dim = max(t.dim, 1)
    return label


def classification_cost(input, label, name=None, weight=None, **kwargs):
    parents = [input, _label_node(label)]
    if weight is not None:
        parents.append(weight)
    return Layer("classification_cost", name, parents,
                 {"weighted": weight is not None})


def cross_entropy(input, label, name=None, **kwargs):
    return Layer("cross_entropy_cost", name, [input, _label_node(label)], {})


def mse_cost(input, label, name=None, **kwargs):
    return Layer("mse_cost", name, [input, label], {})


regression_cost = mse_cost


# ---------------------------------------------------------------------
# mixed_layer + projections (reference layers.py mixed_layer:657,
# full_matrix_projection:500, identity_projection:540, table_projection,
# context_projection, gserver MixedLayer + projections/)
# ---------------------------------------------------------------------


class _Projection(object):
    def __init__(self, ptype, input, **attrs):
        self.ptype = ptype
        self.input = input
        self.attrs = attrs


def full_matrix_projection(input, size=0, param_attr=None, **kwargs):
    return _Projection("full_matrix", input, param_attr=param_attr)


def trans_full_matrix_projection(input, size=0, param_attr=None, **kwargs):
    return _Projection("trans_full_matrix", input, param_attr=param_attr)


def identity_projection(input, offset=None, size=None, **kwargs):
    return _Projection("identity", input, offset=offset, size=size)


def table_projection(input, size=0, param_attr=None, **kwargs):
    return _Projection("table", input, param_attr=param_attr)


def context_projection(input, context_len, context_start=None,
                       padding_attr=False, **kwargs):
    return _Projection(
        "context", input, context_len=context_len,
        context_start=context_start,
    )


def dotmul_projection(input, param_attr=None, **kwargs):
    return _Projection("dotmul", input, param_attr=param_attr)


def scaling_projection(input, param_attr=None, **kwargs):
    return _Projection("scaling", input, param_attr=param_attr)


class MixedLayerNode(Layer):
    """`with mixed_layer(...) as m: m += projection` — a Layer node whose
    attrs collect projections; usable as a context manager and as a
    regular layer input afterwards."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __iadd__(self, proj):
        if not isinstance(proj, _Projection):
            raise TypeError("mixed_layer += expects a projection")
        self.attrs["projections"].append(proj)
        self.parents.append(proj.input)
        self.parents.extend(getattr(proj, "extra_inputs", []))
        return self


def mixed_layer(size=0, input=None, name=None, act=None, bias_attr=None,
                **kwargs):
    node = MixedLayerNode("mixed", name, [], {
        "size": size, "act": _act_name(act), "bias_attr": bias_attr,
        "projections": [],
    })
    if input is not None:
        for proj in _as_list(input):
            node += proj
    return node


# ---------------------------------------------------------------------
# recurrent_group / memory / StaticInput (reference layers.py
# recurrent_group:4082, memory:3590; RecurrentGradientMachine)
# ---------------------------------------------------------------------


class StaticInput(object):
    """Non-sequence input visible unchanged at every step."""

    def __init__(self, input, size=None, is_seq=False, **kwargs):
        self.input = input
        self.size = size


_rg_stack: List[List[Layer]] = []


def memory(name, size=None, boot_layer=None, is_seq=False, **kwargs):
    """State carried across recurrent_group steps: reads the PREVIOUS
    step's value of the layer called `name` (the step must produce a
    layer with that name); `boot_layer` seeds step 0."""
    if not _rg_stack:
        raise RuntimeError("memory() must be called inside a "
                           "recurrent_group step function")
    node = Layer("rg_memory", None, [], {
        "ref_name": name, "size": size,
        "boot_name": boot_layer.name if boot_layer is not None else None,
    })
    node._boot_layer = boot_layer
    _rg_stack[-1].append(node)
    return node


class SubsequenceInput(object):
    """Marks a NESTED-sequence input to recurrent_group (reference
    layers.py SubsequenceInput): each outer step consumes one
    sub-sequence. In the memory-less generation lowering the packed
    tokens are the per-source batch either way, so the marker unwraps
    to its layer."""

    def __init__(self, input):  # noqa: A002 - reference name
        self.input = input


def recurrent_group(step, input, reverse=False, name=None, **kwargs):
    """Runs `step` once per timestep over the sequence inputs (lowered to
    fluid DynamicRNN — core/kernels_control.py). Plain
    layer inputs are per-step sequences; StaticInput is read-only."""
    raw_inputs = _as_list(input)
    has_subseq = any(isinstance(i, SubsequenceInput) for i in raw_inputs)
    inputs = [
        i.input if isinstance(i, SubsequenceInput) else i
        for i in raw_inputs
    ]
    seq_nodes, static_nodes, placeholders = [], [], []
    for inp in inputs:
        if isinstance(inp, StaticInput):
            ph = Layer("rg_static_in", None, [], {})
            ph._outer = inp.input
            static_nodes.append(ph)
        else:
            ph = Layer("rg_step_in", None, [], {})
            ph._outer = inp
            seq_nodes.append(ph)
        placeholders.append(ph)

    _rg_stack.append([])
    prev_collector = Layer._step_nodes
    Layer._step_nodes = step_nodes = []
    try:
        out = step(*placeholders)
    finally:
        mems = _rg_stack.pop()
        Layer._step_nodes = prev_collector
    if isinstance(out, (list, tuple)):
        raise NotImplementedError(
            "recurrent_group with multiple step outputs is not supported "
            "yet; return the primary output layer"
        )
    is_nested_gen = getattr(out, "kind", None) == "beam_gen" and not mems
    if has_subseq and not is_nested_gen:
        raise NotImplementedError(
            "SubsequenceInput recurrent groups are supported only for "
            "the memory-less nested-GENERATION form (beam_search in the "
            "step); nested training groups need per-subsequence "
            "iteration — use DynamicRNN composition instead"
        )
    if is_nested_gen:
        # nested generation (reference sample_trainer_nest_rnn_gen.conf):
        # a memory-less outer group whose step runs beam_search is a MAP
        # over the outer sequence's tokens — rewire the beam's static
        # inputs from the per-step placeholders to the packed outer
        # sequences (every token becomes one generation source; the
        # packed order IS the reference's concat-over-outer-steps order)
        ph_to_outer = {ph: ph._outer for ph in placeholders}

        def _reaches_placeholder(node, seen=None):
            seen = seen if seen is not None else set()
            if id(node) in seen:
                return False
            seen.add(id(node))
            if getattr(node, "kind", None) in ("rg_step_in",
                                               "rg_static_in"):
                return True
            return any(
                _reaches_placeholder(par, seen)
                for par in getattr(node, "parents", [])
            )

        for sph in out.attrs["static_phs"]:
            if sph._outer in ph_to_outer:
                sph._outer = ph_to_outer[sph._outer]
            elif _reaches_placeholder(sph._outer):
                raise NotImplementedError(
                    "nested generation supports only DIRECT "
                    "SubsequenceInput -> StaticInput pass-through; layer "
                    "%r transforms the outer step input before the "
                    "beam's StaticInput" % sph._outer.name
                )
        out.parents = [sph._outer for sph in out.attrs["static_phs"]]
        if name and Layer._registry is not None:
            Layer._registry.setdefault(name, out)
        return out
    parents = [ph._outer for ph in placeholders] + [
        m._boot_layer for m in mems if m._boot_layer is not None
    ]
    node = Layer("recurrent_group", name, parents, {
        "reverse": bool(reverse),
        "step_out": out,
        "placeholders": placeholders,
        "mems": mems,
        "step_nodes": step_nodes,
    })
    return node


class BaseGeneratedInput(object):
    """Base for generation-mode step inputs (reference layers.py:4203)."""

    def __init__(self):
        self.bos_id = None
        self.eos_id = None


class GeneratedInput(BaseGeneratedInput):
    """Generation-mode step input: the embedding of the previous step's
    predicted word (reference layers.py GeneratedInput / the generation
    path of RecurrentGradientMachine)."""

    def __init__(self, size, embedding_name, embedding_size, **kwargs):
        super(GeneratedInput, self).__init__()
        self.size = size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


def beam_search(step, input, bos_id, eos_id, beam_size=1,
                num_results_per_sample=None, max_length=10, name=None,
                **kwargs):
    """Legacy generation (reference layers.py beam_search ->
    RecurrentGradientMachine::generateSequence/beamSearch,
    RecurrentGradientMachine.h:307,309): run `step` up to `max_length`
    times, feeding back the embedded best words, keeping `beam_size`
    candidates per source. Lowered to the fluid While + beam_search +
    beam_search_decode machinery (a host-counted While,
    core/kernels_control.py); returns the decoded sentence-id layer."""
    if num_results_per_sample is None:
        num_results_per_sample = beam_size
    if num_results_per_sample > beam_size:
        raise ValueError(
            "num_results_per_sample=%d exceeds beam_size=%d"
            % (num_results_per_sample, beam_size)
        )
    inputs = _as_list(input)
    gen = None
    placeholders, static_phs = [], []
    for inp in inputs:
        if isinstance(inp, GeneratedInput):
            ph = Layer("rg_gen_in", None, [], {"size": inp.embedding_size})
            gen = inp
            placeholders.append(ph)
        elif isinstance(inp, StaticInput):
            ph = Layer("rg_static_in", None, [], {})
            ph._outer = inp.input
            static_phs.append(ph)
            placeholders.append(ph)
        else:
            raise TypeError(
                "beam_search inputs must be StaticInput/GeneratedInput"
            )
    if gen is None:
        raise ValueError("beam_search needs a GeneratedInput")

    _rg_stack.append([])
    try:
        out = step(*placeholders)
    finally:
        mems = _rg_stack.pop()
    parents = [ph._outer for ph in static_phs] + [
        m._boot_layer for m in mems if m._boot_layer is not None
    ]
    node = Layer("beam_gen", name, parents, {
        "step_out": out,
        "placeholders": placeholders,
        "static_phs": static_phs,
        "mems": mems,
        "gen": gen,
        "bos_id": int(bos_id),
        "eos_id": int(eos_id),
        "beam_size": int(beam_size),
        "num_results_per_sample": int(num_results_per_sample),
        "max_length": int(max_length),
    })
    # reference default generation output name (config_parser registers
    # the decode layer as "__beam_search_predict__"; rnn_gen confs say
    # Outputs("__beam_search_predict__"))
    if Layer._registry is not None:
        Layer._registry.setdefault("__beam_search_predict__", node)
    return node


def expand_layer(input, expand_as, name=None, **kwargs):
    """Repeat each row of `input` per `expand_as`'s sequence layout
    (reference expand_layer -> fluid sequence_expand)."""
    return Layer("seq_expand", name, [input, expand_as], {})


def pooling_layer(input, pooling_type=None, name=None, **kwargs):
    ptype = "max"
    if pooling_type is not None:
        p = pooling_type if isinstance(pooling_type, _Pooling) else pooling_type()
        ptype = {"max": "max", "avg": "average", "sum": "sum",
                 "sqrt": "sqrt"}[p.name]
    return Layer("seq_pool", name, [input], {"pool_type": ptype})


def seq_concat_layer(a, b, name=None, **kwargs):
    return Layer("concat", name, [a, b], {})


def maxid_layer(input, name=None, **kwargs):
    return Layer("max_id", name, _as_list(input), {})


def eos_layer(input, eos_id, name=None, **kwargs):
    """1 where the id equals eos_id (reference EosIdCheckLayer)."""
    return Layer("eos", name, _as_list(input), {"eos_id": int(eos_id)})


def img_conv_group(input, conv_num_filter, conv_filter_size=3,
                   conv_padding=1, conv_act=None, num_channels=None,
                   pool_size=2, pool_stride=2, pool_type=None,
                   conv_with_batchnorm=False, name=None, **kwargs):
    """Stacked convs + one pool (reference trainer_config_helpers/networks
    img_conv_group, used by the VGG benchmark config)."""
    tmp = _as_list(input)[0]
    for i, nf in enumerate(conv_num_filter):
        tmp = img_conv_layer(
            input=tmp,
            filter_size=conv_filter_size,
            num_filters=nf,
            num_channels=num_channels if i == 0 else None,
            stride=1,
            padding=conv_padding,
            act=conv_act,
        )
        if conv_with_batchnorm:
            tmp = batch_norm_layer(input=tmp, act=None)
    return img_pool_layer(
        input=tmp, pool_size=pool_size, stride=pool_stride,
        pool_type=pool_type,
    )


# ---------------------------------------------------------------------
# breadth wrappers (reference layers.py; each lowers onto an existing
# fluid layer/kernel — see v2/topology.py for the lowering)
# ---------------------------------------------------------------------


def _simple(kind, inputs, **attrs):
    name = attrs.pop("name", None)
    return Layer(kind, name, _as_list(inputs), attrs)


def cos_sim(a, b, scale=1.0, name=None, **kwargs):
    return _simple("cos_sim", [a, b], name=name, scale=scale)


def trans_layer(input, name=None, **kwargs):
    return _simple("trans", input, name=name)


def power_layer(input, weight, name=None, **kwargs):
    """y_ij = x_ij ^ w_i (reference PowerLayer)."""
    return _simple("power", [input, weight], name=name)


def scaling_layer(input, weight, name=None, **kwargs):
    """row i scaled by weight row i (reference ScalingLayer)."""
    return _simple("scaling", [input, weight], name=name)


def interpolation_layer(input, weight, name=None, **kwargs):
    """w*a + (1-w)*b over input=[a, b] (reference InterpolationLayer)."""
    a, b = _as_list(input)
    return _simple("interpolation", [a, b, weight], name=name)


def slope_intercept_layer(input, slope=1.0, intercept=0.0, name=None,
                          **kwargs):
    return _simple("slope_intercept", input, name=name,
                   slope=float(slope), intercept=float(intercept))


def sum_to_one_norm_layer(input, name=None, **kwargs):
    return _simple("sum_to_one_norm", input, name=name)


def row_l2_norm_layer(input, name=None, **kwargs):
    return _simple("row_l2_norm", input, name=name)


def dot_prod_layer(a, b, name=None, **kwargs):
    return _simple("dot_prod", [a, b], name=name)


def out_prod_layer(a, b, name=None, **kwargs):
    return _simple("out_prod", [a, b], name=name)


def l2_distance_layer(a, b, name=None, **kwargs):
    return _simple("l2_distance", [a, b], name=name)


def pad_layer(input, pad_c=None, pad_h=None, pad_w=None, name=None, **kwargs):
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], None)
    pad_c, pad_h, pad_w = pad_c or [0, 0], pad_h or [0, 0], pad_w or [0, 0]
    node = _simple("pad_img", inp, name=name,
                   pad_c=list(pad_c), pad_h=list(pad_h), pad_w=list(pad_w))
    node.im_shape = (c + sum(pad_c), h + sum(pad_h), w + sum(pad_w))
    return node


def clip_layer(input, min, max, name=None, **kwargs):  # noqa: A002
    return _simple("clip", input, name=name, min=float(min), max=float(max))


def multiplex_layer(input, name=None, **kwargs):
    """input[0] = int selector, rest = candidates (reference Multiplex)."""
    ins = _as_list(input)
    if ins[0].kind == "data":
        ins[0].attrs["type"].type = 3  # the selector is an id slot
    return _simple("multiplex", ins, name=name)


def row_conv_layer(input, context_len, act=None, name=None, **kwargs):
    return _simple("row_conv", input, name=name,
                   context_len=int(context_len), act=_act_name(act))


def maxout_layer(input, groups, num_channels=None, name=None, **kwargs):
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], num_channels)
    node = _simple("maxout", inp, name=name, groups=int(groups))
    node.im_shape = (c // int(groups), h, w)
    return node


def block_expand_layer(input, block_x=1, block_y=1, stride_x=1, stride_y=1,
                       padding_x=0, padding_y=0, num_channels=None,
                       name=None, **kwargs):
    """Image -> sequence of blocks (reference BlockExpandLayer; fluid
    im2sequence)."""
    input, _ = _ensure_image(_as_list(input)[0], num_channels)
    return _simple("block_expand", input, name=name,
                   block=[int(block_y), int(block_x)],
                   stride=[int(stride_y), int(stride_x)],
                   padding=[int(padding_y), int(padding_x)],
                   num_channels=num_channels)


def seq_reshape_layer(input, reshape_size, name=None, **kwargs):
    return _simple("seq_reshape", input, name=name,
                   new_dim=int(reshape_size))


def repeat_layer(input, num_repeats, name=None, **kwargs):
    return _simple("repeat", input, name=name, num_repeats=int(num_repeats))


def recurrent_layer(input, act=None, reverse=False, name=None,
                    param_attr=None, bias_attr=None, **kwargs):
    """Simple full-matrix recurrence (reference RecurrentLayer):
    h_t = act(x_t + W h_{t-1}) — sugar over recurrent_group; with
    reverse=True the recurrence runs t = len-1 .. 0 (reference
    RecurrentLayer reversed_)."""
    act = act or TanhActivation()
    inp = _as_list(input)[0]
    if name is None:
        # auto-unique like every other wrapper (two unnamed recurrences
        # must not share a state name or weight)
        i = Layer._counters.get("recurrent_layer", 0)
        Layer._counters["recurrent_layer"] = i + 1
        name = "__recurrent_layer_%d__" % i

    def step(y):
        mem = memory(name=name + "@state", size=None)
        out_ = _simple("recurrent_step", [y, mem], name=name + "@state",
                       act=_act_name(act), param_attr=param_attr)
        return out_

    return recurrent_group(step=step, input=inp, name=name,
                           reverse=reverse)


def ctc_layer(input, label, size=None, blank=None, norm_by_times=False,
              name=None, **kwargs):
    return _simple("ctc_cost", [input, _label_node(label)], name=name,
                   blank=int(blank if blank is not None else (size or 1) - 1),
                   norm_by_times=norm_by_times)


def warp_ctc_layer(input, label, size=None, blank=0, norm_by_times=False,
                   name=None, **kwargs):
    """Reference warp_ctc_layer: blank DEFAULTS TO 0 (ctc_layer's blank
    defaults to size-1)."""
    return _simple("ctc_cost", [input, _label_node(label)], name=name,
                   blank=int(blank), norm_by_times=norm_by_times)


def crf_layer(input, label, size=None, param_attr=None, name=None, **kwargs):
    return _simple("crf_cost", [input, _label_node(label)], name=name,
                   param_attr=param_attr)


def crf_decoding_layer(input, size=None, param_attr=None, label=None,
                       name=None, **kwargs):
    return _simple("crf_decode", [input], name=name, param_attr=param_attr)


def nce_layer(input, label, num_classes, num_neg_samples=10, name=None,
              weight=None, neg_distribution=None, **kwargs):
    parents = _as_list(input) + [_label_node(label)]
    if weight is not None:
        parents.append(weight)
    return _simple("nce_cost", parents,
                   name=name,
                   num_classes=int(num_classes),
                   num_neg_samples=int(num_neg_samples),
                   weighted=weight is not None,
                   neg_distribution=(
                       list(neg_distribution) if neg_distribution else None
                   ))


def hsigmoid(input, label, num_classes, name=None, **kwargs):
    return _simple("hsigmoid_cost", _as_list(input) + [_label_node(label)],
                   name=name,
                   num_classes=int(num_classes))


def rank_cost(left, right, label, name=None, **kwargs):
    return _simple("rank_cost", [left, right, label], name=name)


def huber_regression_cost(input, label, delta=1.0, name=None, **kwargs):
    return _simple("huber_cost", [input, label], name=name,
                   delta=float(delta))


def multi_binary_label_cross_entropy(input, label, name=None, **kwargs):
    return _simple("multi_binary_ce", [input, label], name=name)


def smooth_l1_cost(input, label, name=None, **kwargs):
    return _simple("smooth_l1_cost", [input, label], name=name)


def sum_cost(input, name=None, **kwargs):
    return _simple("sum_cost", input, name=name)


def square_error_cost(input, label, name=None, **kwargs):
    return mse_cost(input, label, name=name)


def scale_shift_layer(input, name=None, param_attr=None, bias_attr=None,
                      **kwargs):
    """y = w*x + b with ONE learned scale and bias (reference
    ScaleShiftLayer)."""
    return _simple("scale_shift", input, name=name, param_attr=param_attr,
                   bias_attr=bias_attr)


def gated_unit_layer(input, size, act=None, name=None, **kwargs):
    """act(fc(x)) * sigmoid(fc(x)) (reference gated_unit_layer)."""
    proj = fc_layer(input=input, size=size, act=act)
    gate = fc_layer(input=input, size=size,
                    act=SigmoidActivation())
    return _simple("elem_mul", [proj, gate], name=name)


__all__ += [
    "cos_sim", "trans_layer", "power_layer", "scaling_layer",
    "interpolation_layer", "slope_intercept_layer", "sum_to_one_norm_layer",
    "row_l2_norm_layer", "dot_prod_layer", "out_prod_layer",
    "l2_distance_layer", "pad_layer", "clip_layer", "multiplex_layer",
    "row_conv_layer", "maxout_layer", "block_expand_layer",
    "seq_reshape_layer", "repeat_layer", "recurrent_layer", "ctc_layer",
    "warp_ctc_layer", "crf_layer", "crf_decoding_layer", "nce_layer",
    "hsigmoid", "rank_cost", "huber_regression_cost",
    "multi_binary_label_cross_entropy", "smooth_l1_cost", "sum_cost",
    "square_error_cost", "scale_shift_layer", "gated_unit_layer",
]


def sampling_id_layer(input, name=None, **kwargs):
    """Sample a class id per row from probabilities (reference
    SamplingIdLayer)."""
    return _simple("sampling_id", input, name=name)


def bilinear_interp_layer(input, out_size_x, out_size_y, name=None,
                          **kwargs):
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], None)
    node = _simple("bilinear_interp", inp, name=name,
                   out_h=int(out_size_y), out_w=int(out_size_x))
    node.im_shape = (c, int(out_size_y), int(out_size_x))
    return node


def conv_shift_layer(a, b, name=None, **kwargs):
    """Circular convolution of a's rows by b's (odd-width) rows
    (reference ConvShiftLayer)."""
    return _simple("conv_shift", [a, b], name=name)


def switch_order_layer(input, reshape_axis=None, name=None, **kwargs):
    """NCHW -> NHWC (reference SwitchOrderLayer)."""
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], None)
    return _simple("switch_order", inp, name=name, shape=[c, h, w])


def spp_layer(input, pyramid_height=2, num_channels=None, pool_type=None,
              name=None, **kwargs):
    """Spatial pyramid pooling (reference SpatialPyramidPoolLayer): pool
    the map at pyramid levels 1x1, 2x2, ... and concat the flats."""
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], num_channels)
    ptype = "max"
    if pool_type is not None:
        p = pool_type if isinstance(pool_type, _Pooling) else pool_type()
        ptype = "avg" if p.name in ("avg", "sum") else "max"
    return _simple("spp", inp, name=name, pyramid_height=int(pyramid_height),
                   pool_type=ptype, im_shape=[c, h, w])


def factorization_machine(input, factor_size, param_attr=None, name=None,
                          **kwargs):
    """Second-order FM interaction term (reference
    FactorizationMachineLayer): 0.5 * sum_f[(x V)_f^2 - (x^2)(V^2)_f]."""
    return _simple("factorization_machine", input, name=name,
                   factor_size=int(factor_size), param_attr=param_attr)


def huber_classification_cost(input, label, name=None, **kwargs):
    """Huberised hinge loss on +-1 labels (reference
    HuberTwoClassification)."""
    return _simple("huber_cls_cost", [input, _label_node(label)], name=name)


def dotmul_operator(a=None, b=None, scale=1.0, **kwargs):
    """Element-wise a*b term inside a mixed_layer (reference
    DotMulOperator; two-input mixed operator)."""
    if not isinstance(a, Layer) or not isinstance(b, Layer):
        raise TypeError(
            "dotmul_operator needs two layers: dotmul_operator(a=x, b=y)"
        )
    proj = _Projection("dotmul_op", a, scale=float(scale))
    proj.extra_inputs = [b]
    return proj


__all__ += [
    "sampling_id_layer", "bilinear_interp_layer", "conv_shift_layer",
    "switch_order_layer", "spp_layer", "factorization_machine",
    "huber_classification_cost", "dotmul_operator",
]


def seq_slice_layer(input, starts=None, ends=None, name=None, **kwargs):
    """Per-sequence subranges (reference seq_slice_layer): keeps rows
    [starts_i, ends_i) of each sequence. starts/ends are layers of one
    int per sequence; None means begin/end of each sequence."""
    return Layer("seq_slice", name,
                 [input] + [x for x in (starts, ends) if x is not None],
                 {"has_starts": starts is not None,
                  "has_ends": ends is not None})


def sub_seq_layer(input, offsets, sizes, name=None, **kwargs):
    """Sub-sequences by (offset, size) per sequence (reference
    SubSequenceLayer)."""
    return Layer("sub_seq", name, [input, offsets, sizes], {})


def lstm_step_layer(input, state, size=None, act=None,
                    gate_act=None, state_act=None, name=None, **kwargs):
    """One LSTM step inside a recurrent_group (reference LstmStepLayer):
    `input` is the 4H pre-projection, `state` the cell memory. Returns
    the hidden; the updated cell is reachable via
    get_output_layer(..., arg_name='state')."""
    return Layer("lstm_step", name, [input, state], {
        "size": size,
    })


def gru_step_layer(input, output_mem, size=None, act=None, gate_act=None,
                   name=None, param_attr=None, bias_attr=None, **kwargs):
    """One GRU step inside a recurrent_group (reference GruStepLayer):
    `input` is the 3H pre-projection, `output_mem` the hidden memory."""
    return Layer("gru_step", name, [input, output_mem], {
        "size": size, "param_attr": param_attr, "bias_attr": bias_attr,
    })


gru_step_naive_layer = gru_step_layer


def get_output_layer(input, arg_name="state", name=None, **kwargs):
    """Secondary output of a multi-output step layer (reference
    GetOutputLayer): e.g. the cell state of lstm_step_layer."""
    return Layer("get_output", name, [input], {"arg_name": arg_name})


def tensor_layer(a, b, size, act=None, name=None, param_attr=None,
                 **kwargs):
    """Bilinear tensor product (reference TensorLayer):
    out_k = a W_k b^T with W_k [da, db], k < size."""
    return Layer("tensor", name, [a, b], {
        "size": int(size), "act": _act_name(act), "param_attr": param_attr,
    })


def selective_fc_layer(input, size, select=None, act=None, name=None,
                       param_attr=None, bias_attr=None, **kwargs):
    """Reference selective_fc_layer; with select=None it equals fc (the
    full-output case, which is what training configs use — the
    inference-time column selection is a serving optimisation the full
    matmul does not need)."""
    if select is not None:
        raise NotImplementedError(
            "selective_fc with a selection input: the full-matmul path "
            "makes column selection unnecessary"
        )
    return fc_layer(input=input, size=size, act=act, name=name,
                    param_attr=param_attr, bias_attr=bias_attr)


__all__ += [
    "seq_slice_layer", "sub_seq_layer", "lstm_step_layer",
    "gru_step_layer", "gru_step_naive_layer", "get_output_layer",
    "tensor_layer", "selective_fc_layer",
]


def printer_layer(input, format=None, name=None, **kwargs):
    """Pass-through that prints values at run time; parity surface with
    the JAX package, whose fused executor cannot interleave it: identity
    (reference PrintLayer prints to the trainer log)."""
    return _simple("identity", input, name=name)


def resize_layer(input, size, name=None, **kwargs):
    """Reshape rows to width `size` (reference ResizeLayer)."""
    return _simple("resize", input, name=name, size=int(size))


def rotate_layer(input, height=None, width=None, name=None, **kwargs):
    """90-degree CLOCKWISE rotation of each feature map (reference
    RotateLayer: out(c, H-1-r) = in(r, c)); height/width declare the
    geometry when the input has none."""
    src = _as_list(input)[0]
    if height and width and getattr(src, "im_shape", None) is None:
        size = src.attrs["type"].dim
        src.im_shape = (size // (height * width), int(height), int(width))
    inp, (c, h, w) = _ensure_image(src, None)
    node = _simple("rotate", inp, name=name)
    node.im_shape = (c, w, h)
    return node


def cross_channel_norm_layer(input, name=None, param_attr=None, **kwargs):
    """L2-normalise across channels per spatial position, with a learned
    per-channel scale (reference CrossChannelNormLayer, the SSD conv4_3
    norm)."""
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], None)
    node = _simple("cross_channel_norm", inp, name=name,
                   channels=c, param_attr=param_attr)
    node.im_shape = (c, h, w)
    return node


def slice_projection(input, slices, **kwargs):
    """Column slices of the input concatenated (reference
    slice_projection): slices = [(start, end), ...]."""
    return _Projection("slice", input, slices=[
        (int(a), int(b)) for a, b in slices
    ])


__all__ += [
    "printer_layer", "resize_layer", "rotate_layer",
    "cross_channel_norm_layer", "slice_projection",
]


# ---------------------------------------------------------------------
# breadth round 5: detection, image geometry, 3-D conv/pool, ranking
# costs — the last block of reference layers.py wrappers (priorbox:1117,
# multibox_loss:1178, detection_output:1052, roi_pool:1311, crop:6205,
# prelu:6565, img_conv3d:6788, img_pool3d:2709, scale_sub_region:7302,
# kmax_seq_score:6471, sub_nested_seq:6133, lambda_cost:5771,
# cross_entropy_with_selfnorm:5884, cross_entropy_over_beam:6384,
# linear_comb:5207, conv_operator:4789, conv_projection:4869,
# gru_step_naive:3951)
# ---------------------------------------------------------------------


def _triple3(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


def crop_layer(input, offset, axis=2, shape=None, name=None, **kwargs):
    """Crop along trailing axes of an NCHW image (reference CropLayer):
    `offset`/`shape` cover axes [axis:] of the 4-D tensor."""
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], None)
    node = Layer("crop", name, [inp], {
        "offset": list(offset), "axis": axis,
        "shape": list(shape) if shape is not None else None,
    })
    if shape is not None:
        full = [c, h, w]
        full[axis - 1:] = list(shape)[: 4 - axis]
        node.im_shape = tuple(full)
    else:
        node.im_shape = (c, h, w)
    return node


def prelu_layer(input, name=None, partial_sum=1, channel_shared=None,
                num_channels=None, param_attr=None, **kwargs):
    """Parametric ReLU (reference PReluLayer): partial_sum groups inputs
    sharing one alpha — 1 = element-wise, one channel's extent =
    channel-wise, the whole width = all-shared."""
    inp = _as_list(input)[0]
    shape = getattr(inp, "im_shape", None)
    if channel_shared:
        mode = "all"
    elif partial_sum == 1:
        # reference: each element its own weight
        mode = "element"
    elif shape is not None and partial_sum >= shape[0] * shape[1] * shape[2]:
        mode = "all"
    elif shape is not None and partial_sum == shape[1] * shape[2]:
        mode = "channel"
    else:
        mode = "channel" if shape is not None else "all"
    node = Layer("prelu", name, [inp], {
        "mode": mode, "param_attr": param_attr,
    })
    node.im_shape = shape
    return node


def priorbox_layer(input, image, aspect_ratio, variance, min_size,
                   max_size=[], name=None, **kwargs):
    """SSD anchor generation (reference PriorBoxLayer): the node's main
    output is the [P, 4] box tensor; the variances ride as an auxiliary
    `<name>@var` binding consumed by detection_output/multibox_loss."""
    return Layer("priorbox", name, [input, image], {
        "aspect_ratio": list(aspect_ratio), "variance": list(variance),
        "min_size": _as_list(min_size), "max_size": _as_list(max_size),
    })


def detection_output_layer(input_loc, input_conf, priorbox, num_classes,
                           nms_threshold=0.45, nms_top_k=400,
                           keep_top_k=200, confidence_threshold=0.01,
                           background_id=0, name=None, **kwargs):
    """SSD inference head (reference DetectionOutputLayer): decode
    per-prior offsets against the priors, softmax confidences, NMS."""
    locs, confs = _as_list(input_loc), _as_list(input_conf)
    node = Layer("detection_output", name, locs + confs + [priorbox], {
        "n_loc": len(locs), "num_classes": num_classes,
        "nms_threshold": nms_threshold, "nms_top_k": nms_top_k,
        "keep_top_k": keep_top_k,
        "confidence_threshold": confidence_threshold,
        "background_id": background_id,
    })
    return node


def multibox_loss_layer(input_loc, input_conf, priorbox, label, num_classes,
                        overlap_threshold=0.5, neg_pos_ratio=3.0,
                        neg_overlap=0.5, background_id=0, name=None,
                        **kwargs):
    """SSD training loss (reference MultiBoxLossLayer): `label` is a
    sequence whose rows are [class, xmin, ymin, xmax, ymax(, difficult)]
    ground-truth boxes per image."""
    locs, confs = _as_list(input_loc), _as_list(input_conf)
    return Layer("multibox_loss", name, locs + confs + [priorbox, label], {
        "n_loc": len(locs), "num_classes": num_classes,
        "overlap_threshold": overlap_threshold,
        "neg_pos_ratio": neg_pos_ratio, "neg_overlap": neg_overlap,
        "background_id": background_id,
    })


def roi_pool_layer(input, rois, pooled_width, pooled_height, spatial_scale,
                   num_channels=None, name=None, **kwargs):
    """ROI max pooling (reference ROIPoolLayer)."""
    inp, (c, h, w) = _ensure_image(_as_list(input)[0], num_channels)
    node = Layer("roi_pool", name, [inp, rois], {
        "pooled_width": pooled_width, "pooled_height": pooled_height,
        "spatial_scale": spatial_scale,
    })
    node.im_shape = (c, pooled_height, pooled_width)
    return node


def scale_sub_region_layer(input, indices, value, name=None, **kwargs):
    """Scale a per-sample (C, H, W) box by `value` (reference
    ScaleSubRegionLayer); indices rows are 1-based inclusive
    [c0, c1, h0, h1, w0, w1]."""
    inp, shape = _ensure_image(_as_list(input)[0], None)
    node = Layer("scale_sub_region", name, [inp, indices],
                 {"value": value})
    node.im_shape = shape
    return node


def img_conv3d_layer(input, filter_size, num_filters, name=None,
                     num_channels=None, act=None, groups=1, stride=1,
                     padding=0, bias_attr=None, param_attr=None,
                     shared_biases=True, layer_attr=None, trans=False,
                     layer_type=None, **kwargs):
    """3-D convolution over NCDHW volumes (reference Conv3DLayer). Flat
    data inputs are reshaped assuming cubic volumes (side =
    cbrt(size/channels)), matching config_parser's square-image default
    extended to 3-D."""
    inp = _as_list(input)[0]
    vol = getattr(inp, "vol_shape", None)
    if vol is None:
        if inp.kind != "data":
            raise ValueError(
                "img_conv3d_layer input %r has no volume shape; feed it "
                "a data layer (cubic volume inferred) or another 3-D "
                "layer" % inp.name
            )
        size = inp.attrs["type"].dim
        c = num_channels or 3
        side = int(round((size // c) ** (1.0 / 3)))
        vol = (c, side, side, side)
        inp = Layer("vol_reshape", None, [inp], {"shape": list(vol)})
        inp.vol_shape = vol
    node = Layer("img_conv3d", name, [inp], {
        "filter_size": filter_size, "num_filters": num_filters,
        "act": _act_name(act),
        "groups": groups, "stride": stride, "padding": padding,
        "bias": bias_attr is not False, "param_attr": param_attr,
    })
    fs, st, pd = (_triple3(filter_size), _triple3(stride),
                  _triple3(padding))
    node.vol_shape = (num_filters,) + tuple(
        _conv_out(d, f, s, p) for d, f, s, p in zip(vol[1:], fs, st, pd)
    )
    return node


def img_pool3d_layer(input, pool_size, name=None, num_channels=None,
                     pool_type=None, stride=1, padding=0, layer_attr=None,
                     ceil_mode=True, **kwargs):
    """3-D pooling over NCDHW volumes (reference Pool3DLayer)."""
    ptype = "avg" if isinstance(pool_type, AvgPooling) or pool_type is AvgPooling else "max"
    inp = _as_list(input)[0]
    vol = getattr(inp, "vol_shape", None)
    if vol is None:
        raise ValueError(
            "img_pool3d_layer input %r has no volume shape; it must come "
            "from img_conv3d_layer (or another 3-D layer)" % inp.name
        )
    node = Layer("img_pool3d", name, [inp], {
        "pool_size": pool_size,
        "pool_type": ptype, "stride": stride, "padding": padding,
        "ceil_mode": ceil_mode,
    })
    node.vol_shape = (vol[0],) + tuple(
        _pool_out(d, ps, st, pd, ceil_mode)
        for d, ps, st, pd in zip(vol[1:], _triple3(pool_size),
                                 _triple3(stride), _triple3(padding))
    )
    return node


def linear_comb_layer(weights, vectors, size=None, name=None, **kwargs):
    """Weighted sum of sub-vectors (reference ConvexCombinationLayer):
    out[j] = sum_i weights[i] * vectors[i*size + j]."""
    return Layer("linear_comb", name, [weights, vectors], {"size": size})


def kmax_seq_score_layer(input, name=None, beam_size=1, **kwargs):
    """Within-sequence indices of the top-`beam_size` scores per
    sequence (reference KmaxSeqScoreLayer), -1 padded."""
    return Layer("kmax_seq_score", name, _as_list(input),
                 {"beam_size": beam_size})


def sub_nested_seq_layer(input, selected_indices, name=None, **kwargs):
    """Select sub-sequences of a nested sequence by per-sequence indices
    (reference SubNestedSequenceLayer)."""
    return Layer("sub_nested_seq", name, [input, selected_indices], {})


def lambda_cost(input, score, name=None, NDCG_num=5, max_sort_size=-1,
                **kwargs):
    """LambdaRank listwise cost (reference LambdaCost): `input` is the
    model score sequence, `score` the relevance labels. Full-sort
    (max_sort_size=-1) semantics."""
    return Layer("lambda_cost", name, [input, score],
                 {"NDCG_num": NDCG_num})


def cross_entropy_with_selfnorm(input, label, name=None, coeff=1.0,
                                softmax_selfnorm_alpha=0.1, **kwargs):
    """Self-normalised CE (reference MultiClassCrossEntropyWithSelfNorm,
    CostLayer.cpp:113): CE - though over an UNnormalised row - plus
    log(Z) + alpha*log(Z)^2 where Z is the row sum."""
    return Layer("ce_selfnorm", name, [input, _label_node(label)], {
        "coeff": coeff, "alpha": softmax_selfnorm_alpha,
    })


class BeamInput(object):
    """A (candidate_scores, selected_candidates, gold) triple feeding
    cross_entropy_over_beam (reference layers.py BeamInput:6362)."""

    def __init__(self, candidate_scores, selected_candidates, gold):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


def cross_entropy_over_beam(input, name=None, **kwargs):
    """Globally normalised CE over beam expansions (reference
    CrossEntropyOverBeam.cpp); `input` is a list of BeamInput triples."""
    beams = _as_list(input)
    parents = []
    for b in beams:
        parents += [b.candidate_scores, b.gold]
    return Layer("ce_over_beam", name, parents, {"n_beams": len(beams)})


def conv_operator(img, filter, filter_size, num_filters, num_channels=None,
                  stride=1, padding=0, **kwargs):
    """Convolution term inside a mixed_layer (reference ConvOperator):
    filter comes from a layer (dynamic weights)."""
    proj = _Projection(
        "conv_op", img, filter_size=filter_size, num_filters=num_filters,
        num_channels=num_channels, stride=stride, padding=padding,
    )
    proj.extra_inputs = [filter]
    return proj


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, groups=1, param_attr=None,
                    **kwargs):
    """Convolution projection inside a mixed_layer (reference
    ConvProjection): learned filter parameter."""
    return _Projection(
        "conv_proj", input, filter_size=filter_size,
        num_filters=num_filters, num_channels=num_channels, stride=stride,
        padding=padding, groups=groups, param_attr=param_attr,
    )


__all__ += [
    "crop_layer", "prelu_layer", "priorbox_layer",
    "detection_output_layer", "multibox_loss_layer", "roi_pool_layer",
    "scale_sub_region_layer", "img_conv3d_layer", "img_pool3d_layer",
    "linear_comb_layer", "kmax_seq_score_layer", "sub_nested_seq_layer",
    "lambda_cost", "cross_entropy_with_selfnorm", "BeamInput",
    "cross_entropy_over_beam", "gru_step_naive_layer", "conv_operator",
    "conv_projection",
]


# composite network helpers (reference networks.py) — star-import them
# into the DSL namespace the way the reference's config environment does
from . import networks  # noqa: E402
from .networks import (  # noqa: E402,F401
    bidirectional_gru, bidirectional_lstm, dot_product_attention,
    gru_group, gru_unit, img_conv_bn_pool, img_separable_conv,
    lstmemory_group, lstmemory_unit, multi_head_attention,
    sequence_conv_pool, simple_attention, simple_gru, simple_gru2,
    simple_img_conv_pool, small_vgg, text_conv_pool, vgg_16_network,
)
from .networks import inputs as inputs  # noqa: E402,F401

__all__ += [n for n in networks.__all__ if n != "outputs"]


# evaluator wrappers (reference trainer_config_helpers/evaluators.py)
from . import evaluators  # noqa: E402
from .evaluators import (  # noqa: E402,F401
    auc_evaluator, chunk_evaluator, classification_error_evaluator,
    classification_error_printer_evaluator, column_sum_evaluator,
    ctc_error_evaluator, detection_map_evaluator, evaluator_base,
    gradient_printer_evaluator, maxframe_printer_evaluator,
    maxid_printer_evaluator, pnpair_evaluator,
    precision_recall_evaluator, seqtext_printer_evaluator,
    sum_evaluator, value_printer_evaluator,
)

__all__ += list(evaluators.__all__)


# ---------------------------------------------------------------------
# remaining optimizers / poolings / attrs / decorators (reference
# trainer_config_helpers/{optimizers,poolings,attrs,
# default_decorators}.py)
# ---------------------------------------------------------------------


class Optimizer(object):
    """Base of the DSL optimizer classes (reference optimizers.py
    Optimizer): subclasses implement make(lr) -> fluid optimizer."""

    def make(self, lr):
        raise NotImplementedError


BaseSGDOptimizer = Optimizer


class AdamaxOptimizer(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, **kwargs):
        self.beta1, self.beta2 = beta1, beta2

    def make(self, lr):
        from .. import fluid

        return fluid.optimizer.Adamax(
            learning_rate=lr, beta1=self.beta1, beta2=self.beta2
        )


class AdaDeltaOptimizer(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kwargs):
        self.rho, self.epsilon = rho, epsilon

    def make(self, lr):
        from .. import fluid

        return fluid.optimizer.Adadelta(
            learning_rate=lr, rho=self.rho, epsilon=self.epsilon
        )


class DecayedAdaGradOptimizer(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kwargs):
        self.rho, self.epsilon = rho, epsilon

    def make(self, lr):
        from .. import fluid

        return fluid.optimizer.DecayedAdagrad(
            learning_rate=lr, decay=self.rho, epsilon=self.epsilon
        )


class BaseRegularization(object):
    """Base of the DSL regularization markers (reference optimizers.py
    BaseRegularization); L1/L2Regularization carry a `rate`."""

    def __init__(self, rate=0.0):
        self.rate = float(rate)


class L1Regularization(BaseRegularization):
    pass


class L2Regularization(BaseRegularization):  # noqa: F811
    """Rebinds the early definition under the shared base so
    isinstance(x, BaseRegularization) covers both L1 and L2."""


class ModelAverage(object):
    """Parameter averaging window (reference optimizers.py ModelAverage
    / trainer sgd average_window). IMPLEMENTED: both the v2 trainer and
    the CLI build in-graph EMA slots from this spec
    (fluid.optimizer.ModelAverage.from_spec); v2 test()/
    save_parameter_to_tar and --job=test evaluate/export the averaged
    weights."""

    def __init__(self, average_window, max_average_window=None, **kwargs):
        self.average_window = float(average_window)
        self.max_average_window = max_average_window


BasePoolingType = _Pooling


class SquareRootNPooling(_Pooling):
    name = "sqrt"


class MaxWithMaskPooling(_Pooling):
    name = "max"


# cudnn pooling variants are device hints in the reference; identical
# math here (the executor picks the implementation)
CudnnMaxPooling = MaxPooling
CudnnAvgPooling = AvgPooling
CudnnAvgInclPadPooling = AvgPooling

ParameterAttribute = ParamAttr


class HookAttr(object):
    """Parameter update hook marker (reference attrs.py HookAttribute:
    pruning masks etc). Recorded; pruning-style hooks are not executed
    by the core (documented stance — static masks belong in the
    program, not a post-update hook)."""

    def __init__(self, type=None, sparsity_ratio=None, **kwargs):
        self.type = type
        self.sparsity_ratio = sparsity_ratio


HookAttribute = HookAttr


# --- default_decorators (reference default_decorators.py): utility
# decorators some external configs import directly -------------------


def wrap_name_default(prefix=None, name_prefix=None):
    """Fill a None `name` kwarg with an auto-generated unique name.
    Names draw from Layer's own per-kind counter namespace so they can
    never collide with auto-named layers (v2/layer.py Layer.__init__)."""
    p = prefix or name_prefix or "layer"

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if kwargs.get("name") is None:
                i = Layer._counters.get(p, 0)
                Layer._counters[p] = i + 1
                kwargs["name"] = "__%s_%d__" % (p, i)
            return fn(*args, **kwargs)

        return wrapper

    return deco


def _wrap_default(key, builtin_factory):
    """Reference default_decorators.wrap_param_default shape: optional
    `param_names` list (defaults to [key]) and `default_factory`
    (called with the decorated function) override the built-in."""

    def outer(param_names=None, default_factory=None, **_ignored):
        names = list(param_names) if isinstance(
            param_names, (list, tuple)
        ) else [key]
        fn = param_names if callable(param_names) else None

        def deco(f):
            import functools

            @functools.wraps(f)
            def wrapper(*args, **kwargs):
                for n in names:
                    if kwargs.get(n) is None:
                        kwargs[n] = (
                            default_factory(f) if default_factory
                            else builtin_factory()
                        )
                return f(*args, **kwargs)

            return wrapper

        return deco(fn) if fn is not None else deco

    return outer


wrap_param_attr_default = _wrap_default("param_attr", lambda: ParamAttr())
wrap_bias_attr_default = _wrap_default("bias_attr", lambda: None)
wrap_act_default = _wrap_default("act", lambda: TanhActivation())
wrap_param_default = _wrap_default("param_attr", lambda: ParamAttr())

__all__ += [
    "Optimizer", "BaseSGDOptimizer", "AdamaxOptimizer",
    "AdaDeltaOptimizer", "DecayedAdaGradOptimizer",
    "BaseRegularization", "L1Regularization", "ModelAverage",
    "BasePoolingType", "SquareRootNPooling", "MaxWithMaskPooling",
    "CudnnMaxPooling", "CudnnAvgPooling", "CudnnAvgInclPadPooling",
    "ParameterAttribute", "HookAttr", "HookAttribute",
    "wrap_name_default", "wrap_param_attr_default",
    "wrap_bias_attr_default", "wrap_act_default", "wrap_param_default",
]


# ---------------------------------------------------------------------
# layer-surface compatibility objects (reference layers.py:155,289,315,
# 393,1836,4203): enumerations and base classes that reference configs
# import by name. The sequence-level enums carry the same wire strings
# the reference config_parser understands ('non-seq'/'seq'); the rest
# are structural parity for isinstance checks and introspection.
# ---------------------------------------------------------------------


class AggregateLevel(object):
    """Which nesting level a sequence aggregation collapses
    (reference layers.py:289)."""

    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    # compatible with previous configuration names
    EACH_TIMESTEP = TO_NO_SEQUENCE
    EACH_SEQUENCE = TO_SEQUENCE


class ExpandLevel(object):
    """Which nesting level an expansion starts from
    (reference layers.py:1836)."""

    FROM_NO_SEQUENCE = AggregateLevel.TO_NO_SEQUENCE
    FROM_SEQUENCE = AggregateLevel.TO_SEQUENCE
    # compatible with previous configuration names
    FROM_TIMESTEP = FROM_NO_SEQUENCE


class LayerType(object):
    """Layer type name constants (reference layers.py:155). This core
    identifies layers by their op graph rather than a type registry, so
    the constants exist for config/introspection compatibility."""

    DATA = "data"
    FC_LAYER = "fc"
    MIXED_LAYER = "mixed"
    LSTMEMORY = "lstmemory"
    GRUMEMORY = "gated_recurrent"
    SEQUENCE_LAST_INSTANCE = "seqlastins"
    SEQUENCE_FIRST_INSTANCE = "seqfirstins"
    SEQUENCE_RESHAPE = "seqreshape"
    POOLING_MAX = "max"
    POOLING_AVG = "average"
    COST = "cost"
    CONV_LAYER = "conv"

    @staticmethod
    def is_layer_type(type_name):
        return isinstance(type_name, str) and bool(type_name)


# wrappers here return v2-layer graph nodes; LayerOutput is the
# reference's name for that node type (layers.py:315)
LayerOutput = Layer


def layer_support(*attrs):
    """Decorator marking which ExtraLayerAttribute fields a wrapper
    honors (reference layers.py:393). Attribute enforcement here happens
    in the wrappers themselves, so the decorator only preserves the
    wrapped function's identity."""

    def decorator(method):
        return method

    return decorator


# V1-compatibility aliases (reference layers.py:1123 print_layer,
# :5353 convex_comb_layer)
print_layer = printer_layer
convex_comb_layer = linear_comb_layer
