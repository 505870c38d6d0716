"""v2 layer DSL (reference python/paddle/v2/layer.py wrapping
trainer_config_helpers/layers.py's 137 layer functions).

The reference builds a ModelConfig protobuf interpreted by the C++
GradientMachine; here each DSL call records a lazy graph node and
`topology.Topology` (used by parameters.create / trainer.SGD) replays the
node DAG into a fluid Program — one modern core under both API surfaces
(SURVEY.md §7.1)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from . import activation as act_mod
from . import data_type as dt

__all__ = [
    "data",
    "fc",
    "embedding",
    "concat",
    "img_conv",
    "img_pool",
    "batch_norm",
    "lstmemory",
    "simple_lstm",
    "gru",
    "pooling",
    "last_seq",
    "first_seq",
    "max_id",
    "classification_cost",
    "cross_entropy_cost",
    "mse_cost",
    "regression_cost",
    "dropout",
    "Layer",
    "parse_network",
]


class Layer(object):
    """A lazy DSL node. `name` is stable (auto-generated per type) so
    parameters and feeds can address it."""

    _counters: Dict[str, int] = {}
    _seq = 0  # global creation order (legacy provider slots bind to data
    #           layers by DECLARATION order, not graph-traversal order)

    def __init__(self, kind: str, name: Optional[str], parents: List["Layer"],
                 attrs: Dict[str, Any]):
        self.kind = kind
        if name is None:
            i = Layer._counters.get(kind, 0)
            Layer._counters[kind] = i + 1
            name = "__%s_%d__" % (kind, i)
        self.name = name
        self.parents = parents
        self.attrs = attrs
        Layer._seq += 1
        self.created_at = Layer._seq
        if Layer._registry is not None:
            Layer._registry[self.name] = self
        if Layer._step_nodes is not None:
            Layer._step_nodes.append(self)

    # when not None, every created node is recorded by name — the legacy
    # config path (trainer_config_helpers.reset_config) uses this so
    # Outputs("layer_name") can resolve names to nodes
    _registry: Optional[Dict[str, "Layer"]] = None
    # when not None, created nodes are ALSO appended here — used by
    # recurrent_group to capture side-effect nodes of a step function
    # (e.g. a get_output_layer that closes a memory cycle but is not on
    # the path to the step output)
    _step_nodes: Optional[List["Layer"]] = None

    def __repr__(self):
        return "v2.Layer(%s, %r)" % (self.kind, self.name)


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _act_name(act):
    if act is None:
        return None
    if isinstance(act, type):
        act = act()
    return act.name


def data(name, type, **kwargs):
    return Layer("data", name, [], {"type": type})


def fc(input, size, act=None, param_attr=None, bias_attr=None, name=None,
       layer_attr=None, **kwargs):
    return Layer("fc", name, _as_list(input), {
        "size": size, "act": _act_name(act), "param_attr": param_attr,
        "bias_attr": bias_attr,
    })


def embedding(input, size, param_attr=None, name=None, **kwargs):
    return Layer("embedding", name, _as_list(input), {
        "size": size, "param_attr": param_attr,
    })


def concat(input, name=None, **kwargs):
    return Layer("concat", name, _as_list(input), {})


def img_conv(input, filter_size, num_filters, num_channels=None, stride=1,
             padding=0, act=None, bias_attr=None, param_attr=None, name=None,
             **kwargs):
    return Layer("img_conv", name, _as_list(input), {
        "filter_size": filter_size, "num_filters": num_filters,
        "num_channels": num_channels, "stride": stride, "padding": padding,
        "act": _act_name(act),
    })


def img_pool(input, pool_size, stride=1, padding=0, pool_type=None, name=None,
             **kwargs):
    ptype = "max"
    if pool_type is not None:
        ptype = getattr(pool_type, "name", str(pool_type)).lower()
        ptype = "avg" if "avg" in ptype else "max"
    return Layer("img_pool", name, _as_list(input), {
        "pool_size": pool_size, "stride": stride, "padding": padding,
        "pool_type": ptype,
    })


def batch_norm(input, act=None, name=None, **kwargs):
    return Layer("batch_norm", name, _as_list(input), {"act": _act_name(act)})


def lstmemory(input, size=None, reverse=False, act=None, name=None, **kwargs):
    return Layer("lstmemory", name, _as_list(input), {
        "size": size, "reverse": reverse,
    })


def simple_lstm(input, size, name=None, **kwargs):
    """fc(4*size) + lstmemory (reference trainer_config_helpers
    simple_lstm). `size` is the hidden width H throughout the DSL."""
    f = fc(input=input, size=size * 4, name=None)
    return Layer("lstmemory", name, [f], {"size": size, "reverse": False})


def gru(input, size, reverse=False, name=None, **kwargs):
    return Layer("gru", name, _as_list(input), {"size": size, "reverse": reverse})


def pooling(input, pooling_type=None, name=None, **kwargs):
    ptype = "max"
    if pooling_type is not None:
        n = type(pooling_type).__name__.lower() if not isinstance(
            pooling_type, str) else pooling_type.lower()
        for cand in ("max", "avg", "sum", "sqrt"):
            if cand in n:
                ptype = cand
    return Layer("seq_pool", name, _as_list(input), {"pool_type": ptype})


def last_seq(input, name=None, **kwargs):
    return Layer("last_seq", name, _as_list(input), {})


def first_seq(input, name=None, **kwargs):
    return Layer("first_seq", name, _as_list(input), {})


def max_id(input, name=None, **kwargs):
    return Layer("max_id", name, _as_list(input), {})


def classification_cost(input, label, name=None, **kwargs):
    return Layer("classification_cost", name, [input, label], {})


def cross_entropy_cost(input, label, name=None, **kwargs):
    return Layer("cross_entropy_cost", name, [input, label], {})


def mse_cost(input, label, name=None, **kwargs):
    return Layer("mse_cost", name, [input, label], {})


regression_cost = mse_cost


def dropout(input, dropout_rate, name=None, **kwargs):
    return Layer("dropout", name, _as_list(input), {"rate": dropout_rate})


def parse_network(*outputs):
    """Topological node order covering `outputs` (reference layer.py
    parse_network returns the pruned ModelConfig)."""
    seen: Dict[int, Layer] = {}
    order: List[Layer] = []

    def visit(node: Layer):
        if id(node) in seen:
            return
        seen[id(node)] = node
        for p in node.parents:
            visit(p)
        order.append(node)

    for o in outputs:
        visit(o)
    return order
