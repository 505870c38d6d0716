"""Topology: replay a v2 layer DAG into a fluid Program (counterpart of
paddle_tpu/v2/topology.py; reference python/paddle/v2/topology.py builds
a ModelConfig protobuf). Here the single core is the port's fluid
Program and its Executor: every `_emit_*` lowers onto
paddle_tpu_torch.fluid.layers, so the program matches the JAX package's
op for op."""

from __future__ import annotations

from typing import Dict, List

from .. import fluid
from . import data_type as dt
from .layer import Layer, parse_network

__all__ = ["Topology"]


def _user_attr(pa, default_name):
    """fluid ParamAttr from a legacy user attribute: a user name override
    (the legacy weight-sharing mechanism) plus is_static freezing
    (reference ParameterConfig.is_static — the parameter never updates)."""
    return fluid.ParamAttr(
        name=getattr(pa, "name", None) or default_name,
        trainable=not getattr(pa, "is_static", False),
        update_hook=getattr(pa, "update_hooks", None),
    )


class Topology(object):
    def __init__(self, layers, extra_layers=None):
        if not isinstance(layers, (list, tuple)):
            layers = [layers]
        extra = list(extra_layers or [])
        self.output_layers = list(layers)
        self.extra_layers = extra
        self.order = parse_network(*(list(layers) + extra))

        self.main_program = fluid.Program()
        self.startup_program = fluid.Program()
        self.var_of: Dict[str, object] = {}  # layer name -> fluid Variable
        self._scopes: List[Dict[str, object]] = []  # recurrent sub-scopes
        self._data_layers: List[Layer] = []
        with fluid.program_guard(self.main_program, self.startup_program):
            for node in self.order:
                self.var_of[node.name] = self._emit(node)
        # provider slots bind positionally to data layers in DECLARATION
        # order (reference config_parser input order), not traversal order
        self._data_layers.sort(key=lambda n: getattr(n, "created_at", 0))

    # ------------------------------------------------------------------
    def _var(self, name):
        for scope in reversed(self._scopes):
            if name in scope:
                return scope[name]
        return self.var_of[name]

    def _bind(self, name, var):
        (self._scopes[-1] if self._scopes else self.var_of)[name] = var

    def _in(self, node, i=0):
        return self._var(node.parents[i].name)

    def _ins(self, node):
        return [self._var(p.name) for p in node.parents]

    def _emit(self, node: Layer):
        L = fluid.layers
        a = node.attrs
        if node.kind == "data":
            t = a["type"]
            self._data_layers.append(node)
            lod = 1 if t.seq_type != 0 else 0
            if t.type == dt.DataType.Index:
                shape, dtype = [1], "int64"
            else:
                shape, dtype = [t.dim], "float32"
            return L.data(name=node.name, shape=shape, dtype=dtype,
                          lod_level=lod)
        if node.kind == "fc":
            # deterministic parameter names derived from the layer name
            # (reference convention "___fc_0__.w0") so Parameters re-bind
            # across replays of the same DAG; a user ParamAttr(name=...)
            # overrides them, which is how legacy configs SHARE weights
            # (e.g. sample_trainer_config.conf's 'sharew')
            user = a.get("param_attr")
            user_list = (
                list(user) if isinstance(user, (list, tuple))
                else ([user] if user is not None else [])
            )
            attrs = []
            for i in range(len(node.parents)):
                if i < len(user_list):
                    ua = user_list[i]
                elif len(user_list) == 1:
                    ua = user_list[0]  # single attr broadcasts (reference)
                else:
                    ua = None
                attrs.append(
                    fluid.ParamAttr(
                        name=(getattr(ua, "name", None) if i < len(user_list)
                              else None) or "%s.w%d" % (node.name, i),
                        # legacy is_static: the parameter never updates
                        trainable=not getattr(ua, "is_static", False),
                        update_hook=getattr(ua, "update_hooks", None),
                    )
                )
            bias = a.get("bias_attr")
            if bias is False:
                bias_attr = False
            else:
                bias_attr = _user_attr(bias, node.name + ".wbias")
            return L.fc(input=self._ins(node), size=a["size"], act=a["act"],
                        param_attr=attrs, bias_attr=bias_attr)
        if node.kind == "embedding":
            t = node.parents[0].attrs["type"]
            pa = a.get("param_attr")
            return L.embedding(
                input=self._in(node),
                size=[t.dim, a["size"]],
                # legacy ParamAttr(sparse_update=True) -> SelectedRows
                is_sparse=bool(getattr(pa, "sparse_update", False)),
                param_attr=_user_attr(pa, node.name + ".w0"),
            )
        if node.kind == "concat":
            return L.concat(input=self._ins(node), axis=1)
        if node.kind == "img_conv":
            return L.conv2d(
                input=self._in(node), num_filters=a["num_filters"],
                filter_size=a["filter_size"], stride=a["stride"],
                padding=a["padding"], act=a["act"],
                groups=a.get("groups", 1) or 1,
                param_attr=fluid.ParamAttr(name=node.name + ".w0"),
                bias_attr=(
                    False if not a.get("bias", True)
                    else fluid.ParamAttr(name=node.name + ".wbias")
                ),
            )
        if node.kind == "im_reshape":
            c, h, w = a["shape"]
            return L.reshape(x=self._in(node), shape=[-1, c, h, w])
        if node.kind == "lrn":
            return L.lrn(
                input=self._in(node), n=a["size"], k=1.0,
                alpha=a.get("scale", 1e-4), beta=a.get("power", 0.75),
            )
        if node.kind == "addto":
            out = L.sums(input=self._ins(node))
            act = a.get("act")
            if act:
                out = getattr(L, act)(out)
            return out
        if node.kind == "img_pool":
            return L.pool2d(
                input=self._in(node), pool_size=a["pool_size"],
                pool_stride=a["stride"], pool_padding=a["padding"],
                pool_type=a["pool_type"],
                ceil_mode=a.get("ceil_mode", False),
            )
        if node.kind == "batch_norm":
            return L.batch_norm(input=self._in(node), act=a["act"])
        if node.kind == "lstmemory":
            # v2 semantics: `size` is the hidden width H and the input must
            # be 4H wide (fluid dynamic_lstm's `size` argument is 4H)
            size = a["size"]
            if size is None:
                size = int(self._in(node).shape[1]) // 4
            hidden, _ = L.dynamic_lstm(
                input=self._in(node), size=size * 4,
                is_reverse=a.get("reverse", False),
                param_attr=fluid.ParamAttr(name=node.name + ".w0"),
                bias_attr=fluid.ParamAttr(name=node.name + ".wbias"),
            )
            return hidden
        if node.kind == "gru":
            return L.dynamic_gru(
                input=self._in(node), size=a["size"],
                is_reverse=a.get("reverse", False),
                param_attr=fluid.ParamAttr(name=node.name + ".w0"),
            )
        if node.kind == "seq_pool":
            return L.sequence_pool(input=self._in(node),
                                   pool_type=a["pool_type"])
        if node.kind == "last_seq":
            return L.sequence_last_step(input=self._in(node))
        if node.kind == "first_seq":
            return L.sequence_first_step(input=self._in(node))
        if node.kind == "max_id":
            _, idx = L.topk(self._in(node), k=1)
            return idx
        if node.kind == "classification_cost":
            ins = self._ins(node)
            pred, label = ins[0], ins[1]
            # reference classification_cost = softmax output + CE cost; the
            # DSL's `input` already went through act=Softmax
            cost = L.cross_entropy(input=pred, label=label)
            if a.get("weighted") and len(ins) > 2:
                wgt = ins[2]
                num = L.reduce_sum(L.elementwise_mul(x=cost, y=wgt))
                den = L.reduce_sum(wgt)
                return L.elementwise_div(
                    x=L.reshape(x=num, shape=[1]),
                    y=L.reshape(x=den, shape=[1]),
                )
            return L.mean(x=cost)
        if node.kind == "cross_entropy_cost":
            pred, label = self._ins(node)
            return L.mean(x=L.cross_entropy(input=pred, label=label))
        if node.kind == "mse_cost":
            pred, label = self._ins(node)
            return L.mean(x=L.square_error_cost(input=pred, label=label))
        if node.kind == "dropout":
            return L.dropout(x=self._in(node), dropout_prob=a["rate"])
        if node.kind == "classification_error_evaluator":
            pred, label = self._ins(node)
            acc = L.accuracy(input=pred, label=label,
                             k=a.get("top_k", 1) or 1)
            one = L.fill_constant(shape=[1], dtype="float32", value=1.0)
            return L.elementwise_sub(x=one, y=acc)  # error = 1 - accuracy
        if node.kind == "auc_evaluator":
            pred, label = self._ins(node)
            return L.auc(input=pred, label=label)
        if node.kind == "sum_evaluator":
            return L.reduce_sum(self._in(node))
        if node.kind == "column_sum_evaluator":
            return L.reduce_sum(self._in(node), dim=0)
        if node.kind == "mixed":
            return self._emit_mixed(node)
        if node.kind == "recurrent_group":
            return self._emit_recurrent_group(node)
        if node.kind == "beam_gen":
            return self._emit_beam_gen(node)
        if node.kind in _BREADTH_EMITTERS:
            return _BREADTH_EMITTERS[node.kind](self, node)
        if node.kind == "seq_expand":
            x, y = self._ins(node)
            return L.sequence_expand(x, y)
        if node.kind == "eos":
            # 1.0 where the id equals eos_id (reference EosIdCheckLayer)
            x = self._in(node)
            eos = L.fill_constant(shape=[1], dtype="int64",
                                  value=a["eos_id"])
            return L.cast(L.equal(x=x, y=eos), "float32")
        raise NotImplementedError("v2 layer kind %r" % node.kind)

    # ------------------------------------------------------------------
    def _width(self, var, node: Layer):
        """Feature width of a layer's output: the fluid var's static last
        dim when known, else derived from the DSL node (many tmp vars
        carry no static shape)."""
        if getattr(var, "shape", None):
            d = var.shape[-1]
            if d is not None and int(d) > 0:
                return int(d)
        w = self._node_width(node)
        if w is None:
            raise ValueError(
                "cannot determine feature width of layer %r (%s)"
                % (node.name, node.kind)
            )
        return w

    def _node_width(self, node: Layer):
        a = node.attrs
        if node.kind in ("fc", "embedding", "mixed"):
            return int(a["size"])
        if node.kind in ("lstmemory", "gru"):
            return int(a["size"]) if a.get("size") else None
        if node.kind == "data":
            return int(a["type"].dim)
        if node.kind == "rg_memory":
            if a.get("size"):
                return int(a["size"])
            boot = getattr(node, "_boot_layer", None)
            return self._node_width(boot) if boot is not None else None
        if node.kind == "rg_gen_in":
            return int(a["size"])
        if node.kind in ("lstm_step", "gru_step"):
            if a.get("size"):
                return int(a["size"])
            return self._node_width(node.parents[1])
        if node.kind == "get_output":
            return self._node_width(node.parents[0])
        if node.kind in ("rg_step_in", "rg_static_in"):
            return self._node_width(node._outer)
        if node.parents:
            return self._node_width(node.parents[0])
        return None

    def _as_image(self, var, proj):
        """Reshape a flat [N, C*H*W] var to NCHW for conv projections,
        using the DSL node's image geometry."""
        if var.shape is not None and len(var.shape) == 4:
            return var
        shape = getattr(proj.input, "im_shape", None)
        if shape is None:
            c = proj.attrs.get("num_channels") or 3
            import math as _math

            size = self._node_width(proj.input)
            hw = int(round(_math.sqrt(size // c)))
            shape = (c, hw, hw)
        c, h, w = shape
        return fluid.layers.reshape(x=var, shape=[-1, c, h, w])

    def _emit_mixed(self, node: Layer):
        """mixed_layer = sum of projection outputs (+bias, act) — the
        reference MixedLayer with full_matrix/trans/identity/table/
        context/dotmul/scaling projections (gserver/layers/projections)."""
        L = fluid.layers
        a = node.attrs
        size = int(a["size"])
        terms = []
        for k, proj in enumerate(a["projections"]):
            x = self._var(proj.input.name)
            pa = proj.attrs.get("param_attr")
            pname = getattr(pa, "name", None) or "%s.w%d" % (node.name, k)
            if proj.ptype == "full_matrix":
                in_dim = self._width(x, proj.input)
                w = L.create_parameter([in_dim, size], "float32", attr=pname)
                terms.append(L.mul(x=x, y=w))
            elif proj.ptype == "trans_full_matrix":
                # y = x @ W^T; W is [size, in_dim] — the transposed view of
                # a full_matrix/fc weight, enabling weight sharing
                in_dim = self._width(x, proj.input)
                w = L.create_parameter([size, in_dim], "float32", attr=pname)
                terms.append(L.matmul(x=x, y=w, transpose_y=True))
            elif proj.ptype == "identity":
                off = proj.attrs.get("offset")
                if off is not None:
                    psize = proj.attrs.get("size") or size
                    terms.append(
                        L.slice(x, axes=[1], starts=[off], ends=[off + psize])
                    )
                else:
                    terms.append(x)
            elif proj.ptype == "table":
                t = proj.input.attrs.get("type")
                dict_dim = t.dim if t is not None else self._width(x, proj.input)
                terms.append(L.embedding(
                    input=x, size=[dict_dim, size],
                    param_attr=fluid.ParamAttr(name=pname),
                ))
            elif proj.ptype == "context":
                cl = int(proj.attrs["context_len"])
                cs = proj.attrs.get("context_start")
                terms.append(L.sequence_context(
                    input=x, context_length=cl,
                    context_start=-(cl // 2) if cs is None else int(cs),
                ))
            elif proj.ptype == "dotmul":
                in_dim = self._width(x, proj.input)
                w = L.create_parameter([in_dim], "float32", attr=pname)
                terms.append(L.elementwise_mul(x=x, y=w))
            elif proj.ptype == "scaling":
                w = L.create_parameter([1], "float32", attr=pname)
                terms.append(L.elementwise_mul(x=x, y=w))
            elif proj.ptype == "slice":
                parts = [
                    L.slice(x, axes=[1], starts=[a], ends=[b])
                    for a, b in proj.attrs["slices"]
                ]
                terms.append(
                    parts[0] if len(parts) == 1
                    else L.concat(input=parts, axis=1)
                )
            elif proj.ptype == "conv_proj":
                # learned-filter conv inside mixed (reference
                # ConvProjection): output flattened to [N, C*H*W] so it
                # sums with the other projection terms
                nf = int(proj.attrs["num_filters"])
                x = self._as_image(x, proj)
                conv = L.conv2d(
                    input=x, num_filters=nf,
                    filter_size=proj.attrs["filter_size"],
                    stride=proj.attrs.get("stride", 1),
                    padding=proj.attrs.get("padding", 0),
                    groups=proj.attrs.get("groups", 1) or 1,
                    param_attr=fluid.ParamAttr(name=pname),
                    bias_attr=False,
                )
                terms.append(L.reshape(x=conv, shape=[0, -1]))
            elif proj.ptype == "conv_op":
                # dynamic-filter conv (reference ConvOperator): the
                # filter layer's (first-row) values ARE the weights
                f = self._var(proj.extra_inputs[0].name)
                nf = int(proj.attrs["num_filters"])
                fs = int(proj.attrs["filter_size"])
                x = self._as_image(x, proj)
                nc = proj.attrs.get("num_channels") or int(x.shape[1])
                w = L.reshape(
                    x=L.slice(f, axes=[0], starts=[0], ends=[1]),
                    shape=[nf, nc, fs, fs],
                )
                helper = fluid.layer_helper.LayerHelper("conv2d")
                ov = helper.create_tmp_variable("float32")
                helper.append_op(
                    type="conv2d",
                    inputs={"Input": [x], "Filter": [w]},
                    outputs={"Output": [ov]},
                    attrs={
                        "strides": [proj.attrs.get("stride", 1)] * 2,
                        "paddings": [proj.attrs.get("padding", 0)] * 2,
                        "dilations": [1, 1], "groups": 1,
                    },
                )
                terms.append(L.reshape(x=ov, shape=[0, -1]))
            elif proj.ptype == "dotmul_op":
                b = self._var(proj.extra_inputs[0].name)
                term = L.elementwise_mul(x=x, y=b)
                sc = proj.attrs.get("scale", 1.0)
                if sc != 1.0:
                    term = L.scale(x=term, scale=sc)
                terms.append(term)
            else:
                raise NotImplementedError("projection %r" % proj.ptype)
        out = terms[0] if len(terms) == 1 else L.sums(input=terms)
        if a.get("bias_attr") not in (None, False):
            b = L.create_parameter(
                [size], "float32", attr=node.name + ".wbias", is_bias=True
            )
            out = L.elementwise_add(x=out, y=b)
        act = a.get("act")
        if act:
            out = getattr(L, act)(out)
        return out

    # ------------------------------------------------------------------
    def _emit_beam_gen(self, node: Layer):
        """Legacy beam_search generation (reference
        RecurrentGradientMachine::generateSequence:307/beamSearch:309):
        lowered to the fluid While + beam_search + beam_search_decode
        machinery, which the executor runs as a host-counted loop that
        stops once every beam has ended (core/kernels_control.py). The step replays per iteration with
        the GeneratedInput placeholder bound to the embedding of the
        previous step's selected words and StaticInputs expanded to the
        live beam width. Returns the decoded sentence-id layer
        (reference default output "__beam_search_predict__"); when
        num_results_per_sample < beam_size the decode keeps each
        source's top-n rows by cumulative score."""
        from .layer import parse_network

        L = fluid.layers
        a = node.attrs
        if a["mems"]:
            raise NotImplementedError(
                "beam_search step functions with memory() are not "
                "supported yet; carry state through the generated words"
            )
        gen = a["gen"]
        placeholders = a["placeholders"]
        statics = a["static_phs"]
        if statics:
            anchor = self._var(statics[0]._outer.name)
        else:
            raise ValueError(
                "beam_search needs at least one StaticInput to size the "
                "generation batch (reference: a Memory must have a boot "
                "layer when generating)"
            )

        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("beam_gen")
        init_ids = helper.create_tmp_variable(dtype="int64")
        init_scores = helper.create_tmp_variable(dtype="float32")
        helper.append_op(
            type="beam_init", inputs={"X": [anchor]},
            outputs={"Ids": [init_ids], "Scores": [init_scores]},
            attrs={"bos_id": a["bos_id"]},
        )

        max_len = L.fill_constant(shape=[1], dtype="int64",
                                  value=a["max_length"])
        counter = L.zeros(shape=[1], dtype="int64", force_cpu=True)
        ids_array = L.create_array("int64")
        scores_array = L.create_array("float32")
        L.array_write(init_ids, array=ids_array, i=counter)
        L.array_write(init_scores, array=scores_array, i=counter)

        cond = L.less_than(x=counter, y=max_len)
        while_op = L.While(cond=cond)
        ph_ids = {id(p) for p in placeholders}
        with while_op.block():
            pre_ids = L.array_read(array=ids_array, i=counter)
            pre_score = L.array_read(array=scores_array, i=counter)
            emb = L.embedding(
                input=pre_ids,
                size=[gen.size, gen.embedding_size],
                param_attr=fluid.ParamAttr(name=gen.embedding_name),
            )
            local: Dict[str, object] = {}
            self._scopes.append(local)
            try:
                for ph in placeholders:
                    if ph.kind == "rg_gen_in":
                        local[ph.name] = emb
                    else:  # static: expand to the live beam width
                        local[ph.name] = L.sequence_expand(
                            self._var(ph._outer.name), pre_score
                        )
                for sub in parse_network(a["step_out"]):
                    if id(sub) in ph_ids or sub.name in local:
                        continue
                    local[sub.name] = self._emit(sub)
                out_var = local[a["step_out"].name]
            finally:
                self._scopes.pop()
            # topk width: twice the beam, capped at the vocab size
            k = min(int(gen.size), 2 * a["beam_size"])
            topk_scores, topk_idx = L.topk(out_var, k=k)
            selected_ids, selected_scores = L.beam_search(
                pre_ids, topk_idx, topk_scores, a["beam_size"],
                end_id=a["eos_id"],
            )
            L.increment(x=counter, value=1, in_place=True)
            L.array_write(selected_ids, array=ids_array, i=counter)
            L.array_write(selected_scores, array=scores_array, i=counter)
            L.less_than(x=counter, y=max_len, cond=cond)

        sentence_ids, sentence_scores = L.beam_search_decode(
            ids=ids_array, scores=scores_array,
            beam_width=a["beam_size"],
            num_results_per_sample=a.get("num_results_per_sample", 0),
        )
        self._bind(node.name + ".scores", sentence_scores)
        return sentence_ids  # carries .lens_name for per-row true lengths

    # ------------------------------------------------------------------
    def _emit_recurrent_group(self, node: Layer):
        """recurrent_group -> fluid DynamicRNN: the step sub-DAG replays
        inside rnn.block() with placeholders bound to step/static inputs
        and memory() nodes to rnn.memory() (reference
        RecurrentGradientMachine; here the port's DynamicRNN,
        kernels_control)."""
        from .layer import parse_network

        L = fluid.layers
        a = node.attrs
        step_out = a["step_out"]
        placeholders = a["placeholders"]
        mems = a["mems"]
        reverse = bool(a.get("reverse"))

        rnn = L.DynamicRNN()
        ph_ids = {id(p) for p in placeholders} | {id(m) for m in mems}
        # outer-block vars resolved (and, for a reversed group,
        # time-flipped) BEFORE entering the step sub-block: a reversed
        # group = forward scan over the flipped sequences, output
        # un-flipped below (reference RecurrentLayer reversed_=true
        # walks t = len-1 .. 0)
        outer_vars = {}
        for ph in placeholders:
            outer = self._var(ph._outer.name)
            if reverse and ph.kind == "rg_step_in":
                outer = L.sequence_reverse(outer)
            outer_vars[id(ph)] = outer
        with rnn.block():
            local: Dict[str, object] = {}
            self._scopes.append(local)
            try:
                for ph in placeholders:
                    outer = outer_vars[id(ph)]
                    if ph.kind == "rg_step_in":
                        local[ph.name] = rnn.step_input(outer)
                    else:
                        local[ph.name] = rnn.static_input(outer)
                mem_pre = {}
                for m in mems:
                    boot = m.attrs.get("boot_name")
                    if boot is not None:
                        pre = rnn.memory(init=self._var(boot))
                    else:
                        size = m.attrs.get("size")
                        if size is None:
                            # reference RecurrentLayer: the state is as
                            # wide as the step input
                            seq_phs = [
                                p for p in placeholders
                                if p.kind == "rg_step_in"
                            ]
                            size = self._node_width(seq_phs[0])
                        pre = rnn.memory(shape=[int(size)], value=0.0)
                    local[m.name] = pre
                    mem_pre[m.attrs["ref_name"]] = pre
                # replay the step sub-DAG (placeholders/memories
                # excluded), PLUS any side-effect node that closes a
                # memory cycle without being on the output path (e.g.
                # get_output_layer of an lstm_step's cell)
                mem_closers = [
                    n for n in node.attrs.get("step_nodes", [])
                    if n.name in mem_pre
                ]
                targets = [step_out] + mem_closers
                for sub in parse_network(*targets):
                    if id(sub) in ph_ids or sub.name in local:
                        continue
                    local[sub.name] = self._emit(sub)
                    if sub.name in mem_pre:
                        rnn.update_memory(mem_pre[sub.name], local[sub.name])
                rnn.output(local[step_out.name])
            finally:
                self._scopes.pop()
        out = rnn()
        if reverse:
            out = L.sequence_reverse(out)
        return out

    # ------------------------------------------------------------------
    def data_layers(self) -> Dict[str, Layer]:
        return {n.name: n for n in self._data_layers}

    def data_type(self):
        return [(n.name, n.attrs["type"]) for n in self._data_layers]

    def get_layer_proto(self, name):
        return None


# ---------------------------------------------------------------------------
# breadth-wrapper lowerings (trainer_config_helpers breadth layers; each a
# thin mapping onto fluid layers/kernels — reference layers.py semantics)
# ---------------------------------------------------------------------------


def _L():
    return fluid.layers


def _act_apply(out, act):
    return getattr(_L(), act)(out) if act else out


def _emit_cos_sim(t, node):
    a, b = t._ins(node)
    out = _L().cos_sim(X=a, Y=b)
    s = node.attrs.get("scale", 1.0)
    return _L().scale(x=out, scale=float(s)) if s != 1.0 else out


def _emit_trans(t, node):
    return _L().transpose(t._in(node), [1, 0])


def _emit_power(t, node):
    x, w = t._ins(node)
    return _L().elementwise_pow(x=x, y=w)


def _emit_scaling(t, node):
    x, w = t._ins(node)
    return _L().elementwise_mul(x=x, y=w)


def _emit_interpolation(t, node):
    a, b, w = t._ins(node)
    one_minus_w = _L().scale(x=w, scale=-1.0, bias=1.0)
    wa = _L().elementwise_mul(x=a, y=w)
    wb = _L().elementwise_mul(x=b, y=one_minus_w)
    return _L().elementwise_add(x=wa, y=wb)


def _emit_slope_intercept(t, node):
    return _L().scale(x=t._in(node), scale=node.attrs["slope"],
                      bias=node.attrs["intercept"])


def _emit_sum_to_one_norm(t, node):
    x = t._in(node)
    s = _L().reduce_sum(x, dim=1, keep_dim=True)
    return _L().elementwise_div(x=x, y=s)


def _emit_row_l2_norm(t, node):
    return _L().l2_normalize(x=t._in(node), axis=1)


def _emit_dot_prod(t, node):
    a, b = t._ins(node)
    return _L().reduce_sum(_L().elementwise_mul(x=a, y=b), dim=1,
                           keep_dim=True)


def _emit_out_prod(t, node):
    a, b = t._ins(node)
    da = t._width(a, node.parents[0])
    db = t._width(b, node.parents[1])
    a3 = _L().reshape(x=a, shape=[-1, da, 1])
    b3 = _L().reshape(x=b, shape=[-1, 1, db])
    return _L().reshape(x=_L().elementwise_mul(x=a3, y=b3),
                        shape=[-1, da * db])


def _emit_l2_distance(t, node):
    a, b = t._ins(node)
    d = _L().elementwise_sub(x=a, y=b)
    return _L().sqrt(_L().reduce_sum(_L().square(d), dim=1, keep_dim=True))


def _emit_pad_img(t, node):
    a = node.attrs
    x = t._in(node)  # [N, C, H, W]
    pads = [0, 0] + list(a["pad_c"]) + list(a["pad_h"]) + list(a["pad_w"])
    return _L().pad(x=x, paddings=pads)


def _emit_clip(t, node):
    return _L().clip(x=t._in(node), min=node.attrs["min"],
                     max=node.attrs["max"])


def _emit_multiplex(t, node):
    ins = t._ins(node)
    return _L().multiplex(inputs=ins[1:], index=ins[0])


def _emit_row_conv(t, node):
    # legacy context_len counts the current step + lookahead; fluid's
    # future_context_size counts lookahead only
    out = _L().row_conv(input=t._in(node),
                        future_context_size=node.attrs["context_len"] - 1)
    return _act_apply(out, node.attrs.get("act"))


def _emit_maxout(t, node):
    return _L().maxout(x=t._in(node), groups=node.attrs["groups"])


def _emit_block_expand(t, node):
    a = node.attrs
    return _L().im2sequence(
        input=t._in(node), filter_size=a["block"], stride=a["stride"],
        padding=a["padding"],
    )


def _emit_seq_reshape(t, node):
    return _L().sequence_reshape(input=t._in(node),
                                 new_dim=node.attrs["new_dim"])


def _emit_repeat(t, node):
    return _L().expand(x=t._in(node),
                       expand_times=[1, node.attrs["num_repeats"]])


def _emit_recurrent_step(t, node):
    """Inner step of recurrent_layer: act(x_t + W h_prev)."""
    x, h = t._ins(node)
    width = t._width(x, node.parents[0])
    pa = node.attrs.get("param_attr")
    pname = getattr(pa, "name", None) or node.name + ".w0"
    w = _L().create_parameter([width, width], "float32", attr=pname)
    out = _L().elementwise_add(x=x, y=_L().mul(x=h, y=w))
    return _act_apply(out, node.attrs.get("act"))


def _emit_ctc_cost(t, node):
    pred, label = t._ins(node)
    cost = _L().warpctc(input=pred, label=label,
                        blank=node.attrs["blank"],
                        norm_by_times=node.attrs.get("norm_by_times", False))
    return _L().mean(x=cost)


def _emit_crf_cost(t, node):
    pred, label = t._ins(node)
    pa = node.attrs.get("param_attr")
    attr = _user_attr(pa, node.name + ".w0")
    cost = _L().linear_chain_crf(input=pred, label=label, param_attr=attr)
    return _L().mean(x=cost)


def _emit_crf_decode(t, node):
    pred = t._in(node)
    pa = node.attrs.get("param_attr")
    pname = getattr(pa, "name", None) or node.name + ".w0"
    blk = fluid.default_main_program().global_block()
    if not blk.has_var(pname):
        # standalone decode (legacy crf_decoding_layer creates its own
        # transition parameter): [size+2, size] like linear_chain_crf
        size = t._width(pred, node.parents[0])
        _L().create_parameter([size + 2, size], "float32", attr=pname)
    return _L().crf_decoding(input=pred, param_attr=fluid.ParamAttr(name=pname))


def _emit_nce_cost(t, node):
    L = _L()
    ins = t._ins(node)
    weighted = node.attrs.get("weighted")
    sample_weight = ins[-1] if weighted else None
    label = ins[-2] if weighted else ins[-1]
    feats = ins[:-2] if weighted else ins[:-1]
    # multi-input NCE: separate per-input weight matrices in the
    # reference sum into one concatenated feature (same math)
    x = feats[0] if len(feats) == 1 else L.concat(input=feats, axis=1)
    cost = L.nce(input=x, label=label,
                 num_total_classes=node.attrs["num_classes"],
                 num_neg_samples=node.attrs["num_neg_samples"],
                 sample_weight=sample_weight,
                 neg_distribution=node.attrs.get("neg_distribution"))
    if weighted:
        # same convention as weighted classification_cost:
        # sum(w * cost_i) / sum(w) — the kernel already applied w
        den = L.reduce_sum(sample_weight)
        return L.elementwise_div(
            x=L.reshape(x=L.reduce_sum(cost), shape=[1]),
            y=L.reshape(x=den, shape=[1]),
        )
    return L.mean(x=cost)


def _emit_hsigmoid_cost(t, node):
    ins = t._ins(node)
    cost = _L().hsigmoid(input=ins[0], label=ins[-1],
                         num_classes=node.attrs["num_classes"])
    return _L().mean(x=cost)


def _emit_rank_cost(t, node):
    from ..fluid.layer_helper import LayerHelper

    left, right, label = t._ins(node)
    helper = LayerHelper("rank_loss")
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="rank_loss",
        inputs={"Left": [left], "Right": [right], "Label": [label]},
        outputs={"Out": [out]},
    )
    return _L().mean(x=out)


def _emit_huber_cost(t, node):
    from ..fluid.layer_helper import LayerHelper

    x, y = t._ins(node)
    helper = LayerHelper("huber_loss")
    out = helper.create_tmp_variable(dtype="float32")
    resid = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="huber_loss",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out], "Residual": [resid]},
        attrs={"delta": node.attrs["delta"]},
    )
    return _L().mean(x=out)


def _emit_multi_binary_ce(t, node):
    # the legacy layer takes already-sigmoid-activated PROBABILITIES
    # (reference multi_binary_label_cross_entropy docs) — plain BCE
    p, label = t._ins(node)
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("log_loss")
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="log_loss",
        inputs={"Predicted": [p], "Labels": [label]},
        outputs={"Loss": [out]},
    )
    return _L().mean(x=out)


def _emit_smooth_l1_cost(t, node):
    x, y = t._ins(node)
    return _L().mean(x=_L().smooth_l1(x=x, y=y))


def _emit_sum_cost(t, node):
    return _L().reduce_sum(t._in(node))


def _emit_scale_shift(t, node):
    x = t._in(node)
    pa = node.attrs.get("param_attr")
    w = _L().create_parameter(
        [1], "float32",
        attr=getattr(pa, "name", None) or node.name + ".w0",
        default_initializer=fluid.initializer.Constant(1.0),
    )
    ba = node.attrs.get("bias_attr")
    b = _L().create_parameter(
        [1], "float32",
        attr=getattr(ba, "name", None) or node.name + ".wbias",
        is_bias=True,
    )
    return _L().elementwise_add(x=_L().elementwise_mul(x=x, y=w), y=b)


def _emit_elem_mul(t, node):
    a, b = t._ins(node)
    return _L().elementwise_mul(x=a, y=b)


_BREADTH_EMITTERS = {
    "cos_sim": _emit_cos_sim,
    "trans": _emit_trans,
    "power": _emit_power,
    "scaling": _emit_scaling,
    "interpolation": _emit_interpolation,
    "slope_intercept": _emit_slope_intercept,
    "sum_to_one_norm": _emit_sum_to_one_norm,
    "row_l2_norm": _emit_row_l2_norm,
    "dot_prod": _emit_dot_prod,
    "out_prod": _emit_out_prod,
    "l2_distance": _emit_l2_distance,
    "pad_img": _emit_pad_img,
    "clip": _emit_clip,
    "multiplex": _emit_multiplex,
    "row_conv": _emit_row_conv,
    "maxout": _emit_maxout,
    "block_expand": _emit_block_expand,
    "seq_reshape": _emit_seq_reshape,
    "repeat": _emit_repeat,
    "recurrent_step": _emit_recurrent_step,
    "ctc_cost": _emit_ctc_cost,
    "crf_cost": _emit_crf_cost,
    "crf_decode": _emit_crf_decode,
    "nce_cost": _emit_nce_cost,
    "hsigmoid_cost": _emit_hsigmoid_cost,
    "rank_cost": _emit_rank_cost,
    "huber_cost": _emit_huber_cost,
    "multi_binary_ce": _emit_multi_binary_ce,
    "smooth_l1_cost": _emit_smooth_l1_cost,
    "sum_cost": _emit_sum_cost,
    "scale_shift": _emit_scale_shift,
    "elem_mul": _emit_elem_mul,
}


def _emit_sampling_id(t, node):
    return _L().sampling_id(t._in(node))


def _emit_bilinear_interp(t, node):
    return _L().bilinear_interp(t._in(node), out_h=node.attrs["out_h"],
                                out_w=node.attrs["out_w"])


def _emit_conv_shift(t, node):
    a, b = t._ins(node)
    return _L().conv_shift(x=a, y=b)


def _emit_switch_order(t, node):
    c, h, w = node.attrs["shape"]
    out = _L().transpose(t._in(node), [0, 2, 3, 1])  # NCHW -> NHWC
    return _L().reshape(x=out, shape=[-1, h * w * c])


def _emit_spp(t, node):
    c, h, w = node.attrs["im_shape"]
    ptype = node.attrs["pool_type"]
    flats = []
    for level in range(int(node.attrs["pyramid_height"])):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)  # ceil
        pooled = _L().pool2d(
            input=t._in(node), pool_size=[kh, kw],
            pool_stride=[kh, kw], pool_type=ptype, ceil_mode=True,
        )
        # ceil-mode pooling yields ceil(h/kh) x ceil(w/kw) bins — equal to
        # bins x bins only when 2^level tiles the map (the common SPP
        # geometry); size the flat from the ACTUAL output
        obh, obw = -(-h // kh), -(-w // kw)
        flats.append(_L().reshape(x=pooled, shape=[-1, c * obh * obw]))
    return flats[0] if len(flats) == 1 else _L().concat(input=flats, axis=1)


def _emit_factorization_machine(t, node):
    x = t._in(node)
    in_dim = t._width(x, node.parents[0])
    f = int(node.attrs["factor_size"])
    pa = node.attrs.get("param_attr")
    v = _L().create_parameter(
        [in_dim, f], "float32",
        attr=getattr(pa, "name", None) or node.name + ".w0",
    )
    xv = _L().mul(x=x, y=v)                       # [N, F]
    x2v2 = _L().mul(x=_L().square(x), y=_L().square(v))
    diff = _L().elementwise_sub(x=_L().square(xv), y=x2v2)
    return _L().scale(x=_L().reduce_sum(diff, dim=1, keep_dim=True),
                      scale=0.5)


def _emit_huber_cls_cost(t, node):
    x, label = t._ins(node)
    # labels in {0,1} -> y in {-1,+1}; margin m = y*x
    y = _L().scale(x=_L().cast(label, "float32"), scale=2.0, bias=-1.0)
    m = _L().elementwise_mul(x=x, y=y)
    # piecewise: m>=1 -> 0; |m|<1 -> (1-m)^2; m<=-1 -> -4m
    # == clip(1-m, 0, 2)^2 + 4*clip(-1-m, 0, inf)
    t1 = _L().clip(x=_L().scale(x=m, scale=-1.0, bias=1.0), min=0.0, max=2.0)
    t2 = _L().clip(x=_L().scale(x=m, scale=-1.0, bias=-1.0), min=0.0,
                   max=3.4e38)
    loss = _L().elementwise_add(x=_L().square(t1),
                                y=_L().scale(x=t2, scale=4.0))
    return _L().mean(x=loss)


_BREADTH_EMITTERS.update({
    "sampling_id": _emit_sampling_id,
    "bilinear_interp": _emit_bilinear_interp,
    "conv_shift": _emit_conv_shift,
    "switch_order": _emit_switch_order,
    "spp": _emit_spp,
    "factorization_machine": _emit_factorization_machine,
    "huber_cls_cost": _emit_huber_cls_cost,
})


def _emit_seq_slice(t, node):
    x = t._in(node)
    a = node.attrs
    L = _L()
    if not a["has_ends"]:
        raise NotImplementedError(
            "seq_slice_layer without ends=: pass explicit end indices"
        )
    idx = 1
    if a["has_starts"]:
        starts = L.cast(t._var(node.parents[idx].name), "int32")
        idx += 1
        ends = L.cast(t._var(node.parents[idx].name), "int32")
    else:
        # begin of each sequence: a per-SEQUENCE zeros tensor, shaped
        # like `ends` (one row per sequence, not per token)
        ends = L.cast(t._var(node.parents[idx].name), "int32")
        starts = L.scale(x=ends, scale=0.0)
    length = L.elementwise_sub(x=ends, y=starts)
    return L.sequence_slice(input=x, offset=starts, length=length)


def _emit_sub_seq(t, node):
    x, offsets, sizes = t._ins(node)
    L = _L()
    return L.sequence_slice(input=x, offset=L.cast(offsets, "int32"),
                            length=L.cast(sizes, "int32"))


def _emit_lstm_step(t, node):
    x, c_prev = t._ins(node)
    from ..fluid.layer_helper import LayerHelper

    H = t._width(c_prev, node.parents[1])
    helper = LayerHelper("lstm_unit")
    c = helper.create_tmp_variable(dtype="float32", shape=(-1, H))
    h = helper.create_tmp_variable(dtype="float32", shape=(-1, H))
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [x], "C_prev": [c_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": 0.0},
    )
    t._bind(node.name + "@out_state", c)
    return h


def _emit_gru_step(t, node):
    x, h_prev = t._ins(node)
    size = node.attrs.get("size") or t._width(h_prev, node.parents[1])
    pa = node.attrs.get("param_attr")
    # the existing fluid gru_unit wrapper creates weight + bias + outputs
    # (reference GruStepLayer includes the gate bias)
    ba = node.attrs.get("bias_attr")
    hidden, _, _ = _L().gru_unit(
        input=x, hidden=h_prev, size=3 * int(size),
        param_attr=_user_attr(pa, node.name + ".w0"),
        bias_attr=_user_attr(ba, node.name + ".wbias"),
    )
    return hidden


def _emit_get_output(t, node):
    return t._var(node.parents[0].name + "@out_state")


def _emit_tensor(t, node):
    a, b = t._ins(node)
    da = t._width(a, node.parents[0])
    db = t._width(b, node.parents[1])
    k = int(node.attrs["size"])
    pa = node.attrs.get("param_attr")
    w = _L().create_parameter(
        [da, k * db], "float32",
        attr=getattr(pa, "name", None) or node.name + ".w0",
    )
    aw = _L().reshape(x=_L().mul(x=a, y=w), shape=[-1, k, db])  # [N,K,db]
    b3 = _L().reshape(x=b, shape=[-1, 1, db])
    out = _L().reduce_sum(_L().elementwise_mul(x=aw, y=b3), dim=2)
    act = node.attrs.get("act")
    return _act_apply(out, act)


_BREADTH_EMITTERS.update({
    "seq_slice": _emit_seq_slice,
    "sub_seq": _emit_sub_seq,
    "lstm_step": _emit_lstm_step,
    "gru_step": _emit_gru_step,
    "get_output": _emit_get_output,
    "tensor": _emit_tensor,
})


def _emit_identity(t, node):
    return t._in(node)


def _emit_resize(t, node):
    return _L().reshape(x=t._in(node), shape=[-1, node.attrs["size"]])


def _emit_rotate(t, node):
    # reference RotateLayer is CLOCKWISE: out(c, H-1-r) = in(r, c) —
    # transpose H/W then flip the (new) W axis
    out = _L().transpose(t._in(node), [0, 1, 3, 2])
    return _L().reverse(out, axis=[3])


def _emit_cross_channel_norm(t, node):
    x = t._in(node)
    c = int(node.attrs["channels"])
    pa = node.attrs.get("param_attr")
    scale = _L().create_parameter(
        [1, c, 1, 1], "float32",
        attr=getattr(pa, "name", None) or node.name + ".w0",
        default_initializer=fluid.initializer.Constant(1.0),
    )
    sq = _L().reduce_sum(_L().square(x), dim=1, keep_dim=True)
    norm = _L().sqrt(_L().scale(x=sq, scale=1.0, bias=1e-10))
    return _L().elementwise_mul(x=_L().elementwise_div(x=x, y=norm),
                                y=scale)


_BREADTH_EMITTERS.update({
    "identity": _emit_identity,
    "resize": _emit_resize,
    "rotate": _emit_rotate,
    "cross_channel_norm": _emit_cross_channel_norm,
})


# ---------------------------------------------------------------------
# breadth round 5 emitters: detection, 3-D conv/pool, image geometry,
# ranking/beam costs (reference gserver PriorBoxLayer, MultiBoxLossLayer,
# DetectionOutputLayer, ROIPoolLayer, CropLayer, PReluLayer,
# Conv3DLayer, Pool3DLayer, ConvexCombinationLayer, KmaxSeqScoreLayer,
# SubNestedSequenceLayer, CostLayer.cpp LambdaCost /
# MultiClassCrossEntropyWithSelfNorm, CrossEntropyOverBeam.cpp)
# ---------------------------------------------------------------------


def _emit_crop(t, node):
    x = t._in(node)
    a = node.attrs
    if a["shape"] is None:
        raise NotImplementedError("crop_layer needs an explicit shape")
    axis = int(a["axis"])
    shape = [int(s) for s in x.shape]
    offs = [0] * len(shape)
    for k, (o, s) in enumerate(zip(a["offset"], a["shape"])):
        if axis + k < len(shape):
            offs[axis + k] = int(o)
            shape[axis + k] = int(s)
    # batch axis: crop nothing (dynamic N) — kernel slices by python ints,
    # so pass the traced dim through as the full extent
    shape[0] = -1
    return _L().crop(x, shape=shape, offsets=offs)


def _emit_prelu(t, node):
    pa = node.attrs.get("param_attr")
    return _L().prelu(
        t._in(node), mode=node.attrs["mode"],
        param_attr=_user_attr(pa, node.name + ".w0"),
    )


def _emit_priorbox(t, node):
    feat = t._var(node.parents[0].name)
    img = t._var(node.parents[1].name)
    if img.shape is None or len(img.shape) != 4:
        c, h, w = node.parents[1].im_shape
        img = _L().reshape(x=img, shape=[-1, c, h, w])
    a = node.attrs
    boxes, variances = fluid.layers.prior_box(
        input=feat, image=img, min_sizes=a["min_size"],
        max_sizes=a["max_size"] or None,
        aspect_ratios=a["aspect_ratio"], variance=a["variance"],
        flip=True, clip=True,
    )
    L = _L()
    # [H, W, P, 4] anchor grid -> flat [M, 4], matching the loc/conf
    # head flattening order (NHWC -> [N, H*W*P, ...])
    boxes = L.reshape(x=boxes, shape=[-1, 4])
    variances = L.reshape(x=variances, shape=[-1, 4])
    t._bind(node.name + "@var", variances)
    return boxes


def _ssd_heads(t, node):
    """Gather loc/conf conv features into [N, P, 4] and [N, P, C]."""
    L = _L()
    a = node.attrs
    n_loc = a["n_loc"]
    locs = [t._var(p.name) for p in node.parents[:n_loc]]
    confs = [t._var(p.name) for p in node.parents[n_loc:2 * n_loc]]
    C = int(a["num_classes"])

    def flat(vs, width):
        parts = []
        for v in vs:
            nhwc = L.transpose(v, [0, 2, 3, 1])
            parts.append(L.reshape(x=nhwc, shape=[0, -1, width]))
        return parts[0] if len(parts) == 1 else L.concat(input=parts, axis=1)

    return flat(locs, 4), flat(confs, C)


def _emit_detection_output(t, node):
    L = _L()
    a = node.attrs
    loc, conf = _ssd_heads(t, node)
    priors = t._var(node.parents[-1].name)
    variances = t._var(node.parents[-1].name + "@var")
    scores = L.transpose(L.softmax(conf), [0, 2, 1])  # [N, C, P]
    return fluid.layers.detection_output(
        scores=scores, loc=loc, prior_box=priors, prior_box_var=variances,
        background_label=a["background_id"],
        nms_threshold=a["nms_threshold"], nms_top_k=a["nms_top_k"],
        keep_top_k=a["keep_top_k"],
        score_threshold=a["confidence_threshold"],
    )


def _emit_multibox_loss(t, node):
    L = _L()
    a = node.attrs
    loc, conf = _ssd_heads(t, node)
    priors = t._var(node.parents[-2].name)
    variances = t._var(node.parents[-2].name + "@var")
    label = t._var(node.parents[-1].name)
    # label rows: [class, xmin, ymin, xmax, ymax(, difficult)]
    gt_label = L.lod_reset(
        L.cast(L.slice(label, axes=[1], starts=[0], ends=[1]), "int64"),
        y=label,
    )
    gt_box = L.lod_reset(
        L.slice(label, axes=[1], starts=[1], ends=[5]), y=label
    )
    cost = fluid.layers.ssd_loss(
        location=loc, confidence=conf, gt_box=gt_box, gt_label=gt_label,
        prior_box=priors, prior_box_var=variances,
        overlap_threshold=a["overlap_threshold"],
        neg_pos_ratio=a["neg_pos_ratio"], neg_overlap=a["neg_overlap"],
        background_label=a["background_id"],
    )
    return L.mean(x=cost)


def _emit_roi_pool(t, node):
    a = node.attrs
    return _L().roi_pool(
        t._var(node.parents[0].name), t._var(node.parents[1].name),
        pooled_height=a["pooled_height"], pooled_width=a["pooled_width"],
        spatial_scale=a["spatial_scale"],
    )


def _emit_scale_sub_region(t, node):
    x = t._var(node.parents[0].name)
    idx = _L().cast(t._var(node.parents[1].name), "int32")
    return _L().scale_sub_region(x, idx, node.attrs["value"])


def _emit_vol_reshape(t, node):
    c, d, h, w = node.attrs["shape"]
    return _L().reshape(x=t._in(node), shape=[-1, c, d, h, w])


def _emit_img_conv3d(t, node):
    a = node.attrs
    pa = a.get("param_attr")
    return _L().conv3d(
        input=t._in(node), num_filters=a["num_filters"],
        filter_size=a["filter_size"], stride=a["stride"],
        padding=a["padding"], groups=a.get("groups", 1) or 1,
        act=a["act"],
        param_attr=_user_attr(pa, node.name + ".w0"),
        bias_attr=(
            False if not a.get("bias", True)
            else fluid.ParamAttr(name=node.name + ".wbias")
        ),
    )


def _emit_img_pool3d(t, node):
    a = node.attrs
    return _L().pool3d(
        input=t._in(node), pool_size=a["pool_size"],
        pool_type=a["pool_type"], pool_stride=a["stride"],
        pool_padding=a["padding"], ceil_mode=a.get("ceil_mode", True),
    )


def _emit_linear_comb(t, node):
    L = _L()
    w, v = t._ins(node)
    zdim = t._width(w, node.parents[0])
    full = t._width(v, node.parents[1])
    size = node.attrs.get("size") or full // zdim
    v3 = L.reshape(x=v, shape=[-1, zdim, size])
    w3 = L.reshape(x=w, shape=[-1, zdim, 1])
    return L.reshape(
        x=L.reduce_sum(L.elementwise_mul(x=v3, y=w3), dim=1),
        shape=[-1, size],
    )


def _emit_kmax_seq_score(t, node):
    return _L().kmax_sequence_score(
        t._in(node), beam_size=node.attrs["beam_size"]
    )


def _emit_sub_nested_seq(t, node):
    x = t._var(node.parents[0].name)
    sel = _L().cast(t._var(node.parents[1].name), "int32")
    return _L().sub_nested_seq(x, sel)


def _emit_lambda_cost(t, node):
    score, label = t._ins(node)
    return _L().lambda_rank_cost(
        score, label, ndcg_num=node.attrs["NDCG_num"]
    )


def _emit_ce_selfnorm(t, node):
    L = _L()
    x, label = t._ins(node)
    a = node.attrs
    z = L.reduce_sum(x, dim=1, keep_dim=True)
    logz = L.log(z)
    cost = L.elementwise_add(
        x=L.cross_entropy(input=x, label=label),
        y=L.elementwise_add(
            x=logz, y=L.scale(x=L.square(logz), scale=a["alpha"])
        ),
    )
    if a.get("coeff", 1.0) != 1.0:
        cost = L.scale(x=cost, scale=a["coeff"])
    return L.mean(x=cost)


def _emit_ce_over_beam(t, node):
    L = _L()
    helper = fluid.layer_helper.LayerHelper("cross_entropy_over_beam")
    scores = [t._var(p.name) for p in node.parents[0::2]]
    golds = [
        L.cast(t._var(p.name), "int32") for p in node.parents[1::2]
    ]
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="cross_entropy_over_beam",
        inputs={"Scores": scores, "Gold": golds},
        outputs={"Out": [out]},
    )
    return L.mean(x=out)


_BREADTH_EMITTERS.update({
    "crop": _emit_crop,
    "prelu": _emit_prelu,
    "priorbox": _emit_priorbox,
    "detection_output": _emit_detection_output,
    "multibox_loss": _emit_multibox_loss,
    "roi_pool": _emit_roi_pool,
    "scale_sub_region": _emit_scale_sub_region,
    "vol_reshape": _emit_vol_reshape,
    "img_conv3d": _emit_img_conv3d,
    "img_pool3d": _emit_img_pool3d,
    "linear_comb": _emit_linear_comb,
    "kmax_seq_score": _emit_kmax_seq_score,
    "sub_nested_seq": _emit_sub_nested_seq,
    "lambda_cost": _emit_lambda_cost,
    "ce_selfnorm": _emit_ce_selfnorm,
    "ce_over_beam": _emit_ce_over_beam,
})


# ---------------------------------------------------------------------
# evaluator emitters (reference trainer_config_helpers/evaluators.py;
# DSL wrappers in trainer_config_helpers/evaluators.py here)
# ---------------------------------------------------------------------


def _emit_precision_recall_eval(t, node):
    L = _L()
    pred, label = t._ins(node)
    n_cls = t._width(pred, node.parents[0])
    _, idx = L.topk(pred, k=1)
    # batch metrics = [macro-P, macro-R, macro-F1, micro-P, micro-R,
    # micro-F1]; per-class counts ride the states tensor [C, (tp,fp,tn,fn)]
    batch_m, _, states = fluid.layers.precision_recall(
        input=L.cast(idx, "int64"), label=L.cast(label, "int64"),
        class_number=n_cls,
    )
    pos = node.attrs.get("positive_label")
    if pos is None:
        return L.slice(batch_m, axes=[0], starts=[2], ends=[3])
    row = L.slice(states, axes=[0], starts=[int(pos)],
                  ends=[int(pos) + 1])
    tp = L.slice(row, axes=[1], starts=[0], ends=[1])
    fp = L.slice(row, axes=[1], starts=[1], ends=[2])
    fn = L.slice(row, axes=[1], starts=[3], ends=[4])
    denom = L.sums(input=[L.scale(x=tp, scale=2.0), fp, fn])
    eps = L.fill_constant(shape=[1], dtype="float32", value=1e-12)
    return L.elementwise_div(
        x=L.scale(x=tp, scale=2.0),
        y=L.elementwise_max(x=L.reshape(x=denom, shape=[1]), y=eps),
    )


def _emit_pnpair_eval(t, node):
    helper = fluid.layer_helper.LayerHelper("pnpair_eval")
    vars_ = [t._var(p.name) for p in node.parents]
    inputs = {"Score": [vars_[0]], "Label": [vars_[1]],
              "QueryID": [vars_[2]]}
    if len(vars_) > 3:
        inputs["Weight"] = [vars_[3]]
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="pnpair_eval", inputs=inputs, outputs={"Out": [out]},
    )
    return out


def _emit_ctc_error_eval(t, node):
    L = _L()
    pred, label = t._ins(node)
    n_cls = t._width(pred, node.parents[0])
    decoded = L.ctc_greedy_decoder(pred, blank=n_cls - 1)
    dist, _ = L.edit_distance(decoded, label, normalized=True)
    return L.mean(x=dist)


def _emit_chunk_eval(t, node):
    L = _L()
    pred, label = t._ins(node)
    a = node.attrs
    # prediction may be per-class scores: reduce to tag ids
    w = t._width(pred, node.parents[0])
    if w and w > 1:
        _, idx = L.topk(pred, k=1)
        pred = L.cast(idx, "int64")
    _, _, f1, _, _, _ = fluid.layers.chunk_eval(
        input=pred, label=label, chunk_scheme=a["chunk_scheme"],
        num_chunk_types=a["num_chunk_types"],
        excluded_chunk_types=a.get("excluded_chunk_types"),
    )
    return f1


def _emit_detection_map_eval(t, node):
    L = _L()
    det = t._var(node.parents[0].name)
    label = t._var(node.parents[1].name)
    a = node.attrs
    n_cls = a.get("num_classes")
    if not n_cls:
        n_cls = node.parents[0].attrs.get("num_classes")
    gt_label = L.lod_reset(
        L.cast(L.slice(label, axes=[1], starts=[0], ends=[1]), "int64"),
        y=label,
    )
    gt_box = L.lod_reset(
        L.slice(label, axes=[1], starts=[1], ends=[5]), y=label
    )
    inputs = {"Detection": [det], "GTBox": [gt_box],
              "GTLabel": [gt_label]}
    width = t._node_width(node.parents[1])
    if width and width >= 6:  # [class, x1, y1, x2, y2, difficult]
        inputs["GTDifficult"] = [
            L.slice(label, axes=[1], starts=[5], ends=[6])
        ]
    helper = fluid.layer_helper.LayerHelper("detection_map")
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="detection_map",
        inputs=inputs,
        outputs={"MAP": [out]},
        attrs={
            "overlap_threshold": a.get("overlap_threshold", 0.5),
            "num_classes": int(n_cls),
            "background_id": int(a.get("background_id", 0)),
        },
    )
    return out


def _emit_maxid_printer(t, node):
    _, idx = _L().topk(t._in(node), k=1)
    return idx


_BREADTH_EMITTERS.update({
    "precision_recall_evaluator": _emit_precision_recall_eval,
    "pnpair_evaluator": _emit_pnpair_eval,
    "ctc_error_evaluator": _emit_ctc_error_eval,
    "chunk_evaluator": _emit_chunk_eval,
    "detection_map_evaluator": _emit_detection_map_eval,
    "maxid_printer": _emit_maxid_printer,
})
