"""v2 layer namespace. Counterpart of ``paddle_tpu/v2/layer.py``
(reference python/paddle/v2/layer.py re-exporting
trainer_config_helpers/layers.py): keyword-style layer functions
(input=, size=, act=activation.Relu()) over the port's ``layers``
package. Each function documents the v1 DSL name it serves.

Where the port lacks what a layer function needs, it raises
``NotImplementedError`` naming the ROADMAP item that ports it: the 21
``legacy_ops`` layers but ``addto``, and ``hsigmoid`` (item 8);
``sequence_concat``, ``sequence_expand`` and ``warpctc`` (item 3); an op
it appends that the port's registry lacks (the item named in
``_OP_ITEMS``). Each works as it is once what it needs lands. The v1
step-level recurrent DSL (``recurrent_group``, ``memory``,
``StaticInput``, ``GeneratedInput``, ``gru_step_layer``,
``lstm_step_layer``) is re-exported from ``v1.helpers``.
"""
from __future__ import annotations

from .. import layers as L
from ..core.registry import has_op
from . import activation as _act
from . import pooling as _pool
from .data_type import InputType


def _missing(what, item):
    raise NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet; see ROADMAP.md "
        f"Queue 1 item {item}")


def _layer(name, item):
    """``layers.<name>``, or a stand-in that raises naming ROADMAP
    ``item`` while the port lacks it."""
    fn = getattr(L, name, None)
    if fn is not None:
        return fn
    return lambda *a, **kw: _missing(f"layers.{name}", item)


# ops the layer functions below append that the port's registry may lack,
# by the ROADMAP item that ports them
_OP_ITEMS = {"conv3d": 2, "pool3d": 2, "im2sequence": 2, "spp": 2,
             "roi_pool": 2, "detection_output": 2, "conv_shift": 8,
             "nce": 8, "cross_entropy_with_selfnorm": 8, "lambda_cost": 8,
             "sub_seq": 8, "switch_order": 8, "scale_sub_region": 8,
             "sequence_mask": 3}


def _need_op(op_type):
    if not has_op(op_type):
        _missing(f"the {op_type!r} op", _OP_ITEMS.get(op_type, 8))


def data(name, type: InputType, **kw):
    """data_layer. ``type`` is a data_type.* declaration; sequence types
    become padded+length feeds (lod_level=1). For integer types the dim is
    the VALUE RANGE (vocab/class count) — the tensor itself is one id per
    (sequence) position, exactly the reference's InputType contract. The
    declaration rides on the returned handle (``.input_type``) so downstream
    layer functions (embedding, fc-over-sparse) can read the vocab/width
    from the graph, as the reference's config_parser propagates
    LayerConfig input sizes (python/paddle/trainer/config_parser.py)."""
    if type.sparse:
        # padded active-id list + length mask (+ values for sparse_float)
        var = L.data(name, shape=[1], dtype="int64", lod_level=1)
        if type.sparse == "float":
            val = L.data(f"{name}@val", shape=[-1], dtype="float32",
                         append_batch_size=False)
            val.is_companion = True
            var.sparse_values = val
        var.input_type = type
        return var
    width = 1 if type.dtype == "int64" else type.dim
    var = L.data(name, shape=[width], dtype=type.dtype,
                 lod_level=1 if type.seq_type else 0)
    var.input_type = type
    return var


def _sparse_fc_branch(inp, size, param_attr):
    """One fc branch over a sparse id-list input: the sum of the weight
    rows of the active ids (weighted by their values for a float input),
    which is the multi-hot row @ W fed O(nnz). Its embedding keeps a
    dense gradient, as the JAX package builds it."""
    t = inp.input_type
    emb = L.embedding(inp, size=[t.dim, size], param_attr=param_attr)
    emb.seq_len = inp.seq_len
    values = getattr(inp, "sparse_values", None)
    if values is not None:
        emb = L.elementwise_mul(emb, L.reshape(values, shape=[0, -1, 1]))
        emb.seq_len = inp.seq_len
    return L.sequence_pool(emb, "sum")


def _is_sparse(v):
    t = getattr(v, "input_type", None)
    return t is not None and t.sparse


def _fc_flatten_dims(inputs):
    """The v1 fc_layer contract, PER INPUT: a [b, T, d] sequence input is
    transformed per timestep (reference fc_layer applied inside the time
    loop); a static image tensor is flattened whole. Per-timestep
    whenever an input carries sequence-ness or a dynamic inner dim that
    would poison the flattened fan-in with the -1 sentinel."""
    nfds = []
    for v in inputs:
        shape = v.shape or ()
        if len(shape) > 2 and (getattr(v, "seq_len", None) is not None
                               or getattr(getattr(v, "input_type", None),
                                          "seq_type", 0)
                               or -1 in shape[1:-1]):
            nfds.append(len(shape) - 1)
        else:
            nfds.append(1)
    return nfds


def fc(input, size, act=None, param_attr=None, bias_attr=None, **kw):
    """fc_layer. ``input`` may be a list (each gets its own weight); sparse
    id-list inputs route through the embedding-sum path. The bias (one per
    fc, reference fc_layer contract) is carried by the dense sub-fc when
    one exists, else created here so sparse-only fcs keep their bias."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    sparse = [v for v in inputs if _is_sparse(v)]
    dense = [v for v in inputs if not _is_sparse(v)]
    if not sparse:
        r = L.fc(input, size=size, act=_act.resolve(act),
                 param_attr=param_attr, bias_attr=bias_attr,
                 num_flatten_dims=_fc_flatten_dims(inputs))
        sl = next((getattr(v, "seq_len", None) for v in inputs
                   if getattr(v, "seq_len", None) is not None), None)
        if sl is not None and len(r.shape) >= 2:
            r.seq_len = sl
        return r
    from ..layers.layer_helper import LayerHelper

    branches = [_sparse_fc_branch(v, size, param_attr) for v in sparse]
    if dense:
        # the dense sub-fc owns the (single) bias
        branches.append(L.fc(dense, size=size, act=None,
                             param_attr=param_attr, bias_attr=bias_attr))
        return _layer("addto", 8)(branches, act=_act.resolve(act))
    summed = _layer("addto", 8)(branches, act=None)
    helper = LayerHelper("fc")
    if bias_attr is not False:
        summed = helper.append_bias_op(summed, bias_attr, size, dim_start=1)
    return helper.append_activation(summed, _act.resolve(act))


def embedding(input, size, param_attr=None, **kw):
    """embedding_layer: size is the embedding dim; the vocab comes from the
    upstream data layer's InputType.dim (v1 DSL contract), overridable with
    an explicit ``vocab_size`` kwarg."""
    vocab = kw.get("vocab_size")
    if vocab is None:
        t = getattr(input, "input_type", None)
        if t is not None:
            vocab = t.dim
    if vocab is None:
        raise ValueError(
            "embedding(): the input does not carry an InputType to read the "
            "vocab from (it is not a data layer); pass vocab_size=...")
    return L.embedding(input, size=[vocab, size], param_attr=param_attr)


def img_conv(input, filter_size, num_filters, num_channels=None, stride=1,
             padding=0, groups=1, act=None, param_attr=None, bias_attr=None,
             data_format="NHWC", **kw):
    """img_conv_layer."""
    return L.conv2d(input, num_filters=num_filters, filter_size=filter_size,
                    stride=stride, padding=padding, groups=groups,
                    act=_act.resolve(act), param_attr=param_attr,
                    bias_attr=bias_attr, data_format=data_format)


def img_pool(input, pool_size, stride=1, padding=0, pool_type=None,
             ceil_mode=True, data_format="NHWC", **kw):
    """img_pool_layer. ``ceil_mode`` defaults True — the v1 DSL's output
    size rule (reference trainer_config_helpers/layers.py img_pool_layer
    ceil_mode=True)."""
    return L.pool2d(input, pool_size=pool_size, pool_stride=stride,
                    pool_padding=padding,
                    pool_type=_pool.resolve(pool_type),
                    ceil_mode=ceil_mode, data_format=data_format)


def batch_norm(input, act=None, **kw):
    """batch_norm_layer."""
    return L.batch_norm(input, act=_act.resolve(act),
                        data_layout=kw.get("data_format", "NHWC"),
                        is_test=kw.get("is_test", False))


def dropout_keep_len(var, rate):
    """Dropout that preserves the sequence-length annotation (dropout is
    shape-preserving, so the mask survives)."""
    sl = getattr(var, "seq_len", None)
    var = dropout(var, rate)
    if sl is not None:
        var.seq_len = sl
    return var


def dropout(input, dropout_rate=0.5, **kw):
    """dropout_layer."""
    return L.dropout(input, dropout_prob=dropout_rate)


def concat(input, **kw):
    """concat_layer (feature axis)."""
    return L.concat(list(input), axis=-1)


def addto(input, act=None, bias_attr=None, **kw):
    """addto_layer."""
    return _layer("addto", 8)(list(input), act=_act.resolve(act))


def lstmemory(input, size=None, reverse=False, act=None, **kw):
    """lstmemory: input must be the 4x-projected sequence, as in the v1
    DSL (pair with fc(size=4*hidden, act=Linear()) or use
    networks.simple_lstm). ``size`` is the HIDDEN width (projected/4)."""
    proj = int(input.shape[-1])
    if size is not None and proj != 4 * size:
        raise ValueError(
            f"lstmemory(size={size}) expects a {4 * size}-wide projected "
            f"input, got {proj} (v1 DSL contract)")
    h, _ = L.dynamic_lstm(input, proj, is_reverse=reverse)
    return h


def grumemory(input, size=None, reverse=False, **kw):
    """grumemory: input is the 3x-projected sequence."""
    if size is None:
        size = int(input.shape[-1]) // 3
    return L.dynamic_gru(input, size, is_reverse=reverse)


def pooling(input, pooling_type=None, **kw):
    """pooling_layer over the sequence axis."""
    return L.sequence_pool(input, _pool.resolve(pooling_type))


def first_seq(input, **kw):
    return L.sequence_first_step(input)


def last_seq(input, **kw):
    return L.sequence_last_step(input)


def expand(input, expand_as, **kw):
    """expand_layer."""
    return _layer("sequence_expand", 3)(input, expand_as)


def max_id(input, **kw):
    """maxid_layer."""
    return L.argmax(input, axis=-1)


def crf(input, label, size=None, param_attr=None, **kw):
    """crf_layer: per-sequence negative log-likelihood [b, 1]; the
    transition parameter rides on ``.transition`` for crf_decoding."""
    return L.linear_chain_crf(input, label, param_attr=param_attr)


def crf_decoding(input, size=None, param_attr=None, label=None,
                 transition=None, **kw):
    """crf_decoding_layer. Pass ``transition=cost.transition`` from the
    crf() cost so Viterbi uses the TRAINED transitions."""
    return L.crf_decoding(input, param_attr=param_attr, label=label,
                          transition=transition)


def ctc(input, label, blank=0, **kw):
    """ctc_layer / warp_ctc_layer."""
    return _layer("warpctc", 3)(input, label, blank=blank)


# ---- cost layers (CostLayer.cpp family) --------------------------------
def classification_cost(input, label, **kw):
    """classification_cost: softmax cross-entropy over class scores."""
    return L.mean(L.softmax_with_cross_entropy(input, label))


def cross_entropy_cost(input, label, **kw):
    return L.mean(L.cross_entropy(input, label))


def square_error_cost(input, label, **kw):
    """regression_cost."""
    return L.mean(L.square_error_cost(input, label))


def rank_cost(left, right, label, **kw):
    """rank_cost (RankingCost): pairwise logistic loss."""
    diff = L.elementwise_sub(left, right)
    return L.mean(L.log(L.elementwise_add(
        L.exp(L.elementwise_mul(L.scale(label, -2.0, bias=1.0), diff)),
        L.fill_constant(shape=[1], value=1.0, dtype="float32"))))


def huber_regression_cost(input, label, delta=1.0, **kw):
    """huber_regression_cost (HuberRegressionLoss, CostLayer.cpp)."""
    from ..layers.layer_helper import LayerHelper

    h = LayerHelper("huber_cost")
    outs, _ = h.append_op("huber_loss", {"X": [input], "Y": [label]},
                          ["Out", "Residual"], {"delta": float(delta)})
    return L.mean(outs["Out"][0])


# ---------------------------------------------------------------------------
# mixed_layer + projections (reference trainer_config_helpers/layers.py
# mixed_layer, *_projection: a mixed layer sums the projected inputs, then
# bias + activation — MixedLayer.cpp. Projections are deferred;
# mixed_layer(input=[...]) is the immediate form, `with mixed_layer(...)
# as m: m += proj` the incremental one.)
# ---------------------------------------------------------------------------

class BaseProjection:
    def __init__(self, input, param_attr=None):
        self.input = input
        self.param_attr = param_attr

    def build(self, size):
        raise NotImplementedError


class full_matrix_projection(BaseProjection):
    """input @ W, no bias (FullMatrixProjection.cpp)."""

    def __init__(self, input, size=0, param_attr=None):
        super().__init__(input, param_attr)

    def build(self, size):
        # via the v2 fc: per-timestep on sequence inputs (the reference
        # projection operates inside the time loop)
        return fc(self.input, size, act=None,
                  param_attr=self.param_attr, bias_attr=False)


class trans_full_matrix_projection(BaseProjection):
    """input @ W^T — the weight is stored [size, in] and shared with a
    forward projection by name (TransposedFullMatrixProjection.cpp)."""

    def __init__(self, input, size=0, param_attr=None):
        super().__init__(input, param_attr)

    def build(self, size):
        from ..layers.layer_helper import LayerHelper

        helper = LayerHelper("trans_fc")
        d = int(self.input.shape[-1])
        w = helper.create_parameter(self.param_attr, shape=[size, d],
                                    dtype=self.input.dtype)
        return L.matmul(self.input, L.transpose(w, axis=[1, 0]))


class table_projection(BaseProjection):
    """Embedding-table lookup of integer input (TableProjection.cpp)."""

    def __init__(self, input, size=0, param_attr=None):
        super().__init__(input, param_attr)

    def build(self, size):
        return embedding(self.input, size, param_attr=self.param_attr)


class identity_projection(BaseProjection):
    """Pass-through, or a feature slice when offset is given
    (IdentityProjection.cpp / IdentityOffsetProjection.cpp)."""

    def __init__(self, input, offset=None, size=None):
        super().__init__(input)
        self.offset = offset
        self.size = size

    def build(self, size):
        if self.offset is None:
            return self.input
        end = self.offset + (self.size or size)
        from ..layers.layer_helper import LayerHelper

        helper = LayerHelper("identity_offset")
        rank = len(self.input.shape)
        return helper.simple_op(
            "slice", {"X": [self.input]},
            {"axes": [rank - 1], "starts": [int(self.offset)],
             "ends": [int(end)]})


class scaling_projection(BaseProjection):
    """w * input with a single learned scalar (ScalingProjection.cpp)."""

    def build(self, size):
        from ..layers.layer_helper import LayerHelper

        helper = LayerHelper("scaling_projection")
        w = helper.create_parameter(self.param_attr, shape=[1],
                                    dtype=self.input.dtype)
        return L.elementwise_mul(self.input, w)


class dotmul_projection(BaseProjection):
    """input .* w with a learned per-feature vector (DotMulProjection)."""

    def build(self, size):
        from ..layers.layer_helper import LayerHelper

        helper = LayerHelper("dotmul_projection")
        d = int(self.input.shape[-1])
        w = helper.create_parameter(self.param_attr, shape=[d],
                                    dtype=self.input.dtype)
        return L.elementwise_mul(self.input, w)


class context_projection(BaseProjection):
    """Neighbour-window concat over the time axis (ContextProjection.cpp);
    trainable out-of-range padding is not supported (rows are zeros)."""

    def __init__(self, input, context_len, context_start=None, **kw):
        super().__init__(input)
        self.context_len = int(context_len)
        self.context_start = (-(self.context_len // 2)
                              if context_start is None else
                              int(context_start))

    def build(self, size):
        from ..layers.layer_helper import LayerHelper
        from ..layers.sequence import _len_input

        helper = LayerHelper("context_project")
        out = helper.simple_op(
            "context_project",
            {"X": [self.input], **_len_input(self.input)},
            {"context_length": self.context_len,
             "context_start": self.context_start})
        sl = getattr(self.input, "seq_len", None)
        if sl is not None:
            out.seq_len = sl
        return out


class MixedLayerType:
    """What mixed_layer() returns: collects projections via ``+=`` inside
    a ``with`` block; at exit it BECOMES the built output variable (the
    instance adopts the Variable's class/state), so the reference idiom
    of using the mixed object as a layer input works unchanged."""

    def __init__(self, size, act=None, bias_attr=False, drop_rate=0.0):
        self._size = size
        self._act = act
        self._bias_attr = bias_attr
        self._drop_rate = drop_rate
        self._projections = []

    def __iadd__(self, proj):
        if not isinstance(proj, BaseProjection):
            raise TypeError(f"mixed_layer += expects a projection, got "
                            f"{type(proj).__name__}")
        self._projections.append(proj)
        return self

    def __enter__(self):
        return self

    def _finalize(self):
        var = _build_mixed(self._projections, self._size, self._act,
                           self._bias_attr)
        if self._drop_rate:
            var = dropout_keep_len(var, self._drop_rate)
        # adopt the Variable's identity: everything downstream reads
        # name/shape/block from the shared state
        self.__class__ = var.__class__
        self.__dict__ = var.__dict__
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._finalize()
        return False


def _build_mixed(projections, size, act, bias_attr):
    if not projections:
        raise ValueError("mixed_layer has no projections")
    from ..layers.layer_helper import LayerHelper

    built = [p.build(size) for p in projections]
    widths = {int(v.shape[-1]) for v in built}
    if len(widths) > 1:
        raise ValueError(
            f"mixed_layer projections disagree on width: {sorted(widths)}")
    summed = built[0] if len(built) == 1 else L.sums(built)
    helper = LayerHelper("mixed")
    out_size = widths.pop()
    if bias_attr is not False:
        summed = helper.append_bias_op(summed, bias_attr, out_size,
                                       dim_start=len(summed.shape) - 1)
    result = helper.append_activation(summed, _act.resolve(act))
    sl = next((getattr(v, "seq_len", None) for v in built
               if getattr(v, "seq_len", None) is not None), None)
    if sl is not None:
        result.seq_len = sl
    return result


def mixed_layer(size=0, input=None, act=None, bias_attr=False,
                drop_rate=0.0, **kw):
    """mixed_layer: immediate form returns the Variable; without input,
    a context manager collecting ``+=`` projections. NO bias unless
    bias_attr is given — the reference decorates mixed_layer with
    wrap_bias_attr_default(has_bias=False) (layers.py:865)."""
    if input is not None:
        projs = input if isinstance(input, (list, tuple)) else [input]
        var = _build_mixed(list(projs), size, act, bias_attr)
        if drop_rate:
            var = dropout_keep_len(var, drop_rate)
        return var
    return MixedLayerType(size, act=act, bias_attr=bias_attr,
                          drop_rate=drop_rate)


mixed = mixed_layer


# ---------------------------------------------------------------------------
# v1 layer-name tail: thin keyword adapters over the fluid layer fns
# (reference trainer_config_helpers/layers.py names; math in
# layers/legacy.py and the op registry)
# ---------------------------------------------------------------------------

def cos_sim(a, b, scale=1.0, **kw):
    """cos_sim layer (CosSimLayer.cpp); ``scale`` multiplies the cosine."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("cos_sim")
    outs, _ = helper.append_op("cos_sim", {"X": [a], "Y": [b]},
                               ["Out", "XNorm", "YNorm"], {})
    sim = outs["Out"][0]
    return L.scale(sim, float(scale)) if scale != 1.0 else sim


def trans(input, **kw):
    """trans_layer: transpose the two feature dims (TransLayer.cpp)."""
    return L.transpose(input, axis=[0, 2, 1])


def interpolation(input, weight, **kw):
    """interpolation_layer: w*x + (1-w)*y (InterpolationLayer.cpp)."""
    x, y = input
    return _layer("interpolation", 8)(x, y, weight)


def power(input, weight, **kw):
    return _layer("power", 8)(input, weight)


def scaling(input, weight, **kw):
    return _layer("scaling", 8)(input, weight)


def slope_intercept(input, slope=1.0, intercept=0.0, **kw):
    return _layer("slope_intercept", 8)(input, slope=slope,
                                        intercept=intercept)


def sum_to_one_norm(input, **kw):
    return _layer("sum_to_one_norm", 8)(input)


def row_l2_norm(input, **kw):
    return _layer("row_l2_norm", 8)(input)


def scale_shift(input, param_attr=None, bias_attr=None, **kw):
    return _layer("scale_shift", 8)(input, param_attr=param_attr,
                                    bias_attr=bias_attr)


def linear_comb(weights, vectors, size=None, **kw):
    return _layer("linear_comb", 8)(weights, vectors)


def dot_prod(a, b, **kw):
    return _layer("dot_prod", 8)(a, b)


def out_prod(a, b, **kw):
    return _layer("out_prod", 8)(a, b)


def l2_distance(a, b, **kw):
    return _layer("l2_distance", 8)(a, b)


def repeat(input, num_repeats, as_row_vector=True, **kw):
    return _layer("repeat", 8)(input, num_repeats, as_row_vector=as_row_vector)


def resize(input, size, **kw):
    return _layer("resize", 8)(input, size)


def rotate(input, height, width=None, **kw):
    return _layer("rotate", 8)(input, height, width or height)


def multiplex(input, index, **kw):
    return _layer("multiplex", 8)(list(input), index)


def kmax_seq_score(input, beam_size=1, **kw):
    return _layer("kmax_seq_score", 8)(input, beam_size=beam_size)


def seq_reshape(input, reshape_size, **kw):
    return _layer("sequence_reshape", 8)(input, reshape_size)


def seq_concat(a, b, **kw):
    return _layer("sequence_concat", 3)([a, b])


def sampling_id(input, **kw):
    return _layer("sampling_id", 8)(input)


def factorization_machine(input, factor_size, param_attr=None, **kw):
    return _layer("factorization_machine", 8)(input, factor_size,
                                   param_attr=param_attr)


def gated_unit(input, size, act=None, **kw):
    return _layer("gated_unit", 8)(input, size,
                                   act=_act.resolve(act) or "tanh")


def maxout(input, groups, num_channels=None, **kw):
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("maxout")
    return helper.simple_op("maxout", {"X": [input]}, {"groups": groups})


def prelu(input, param_attr=None, **kw):
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("prelu")
    alpha = helper.create_parameter(
        param_attr, shape=[1], dtype=input.dtype,
        default_initializer=None) if param_attr is not None else None
    if alpha is None:
        from ..initializer import ConstantInitializer
        from ..param_attr import ParamAttr as _PA

        alpha = helper.create_parameter(
            _PA(initializer=ConstantInitializer(0.25)), shape=[1],
            dtype=input.dtype)
    return helper.simple_op("prelu", {"X": [input], "Alpha": [alpha]}, {})


def pad(input, paddings, pad_value=0.0, **kw):
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("pad")
    return helper.simple_op("pad", {"X": [input]},
                            {"paddings": list(paddings),
                             "pad_value": float(pad_value)})


def block_expand(input, block_x=1, block_y=1, stride_x=1, stride_y=1,
                 padding_x=0, padding_y=0, num_channels=None, **kw):
    """block_expand_layer (BlockExpandLayer.cpp -> im2sequence_op)."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("block_expand")
    _need_op("im2sequence")
    return helper.simple_op(
        "im2sequence", {"X": [input]},
        {"kernels": [block_y, block_x], "strides": [stride_y, stride_x],
         "paddings": [padding_y, padding_x, padding_y, padding_x]})


def conv_shift(a, b, **kw):
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("conv_shift")
    _need_op("conv_shift")
    return helper.simple_op("conv_shift", {"X": [a], "Y": [b]}, {})


def sum_cost(input, **kw):
    """sum_cost (SumCostLayer.cpp): plain sum of the input."""
    return L.reduce_sum(input)


def huber_classification_cost(input, label, delta=1.0, **kw):
    """HuberTwoClassification (CostLayer.cpp): labels {0,1} -> y in
    {-1,+1}; loss = max(0, 1-z)^2 where z = y*f for z >= -1, else -4z."""
    y = L.scale(L.cast(label, "float32"), 2.0, bias=-1.0)
    z = L.elementwise_mul(y, input)
    sq = L.square(L.relu(L.scale(z, -1.0, bias=1.0)))
    lin = L.scale(z, -4.0)
    ge = L.cast(L.greater_equal(
        z, L.fill_constant(shape=[1], value=-1.0, dtype="float32")),
        "float32")
    cost = L.elementwise_add(
        L.elementwise_mul(ge, sq),
        L.elementwise_mul(L.scale(ge, -1.0, bias=1.0), lin))
    return L.mean(cost)


def multi_binary_label_cross_entropy(input, label, **kw):
    """multi_binary_label_cross_entropy_layer: per-class sigmoid CE."""
    return L.mean(L.sigmoid_cross_entropy_with_logits(input, label))


def smooth_l1_cost(input, label, **kw):
    """smooth_l1_cost (SmoothL1CostLayer.cpp)."""
    d = L.elementwise_sub(input, label)
    a = L.abs(d)
    lt = L.cast(L.less_than(
        a, L.fill_constant(shape=[1], value=1.0, dtype="float32")),
        "float32")
    quad = L.scale(L.square(d), 0.5)
    lin = L.scale(a, 1.0, bias=-0.5)
    return L.mean(L.elementwise_add(
        L.elementwise_mul(lt, quad),
        L.elementwise_mul(L.scale(lt, -1.0, bias=1.0), lin)))


def nce(input, label, num_classes, num_neg_samples=10, param_attr=None,
        bias_attr=None, **kw):
    """nce_layer (NCELayer.cpp): noise-contrastive estimation cost."""
    from ..layers.layer_helper import LayerHelper

    _need_op("nce")
    helper = LayerHelper("nce")
    d = int(input.shape[-1])
    w = helper.create_parameter(param_attr, shape=[num_classes, d],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[num_classes],
                                dtype=input.dtype, is_bias=True)
    return helper.simple_op(
        "nce", {"Input": [input], "Label": [label], "Weight": [w],
                "Bias": [b]},
        {"num_total_classes": int(num_classes),
         "num_neg_samples": int(num_neg_samples)}, out_slot="Cost")


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             **kw):
    return _layer("hsigmoid", 8)(input, label, num_classes,
                                 param_attr=param_attr,
                                 bias_attr=bias_attr)


def eos(input, eos_id, **kw):
    """eos_layer: 1 where the id equals eos_id (EosIdCheckLayer.cpp)."""
    return L.cast(L.equal(
        input, L.fill_constant(shape=[1], value=int(eos_id),
                               dtype=input.dtype)), "float32")


# ---------------------------------------------------------------------------
# final layer-name tail: 3-D conv/pool wrappers,
# cmrnorm, sub_seq, switch_order, scale_sub_region, selective_fc,
# lambda_cost, cross_entropy_with_selfnorm, conv projections/operators
# ---------------------------------------------------------------------------

def img_cmrnorm(input, size=5, scale=0.0128, power=0.75,
                data_format="NHWC", **kw):
    """img_cmrnorm_layer — cross-map response normalization, a thin
    wrapper over the lrn op (reference CMRProjectionNormLayer; attrs map
    scale -> alpha*n, power -> beta per the v1 config_parser rule)."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("img_cmrnorm")
    return helper.simple_op(
        "lrn", {"X": [input]},
        {"n": int(size), "alpha": float(scale) / int(size), "k": 1.0,
         "beta": float(power), "data_format": data_format})


def img_conv3d(input, filter_size, num_filters, num_channels=None,
               stride=1, padding=0, groups=1, act=None, param_attr=None,
               bias_attr=None, **kw):
    """img_conv3d_layer over the conv3d op (NCDHW, reference
    trainer_config_helpers img_conv3d_layer)."""
    from ..initializer import NormalInitializer
    from ..layers.layer_helper import LayerHelper

    _need_op("conv3d")
    helper = LayerHelper("img_conv3d")
    ksz = ([filter_size] * 3 if isinstance(filter_size, int)
           else list(filter_size))
    cin = int(input.shape[1]) if num_channels is None else num_channels
    fan_in = (cin // groups) * ksz[0] * ksz[1] * ksz[2]
    w = helper.create_parameter(
        param_attr, shape=[num_filters, cin // groups] + ksz,
        dtype=input.dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    o = helper.simple_op(
        "conv3d", {"Input": [input], "Filter": [w]},
        {"strides": stride, "paddings": padding, "groups": groups},
        out_slot="Output")
    o = helper.append_bias_op(o, bias_attr, num_filters, dim_start=1)
    return helper.append_activation(o, _act.resolve(act))


def img_pool3d(input, pool_size, stride=1, padding=0, pool_type=None,
               **kw):
    """img_pool3d_layer over the pool3d op (NCDHW)."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("img_pool3d")
    _need_op("pool3d")
    return helper.simple_op(
        "pool3d", {"X": [input]},
        {"pooling_type": _pool.resolve(pool_type) or "max",
         "ksize": pool_size, "strides": stride, "paddings": padding})


def sub_seq(input, offsets, sizes, **kw):
    """sub_seq_layer (SubSequenceLayer.cpp): per-row [offset, offset+size)
    time slice; the result carries the new lengths."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("sub_seq")
    _need_op("sub_seq")
    outs, _ = helper.append_op(
        "sub_seq", {"X": [input], "Offsets": [offsets], "Sizes": [sizes]},
        ["Out", "OutLength"], {})
    o = outs["Out"][0]
    o.seq_len = outs["OutLength"][0]
    return o


def switch_order(input, reshape_axis=None, act=None, **kw):
    """switch_order_layer: NCHW -> NHWC (+ optional 2-D reshape split at
    ``reshape_axis``)."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("switch_order")
    _need_op("switch_order")
    o = helper.simple_op("switch_order", {"X": [input]},
                         {"reshape_axis": int(reshape_axis or 0)})
    return helper.append_activation(o, _act.resolve(act))


def scale_sub_region(input, indices, value=1.0, **kw):
    """scale_sub_region_layer: scale the per-sample sub-region named by
    ``indices`` [b, 6] (1-based inclusive) by ``value``."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("scale_sub_region")
    _need_op("scale_sub_region")
    return helper.simple_op(
        "scale_sub_region", {"X": [input], "Indices": [indices]},
        {"value": float(value)})


def selective_fc(input, select, size, act=None, param_attr=None,
                 bias_attr=None, pass_generation=False, **kw):
    """selective_fc_layer (SelectiveFullyConnectedLayer.cpp): a full fc
    whose output is masked to the selected columns (``select`` is a
    0/1 [b, size] selection plane; zeros elsewhere). The reference's
    sparse-compute fast path is a serving optimization; the dense matmul
    and mask is the fast path on a tensor-core device (no gather)."""
    out_full = fc(input, size, act=act, param_attr=param_attr,
                  bias_attr=bias_attr)
    return L.elementwise_mul(out_full, select)


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, **kw):
    """lambda_cost (LambdaRank): ``input`` is the MODEL SCORE sequence
    (the network output, LambdaCost's first input in the reference
    CostLayer.cpp), ``score`` the ground-truth relevance sequence —
    the reference's counter-intuitive but load-bearing argument order,
    which v1 configs depend on."""
    from ..layers.layer_helper import LayerHelper
    from ..layers.sequence import _len_input

    helper = LayerHelper("lambda_cost")
    _need_op("lambda_cost")
    return helper.simple_op(
        "lambda_cost",
        {"Score": [input], "Label": [score], **_len_input(input)},
        {"NDCG_num": int(NDCG_num),
         "max_sort_size": int(max_sort_size)})


def cross_entropy_with_selfnorm(input, label, softmax_selfnorm_alpha=0.1,
                                **kw):
    """cross_entropy_with_selfnorm (CostLayer.cpp:113): CE over softmax
    probs + log(Z) + alpha*log(Z)^2 self-normalization penalty."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("ce_selfnorm")
    _need_op("cross_entropy_with_selfnorm")
    return helper.simple_op(
        "cross_entropy_with_selfnorm", {"X": [input], "Label": [label]},
        {"softmax_selfnorm_alpha": float(softmax_selfnorm_alpha)})


class conv_projection(BaseProjection):
    """conv_projection (ConvProjection.cpp): a conv2d as a mixed_layer
    projection; NHWC input, same-geometry knobs as img_conv."""

    def __init__(self, input, filter_size, num_filters, stride=1,
                 padding=0, groups=1, param_attr=None, **kw):
        super().__init__(input, param_attr)
        self.filter_size = filter_size
        self.num_filters = num_filters
        self.stride = stride
        self.padding = padding
        self.groups = groups

    def build(self, size):
        return img_conv(self.input, self.filter_size, self.num_filters,
                        stride=self.stride, padding=self.padding,
                        groups=self.groups, act=None,
                        param_attr=self.param_attr, bias_attr=False)


def conv_operator(*a, **kw):
    """Reference conv_operator convolves with a LAYER's output as the
    filter (dynamic filters, ConvOperator.cpp) — unsupported; use
    conv_projection for learned-filter convolution projections."""
    raise NotImplementedError(
        "conv_operator (dynamic data-dependent conv filters) is not "
        "supported; use conv_projection")


# ---------------------------------------------------------------------------
# the step-level recurrent DSL, re-exported (reference v2/layer.py carries
# recurrent_group/memory/StaticInput from trainer_config_helpers into the
# v2 namespace). The machinery lives in v1/helpers.py and needs no parse
# context: it builds directly on StaticRNN.
# ---------------------------------------------------------------------------

_DSL_REEXPORTS = ("recurrent_group", "memory", "StaticInput",
                  "GeneratedInput", "gru_step_layer", "lstm_step_layer")


def __getattr__(name):
    if name in _DSL_REEXPORTS:
        from ..v1 import helpers as _h

        return getattr(_h, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_DSL_REEXPORTS))
