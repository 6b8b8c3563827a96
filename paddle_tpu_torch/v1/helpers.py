"""trainer_config_helpers compatibility namespace: the v1 config DSL.

Counterpart of ``paddle_tpu/v1/helpers.py``: the surface a v1 config
file sees after ``from paddle.trainer_config_helpers import *``
(reference trainer_config_helpers/layers.py et al.). Each builder
delegates to the port's v2 facade or ``layers`` and records config-level
state (settings, data sources, inputs/outputs, evaluators) into the
active :class:`ParseContext`, the role the reference's global
``g_config`` plays in config_parser.py.

Input typing: ``data_layer(name, size)`` carries no dtype or sparsity;
in the reference those come from the data provider's input_types at run
time. ``define_py_data_sources2`` therefore resolves the provider
eagerly (imports the module, runs the init_hook) so data_layer can claim
its InputType: by name when the provider declares a dict, by best
dimension match when it declares a positional list (ambiguity raises,
pointing at dict declarations).

The step-level recurrent DSL (``recurrent_group``, ``memory``,
``StaticInput``, ``gru_step_layer``, ``lstm_step_layer``) builds one
``StaticRNN`` sub-block per group; the group is one ``static_rnn`` op,
which runs the step's ops once a time step.

Layers whose op the port lacks raise ``NotImplementedError`` naming the
ROADMAP item that ports it, as the v2 facade's do.
"""
from __future__ import annotations

import math
import os
from typing import Optional

from .. import layers as L
from .. import optimizer as _opt
from ..initializer import (ConstantInitializer, NormalInitializer,
                           UniformInitializer)
from ..param_attr import ParamAttr as _FluidParamAttr
from ..regularizer import L1DecayRegularizer, L2DecayRegularizer
from ..v2 import layer as v2l
from ..v2.layer import _layer as _L, _need_op
from ..v2.data_type import InputType, dense_vector
from . import data_provider as _dp

# ---------------------------------------------------------------------------
# parse context
# ---------------------------------------------------------------------------

_CTX = None  # the active ParseContext (set by config_parser.parse_config)


class ParseContext:
    def __init__(self, config_args=None, config_dir="."):
        self.config_args = dict(config_args or {})
        self.config_dir = config_dir
        self.settings = {
            "batch_size": 100,
            "learning_rate": 0.01,
            "learning_method": None,
            "regularization": None,
            "gradient_clipping_threshold": None,
            "model_average": None,
        }
        self.data_sources = None       # define_py_data_sources2 record
        self.provider_types = None     # dict name->InputType | list
        self._claimed = set()          # claimed positional slots
        self.data_layers = []          # creation order
        self.inputs_order = None       # inputs() override
        self.outputs = None
        self.evaluators = []
        self.named_layers = {}         # v1 name= kwarg -> built var
        self.default_momentum = None   # default_momentum()
        self.default_decay_rate = None  # default_decay_rate()


def _ctx() -> ParseContext:
    if _CTX is None:
        raise RuntimeError(
            "the v1 DSL must run under parse_config() "
            "(paddle_tpu_torch.v1.parse_config)")
    return _CTX


# ---------------------------------------------------------------------------
# config-level declarations
# ---------------------------------------------------------------------------

def get_config_arg(name, type_=str, default=None):
    """Read a --config_args key (reference config_parser.py
    get_config_arg)."""
    val = _ctx().config_args.get(name)
    if val is None:
        return default
    if type_ is bool:
        return str(val).lower() not in ("0", "false", "")
    return type_(val)


def define_py_data_sources2(train_list, test_list, module, obj, args=None):
    """Record the data sources and eagerly resolve the provider's
    input_types (reference trainer/config_parser data_sources handling) so
    data_layer() can type its feeds."""
    ctx = _ctx()
    ctx.data_sources = {"train_list": train_list, "test_list": test_list,
                        "module": module, "obj": obj,
                        "args": dict(args or {})}
    from .config_parser import import_provider

    try:
        # this package's own copy: one the JAX package imported first
        # carries that package's @provider
        mod = import_provider(module, ctx.config_dir)
    except Exception:  # noqa: BLE001 - unimportable provider (missing, or
        # py2-only like the reference sequence_tagging dataprovider):
        # data_layer falls back to dense typing; training needs a usable
        # provider but parsing should not
        return
    dp = getattr(mod, obj, None)
    if isinstance(dp, _dp.DataProvider):
        # the TRAIN source's files only — the reference hands each data
        # source its own provider instance and file_list
        # (PyDataProvider2.py:434); hooks deriving state (vocabs, class
        # counts) must not also see the test files
        file_list = []
        lst = train_list or test_list
        if lst:
            for base in (os.getcwd(), ctx.config_dir):
                path = lst if os.path.isabs(lst) else os.path.join(base,
                                                                   lst)
                if os.path.exists(path):
                    with open(path) as lf:
                        file_list.extend(
                            ln.strip() for ln in lf if ln.strip())
                    break
        try:
            settings = dp.create(file_list=file_list,
                                 **ctx.data_sources["args"])
        except (NameError, AttributeError, SyntaxError, ImportError):
            # py2-only init hooks (xrange, dict.iteritems, ...): degrade
            # to dense typing like an unimportable module — but say so,
            # because the feeds lose their provider types
            import traceback
            import warnings

            warnings.warn(
                f"provider {module}.{obj} init hook failed "
                f"(py2-only?); data layers degrade to dense typing:\n"
                f"{traceback.format_exc()}", stacklevel=2)
            return
        ctx.provider_types = settings.input_types
        ctx.data_sources["provider"] = dp
        ctx.data_sources["provider_settings"] = settings


def settings(batch_size=None, learning_rate=None, learning_method=None,
             regularization=None, gradient_clipping_threshold=None,
             model_average=None, **kw):
    """The v1 settings() call (reference trainer_config_helpers/
    optimizers.py settings): records the optimization recipe; the trainer
    materializes it via build_optimizer()."""
    ctx = _ctx()
    for k, v in [("batch_size", batch_size),
                 ("learning_rate", learning_rate),
                 ("learning_method", learning_method),
                 ("regularization", regularization),
                 ("gradient_clipping_threshold",
                  gradient_clipping_threshold),
                 ("model_average", model_average)]:
        if v is not None:
            ctx.settings[k] = v
    ctx.settings.update(kw)  # decay_a/b etc. kept for inspection


def inputs(*layers_):
    _ctx().inputs_order = [getattr(v, "name", v) for v in layers_]


def outputs(*layers_):
    flat = []
    for item in layers_:
        flat.extend(item if isinstance(item, (list, tuple)) else [item])
    _ctx().outputs = flat


def Inputs(*names):
    """Name-string form (reference config_parser Inputs): the feed order
    by data-layer name."""
    _ctx().inputs_order = list(names)


def Outputs(*names):
    """Name-string form (reference config_parser Outputs): entries are
    v1 layer names resolved against the name registry at parse end."""
    _ctx().outputs = list(names)


def default_momentum(momentum):
    """Config-wide momentum default consumed by Settings(
    learning_method='momentum') (reference config_parser
    default_momentum)."""
    _ctx().default_momentum = float(momentum)


def default_decay_rate(rate):
    """Config-wide L2 decay default (reference default_decay_rate)."""
    _ctx().default_decay_rate = float(rate)


def default_initial_std(std):
    """Accepted no-op: per-layer attrs carry their own initializers."""


def default_initial_mean(mean):
    """Accepted no-op (see default_initial_std)."""


def Settings(algorithm="sgd", batch_size=None, learning_rate=None,
             learning_method=None, learning_rate_decay_a=None,
             learning_rate_decay_b=None, learning_rate_schedule=None,
             **kw):
    """The capitalized low-level form (reference config_parser Settings):
    ``learning_method`` arrives as a STRING and is recorded AS-IS —
    resolution to an optimizer object happens lazily in
    build_optimizer, because the reference reads default_momentum()/
    default_decay_rate() at parameter-build time, so configs may call
    them in any order relative to Settings()."""
    settings(batch_size=batch_size, learning_rate=learning_rate,
             learning_method=learning_method,
             learning_rate_decay_a=learning_rate_decay_a,
             learning_rate_decay_b=learning_rate_decay_b,
             learning_rate_schedule=learning_rate_schedule, **kw)


def resolve_learning_method(method, default_momentum=None):
    """STRING learning_method -> optimizer object (reference
    config_parser Settings algorithm table). Momentum defaults to the
    reference's 0.0 unless default_momentum() was called; unknown
    methods fail loudly."""
    if not isinstance(method, str):
        return method
    mom = default_momentum if default_momentum is not None else 0.0
    table = {
        "momentum": lambda: MomentumOptimizer(momentum=mom),
        # the sparse variant differs only in pserver-side update layout;
        # sparse gradients here are SelectedRows either way
        "sparse_momentum": lambda: MomentumOptimizer(momentum=mom),
        "sgd": lambda: MomentumOptimizer(momentum=mom),
        "adam": AdamOptimizer,
        "adamax": AdamaxOptimizer,
        "adagrad": AdaGradOptimizer,
        "decayed_adagrad": DecayedAdaGradOptimizer,
        "adadelta": AdaDeltaOptimizer,
        "rmsprop": RMSPropOptimizer,
    }
    if method not in table:
        raise ValueError(
            f"Settings(learning_method={method!r}) is not a supported "
            f"method; known: {sorted(table)}")
    return table[method]()


# ---------------------------------------------------------------------------
# settings objects: optimizers / regularization / model average
# ---------------------------------------------------------------------------

class _V1Optimizer:
    factory = None
    kwargs = {}

    def build(self, learning_rate, regularization=None):
        return type(self).factory(learning_rate=learning_rate,
                                  regularization=regularization,
                                  **self.kwargs)


Optimizer = _V1Optimizer            # reference optimizers.py base names
BaseSGDOptimizer = _V1Optimizer


class BaseRegularization:
    """Base marker (reference optimizers.py BaseRegularization)."""


class AdamOptimizer(_V1Optimizer):
    factory = _opt.AdamOptimizer

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.kwargs = {"beta1": beta1, "beta2": beta2, "epsilon": epsilon}


class AdamaxOptimizer(_V1Optimizer):
    factory = _opt.AdamaxOptimizer

    def __init__(self, beta1=0.9, beta2=0.999):
        self.kwargs = {"beta1": beta1, "beta2": beta2}


class MomentumOptimizer(_V1Optimizer):
    factory = _opt.MomentumOptimizer

    def __init__(self, momentum=0.9, sparse=False):
        self.kwargs = {"momentum": momentum}


class AdaGradOptimizer(_V1Optimizer):
    factory = _opt.AdagradOptimizer

    def __init__(self):
        self.kwargs = {}


class DecayedAdaGradOptimizer(_V1Optimizer):
    factory = _opt.DecayedAdagradOptimizer

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.kwargs = {"decay": rho, "epsilon": epsilon}


class AdaDeltaOptimizer(_V1Optimizer):
    factory = _opt.AdadeltaOptimizer

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.kwargs = {"rho": rho, "epsilon": epsilon}


class RMSPropOptimizer(_V1Optimizer):
    factory = _opt.RMSPropOptimizer

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.kwargs = {"decay": rho, "epsilon": epsilon}


def L2Regularization(rate):
    return L2DecayRegularizer(regularization_coeff=rate)


def L1Regularization(rate):
    return L1DecayRegularizer(regularization_coeff=rate)


class ModelAverage:
    """settings(model_average=ModelAverage(w)) marker (the trainer may wire
    it to optimizer.ModelAverage)."""

    def __init__(self, average_window, max_average_window=None):
        self.average_window = average_window
        self.max_average_window = max_average_window


# ---------------------------------------------------------------------------
# activations / poolings / attrs
# ---------------------------------------------------------------------------

from ..v2 import activation as _act  # noqa: E402
from ..v2 import pooling as _pool  # noqa: E402

BaseActivation = _act.BaseActivation
LinearActivation = _act.Linear
IdentityActivation = _act.Linear
SqrtActivation = _act.Sqrt
ReciprocalActivation = _act.Reciprocal
SoftSignActivation = _act.SoftSign
ReluActivation = _act.Relu
BReluActivation = _act.BRelu
SoftReluActivation = _act.SoftRelu
TanhActivation = _act.Tanh
STanhActivation = _act.STanh
SigmoidActivation = _act.Sigmoid
SoftmaxActivation = _act.Softmax
ExpActivation = _act.Exp
LogActivation = _act.Log
AbsActivation = _act.Abs
SquareActivation = _act.Square
SequenceSoftmaxActivation = _act.SequenceSoftmax

BasePoolingType = _pool.BasePooling
MaxPooling = _pool.Max
AvgPooling = _pool.Avg
SumPooling = _pool.Sum
SquareRootNPooling = _pool.SquareRootN
# the reference's GPU-library pooling names alias the same math here
CudnnMaxPooling = _pool.Max
CudnnAvgPooling = _pool.Avg
CudnnAvgInclPadPooling = _pool.Avg
MaxWithMaskPooling = _pool.Max  # the mask is implicit in the max


class ParamAttr:
    """v1 ParameterAttribute (reference trainer_config_helpers/attrs.py):
    translated onto the fluid ParamAttr at use time."""

    def __init__(self, name=None, is_static=False, initial_std=None,
                 initial_mean=None, initial_max=None, initial_min=None,
                 l1_rate=None, l2_rate=None, learning_rate=None,
                 momentum=None, gradient_clipping_threshold=None,
                 sparse_update=False, initializer=None,
                 update_hooks=None):
        self.update_hooks = update_hooks
        self.name = name
        self.is_static = is_static
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        self.initial_max = initial_max
        self.initial_min = initial_min
        self.l1_rate = l1_rate
        self.l2_rate = l2_rate
        self.learning_rate = learning_rate
        self.sparse_update = sparse_update
        self.initializer = initializer
        self.gradient_clipping_threshold = gradient_clipping_threshold

    def to_fluid(self):
        init = self.initializer
        if init is None and self.initial_std is not None:
            if self.initial_std == 0 and not self.initial_mean:
                init = ConstantInitializer(0.0)
            else:
                init = NormalInitializer(loc=self.initial_mean or 0.0,
                                         scale=self.initial_std)
        elif init is None and self.initial_max is not None:
            init = UniformInitializer(low=self.initial_min or 0.0,
                                      high=self.initial_max)
        reg = None
        if self.l2_rate:
            reg = L2DecayRegularizer(regularization_coeff=self.l2_rate)
        elif self.l1_rate:
            reg = L1DecayRegularizer(regularization_coeff=self.l1_rate)
        from ..clip import GradientClipByNorm

        clip = (GradientClipByNorm(self.gradient_clipping_threshold)
                if self.gradient_clipping_threshold else None)
        hooks = self.update_hooks
        if hooks is not None and not isinstance(hooks, (list, tuple)):
            hooks = [hooks]
        hooks = [h.to_fluid_hook() if isinstance(h, HookAttribute) else h
                 for h in (hooks or [])]
        return _FluidParamAttr(
            name=self.name, initializer=init,
            learning_rate=self.learning_rate
            if self.learning_rate is not None else 1.0,
            regularizer=reg, trainable=not self.is_static,
            gradient_clip=clip, update_hooks=hooks or None)


ParameterAttribute = ParamAttr


class HookAttribute:
    """Parameter update hook (reference attrs.py HookAttribute):
    'pruning' with a sparsity_ratio — carried onto the fluid ParamAttr's
    update_hooks plane (param_attr.py)."""

    def __init__(self, type="pruning", sparsity_ratio=0.6):
        if type != "pruning":
            raise ValueError(f"unsupported hook type {type!r} "
                             "(only 'pruning' is registered)")
        self.type = type
        self.sparsity_ratio = float(sparsity_ratio)

    def to_fluid_hook(self):
        from ..param_attr import Hook

        return Hook("pruning", sparsity_ratio=self.sparsity_ratio)


HookAttr = HookAttribute


def _pa(attr):
    """None | bool | v1 ParamAttr | fluid ParamAttr -> fluid attr.
    True means "default attribute" in the v1 DSL."""
    if isinstance(attr, ParamAttr):
        return attr.to_fluid()
    if attr is True:
        return None
    return attr


class ExtraLayerAttribute:
    """v1 ExtraLayerAttribute (reference attrs.py): ``drop_rate`` is
    honored (the wrapper applies dropout to the layer output, the role
    LayerConfig.drop_rate plays in the reference); ``device`` and
    ``error_clipping_threshold`` are accepted no-ops (there is no
    per-layer device placement: the executor runs on one device)."""

    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None):
        self.drop_rate = drop_rate


ExtraAttr = ExtraLayerAttribute


def _maybe_drop(var, kw):
    """Apply layer_attr=ExtraAttr(drop_rate=...) to a layer output."""
    rate = getattr(kw.get("layer_attr"), "drop_rate", None)
    if rate:
        var = v2l.dropout_keep_len(var, rate)
    return var


def default_device(device=0):
    """Accepted no-op: per-layer device placement does not exist under a
    single-device executor."""


# ---------------------------------------------------------------------------
# input-type resolution for data_layer
# ---------------------------------------------------------------------------

def _resolve_input_type(name, size):
    """Claim this data layer's InputType from the provider declaration."""
    ctx = _ctx()
    types = ctx.provider_types
    if isinstance(types, dict):
        t = types.get(name)
        if t is not None:
            return t
    elif isinstance(types, (list, tuple)):
        # positional list: the reference matches slots to the inputs()
        # order, unknown at this point — recover the pairing by dimension.
        exact = [i for i, t in enumerate(types)
                 if i not in ctx._claimed and t.dim == size]
        loose = [i for i, t in enumerate(types)
                 if i not in ctx._claimed and t.dim <= size]
        pick = exact or loose
        if len(pick) >= 1:
            # several equal dims: claim in declaration order (matches the
            # reference when creation order follows inputs() order for the
            # tied slots)
            ctx._claimed.add(pick[0])
            return types[pick[0]]
        raise ValueError(
            f"data_layer({name!r}, size={size}): no unclaimed provider "
            f"input_type slot fits; declare input_types as a dict keyed "
            f"by layer name to disambiguate")
    return dense_vector(size)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def data_layer(name, size, height=None, width=None, **kw):
    t = _resolve_input_type(name, size)
    if t.sparse and t.seq_type:
        # per-timestep sparse id lists: [b, T, K] ids, K-padded with -1;
        # fc masks the pads (see _sparse_seq_fc_branch)
        var = L.data(name, shape=[-1], dtype="int64", lod_level=1)
        var.input_type = t
        var.sparse_seq = True
        ctx = _ctx()
        ctx.data_layers.append(var)
        return var
    var = v2l.data(name, t)
    var.height, var.width = height, width
    _ctx().data_layers.append(var)
    return var


def _sparse_seq_fc_branch(inp, size, param_attr):
    """fc over a sequence of sparse binary vectors: per-timestep
    embedding-sum. ids [b, T, K] are K-padded with -1; the pad mask zeroes
    their contribution so the result equals each timestep's multi-hot row
    @ W exactly."""
    t = inp.input_type
    ids = L.relu(inp)  # clamp the -1 pads to a valid lookup id
    emb = L.embedding(ids, size=[t.dim, size], param_attr=_pa(param_attr))
    mask = L.cast(L.greater_equal(
        inp, L.fill_constant(shape=[1], value=0, dtype=inp.dtype)),
        "float32")
    emb = L.elementwise_mul(emb, L.reshape(mask, shape=[0, 0, -1, 1]))
    summed = L.reduce_sum(emb, dim=-2)
    summed.seq_len = inp.seq_len
    return summed


def fc_layer(input, size, act=None, param_attr=None, bias_attr=None, **kw):
    inputs_ = input if isinstance(input, (list, tuple)) else [input]
    sparse_seq = [v for v in inputs_ if getattr(v, "sparse_seq", False)]
    rest = [v for v in inputs_ if not getattr(v, "sparse_seq", False)]
    if isinstance(bias_attr, ParamAttr):
        bias_attr = bias_attr.to_fluid()
    if not sparse_seq:
        return _group_register_name(kw.get("name"), _maybe_drop(
            v2l.fc(input if isinstance(input, (list, tuple)) and
                   len(inputs_) > 1 else inputs_[0], size, act=act,
                   param_attr=_pa(param_attr), bias_attr=bias_attr), kw))
    from ..layers.layer_helper import LayerHelper

    branches = [_sparse_seq_fc_branch(v, size, param_attr)
                for v in sparse_seq]
    if rest:
        # a [b, size] dense branch cannot broadcast onto the [b, T, size]
        # per-timestep branches
        raise ValueError("fc over mixed sparse-sequence and plain inputs "
                         "is not supported")
    summed = branches[0] if len(branches) == 1 else L.addto(branches,
                                                            act=None)
    helper = LayerHelper("fc")
    seq_len = branches[0].seq_len
    if bias_attr is not False:
        summed = helper.append_bias_op(summed, bias_attr, size,
                                       dim_start=len(summed.shape) - 1)
    summed = helper.append_activation(summed, _act.resolve(act))
    summed.seq_len = seq_len
    return summed


def embedding_layer(input, size, param_attr=None, **kw):
    return _maybe_drop(v2l.embedding(input, size, param_attr=_pa(param_attr)),
                       kw)


# -- mixed_layer + projections (reference layers.py mixed_layer et al.) ----
# The builders live in the v2 facade; these shims translate v1 ParamAttr
# objects at the boundary so reference configs pass them unchanged.

def full_matrix_projection(input, size=0, param_attr=None, **kw):
    return v2l.full_matrix_projection(input, size=size,
                                      param_attr=_pa(param_attr))


def trans_full_matrix_projection(input, size=0, param_attr=None, **kw):
    return v2l.trans_full_matrix_projection(input, size=size,
                                            param_attr=_pa(param_attr))


def table_projection(input, size=0, param_attr=None, **kw):
    return v2l.table_projection(input, size=size, param_attr=_pa(param_attr))


def identity_projection(input, offset=None, size=None, **kw):
    return v2l.identity_projection(input, offset=offset, size=size)


def scaling_projection(input, param_attr=None, **kw):
    return v2l.scaling_projection(input, param_attr=_pa(param_attr))


def dotmul_projection(input, param_attr=None, **kw):
    return v2l.dotmul_projection(input, param_attr=_pa(param_attr))


def context_projection(input, context_len, context_start=None, **kw):
    return v2l.context_projection(input, context_len,
                                  context_start=context_start)


def mixed_layer(size=0, input=None, act=None, bias_attr=None, **kw):
    """v1 mixed_layer: immediate form (input=[projections]) or context
    manager collecting ``+=`` projections. Reference defaults: NO bias
    unless bias_attr is set (wrap_bias_attr_default(has_bias=False),
    layers.py:865); layer_attr=ExtraAttr(drop_rate=...) applies dropout
    in both forms."""
    if isinstance(bias_attr, ParamAttr):
        bias_attr = bias_attr.to_fluid()
    elif bias_attr is True:
        bias_attr = None  # default bias
    elif bias_attr is None:
        bias_attr = False  # reference default: no bias
    rate = getattr(kw.get("layer_attr"), "drop_rate", None) or 0.0
    out = v2l.mixed_layer(size=size, input=input, act=act,
                          bias_attr=bias_attr, drop_rate=rate)
    if input is not None:
        _group_register_name(kw.get("name"), out)
    return out


def recurrent_layer(input, act=None, bias_attr=None, param_attr=None,
                    reverse=False, **kw):
    """v1 recurrent_layer (reference layers.py recurrent_layer ->
    gserver RecurrentLayer.cpp): out_t = act(in_t + out_{t-1} @ W + b);
    the input is already at the layer's width."""
    # act unset -> tanh (reference wrap_act_default); an EXPLICIT
    # LinearActivation (whose resolved name is empty) means the identity
    # recurrence, not the default.
    act_name = "tanh" if act is None else (_act.resolve(act) or "identity")
    if isinstance(bias_attr, ParamAttr):
        bias_attr = bias_attr.to_fluid()
    elif bias_attr is True:
        bias_attr = None  # default bias
    o = L.simple_rnn(input, is_reverse=reverse, activation=act_name,
                     param_attr=_pa(param_attr), bias_attr=bias_attr)
    return _maybe_drop(o, kw)


def img_conv_layer(input, filter_size, num_filters, num_channels=None,
                   stride=1, padding=0, groups=1, act=None, param_attr=None,
                   bias_attr=None, **kw):
    input = _as_image(input, num_channels)
    return _group_register_name(kw.get("name"), v2l.img_conv(
        input, filter_size, num_filters, num_channels=num_channels,
        stride=stride, padding=padding, groups=groups, act=act,
        param_attr=_pa(param_attr), bias_attr=_pa(bias_attr)))


def img_pool_layer(input, pool_size, stride=1, padding=0, pool_type=None,
                   num_channels=None, ceil_mode=True, **kw):
    return _group_register_name(kw.get("name"), v2l.img_pool(
        _as_image(input, num_channels), pool_size, stride=stride,
        padding=padding, pool_type=pool_type, ceil_mode=ceil_mode))


def batch_norm_layer(input, act=None, use_global_stats=None, **kw):
    if use_global_stats is not None:
        kw.setdefault("is_test", bool(use_global_stats))
    return _group_register_name(kw.get("name"),
                                v2l.batch_norm(input, act=act, **kw))


def dropout_layer(input, dropout_rate=0.5, **kw):
    return v2l.dropout(input, dropout_rate)


def pooling_layer(input, pooling_type=None, **kw):
    return v2l.pooling(input, pooling_type)


def concat_layer(input, **kw):
    return v2l.concat(input)


def addto_layer(input, act=None, **kw):
    return _group_register_name(kw.get("name"), v2l.addto(input, act=act))


def maxid_layer(input, **kw):
    return v2l.max_id(input)


def lstmemory(input, size=None, reverse=False, act=None, **kw):
    return _maybe_drop(v2l.lstmemory(input, size=size, reverse=reverse), kw)


def grumemory(input, size=None, reverse=False, **kw):
    return _maybe_drop(v2l.grumemory(input, size=size, reverse=reverse), kw)


def first_seq(input, **kw):
    return v2l.first_seq(input)


def last_seq(input, **kw):
    return v2l.last_seq(input)


def crf_layer(input, label, size=None, param_attr=None, **kw):
    return L.linear_chain_crf(input, label, param_attr=_pa(param_attr))


def crf_decoding_layer(input, size=None, label=None, param_attr=None,
                       **kw):
    return L.crf_decoding(input, param_attr=_pa(param_attr), label=label)


def classification_cost(input, label, name=None, **kw):
    return v2l.classification_cost(input, label)


def cross_entropy(input, label, **kw):
    return v2l.cross_entropy_cost(input, label)


def regression_cost(input, label, **kw):
    return v2l.square_error_cost(input, label)


mse_cost = regression_cost


def _as_image(var, num_channels=None):
    """v1 image layers consume flat [C*H*W] data vectors; reshape to NHWC
    when needed (the reference config_parser infers H=W=sqrt(size/C),
    config_parser.py parse_image)."""
    shape = [int(d) for d in var.shape if d != -1]
    if len(shape) == 1 and num_channels:
        hw = int(math.isqrt(shape[0] // num_channels))
        if hw * hw * num_channels != shape[0]:
            raise ValueError(
                f"cannot infer square image from size {shape[0]} with "
                f"{num_channels} channels")
        return L.reshape(var, shape=[-1, hw, hw, num_channels])
    return var


def img_conv_group(input, conv_num_filter, num_channels=None, pool_size=2,
                   pool_stride=2, conv_padding=1, conv_filter_size=3,
                   conv_act=None, conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=0.0, pool_type=None, **kw):
    """VGG-style group (reference trainer_config_helpers/networks.py
    img_conv_group): N convs (+BN (+dropout)) then one pool. Honors the
    v1 conv_padding contract (the fluid nets version always same-pads)."""
    n = len(conv_num_filter)

    def per(x):
        return list(x) if isinstance(x, (list, tuple)) else [x] * n

    pads = per(conv_padding)
    sizes = per(conv_filter_size)
    with_bn = per(conv_with_batchnorm)
    drops = per(conv_batchnorm_drop_rate)
    tmp = _as_image(input, num_channels)
    for i in range(n):
        tmp = v2l.img_conv(tmp, sizes[i], conv_num_filter[i],
                           stride=1, padding=pads[i],
                           act=None if with_bn[i] else conv_act)
        if with_bn[i]:
            tmp = v2l.batch_norm(tmp, act=conv_act)
            if drops[i] > 0:
                tmp = v2l.dropout(tmp, drops[i])
    return v2l.img_pool(tmp, pool_size, stride=pool_stride,
                        pool_type=pool_type)


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride=1, act=None, num_channel=None,
                         pool_type=None, groups=1, conv_stride=1,
                         conv_padding=0, bias_attr=None, param_attr=None,
                         pool_padding=0, **kw):
    """conv -> pool with the REFERENCE defaults (networks.py:144
    simple_img_conv_pool: conv_padding=0, conv_stride=1, pool_padding=0)
    so unmodified v1 configs get the reference's output geometry and
    parameter shapes."""
    tmp = img_conv_layer(input, filter_size, num_filters,
                         num_channels=num_channel, stride=conv_stride,
                         padding=conv_padding, groups=groups, act=act,
                         param_attr=param_attr, bias_attr=bias_attr)
    return v2l.img_pool(tmp, pool_size, stride=pool_stride,
                        padding=pool_padding,
                        pool_type=pool_type or MaxPooling())


# -- trainer_config_helpers/networks.py composites -------------------------

def simple_lstm(input, size, reverse=False, **kw):
    from ..v2 import networks as _nets

    return _nets.simple_lstm(input, size, reverse=reverse)


def bidirectional_lstm(input, size, return_seq=False, **kw):
    """reference networks.py bidirectional_lstm: fwd+bwd simple_lstm.
    return_seq=False returns the concat of the two LAST states (the
    text-classification head); True the concatenated sequences."""
    from ..v2 import networks as _nets

    if return_seq:
        return _nets.bidirectional_lstm(input, size, return_concat=True)
    fwd, bwd = _nets.bidirectional_lstm(input, size, return_concat=False)
    for v in (fwd, bwd):
        if getattr(v, "seq_len", None) is None:
            v.seq_len = getattr(input, "seq_len", None)
    return L.concat([L.sequence_last_step(fwd),
                     L.sequence_first_step(bwd)], axis=-1)


def simple_gru(input, size, reverse=False, **kw):
    from ..v2 import networks as _nets

    return _nets.simple_gru(input, size, reverse=reverse)


def bidirectional_gru(input, size, **kw):
    from ..v2 import networks as _nets

    return _nets.bidirectional_gru(input, size)


def small_vgg(input_image, num_channels=None, num_classes=10, **kw):
    from ..v2 import networks as _nets

    img = _as_image(input_image, num_channels)
    return _nets.small_vgg(img, num_classes=num_classes)


def vgg_16_network(input_image, num_channels=None, num_classes=1000,
                   **kw):
    from ..v2 import networks as _nets

    img = _as_image(input_image, num_channels)
    return _nets.vgg_16_network(img, num_classes=num_classes)


def text_conv_pool(input, context_len=5, hidden_size=128, **kw):
    from ..v2 import networks as _nets

    return _nets.text_conv_pool(input, context_len=context_len,
                                hidden_size=hidden_size)


def sequence_conv_pool(input, context_len, hidden_size, **kw):
    from ..v2 import networks as _nets

    return _nets.sequence_conv_pool(input, context_len, hidden_size)


def simple_attention(encoded_sequence, encoded_proj, decoder_state, **kw):
    from ..v2 import networks as _nets

    return _nets.simple_attention(encoded_sequence, encoded_proj,
                                  decoder_state)


def sum_cost(input, **kw):
    return v2l.sum_cost(input)


def smooth_l1_cost(input, label, **kw):
    return v2l.smooth_l1_cost(input, label)


def huber_classification_cost(input, label, **kw):
    return v2l.huber_classification_cost(input, label)


def multi_binary_label_cross_entropy(input, label, **kw):
    return v2l.multi_binary_label_cross_entropy(input, label)


class _LayerMath:
    """The ``layer_math`` namespace (reference trainer_config_helpers/
    layer_math.py): unary math as layers. Binary arithmetic rides the
    repo's Variable operator overloading (layers/math_op_patch.py), the
    same contract the reference implements with LayerOutput operators."""

    @staticmethod
    def _unary(op_name):
        def op(input, name=None, **kw):
            from ..layers.layer_helper import LayerHelper

            helper = LayerHelper(op_name)
            return _group_register_name(
                name, helper.simple_op(op_name, {"X": [input]}, {}))

        op.__name__ = op_name
        return op


layer_math = _LayerMath()
for _un in ("exp", "log", "abs", "sigmoid", "tanh", "square", "relu",
            "sqrt", "reciprocal"):
    setattr(layer_math, _un, _LayerMath._unary(_un))
del _un


# ---------------------------------------------------------------------------
# the step-level recurrent DSL: recurrent_group / memory / StaticInput /
# gru_step_layer / lstm_step_layer (reference layers.py recurrent_group ->
# gserver RecurrentGradientMachine.h:32). The step function is built once
# into a StaticRNN sub-block and the whole group is one static_rnn op,
# which runs the step's ops once a time step.
# ---------------------------------------------------------------------------

class StaticInput:
    """Wrap a non-sequence (or whole-sequence, for attention) input that
    every step sees in full (reference layers.py StaticInput)."""

    def __init__(self, input, is_seq=False, size=None):
        self.input = input
        self.is_seq = is_seq


class GeneratedInput:
    """Accepted for source compatibility; in-config generation through
    recurrent_group is not served: beam and greedy generation run
    through the in-graph decode ops instead (models.transformer_lm_*,
    layers.beam_search_decoder)."""

    def __init__(self, size=0, embedding_name=None, embedding_size=0,
                 **kw):
        raise NotImplementedError(
            "GeneratedInput (in-config beam generation) is served by the "
            "in-graph decode ops: models.transformer_lm_generate / "
            "_beam_search, layers.beam_search_decoder")


class _GroupState:
    def __init__(self, rnn, first_seq):
        self.rnn = rnn
        self.first_seq = first_seq
        self.memories = []       # (mem_var, v1 name)
        self.named_outputs = {}  # v1 layer name -> produced var


_GROUP: Optional[_GroupState] = None


def _group_register_name(name, var):
    """Layer shims call this so memory(name=...) can link to a step
    layer produced under that name (the reference's name-based memory
    wiring), and so Outputs("name") can resolve layers by their v1
    name at parse end."""
    if name:
        if _GROUP is not None:
            # step-internal names stay group-scoped: they denote body
            # sub-block vars the main program never produces, so they
            # must not shadow/poison the Outputs() registry
            _GROUP.named_outputs[name] = var
        elif _CTX is not None:
            _CTX.named_layers[name] = var
    return var


def memory(name=None, size=0, boot_layer=None, is_seq=False, **kw):
    """The step-scope memory: this step reads the PREVIOUS step's value
    of the layer named ``name`` (or of whatever updates it via
    output_mem). boot_layer (or zeros [b, size]) seeds t=0."""
    grp = _GROUP
    if grp is None:
        raise RuntimeError("memory() is only valid inside a "
                           "recurrent_group step function")
    rnn = grp.rnn
    if boot_layer is None:
        # synthesize the zeros boot in the PARENT block (MemInit must be
        # an outer var, not a body op output)
        prog = rnn.helper.main_program
        cur = prog.current_block_idx
        prog.current_block_idx = prog.blocks[cur].parent_idx
        try:
            boot = L.fill_constant_batch_size_like(
                input=grp.first_seq, shape=[-1, int(size)],
                value=0.0, dtype="float32")
        finally:
            prog.current_block_idx = cur
    else:
        boot = boot_layer
    mem = rnn.memory(init=boot)
    grp.memories.append((mem, name))
    return mem


def gru_step_layer(input, output_mem, size=None, act=None,
                   gate_act=None, name=None, param_attr=None,
                   bias_attr=None, **kw):
    """One GRU step inside a recurrent_group (reference gru_step_layer):
    ``input`` is the pre-projected [b, 3h] slice, ``output_mem`` the
    state memory — updated with the new hidden, which is returned."""
    grp = _GROUP
    if grp is None:
        raise RuntimeError("gru_step_layer is only valid inside a "
                           "recurrent_group step function")
    size = int(size or output_mem.shape[-1])
    h, _, _ = L.gru_unit(
        input, output_mem, size,
        activation=_act.resolve(act) or "tanh",
        gate_activation=_act.resolve(gate_act) or "sigmoid",
        param_attr=_pa(param_attr), bias_attr=bias_attr)
    grp.rnn.update_memory(output_mem, h)
    return _group_register_name(name, h)


def lstm_step_layer(input, state, size=None, act=None, gate_act=None,
                    state_act=None, name=None, bias_attr=None, **kw):
    """One LSTM step inside a recurrent_group (reference
    lstm_step_layer): ``input`` is the [b, 4h] gate pre-projection,
    ``state`` the CELL memory (updated in place); returns the hidden."""
    grp = _GROUP
    if grp is None:
        raise RuntimeError("lstm_step_layer is only valid inside a "
                           "recurrent_group step function")
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("lstm_step")
    outs, _ = helper.append_op(
        "lstm_unit", {"X": [input], "C_prev": [state]}, ["C", "H"],
        {"forget_bias": 0.0})
    c_new, h = outs["C"][0], outs["H"][0]
    grp.rnn.update_memory(state, c_new)
    return _group_register_name(name, h)


def recurrent_group(step, input, reverse=False, name=None, **kw):
    """Run ``step`` over every timestep (reference layers.py
    recurrent_group): sequence inputs are sliced per step, StaticInput
    is seen whole, memory() carries state, and the step outputs
    re-assemble into sequences. One static_rnn op."""
    global _GROUP
    inputs_ = input if isinstance(input, (list, tuple)) else [input]
    seqs = [i for i in inputs_ if not isinstance(i, StaticInput)]
    if not seqs:
        raise ValueError("recurrent_group needs at least one sequence "
                         "input (wrap constants in StaticInput)")
    if reverse:
        rev = {id(s): L.sequence_reverse(s) for s in seqs}
    rnn = L.StaticRNN()
    prev = _GROUP
    with rnn.step():
        grp = _GroupState(rnn, seqs[0])
        _GROUP = grp
        try:
            args = []
            for i in inputs_:
                if isinstance(i, StaticInput):
                    args.append(i.input)  # whole tensor; body param
                else:
                    args.append(rnn.step_input(
                        rev[id(i)] if reverse else i))
            outs = step(*args)
            outs_list = (list(outs) if isinstance(outs, (list, tuple))
                         else [outs])
            # link memories that were not explicitly updated: by the v1
            # name wiring, else (single memory, single output) to the
            # step's output — the simple-RNN idiom
            for mem, mname in grp.memories:
                if rnn.mem_out.get(mem.name) is not None:
                    continue
                tgt = grp.named_outputs.get(mname)
                if tgt is None and len(grp.memories) == 1 \
                        and len(outs_list) == 1:
                    tgt = outs_list[0]
                if tgt is None:
                    raise ValueError(
                        f"recurrent_group: memory {mname!r} is never "
                        f"updated — produce a step layer with "
                        f"name={mname!r} or use "
                        f"gru_step_layer/lstm_step_layer")
                rnn.update_memory(mem, tgt)
            for o in outs_list:
                rnn.step_output(o)
        finally:
            _GROUP = prev
    result = rnn()
    if reverse:
        rs = result if isinstance(result, (list, tuple)) else [result]
        rs = [L.sequence_reverse(o) for o in rs]
        result = rs[0] if len(rs) == 1 else rs
    return result


def get_output_layer(input, arg_name="", **kw):
    """Accepted shim: the repo's step layers return their primary output
    directly and update their state memories in place, so there is no
    secondary-argument plumbing to unpack."""
    return input


# -- the v1 layer-name tail (thin shims over the v2 builders) --------------

def img_cmrnorm_layer(input, size=5, scale=0.0128, power=0.75, **kw):
    return _maybe_drop(v2l.img_cmrnorm(input, size=size, scale=scale,
                                       power=power), kw)


def img_conv3d_layer(input, filter_size, num_filters, num_channels=None,
                     stride=1, padding=0, groups=1, act=None,
                     param_attr=None, bias_attr=None, **kw):
    return v2l.img_conv3d(input, filter_size, num_filters,
                          num_channels=num_channels, stride=stride,
                          padding=padding, groups=groups, act=act,
                          param_attr=_pa(param_attr),
                          bias_attr=_pa(bias_attr))


def img_pool3d_layer(input, pool_size, stride=1, padding=0,
                     pool_type=None, **kw):
    return v2l.img_pool3d(input, pool_size, stride=stride,
                          padding=padding, pool_type=pool_type)


def sub_seq_layer(input, offsets, sizes, **kw):
    return v2l.sub_seq(input, offsets, sizes)


def switch_order_layer(input, reshape_axis=None, act=None, **kw):
    return v2l.switch_order(input, reshape_axis=reshape_axis, act=act)


def scale_sub_region_layer(input, indices, value=1.0, **kw):
    return v2l.scale_sub_region(input, indices, value=value)


def selective_fc_layer(input, select, size, act=None, param_attr=None,
                       bias_attr=None, **kw):
    return v2l.selective_fc(input, select, size, act=act,
                            param_attr=_pa(param_attr),
                            bias_attr=_pa(bias_attr))


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, **kw):
    # reference order (trainer_config_helpers.layers.lambda_cost):
    # ``input`` = the model's score output, ``score`` = the ground-truth
    # relevance — forwarded positionally, NOT swapped
    return v2l.lambda_cost(input, score, NDCG_num=NDCG_num,
                           max_sort_size=max_sort_size)


def cross_entropy_with_selfnorm(input, label,
                                softmax_selfnorm_alpha=0.1, **kw):
    return v2l.cross_entropy_with_selfnorm(
        input, label, softmax_selfnorm_alpha=softmax_selfnorm_alpha)


def conv_projection(input, filter_size, num_filters, stride=1, padding=0,
                    groups=1, param_attr=None, **kw):
    return v2l.conv_projection(input, filter_size, num_filters,
                               stride=stride, padding=padding,
                               groups=groups, param_attr=_pa(param_attr))


def dotmul_operator(a=None, b=None, scale=1.0, **kw):
    """dotmul_operator (reference layers.py DotMulOperator): the
    elementwise product of TWO layer outputs, scale-weighted, usable
    inside mixed_layer."""
    class _DotMulOp(v2l.BaseProjection):
        def __init__(self, x, y, scale):
            super().__init__(x)
            self.y = y
            self.scale = scale

        def build(self, size):
            out = L.elementwise_mul(self.input, self.y)
            if self.scale != 1.0:
                out = L.scale(out, self.scale)
            return out

    x = a if a is not None else kw.get("x")
    y = b if b is not None else kw.get("y")
    return _DotMulOp(x, y, float(scale))


def conv_operator(img=None, filter=None, **kw):
    """The reference conv_operator convolves ``img`` with the OUTPUT of
    the ``filter`` layer (a dynamic, data-dependent filter —
    ConvOperator.cpp). That form has no users in the reference's demos
    or benchmarks; learned
    static-filter convolutions inside mixed_layer are conv_projection."""
    raise NotImplementedError(
        "conv_operator (dynamic data-dependent conv filters) is not "
        "supported; use conv_projection for learned-filter convolution "
        "projections")


def img_conv_bn_pool(input, filter_size, num_filters, pool_size,
                     num_channel=None, conv_padding=0, conv_stride=1,
                     pool_stride=1, act=None, pool_type=None,
                     drop_rate=0.0, groups=1, **kw):
    """conv -> BN(+act) -> [dropout] -> pool with the REFERENCE
    defaults (networks.py:231: conv_padding=0, conv_stride=1,
    pool_stride=1)."""
    img = _as_image(input, num_channel)
    tmp = v2l.img_conv(img, filter_size, num_filters, stride=conv_stride,
                       padding=conv_padding, groups=groups, act=None)
    tmp = v2l.batch_norm(tmp, act=act)
    if drop_rate:
        tmp = v2l.dropout(tmp, drop_rate)
    return v2l.img_pool(tmp, pool_size, stride=pool_stride,
                        pool_type=pool_type)


def simple_gru2(input, size, reverse=False, **kw):
    from ..v2 import networks as _nets

    return _nets.simple_gru2(input, size, reverse=reverse)


def dot_product_attention(encoded_sequence, attended_sequence=None,
                          transformed_state=None, softmax_param_attr=None,
                          name=None, **kw):
    """reference networks.py:1498 signature: (encoded_sequence,
    attended_sequence, transformed_state, ...)."""
    from ..v2 import networks as _nets

    return _group_register_name(name, _nets.dot_product_attention(
        encoded_sequence, attending_sequence=transformed_state,
        attended_sequence=attended_sequence))


def multi_head_attention(query, key=None, value=None,
                         key_proj_size=None, value_proj_size=None,
                         head_num=8,
                         attention_type="dot-product attention",
                         softmax_param_attr=None, name=None, **kw):
    """reference networks.py:1580 signature (query, key, value,
    key_proj_size, value_proj_size, head_num, attention_type, ...):
    batched multi-head attention over the whole sequences — the
    replacement for the per-step recurrent_group form. The
    qkv projections are sized by the layer (d_model-uniform), so the
    per-side proj sizes are accepted for source compat."""
    o = L.multi_head_attention(query, keys=key, values=value,
                               num_heads=int(head_num))
    return _group_register_name(name, o)


def img_separable_conv(input, num_channels, num_out_channels,
                       filter_size, stride=1, padding=0,
                       depth_multiplier=1, act=None, **kw):
    """Depthwise conv (groups == channels) + 1x1 pointwise conv
    (reference networks.py img_separable_conv)."""
    dw = img_conv_layer(input, filter_size,
                        num_channels * depth_multiplier,
                        num_channels=num_channels, stride=stride,
                        padding=padding, groups=num_channels, act=None,
                        bias_attr=False)
    return img_conv_layer(dw, 1, num_out_channels, stride=1, padding=0,
                          act=act)


def lstmemory_unit(input, out_memory=None, size=None, name=None,
                   param_attr=None, input_proj_bias_attr=None, **kw):
    """One LSTM step WITH its input projection, for use inside a
    recurrent_group (reference networks.py lstmemory_unit): mixed
    4h projection of [x_t, h_{t-1}] -> lstm_step_layer over the cell
    memory; returns the hidden (registered under ``name``)."""
    size = int(size or (input.shape[-1] // 4))
    base = name or "lstmemory_unit"
    h_mem = out_memory if out_memory is not None else memory(
        name=f"{base}.h", size=size)
    c_mem = memory(name=f"{base}.c", size=size)
    proj = fc_layer(input=[input, h_mem], size=4 * size,
                    param_attr=param_attr,
                    bias_attr=input_proj_bias_attr)
    h = lstm_step_layer(proj, state=c_mem, size=size,
                        name=f"{base}.h" if out_memory is None else name)
    return _group_register_name(name, h)


def lstmemory_group(input, size=None, name=None, reverse=False,
                    param_attr=None, **kw):
    """recurrent_group over lstmemory_unit (reference networks.py
    lstmemory_group) — unlike ``lstmemory`` (the monolithic scan op),
    the step is user-visible for mixing with attention etc."""
    size = int(size or (input.shape[-1] // 4))
    base = name or "lstmemory_group"

    def step(x_t):
        return lstmemory_unit(x_t, size=size, name=base,
                              param_attr=param_attr)

    return recurrent_group(step=step, input=input, reverse=reverse)


def gru_unit(input, size=None, name=None, gru_param_attr=None,
             act=None, gate_act=None, **kw):
    """One GRU step for use inside a recurrent_group (reference
    networks.py gru_unit): the state memory + gru_step_layer."""
    size = int(size or (input.shape[-1] // 3))
    base = name or "gru_unit"
    mem = memory(name=base, size=size)
    return gru_step_layer(input, output_mem=mem, size=size, act=act,
                          gate_act=gate_act, param_attr=gru_param_attr,
                          name=base)


def gru_group(input, size=None, name=None, reverse=False,
              gru_param_attr=None, **kw):
    """recurrent_group over gru_unit (reference networks.py
    gru_group)."""
    size = int(size or (input.shape[-1] // 3))
    base = name or "gru_group"

    def step(x_t):
        return gru_unit(x_t, size=size, name=base,
                        gru_param_attr=gru_param_attr)

    return recurrent_group(step=step, input=input, reverse=reverse)


# ---------------------------------------------------------------------------
# the complete reference layers.py __all__: every remaining v1 name maps
# onto its v2-facade / fluid cognate (thin keyword adapters; the math
# lives in the op registry). Names with structural markers or py2-era
# machinery get honest shims.
# ---------------------------------------------------------------------------

def _v1_delegate(target, seq_args=0):
    def shim(*a, **kw):
        name = kw.pop("name", None)
        kw.pop("layer_attr", None)
        for k in ("param_attr", "bias_attr"):
            if k in kw:
                kw[k] = _pa(kw[k])
        return _group_register_name(name, target(*a, **kw))

    shim.__name__ = getattr(target, "__name__", "v1_shim")
    shim.__doc__ = (f"v1 adapter over {target.__module__}."
                    f"{shim.__name__} (reference layers.py)")
    return shim


repeat_layer = _v1_delegate(v2l.repeat)
seq_reshape_layer = _v1_delegate(v2l.seq_reshape)
cos_sim = _v1_delegate(v2l.cos_sim)
l2_distance_layer = _v1_delegate(v2l.l2_distance)
hsigmoid = _v1_delegate(v2l.hsigmoid)
square_error_cost = _v1_delegate(v2l.square_error_cost)
seq_concat_layer = _v1_delegate(v2l.seq_concat)
expand_layer = _v1_delegate(v2l.expand)
scaling_layer = _v1_delegate(v2l.scaling)
power_layer = _v1_delegate(v2l.power)
interpolation_layer = _v1_delegate(v2l.interpolation)
bilinear_interp_layer = _v1_delegate(_L("bilinear_interp", 2))
trans_layer = _v1_delegate(v2l.trans)
rotate_layer = _v1_delegate(v2l.rotate)
sum_to_one_norm_layer = _v1_delegate(v2l.sum_to_one_norm)
row_l2_norm_layer = _v1_delegate(v2l.row_l2_norm)
conv_shift_layer = _v1_delegate(v2l.conv_shift)
sampling_id_layer = _v1_delegate(v2l.sampling_id)
slope_intercept_layer = _v1_delegate(v2l.slope_intercept)
linear_comb_layer = _v1_delegate(v2l.linear_comb)
convex_comb_layer = linear_comb_layer  # the reference aliases them
ctc_layer = _v1_delegate(v2l.ctc)
warp_ctc_layer = _v1_delegate(_L("warpctc", 3))
nce_layer = _v1_delegate(v2l.nce)
rank_cost = _v1_delegate(v2l.rank_cost)
huber_regression_cost = _v1_delegate(v2l.huber_regression_cost)
block_expand_layer = _v1_delegate(v2l.block_expand)
maxout_layer = _v1_delegate(v2l.maxout)
dot_prod_layer = _v1_delegate(v2l.dot_prod)
out_prod_layer = _v1_delegate(v2l.out_prod)
priorbox_layer = _v1_delegate(_L("prior_box", 2))
multibox_loss_layer = _v1_delegate(_L("multibox_loss", 2))
pad_layer = _v1_delegate(v2l.pad)
eos_layer = _v1_delegate(v2l.eos)
multiplex_layer = _v1_delegate(v2l.multiplex)
row_conv_layer = _v1_delegate(_L("row_conv", 3))
prelu_layer = _v1_delegate(v2l.prelu)
gated_unit_layer = _v1_delegate(v2l.gated_unit)
kmax_seq_score_layer = _v1_delegate(v2l.kmax_seq_score)
scale_shift_layer = _v1_delegate(v2l.scale_shift)
resize_layer = _v1_delegate(v2l.resize)
factorization_machine = _v1_delegate(v2l.factorization_machine)
def seq_slice_layer(input, starts=None, ends=None, name=None, **kw):
    """seq_slice_layer (reference layers.py:7039): slice [start, end)
    per row — starts=None means 0, ends=None means the row's length.
    Runs over the sub_seq op (offset + size form)."""
    from ..layers.layer_helper import LayerHelper

    _need_op("sub_seq")
    helper = LayerHelper("seq_slice")
    T = int(input.shape[1])
    if starts is None:
        starts = L.fill_constant_batch_size_like(
            input=input, shape=[-1, 1], value=0, dtype="int64")
    if ends is None:
        sl = getattr(input, "seq_len", None)
        ends = (L.reshape(sl, shape=[-1, 1]) if sl is not None else
                L.fill_constant_batch_size_like(
                    input=input, shape=[-1, 1], value=T, dtype="int64"))
    sizes = L.elementwise_sub(ends, starts)
    outs, _ = helper.append_op(
        "sub_seq", {"X": [input], "Offsets": [starts], "Sizes": [sizes]},
        ["Out", "OutLength"], {})
    o = outs["Out"][0]
    o.seq_len = outs["OutLength"][0]
    return _group_register_name(name, o)


def sub_nested_seq_layer(input, selected_indices, name=None, **kw):
    """Select sub-sequences of a nested sequence (reference
    SubNestedSequenceLayer.cpp). The dense lod_level=2 plane is
    [b, S, T, d]; ``selected_indices`` [b, K] picks sub-sequences per
    row (negative = empty slot)."""
    from ..layers.layer_helper import LayerHelper

    _need_op("sub_nested_seq")
    helper = LayerHelper("sub_nested_seq")
    return _group_register_name(name, helper.simple_op(
        "sub_nested_seq",
        {"X": [input], "Indices": [selected_indices]}, {}))


class slice_projection(v2l.BaseProjection):
    """Concatenated feature slices (reference SliceProjection.cpp):
    slices=[(s0, e0), (s1, e1), ...] over the input's last dim."""

    def __init__(self, input, slices, **kw):
        super().__init__(input)
        self.slices = [(int(s), int(e)) for s, e in slices]

    def build(self, size):
        from ..layers.layer_helper import LayerHelper

        helper = LayerHelper("slice_projection")
        rank = len(self.input.shape)
        parts = [helper.simple_op(
            "slice", {"X": [self.input]},
            {"axes": [rank - 1], "starts": [s], "ends": [e]})
            for s, e in self.slices]
        return parts[0] if len(parts) == 1 else L.concat(parts, axis=-1)


gru_step_naive_layer = gru_step_layer  # one fused formulation here


def crop_layer(input, offset, axis=2, shape=None, name=None, **kw):
    """crop_layer (reference CropLayer.cpp): crop dims starting at
    ``axis`` by per-dim ``offset`` to ``shape``. The op takes full-rank
    offsets/shape attrs; leading dims pass through uncropped."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("crop")
    in_shape = list(input.shape)
    rank = len(in_shape)
    offs = [0] * axis + [int(o) for o in offset]
    offs += [0] * (rank - len(offs))
    if shape is None:
        raise ValueError("crop_layer needs the target shape (the "
                         "reference's reference-input form is served by "
                         "passing that layer's static shape)")
    tgt = list(in_shape[:axis]) + [int(d) for d in shape]
    tgt += list(in_shape[len(tgt):])
    # batch dim: crop never touches it; the op slices from offsets
    tgt[0] = in_shape[0] if in_shape[0] != -1 else -1
    attrs = {"offsets": offs, "shape": [int(d) if d != -1 else -1
                                        for d in tgt]}
    return _group_register_name(
        name, helper.simple_op("crop", {"X": [input]}, attrs))
def clip_layer(input, min, max, name=None, **kw):  # noqa: A002
    """clip_layer (reference layers.py signature (input, min, max)):
    elementwise clamp over the clip op (ClipLayer.cpp)."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("clip")
    return _group_register_name(name, helper.simple_op(
        "clip", {"X": [input]}, {"min": float(min), "max": float(max)}))


def spp_layer(input, pyramid_height=3, pool_type=None, name=None, **kw):
    """Spatial pyramid pooling (reference SpatialPyramidPoolLayer.cpp)
    over the spp op."""
    from ..layers.layer_helper import LayerHelper

    _need_op("spp")
    helper = LayerHelper("spp")
    # default max (the reference's); note the spp op currently always
    # max-pools regardless of the attr (ops/extra_ops.py) — the attr is
    # recorded so an avg-capable op picks it up
    ptype = "max" if pool_type is None else _pool.resolve(pool_type)
    return _group_register_name(name, helper.simple_op(
        "spp", {"X": [input]},
        {"pyramid_height": int(pyramid_height), "pooling_type": ptype}))


def roi_pool_layer(input, rois, pooled_width=7, pooled_height=7,
                   spatial_scale=1.0, name=None, **kw):
    """RoI pooling (reference ROIPoolLayer.cpp) over the roi_pool op."""
    from ..layers.layer_helper import LayerHelper

    _need_op("roi_pool")
    helper = LayerHelper("roi_pool")
    return _group_register_name(name, helper.simple_op(
        "roi_pool", {"X": [input], "ROIs": [rois]},
        {"pooled_height": int(pooled_height),
         "pooled_width": int(pooled_width),
         "spatial_scale": float(spatial_scale)}))


def tensor_layer(a, b, size, act=None, param_attr=None, name=None, **kw):
    """Bilinear tensor product (reference TensorLayer.cpp):
    out[:, i] = a @ W_i @ b^T with W [size, dim_a, dim_b]."""
    from ..layers.layer_helper import LayerHelper

    _need_op("tensor_product")
    helper = LayerHelper("tensor_product")
    out = helper.simple_op(
        "tensor_product",
        {"A": [a], "B": [b],
         "Weight": [helper.create_parameter(
             _pa(param_attr),
             shape=[int(size), int(a.shape[-1]), int(b.shape[-1])],
             dtype=a.dtype)]}, {})
    out = helper.append_activation(out, _act.resolve(act))
    return _group_register_name(name, out)


def cross_channel_norm_layer(input, param_attr=None, name=None, **kw):
    """SSD's Normalize (reference CrossChannelNormLayer.cpp): L2
    normalize across channels (NCHW axis 1), learned per-channel scale.
    Composed from existing ops."""
    from ..layers.layer_helper import LayerHelper

    helper = LayerHelper("cross_channel_norm")
    C = int(input.shape[1])
    sq = L.elementwise_mul(input, input)
    ssum = L.reduce_sum(sq, dim=1, keep_dim=True)
    eps = L.fill_constant(shape=[1], value=1e-10, dtype="float32")
    norm = helper.simple_op("sqrt", {"X": [L.elementwise_add(ssum, eps)]},
                            {})
    scale = helper.create_parameter(
        _pa(param_attr), shape=[C], dtype=input.dtype,
        default_initializer=ConstantInitializer(1.0))
    normalized = L.elementwise_div(input, norm)
    out = L.elementwise_mul(normalized, L.reshape(scale,
                                                  shape=[1, C, 1, 1]))
    return _group_register_name(name, out)


def detection_output_layer(input_loc, input_conf, priorbox,
                           prior_variance=None, num_classes=21,
                           nms_threshold=0.45, nms_top_k=400,
                           keep_top_k=200, confidence_threshold=0.01,
                           background_id=0, name=None, **kw):
    """SSD detection output (reference DetectionOutputLayer.cpp):
    decode the predicted loc offsets against the priors (box_coder),
    then score-threshold + NMS (the detection_output op).
    input_loc [b, n_box, 4] offsets; input_conf [b, n_box, n_cls]
    scores; priorbox [n_box, 4]."""
    from ..layers.layer_helper import LayerHelper

    _need_op("detection_output")
    decoded = _L("box_coder", 2)(priorbox, input_loc,
                          prior_variance=prior_variance,
                          code_type="decode_center_size")
    helper = LayerHelper("detection_output")
    return _group_register_name(name, helper.simple_op(
        "detection_output",
        {"Scores": [input_conf], "Boxes": [decoded]},
        {"nms_threshold": float(nms_threshold),
         "nms_top_k": int(nms_top_k),          # per-class NMS candidates
         "keep_top_k": int(keep_top_k),        # global cross-class cap
         "score_threshold": float(confidence_threshold),
         "background_id": int(background_id)}))


def print_layer(input, name=None, **kw):
    """Accepted declaration: the reference prints layer values during
    training; here the evaluator record carries the request and the
    layer passes through unchanged (printing inside the
    program would force a host round-trip per step)."""
    inputs_ = input if isinstance(input, (list, tuple)) else [input]
    if _CTX is not None:
        _evaluator("value_printer", name=name, input=inputs_)
    return input


printer_layer = print_layer


class AggregateLevel:
    """Sequence aggregation levels (reference layers.py AggregateLevel).
    The dense [b, T(, S), d]+length representation makes the level a
    property of the INPUT's shape here; accepted for source compat."""

    TO_NO_SEQUENCE = EACH_SEQUENCE = "non-seq"
    TO_SEQUENCE = EACH_TIMESTEP = "seq"


class ExpandLevel:
    FROM_NO_SEQUENCE = FROM_SEQUENCE = "non-seq"
    FROM_TIMESTEP = "timestep"


class LayerType:
    """Accepted marker namespace (reference layers.py LayerType enum);
    the op registry is the type system here."""


LayerOutput = object  # isinstance checks in user code stay truthy-safe


def layer_support(*attrs):
    """Accepted no-op decorator (reference layer_support marks DROPOUT
    etc.; layer_attr handling is built into every shim here)."""
    def deco(fn):
        return fn

    return deco


class SubsequenceInput(StaticInput):
    """Nested-sequence step input: served by the dense [b, S, T, d]
    plane — inside a recurrent_group the step sees one [b, T, d]
    sub-sequence slice per outer step."""

    def __init__(self, input, **kw):
        super().__init__(input, is_seq=True)


BaseGeneratedInput = GeneratedInput


class BeamInput:
    """cross_entropy_over_beam's input record — the beam-training plane
    is deliberately served by the in-graph beam ops instead (see
    cross_entropy_over_beam)."""

    def __init__(self, candidate_scores=None, selected_candidates=None,
                 gold=None, **kw):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


def cross_entropy_over_beam(input=None, **kw):
    """Deliberate absence with guidance: beam-level CE
    exists for the reference's recurrent_group beam TRAINING machinery
    (CrossEntropyOverBeam.cpp); beam decoding/training here runs through
    the in-graph beam ops (layers.beam_search_decoder,
    models.transformer_lm_beam_search) whose scores are pinned to
    independent full-forward log-probs."""
    raise NotImplementedError(
        "cross_entropy_over_beam is served by the in-graph beam plane: "
        "train with teacher-forced softmax_with_cross_entropy and decode "
        "with layers.beam_search_decoder / "
        "models.transformer_lm_beam_search")


def beam_search(step, input, bos_id, eos_id, beam_size, max_length=100,
                **kw):
    """In-config beam-search generation (reference layers.py
    beam_search over recurrent_group): deliberately served by the
    in-graph decode ops — see GeneratedInput."""
    raise NotImplementedError(
        "in-config beam_search is served by the in-graph decode ops: "
        "models.transformer_lm_beam_search / layers.beam_search_decoder")


# ---------------------------------------------------------------------------
# evaluators: record the declaration; the v1 trainer materializes them
# ---------------------------------------------------------------------------

def evaluator_base(input, type=None, name=None, **kw):
    """The reference's evaluator_base: record an arbitrary evaluator
    declaration by type string."""
    _evaluator(str(type or "custom"), name=name, input=input, **kw)


def _evaluator(kind, **kw):
    _ctx().evaluators.append({"kind": kind, **kw})


def sum_evaluator(input, name=None, **kw):
    _evaluator("sum", name=name, input=input)


def classification_error_evaluator(input, label, name=None, **kw):
    _evaluator("classification_error", name=name, input=input, label=label)


def chunk_evaluator(input, label=None, chunk_scheme=None,
                    num_chunk_types=None, name=None, **kw):
    _evaluator("chunk", name=name, input=input, label=label,
               chunk_scheme=chunk_scheme, num_chunk_types=num_chunk_types)


def auc_evaluator(input, label, name=None, **kw):
    _evaluator("auc", name=name, input=input, label=label)


def precision_recall_evaluator(input, label, name=None, **kw):
    _evaluator("precision_recall", name=name, input=input, label=label)


def pnpair_evaluator(input, label, query_id=None, weight=None, name=None,
                     **kw):
    """Positive-negative pair ranking evaluator (reference Evaluator.cpp
    PnpairEvaluator); materialized by evaluator.PnpairEvaluator."""
    _evaluator("pnpair", name=name, input=input, label=label,
               query_id=query_id, weight=weight)


def ctc_error_evaluator(input, label, name=None, **kw):
    """CTC edit-distance evaluator (reference CTCErrorEvaluator.cpp);
    materialized by evaluator.CTCErrorEvaluator."""
    _evaluator("ctc_error", name=name, input=input, label=label)


def column_sum_evaluator(input, name=None, **kw):
    _evaluator("column_sum", name=name, input=input)


def detection_map_evaluator(input, label, name=None,
                            overlap_threshold=0.5, background_id=0,
                            evaluate_difficult=False, ap_type="11point",
                            **kw):
    """Detection mAP (reference Evaluator.cpp detection map);
    materialized by evaluator.DetectionMAPEvaluator."""
    _evaluator("detection_map", name=name, input=input, label=label,
               overlap_threshold=overlap_threshold,
               background_id=background_id, ap_type=ap_type)


def value_printer_evaluator(input, name=None, **kw):
    _evaluator("value_printer", name=name, input=input)


def gradient_printer_evaluator(input, name=None, **kw):
    _evaluator("gradient_printer", name=name, input=input)


def maxid_printer_evaluator(input, name=None, **kw):
    _evaluator("maxid_printer", name=name, input=input)


def maxframe_printer_evaluator(input, name=None, **kw):
    _evaluator("maxframe_printer", name=name, input=input)


def seqtext_printer_evaluator(input, result_file=None, name=None, **kw):
    _evaluator("seqtext_printer", name=name, input=input,
               result_file=result_file)


def classification_error_printer_evaluator(input, label, name=None, **kw):
    _evaluator("classification_error_printer", name=name, input=input,
               label=label)


def _register_named(fn):
    """Wrap a layer shim so a name= kwarg registers the result in the
    Outputs()/memory name registry — the reference accepts name= on
    EVERY layer, not just the handful that consume it."""
    import functools

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        nm = kw.get("name")
        if nm and hasattr(out, "name"):
            _group_register_name(nm, out)
        return out

    return wrapped


for _n in list(globals()):
    if (_n.endswith("_layer") or _n in ("lstmemory", "grumemory",
                                        "mixed_layer", "first_seq",
                                        "last_seq", "classification_cost",
                                        "cross_entropy", "regression_cost",
                                        "lambda_cost",
                                        "cross_entropy_with_selfnorm",
                                        "img_conv_group",
                                        "simple_img_conv_pool")):
        _f = globals()[_n]
        if callable(_f) and not isinstance(_f, type):
            globals()[_n] = _register_named(_f)
del _n, _f


xrange = range  # py2-era reference configs iterate with xrange


# everything a `from paddle.trainer_config_helpers import *` should see
_EXPORTS = [n for n in dir() if not n.startswith("_")
            and n not in ("annotations", "importlib", "math", "os", "sys",
                          "Optional")]
