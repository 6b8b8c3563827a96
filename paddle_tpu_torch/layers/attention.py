"""Transformer layers. Counterpart of ``paddle_tpu/layers/attention.py``:
the per-layer transformer (``multi_head_attention``,
``transformer_encoder_layer``) and the stacked-weight one
(``make_stack_params``, ``pipelined_transformer_stack``). The Switch MoE
FFN and sequence-parallel (ring) attention are not ported (ROADMAP.md
Queue 1)."""
from __future__ import annotations

import copy

from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr
from .layer_helper import LayerHelper
from .sequence import get_seq_len


def multi_head_attention(queries, keys=None, values=None, d_model=None,
                         num_heads=8, num_kv_heads=None, causal=False,
                         use_rope=False, sequence_parallel=False,
                         param_attr=None, main_program=None,
                         startup_program=None):
    """Multi-head attention over [b, T, d_model] sequences; self-attention
    when keys/values are omitted. Returns [b, T, d_model].

    Self-attention projects q, k and v with one fused [d, d + 2 d_kv]
    product and splits it; ``num_kv_heads`` < num_heads gives
    grouped-query attention (the op repeats the K/V heads);
    ``use_rope`` rotates the q/k heads in place of learned positions.
    The heads [b, H, T, d/H] go through ``scaled_dot_product_attention``
    (the flash kernels), with the keys' ``seq_len`` as its ``Length``."""
    from . import tensor as T

    if sequence_parallel:
        raise NotImplementedError(
            "sequence-parallel (ring) attention is not ported to "
            "paddle_tpu_torch; see ROADMAP.md Queue 1 item 10")
    helper = LayerHelper("multi_head_attention", main_program=main_program,
                         startup_program=startup_program)
    keys = queries if keys is None else keys
    values = keys if values is None else values
    d_model = d_model or queries.shape[-1]
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} not divisible by heads "
                         f"{num_heads}")
    num_kv_heads = num_kv_heads or num_heads
    if num_heads % num_kv_heads:
        raise ValueError(f"num_heads {num_heads} not a multiple of "
                         f"num_kv_heads {num_kv_heads}")
    head_d = d_model // num_heads
    d_kv = head_d * num_kv_heads
    self_attn = keys is queries

    def proj(x, width, name):
        # each projection gets its own parameter: a user-provided name is
        # suffixed, so qkv and out never share one weight
        attr = ParamAttr.to_attr(param_attr)
        if attr is not None and attr.name:
            attr = copy.copy(attr)
            attr.name = f"{attr.name}.{name}"
        w = helper.create_parameter(
            attr, shape=[x.shape[-1], width], dtype=x.dtype,
            default_initializer=XavierInitializer())
        return helper.simple_op("mul", {"X": [x], "Y": [w]},
                                {"x_num_col_dims": 2})

    mp, sp = helper.main_program, helper.startup_program
    if self_attn:
        qkv = proj(queries, d_model + 2 * d_kv, "qkv")  # one fused product
        q, k, v = T.split(qkv, [d_model, d_kv, d_kv], dim=2,
                          main_program=mp, startup_program=sp)
    else:
        q = proj(queries, d_model, "q")
        k = proj(keys, d_kv, "k")
        v = proj(values, d_kv, "v")

    def heads(x, t_len, n):
        x = T.reshape(x, [-1, t_len, n, head_d], main_program=mp,
                      startup_program=sp)
        return T.transpose(x, [0, 2, 1, 3], main_program=mp,
                           startup_program=sp)

    tq, tk = queries.shape[1], keys.shape[1]
    qh = heads(q, tq, num_heads)
    kh = heads(k, tk, num_kv_heads)
    vh = heads(v, tk, num_kv_heads)
    if use_rope:
        qh = helper.simple_op("rotary_embed", {"X": [qh]})
        kh = helper.simple_op("rotary_embed", {"X": [kh]})
    ins = {"Q": [qh], "K": [kh], "V": [vh]}
    sl = get_seq_len(keys)
    if sl is not None:
        ins["Length"] = [sl]
    ctx = helper.simple_op("scaled_dot_product_attention", ins,
                           {"causal": causal,
                            "sequence_parallel": sequence_parallel})
    ctx = T.transpose(ctx, [0, 2, 1, 3], main_program=mp, startup_program=sp)
    ctx = T.reshape(ctx, [-1, tq, d_model], main_program=mp,
                    startup_program=sp)
    o = proj(ctx, d_model, "out")
    o.seq_len = get_seq_len(queries)
    return o


def transformer_encoder_layer(x, num_heads, d_ff, causal=False,
                              num_kv_heads=None, use_rope=False,
                              dropout_prob=0.0, sequence_parallel=False,
                              moe_experts=0, norm_type="layer_norm",
                              main_program=None, startup_program=None):
    """Pre-LN transformer block: x + MHA(LN(x)); x + FFN(LN(x)), the FFN
    fc(d_ff, gelu) -> [dropout] -> fc(d_model). ``norm_type="rms_norm"``
    swaps both pre-norms for RMSNorm. The Switch MoE FFN
    (``moe_experts``) and ring attention (``sequence_parallel``) are not
    ported."""
    from . import nn as N

    if norm_type not in ("layer_norm", "rms_norm"):
        raise ValueError(f"norm_type must be 'layer_norm' or 'rms_norm', "
                         f"got {norm_type!r}")
    if moe_experts:
        raise NotImplementedError(
            "transformer_encoder_layer(moe_experts=...) (the Switch MoE "
            "FFN) is not ported to paddle_tpu_torch; see ROADMAP.md Queue 1 "
            "item 10")
    if sequence_parallel:
        raise NotImplementedError(
            "sequence-parallel (ring) attention is not ported to "
            "paddle_tpu_torch; see ROADMAP.md Queue 1 item 10")

    def pre_norm(t, **kw2):
        if norm_type == "rms_norm":
            return N.rms_norm(t, begin_norm_axis=2, **kw2)
        return N.layer_norm(t, begin_norm_axis=2, **kw2)

    kw = dict(main_program=main_program, startup_program=startup_program)
    d_model = x.shape[-1]
    h = pre_norm(x, **kw)
    h.seq_len = get_seq_len(x)
    attn = multi_head_attention(h, num_heads=num_heads, causal=causal,
                                num_kv_heads=num_kv_heads,
                                use_rope=use_rope, **kw)
    helper = LayerHelper("transformer", **kw)
    x = helper.simple_op("elementwise_add", {"X": [x], "Y": [attn]})
    h2 = pre_norm(x, **kw)
    ff = N.fc(h2, size=d_ff, num_flatten_dims=2, act="gelu", **kw)
    if dropout_prob:
        ff = N.dropout(ff, dropout_prob, **kw)
    ff = N.fc(ff, size=d_model, num_flatten_dims=2, **kw)
    o = helper.simple_op("elementwise_add", {"X": [x], "Y": [ff]})
    o.seq_len = get_seq_len(x)
    return o


def make_stack_params(helper, base, L, d_model, d_ff, dtype="float32",
                      num_heads=None, num_kv_heads=None, param_attr=None):
    """Create (or rejoin by name) the stacked [L, ...] block weights for
    ``pipelined_transformer_stack``: returns the op-input dict keyed by
    slot name. Names follow ``{base}.stack_{suffix}``, so sibling
    programs (training vs generation) address the same tensors."""

    def mk(suffix, shape, bias=False, fan=None, init=None):
        attr = (ParamAttr.to_attr(param_attr) if param_attr is not None
                else ParamAttr())
        attr = copy.copy(attr)
        attr.name = f"{base}.stack_{suffix}"
        if init is None and not bias:
            init = XavierInitializer(fan_in=fan[0], fan_out=fan[1])
        return helper.create_parameter(
            attr, shape=shape, dtype=dtype, is_bias=bias,
            default_initializer=init)

    one = ConstantInitializer(1.0)
    # GQA: KV planes carry num_kv_heads < num_heads head groups
    d_kv = (d_model if not (num_heads and num_kv_heads)
            else d_model // num_heads * num_kv_heads)
    qkv_width = d_model + 2 * d_kv
    return {
        "Ln1S": [mk("ln1_s", [L, d_model], bias=True, init=one)],
        "Ln1B": [mk("ln1_b", [L, d_model], bias=True)],
        "QkvW": [mk("qkv_w", [L, d_model, qkv_width],
                    fan=(d_model, qkv_width))],
        "OutW": [mk("out_w", [L, d_model, d_model],
                    fan=(d_model, d_model))],
        "Ln2S": [mk("ln2_s", [L, d_model], bias=True, init=one)],
        "Ln2B": [mk("ln2_b", [L, d_model], bias=True)],
        "FfW1": [mk("ff_w1", [L, d_model, d_ff], fan=(d_model, d_ff))],
        "FfB1": [mk("ff_b1", [L, d_ff], bias=True)],
        "FfW2": [mk("ff_w2", [L, d_ff, d_model], fan=(d_ff, d_model))],
        "FfB2": [mk("ff_b2", [L, d_model], bias=True)],
    }


def pipelined_transformer_stack(x, n_layers, num_heads, d_ff=None,
                                num_kv_heads=None, use_rope=False,
                                causal=True, n_microbatches=None,
                                pipe_axis="pp", data_axis="dp", remat=False,
                                param_attr=None, main_program=None,
                                startup_program=None):
    """L pre-LN transformer blocks with stacked [L, ...] weights, one op.
    Names carry a ``.stack_`` marker, as in the JAX package."""
    if get_seq_len(x) is not None:
        raise NotImplementedError(
            "pipelined_transformer_stack assumes full-length sequences; "
            "padded variable-length batches should use the per-layer "
            "transformer_encoder_layer path (which masks via Length)")
    helper = LayerHelper("pipelined_transformer_stack",
                         main_program=main_program,
                         startup_program=startup_program)
    d_model = x.shape[-1]
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} not divisible by heads "
                         f"{num_heads}")
    d_ff = d_ff or 4 * d_model
    given = ParamAttr.to_attr(param_attr)
    base = (given.name if given is not None and given.name
            else helper.main_program.unique_name("pipe"))
    if num_kv_heads and num_heads % num_kv_heads:
        raise ValueError(f"num_heads {num_heads} not a multiple of "
                         f"num_kv_heads {num_kv_heads}")
    ins = {"X": [x]}
    ins.update(make_stack_params(helper, base, n_layers, d_model, d_ff,
                                 dtype=x.dtype, num_heads=num_heads,
                                 num_kv_heads=num_kv_heads,
                                 param_attr=param_attr))
    return helper.simple_op(
        "pipelined_transformer_stack", ins,
        {"num_heads": num_heads, "num_kv_heads": num_kv_heads,
         "use_rope": use_rope, "causal": causal,
         "n_microbatches": n_microbatches, "pipe_axis": pipe_axis,
         "data_axis": data_axis, "remat": remat})
