"""Transformer layers. Counterpart of ``paddle_tpu/layers/attention.py``,
cut to the stacked-weight transformer (``make_stack_params``,
``pipelined_transformer_stack``) the training slice builds."""
from __future__ import annotations

import copy

from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr
from .layer_helper import LayerHelper


def get_seq_len(var):
    """The lengths Variable travelling with ``var`` (or None)."""
    return getattr(var, "seq_len", None)


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
