"""Transformer language model (decoder-only, causal).

Counterpart of ``paddle_tpu/models/transformer.py``:

- ``transformer_lm`` builds the LM into a Program with the port's
  ``layers``, for training through ``Optimizer.minimize`` and
  ``Executor``: per layer (``transformer_encoder_layer`` blocks, the
  model the JAX package's benchmark trains) or stacked (one
  ``pipelined_transformer_stack`` op);
- :class:`TransformerLM` holds the stacked LM's weights for serving.

The stacked form and :class:`TransformerLM` use the JAX package's
parameter names (``tok_emb``, ``pos_emb``, ``lm_stack.stack_*``,
``final_ln.scale``, ``final_ln.bias``, ``lm_head.w``) and layout ([in,
out] matrices applied as ``x @ W``, a leading [L] layer axis on the
block weights), so a trained scope's values, or a JAX scope's, load into
:class:`TransformerLM` by name with :meth:`load_jax_params`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import layers
from ..layers.layer_helper import LayerHelper
from ..ops.pipeline_ops import _STACK_SLOTS
from ..param_attr import ParamAttr


def transformer_lm(ids, vocab_size, d_model=256, n_layers=4, num_heads=8,
                   d_ff=None, num_kv_heads=None, use_rope=False,
                   max_len=2048, norm_type="layer_norm",
                   pipeline_stack=False, n_microbatches=None, remat=False,
                   include_head=True, main_program=None,
                   startup_program=None):
    """ids [b, T] int64 -> logits [b, T, vocab]: pre-LN GPT-style blocks,
    a learned positional embedding (or RoPE), an untied output head.

    ``pipeline_stack=False`` (the default, the model the JAX package's
    benchmark trains) builds ``n_layers`` ``transformer_encoder_layer``
    blocks, about ten ops each; ``pipeline_stack=True`` one
    ``pipelined_transformer_stack`` op over [L, ...] weights under fixed
    names the serving engines rejoin. ``remat`` (recompute segments) and
    a headless model (``include_head=False``, for
    ``fused_head_cross_entropy``) are not ported yet."""
    # validate before building anything: a raise must not leave orphan
    # embedding ops or parameters in the caller's program
    if pipeline_stack and norm_type != "layer_norm":
        raise ValueError(
            "pipeline_stack=True supports norm_type='layer_norm' only")
    if not include_head:
        raise NotImplementedError(
            "transformer_lm(include_head=False) feeds "
            "fused_head_cross_entropy, which is not ported to "
            "paddle_tpu_torch yet (ROADMAP.md Queue 1 item 6)")
    if remat and not pipeline_stack:
        raise NotImplementedError(
            "transformer_lm(remat=True) (one recompute segment per block) "
            "is not ported to paddle_tpu_torch yet: recompute segments are "
            "ROADMAP.md Queue 1 item 4")
    kw = dict(main_program=main_program, startup_program=startup_program)
    d_ff = d_ff or 4 * d_model
    tok = layers.embedding(ids, size=[vocab_size, d_model],
                           param_attr=ParamAttr(name="tok_emb"), **kw)
    tok.seq_len = getattr(ids, "seq_len", None)
    T = ids.shape[1]
    helper = LayerHelper("transformer_lm", **kw)
    if use_rope:
        x = tok  # positions live in the attention rotation
    else:
        pos_table = helper.create_parameter(
            ParamAttr(name="pos_emb"), shape=[max_len, d_model],
            dtype="float32")
        pos = helper.simple_op("slice", {"X": [pos_table]},
                               {"axes": [0], "starts": [0], "ends": [T]})
        x = helper.simple_op("elementwise_add", {"X": [tok], "Y": [pos]})
        x.seq_len = tok.seq_len
    ln_attr = ln_bias = head_attr = None
    if pipeline_stack:
        if "lm_stack.stack_qkv_w" in helper.main_program.global_block.vars:
            raise ValueError(
                "transformer_lm(pipeline_stack=True) may be built only once "
                "per program: its parameter names (lm_stack.*, final_ln.*, "
                "lm_head.w) are fixed, and a second stacked LM in the same "
                "program would silently share weights")
        x = layers.pipelined_transformer_stack(
            x, n_layers=n_layers, num_heads=num_heads, d_ff=d_ff,
            num_kv_heads=num_kv_heads, use_rope=use_rope, causal=True,
            n_microbatches=n_microbatches, remat=remat,
            param_attr=ParamAttr(name="lm_stack"), **kw)
        ln_attr = ParamAttr(name="final_ln.scale")
        ln_bias = ParamAttr(name="final_ln.bias")
        head_attr = ParamAttr(name="lm_head.w")
    else:
        for _ in range(n_layers):
            x = layers.transformer_encoder_layer(
                x, num_heads=num_heads, d_ff=d_ff,
                num_kv_heads=num_kv_heads, use_rope=use_rope, causal=True,
                norm_type=norm_type, **kw)
    if norm_type == "rms_norm":
        x = layers.rms_norm(x, begin_norm_axis=2, **kw)
    else:
        x = layers.layer_norm(x, begin_norm_axis=2, param_attr=ln_attr,
                              bias_attr=ln_bias, **kw)
    return layers.fc(x, size=vocab_size, num_flatten_dims=2,
                     param_attr=head_attr, bias_attr=False, **kw)


def param_shapes(spec) -> Dict[str, tuple]:
    """JAX parameter name -> shape for an LMSpec (``_shared_lm_params``
    and ``make_stack_params`` in the JAX package)."""
    V, d, L = spec.vocab_size, spec.d_model, spec.n_layers
    f = spec.d_ff or 4 * d
    d_kv = spec.head_dim * spec.kv_heads
    shapes = {"tok_emb": (V, d)}
    if not spec.use_rope:
        shapes["pos_emb"] = (spec.max_len, d)
    shapes.update({
        "lm_stack.stack_ln1_s": (L, d), "lm_stack.stack_ln1_b": (L, d),
        "lm_stack.stack_qkv_w": (L, d, d + 2 * d_kv),
        "lm_stack.stack_out_w": (L, d, d),
        "lm_stack.stack_ln2_s": (L, d), "lm_stack.stack_ln2_b": (L, d),
        "lm_stack.stack_ff_w1": (L, d, f), "lm_stack.stack_ff_b1": (L, f),
        "lm_stack.stack_ff_w2": (L, f, d), "lm_stack.stack_ff_b2": (L, d),
        "final_ln.scale": (d,), "final_ln.bias": (d,),
        "lm_head.w": (d, V),
    })
    return shapes


def init_params(spec, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random f32 weights for ``spec`` made with numpy from ``seed``, under
    the JAX names: Xavier-uniform matrices and embeddings, unit norm
    scales, zero biases."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in param_shapes(spec).items():
        if name.endswith(("_s", ".scale")):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_b", ".bias", "_b1", "_b2")):
            params[name] = np.zeros(shape, np.float32)
        else:
            fan_in, fan_out = shape[-2], shape[-1]
            lim = np.float32(np.sqrt(6.0 / (fan_in + fan_out)))
            u = rng.random(shape, dtype=np.float32)
            params[name] = (u * 2 - 1) * lim
    return params


class _Params(nn.Module):
    """A parameter group, so ``named_parameters`` spells the JAX names
    (``final_ln.scale``, ``lm_stack.stack_qkv_w``)."""

    def __init__(self, shapes: Dict[str, tuple], device):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device), requires_grad=False))


class TransformerLM(nn.Module):
    """The stacked-weight LM's parameters for serving (no autograd)."""

    def __init__(self, spec, device=None):
        super().__init__()
        from .. import resolve_device

        self.spec = spec
        dev = resolve_device(device)
        groups: Dict[str, Dict[str, tuple]] = {}
        for name, shape in param_shapes(spec).items():
            head, _, tail = name.rpartition(".")
            groups.setdefault(head, {})[tail] = shape
        for name, shape in groups.pop("").items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=dev), requires_grad=False))
        for head, shapes in groups.items():
            self.add_module(head, _Params(shapes, dev))

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    @classmethod
    def from_jax_params(cls, spec, params: Dict[str, np.ndarray],
                        device=None) -> "TransformerLM":
        model = cls(spec, device)
        model.load_jax_params(params)
        return model

    @torch.no_grad()
    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy the JAX package's parameters in by name (e.g. a JAX
        Scope's values as numpy arrays). Names the model does not hold
        (caches, RNG state, optimizer slots) are ignored; a missing name
        or a shape mismatch raises."""
        for name, p in self.named_parameters():
            if name not in params:
                raise KeyError(f"parameter {name!r} missing from the "
                               "source params")
            src = np.asarray(params[name], dtype=np.float32)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"parameter {name!r}: source shape "
                                 f"{src.shape} != model shape "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(src))

    def shared_lm_inputs(self) -> Dict[str, list]:
        """The decode ops' weight inputs, keyed by op slot (the
        ``_shared_lm_params`` contract)."""
        st = self.lm_stack
        ins = {"TokEmb": [self.tok_emb],
               "FinalLnS": [self.final_ln.scale],
               "FinalLnB": [self.final_ln.bias],
               "HeadW": [self.lm_head.w]}
        if not self.spec.use_rope:
            ins["PosEmb"] = [self.pos_emb]
        for slot, suffix in _STACK_SLOTS.items():
            ins[slot] = [getattr(st, f"stack_{suffix}")]
        return ins
