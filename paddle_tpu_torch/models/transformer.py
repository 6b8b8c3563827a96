"""Transformer language model (decoder-only, causal) for serving.

Counterpart of ``paddle_tpu/models/transformer.py`` for the stacked-weight
LM (``transformer_lm(pipeline_stack=True)``). :class:`TransformerLM` holds
the weights under the JAX package's parameter names (``tok_emb``,
``pos_emb``, ``lm_stack.stack_*``, ``final_ln.scale``, ``final_ln.bias``,
``lm_head.w``), in the JAX layout ([in, out] matrices applied as
``x @ W``, a leading [L] layer axis on the block weights), so a JAX
scope's values carry across by name with :meth:`load_jax_params`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..ops.pipeline_ops import _STACK_SLOTS


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
