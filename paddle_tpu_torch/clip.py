"""Gradient clipping, built into the training program as ops.

Counterpart of ``paddle_tpu/clip.py``, whole: ``GradientClipByValue``
appends a ``clip`` op a gradient, ``GradientClipByNorm`` a
``clip_by_norm`` op, and ``GradientClipByGlobalNorm`` one
``clip_by_global_norm`` op over every gradient whose parameter shares
the attr, so the norm and all the rescales are one op. A sparse
embedding's SelectedRows gradient stays rows through each: the ops merge
its duplicate rows before they bound or measure it.
"""
from __future__ import annotations

import functools

from .layers.layer_helper import LayerHelper

__all__ = [
    "BaseGradientClipAttr", "NullGradientClipAttr", "GradientClipByValue",
    "GradientClipByNorm", "GradientClipByGlobalNorm", "ClipByValue",
    "append_gradient_clip_ops", "set_gradient_clip",
]


class BaseGradientClipAttr:
    def process_context(self, context, p_g):
        raise NotImplementedError()

    def create_operators(self, param, grad):
        raise NotImplementedError()


class NullGradientClipAttr(BaseGradientClipAttr):
    def process_context(self, context, p_g):
        pass

    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    """Elementwise clip to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = -self.max if min is None else float(min)

    def process_context(self, context, p_g):
        pass

    def create_operators(self, param, grad):
        helper = LayerHelper("gradient_clip",
                             main_program=param.block.program)
        new_grad = helper.simple_op(
            "clip", {"X": [grad]}, {"min": self.min, "max": self.max})
        return param, new_grad


class GradientClipByNorm(BaseGradientClipAttr):
    """Rescale one gradient to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def process_context(self, context, p_g):
        pass

    def create_operators(self, param, grad):
        helper = LayerHelper("gradient_clip",
                             main_program=param.block.program)
        new_grad = helper.simple_op(
            "clip_by_norm", {"X": [grad]}, {"max_norm": self.clip_norm})
        return param, new_grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Rescale all the gradients whose parameters share this instance
    together, so that the L2 norm of the set is at most clip_norm: one
    op for the group."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)
        self._group = []
        self._clipped = None

    def process_context(self, context, p_g):
        # this instance's group, once an append_gradient_clip_ops run
        self._group = [(p, g) for p, g in p_g
                       if getattr(p, "gradient_clip", None) is self]
        self._clipped = None

    def create_operators(self, param, grad):
        if self._clipped is None:
            helper = LayerHelper("gradient_clip",
                                 main_program=param.block.program)
            block = param.block
            grads = [g for _, g in self._group]
            out_vars = [
                block.create_var(
                    name=block.program.unique_name(g.name + "@CLIP"),
                    shape=g.shape, dtype=g.dtype, stop_gradient=True)
                for g in grads
            ]
            helper.append_op("clip_by_global_norm", {"X": grads},
                             {"Out": out_vars}, {"max_norm": self.clip_norm})
            self._clipped = {g.name: v for g, v in zip(grads, out_vars)}
        return param, self._clipped[grad.name]


ClipByValue = GradientClipByValue


def set_gradient_clip(clip, param_list=None, program=None):
    """Attach ``clip`` to every parameter of ``param_list`` (by default
    every parameter of ``program``)."""
    from .core.program import default_main_program

    if not isinstance(clip, BaseGradientClipAttr):
        raise TypeError(
            "clip should be an instance of BaseGradientClipAttr")
    program = program or default_main_program()
    if param_list is None:
        params = program.global_block.all_parameters()
    else:
        params = [program.global_block.var(p) if isinstance(p, str) else p
                  for p in param_list]
    for p in params:
        p.gradient_clip = clip


def append_gradient_clip_ops(param_grad):
    """Append the clip ops the parameters' ``gradient_clip`` attrs ask
    for; returns the new [(param, grad)] list."""
    context = {}
    callbacks = []
    seen = set()
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip", None) or NullGradientClipAttr()
        if not isinstance(clip_attr, BaseGradientClipAttr):
            raise TypeError(
                "gradient_clip should be an instance of BaseGradientClipAttr")
        if id(clip_attr) not in seen:
            seen.add(id(clip_attr))
            clip_attr.process_context(context=context, p_g=param_grad)
        callbacks.append(functools.partial(
            clip_attr.create_operators, param=p, grad=g))
    return [cb() for cb in callbacks]
