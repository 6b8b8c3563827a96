"""Gradient clipping. Counterpart of ``paddle_tpu/clip.py``, cut to what
``Optimizer.minimize`` calls when no parameter sets a clip: the clip ops
(``clip``, ``clip_by_norm``, ``clip_by_global_norm``) are a later slice
of the port."""
from __future__ import annotations


def append_gradient_clip_ops(param_grad):
    """[(param, grad)] unchanged; a parameter with a ``gradient_clip``
    raises, naming the slice that brings clipping."""
    for p, _ in param_grad:
        if getattr(p, "gradient_clip", None) is not None:
            raise NotImplementedError(
                f"parameter {p.name!r} sets gradient_clip: gradient "
                "clipping is not ported to paddle_tpu_torch yet (it lands "
                "with the optimizer-plane slice)")
    return list(param_grad)
