"""Weight-decay regularizers. Counterpart of ``paddle_tpu/regularizer.py``,
cut to what ``Optimizer.minimize`` calls with no regularizer set: L1/L2
decay ops are a later slice of the port."""
from __future__ import annotations


def append_regularization_ops(params_grads, regularization=None):
    """[(param, grad)] unchanged; a regularizer (global or per parameter)
    raises, naming the slice that brings it."""
    for param, _ in params_grads:
        if (getattr(param, "regularizer", None) or regularization) is not None:
            raise NotImplementedError(
                f"parameter {param.name!r} has a regularizer: weight decay "
                "is not ported to paddle_tpu_torch yet (ROADMAP.md Queue 1 "
                "item 3; AdamWOptimizer's decoupled weight_decay is "
                "ported)")
    return list(params_grads)
