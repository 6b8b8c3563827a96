"""ParamAttr: per-parameter configuration (name, initializer,
learning-rate multiplier, regularizer, trainable flag, gradient clip,
updater hooks). Counterpart of ``paddle_tpu/param_attr.py``, whole."""
from __future__ import annotations

from .initializer import Initializer


class StaticPruningHook:
    """An updater hook: a fixed mask keeping the largest |w|
    (1 - sparsity_ratio) share of the initial weights, applied after
    every optimizer update (``Optimizer._append_updater_hooks``)."""

    def __init__(self, sparsity_ratio: float = 0.6):
        if not 0.0 <= sparsity_ratio < 1.0:
            raise ValueError(f"sparsity_ratio must be in [0, 1), got "
                             f"{sparsity_ratio}")
        self.sparsity_ratio = float(sparsity_ratio)


def Hook(type: str, sparsity_ratio: float = 0.6):
    """A HookConfig-style factory: 'pruning' is the only type."""
    if type != "pruning":
        raise ValueError(f"unknown updater hook type {type!r}")
    return StaticPruningHook(sparsity_ratio)


class ParamAttr:
    def __init__(self, name: str = None, initializer: Initializer = None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None,
                 update_hooks=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        if update_hooks is not None and not isinstance(update_hooks,
                                                       (list, tuple)):
            update_hooks = [update_hooks]
        self.update_hooks = list(update_hooks or [])

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if arg is False:
            return None  # explicit "no parameter" (e.g. bias_attr=False)
        raise TypeError(f"cannot interpret {arg!r} as ParamAttr")
