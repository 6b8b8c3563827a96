"""ParamAttr — per-parameter configuration (name, initializer,
learning-rate multiplier, regularizer, trainable flag, gradient clip).
Counterpart of ``paddle_tpu/param_attr.py``; updater hooks (static
pruning) are a later slice of the port."""
from __future__ import annotations

from .initializer import Initializer


class ParamAttr:
    def __init__(self, name: str = None, initializer: Initializer = None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

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
