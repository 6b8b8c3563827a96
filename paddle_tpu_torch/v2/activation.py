"""v2 activation objects. Counterpart of ``paddle_tpu/v2/activation.py``
(reference python/paddle/v2/activation.py): each carries the act name the
layer functions understand."""


class BaseActivation:
    name: str = ""

    def __repr__(self):
        return f"activation.{type(self).__name__}()"


def _make(cls_name, act_name):
    return type(cls_name, (BaseActivation,), {"name": act_name})


Linear = _make("Linear", "")
Relu = _make("Relu", "relu")
BRelu = _make("BRelu", "brelu")
SoftRelu = _make("SoftRelu", "softplus")
Tanh = _make("Tanh", "tanh")
STanh = _make("STanh", "stanh")
Sigmoid = _make("Sigmoid", "sigmoid")
Softmax = _make("Softmax", "softmax")
Exp = _make("Exp", "exp")
Log = _make("Log", "log")
Abs = _make("Abs", "abs")
Square = _make("Square", "square")
SequenceSoftmax = _make("SequenceSoftmax", "softmax")
Sqrt = _make("Sqrt", "sqrt")
Reciprocal = _make("Reciprocal", "reciprocal")
SoftSign = _make("SoftSign", "softsign")


def resolve(act):
    """None | BaseActivation | str -> act name (or None)."""
    if act is None:
        return None
    if isinstance(act, str):
        return act or None
    return act.name or None
