"""v2 sequence-pooling objects. Counterpart of ``paddle_tpu/v2/pooling.py``
(reference v2/pooling.py)."""


class BasePooling:
    name: str = "average"


class Max(BasePooling):
    name = "max"


class Avg(BasePooling):
    name = "average"


class Sum(BasePooling):
    name = "sum"


class SquareRootN(BasePooling):
    name = "sqrt"


def resolve(p):
    if p is None:
        return "average"
    if isinstance(p, str):
        return p
    if isinstance(p, type):
        p = p()
    return p.name
