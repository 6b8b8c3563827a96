"""Matrix ops. Counterpart of ``paddle_tpu/ops/math_ops.py``: ``mul``
(the training slice's LM head), ``matmul`` (the batched product of
primitive attention programs), and the row products ``dot`` and
``cos_sim``. The product is a plain
``torch.matmul`` (cuBLAS on the card), as the JAX package leaves it to
XLA: f32, or under AMP bf16 operands with f32 accumulation and a bf16
result (``common.matmul``). Its gradient is the generic vjp."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from . import common as C
from .common import amp_cast, matmul as _matmul, out, single


@register_op("mul")
def mul(attrs, ins):
    """Reference mul_op: flatten X to 2-D at x_num_col_dims, ditto Y, matmul."""
    x = single(ins, "X")
    y = single(ins, "Y")
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    x2, y2 = amp_cast(x.reshape(math.prod(x.shape[:xd]), -1),
                      y.reshape(math.prod(y.shape[:yd]), -1))
    return out(Out=_matmul(x2, y2).reshape(tuple(x.shape[:xd])
                                          + tuple(y.shape[yd:])))


@register_op("matmul")
def matmul(attrs, ins):
    """Batched X @ Y with optional transposes of the last two dims, times
    ``alpha`` when it is not 1."""
    x = single(ins, "X")
    y = single(ins, "Y")
    if attrs.get("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    x, y = amp_cast(x, y)
    res = _matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        res = res * torch.tensor(alpha, dtype=res.dtype)
    return out(Out=res)



@register_op("dot")
def dot(attrs, ins):
    """Row dot products: sum(x * y) over the last dim, kept."""
    return out(Out=C.row_sum(torch.mul, single(ins, "X"), single(ins, "Y")))


@register_op("cos_sim")
def cos_sim(attrs, ins):
    """Row cosines x.y / (|x| |y| + 1e-12), with the norms as XNorm and
    YNorm."""
    x = single(ins, "X")
    y = single(ins, "Y")
    xn = C.sqrt(C.row_sum(torch.mul, x, x))
    yn = C.sqrt(C.row_sum(torch.mul, y, y))
    den = xn * yn
    sim = C.div(C.row_sum(torch.mul, x, y), den + C.weak(den, 1e-12))
    return {"Out": [sim], "XNorm": [xn], "YNorm": [yn]}
