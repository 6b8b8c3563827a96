"""Matrix ops. Counterpart of ``paddle_tpu/ops/math_ops.py``, cut to
``mul``, the training slice's LM head. The product is a plain f32
``torch.matmul`` (cuBLAS on the card), as the JAX package leaves it to
XLA; its gradient is the generic vjp."""
from __future__ import annotations

import math

from ..core.registry import register_op
from .common import out, single


@register_op("mul")
def mul(attrs, ins):
    """Reference mul_op: flatten X to 2-D at x_num_col_dims, ditto Y, matmul."""
    x = single(ins, "X")
    y = single(ins, "Y")
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xd]), -1)
    y2 = y.reshape(math.prod(y.shape[:yd]), -1)
    return out(Out=(x2 @ y2).reshape(tuple(x.shape[:xd]) + tuple(y.shape[yd:])))
