"""Row-granular sparse optimizer updates as ops.

Counterpart of ``paddle_tpu/ops/sparse_ops.py``, its serial path:
``sparse_sgd`` and ``sparse_adagrad`` take a SelectedRows gradient and
touch only the looked-up rows: the unique ids by the segment-sum
dedup (``SelectedRows.merged``), then one in-place scatter a state
tensor, never a [V, D] buffer. The touched rows follow the dense formula. A dense
gradient (a sparse and a dense contribution summed) takes the dense
formula. The ``vocab_axis`` attribute of a vocab-sharded table is
ignored: on one device the JAX ops take this serial path too.
"""
from __future__ import annotations

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows, scatter_rows_
from .common import out, single
from .optimizer_ops import _adagrad_dense, _adagrad_rows


@register_op("sparse_sgd")
def sparse_sgd(attrs, ins):
    """param[rows] -= lr * grad_rows over the merged rows."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    lr = single(ins, "LearningRate").to(p.dtype).reshape(())
    if not isinstance(g, SelectedRows):
        return out(ParamOut=p - lr * g.to(p.dtype))
    m = g.merged()
    return out(ParamOut=scatter_rows_(p, m, -(lr * m.values.to(p.dtype))))


@register_op("sparse_adagrad")
def sparse_adagrad(attrs, ins):
    """Row-sparse adagrad: the moment accumulates and the parameter steps
    only on the touched rows."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    mom = single(ins, "Moment")
    lr = single(ins, "LearningRate").reshape(())
    eps = attrs.get("epsilon", 1e-6)
    if not isinstance(g, SelectedRows):
        return _adagrad_dense(p, g, mom, lr, eps)
    return _adagrad_rows(p, g.merged(), mom, lr, eps)
