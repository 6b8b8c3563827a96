"""Op functions of the port, called like their JAX twins: fn(attrs, ins).

Importing this package registers every ported op in
``core/registry.py``."""
from . import (activation_ops, fusion_ops, loss_ops,  # noqa: F401
               math_ops, nn_ops, optimizer_ops, pipeline_ops, tensor_ops)
