"""Op functions of the port, called like their JAX twins: fn(attrs, ins).

Importing this package registers every ported op in
``core/registry.py``."""
from . import (loss_ops, math_ops, nn_ops, optimizer_ops,  # noqa: F401
               pipeline_ops, tensor_ops)
