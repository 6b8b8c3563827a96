"""Op functions of the port, called like their JAX twins: fn(attrs, ins).

Importing this package registers every ported op in
``core/registry.py``."""
from . import (activation_ops, attention_ops, fusion_ops,  # noqa: F401
               loss_ops, math_ops, nn_ops, optimizer_ops, pipeline_ops,
               rnn_ops, sequence_ops, tensor_ops)
