"""Op functions of the port, called like their JAX twins: fn(attrs, ins).

Importing this package registers every ported op in
``core/registry.py``."""
from . import (activation_ops, attention_ops,  # noqa: F401
               control_flow_ops, crf_ops, fusion_ops, legacy_ops, loss_ops,
               math_ops, metric_ops, nn_ops, optimizer_ops, pipeline_ops,
               rnn_ops, seq2seq_ops, sequence_ops, sparse_ops, tensor_ops)
