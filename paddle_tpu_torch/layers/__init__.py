"""User-facing layer functions (fluid layers package parity), cut to
what the port's slices build."""
from .attention import make_stack_params, pipelined_transformer_stack
from .io import data
from .nn import (batch_norm, conv1x1_bn_act, conv2d, dropout, embedding,
                 fc, layer_norm, pool2d, softmax_with_cross_entropy)
from .ops import elementwise_add, relu, softmax
from .tensor import (assign, create_global_var, fill_constant, matmul, mean,
                     reshape, scale)

__all__ = [
    "assign", "batch_norm", "conv1x1_bn_act", "conv2d", "create_global_var",
    "data", "dropout", "elementwise_add", "embedding", "fc", "fill_constant",
    "layer_norm", "make_stack_params", "matmul", "mean",
    "pipelined_transformer_stack", "pool2d", "relu", "reshape", "scale",
    "softmax", "softmax_with_cross_entropy",
]
