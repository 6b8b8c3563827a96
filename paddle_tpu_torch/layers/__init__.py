"""User-facing layer functions (fluid layers package parity), cut to
what the port's slices build."""
from .attention import (make_stack_params, multi_head_attention,
                        pipelined_transformer_stack,
                        transformer_encoder_layer)
from .io import data
from .nn import (batch_norm, conv1x1_bn_act, conv2d, dropout, embedding,
                 fc, layer_norm, pool2d, rms_norm,
                 softmax_with_cross_entropy)
from .ops import elementwise_add, gelu, relu, softmax
from .tensor import (assign, create_global_var, fill_constant, matmul, mean,
                     reshape, scale, split, transpose)

__all__ = [
    "assign", "batch_norm", "conv1x1_bn_act", "conv2d", "create_global_var",
    "data", "dropout", "elementwise_add", "embedding", "fc", "fill_constant",
    "gelu", "layer_norm", "make_stack_params", "matmul", "mean",
    "multi_head_attention", "pipelined_transformer_stack", "pool2d", "relu",
    "reshape", "rms_norm", "scale", "softmax", "softmax_with_cross_entropy",
    "split", "transformer_encoder_layer", "transpose",
]
