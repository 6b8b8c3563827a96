"""User-facing layer functions (fluid layers package parity), cut to
what the port's slices build."""
from .attention import (make_stack_params, multi_head_attention,
                        pipelined_transformer_stack,
                        transformer_encoder_layer)
from .control_flow import increment
from .io import data
from .nn import (accuracy, batch_norm, conv1x1_bn_act, conv2d, dropout,
                 embedding, fc, layer_norm, lrn, pool2d, rms_norm,
                 softmax_with_cross_entropy, topk)
from .ops import (elementwise_add, elementwise_mul, elementwise_sub, equal,
                  gelu, relu, softmax)
from .sequence import (dynamic_gru, dynamic_lstm, sequence_first_step,
                       sequence_last_step, sequence_pool, simple_rnn)
from .tensor import (assign, cast, concat, create_global_var, fill_constant,
                     matmul, mean, reshape, scale, split, transpose)

__all__ = [
    "accuracy", "assign", "batch_norm", "cast", "concat", "conv1x1_bn_act",
    "conv2d", "create_global_var", "data", "dropout", "dynamic_gru",
    "dynamic_lstm", "elementwise_add", "elementwise_mul", "elementwise_sub",
    "embedding", "equal", "fc", "fill_constant", "gelu", "increment",
    "layer_norm", "lrn",
    "make_stack_params", "matmul", "mean", "multi_head_attention",
    "pipelined_transformer_stack", "pool2d", "relu", "reshape", "rms_norm",
    "scale", "sequence_first_step", "sequence_last_step", "sequence_pool",
    "simple_rnn", "softmax", "softmax_with_cross_entropy", "split",
    "topk", "transformer_encoder_layer", "transpose",
]
