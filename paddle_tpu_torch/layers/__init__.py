"""User-facing layer functions (fluid layers package parity), cut to
what the port's slices build."""
from .attention import (make_stack_params, multi_head_attention,
                        pipelined_transformer_stack,
                        transformer_encoder_layer)
from .control_flow import beam_search_decoder, increment
from .io import data
from .legacy import addto
from .nn import (accuracy, batch_norm, chunk_eval, clip, conv1x1_bn_act,
                 conv2d, cos_sim, crf_decoding, cross_entropy, dropout,
                 embedding, fc, fused_head_cross_entropy, layer_norm,
                 linear_chain_crf, lrn, mul, pool2d, rms_norm,
                 sigmoid_cross_entropy_with_logits,
                 softmax_with_cross_entropy, square_error_cost, topk)
from .ops import *  # noqa: F401,F403  (the generated unary/binary layers)
from .ops import __all__ as _ops_all
from . import math_op_patch  # noqa: F401  (patches +, -, *, / onto Variable)
from .sequence import (dynamic_gru, dynamic_lstm, sequence_conv,
                       sequence_first_step, sequence_last_step,
                       sequence_pool, simple_rnn)
from .tensor import (argmax, assign, cast, concat, create_global_var,
                     create_tensor, fill_constant,
                     fill_constant_batch_size_like,
                     gaussian_random_batch_size_like, matmul, mean, one_hot,
                     ones, reduce_max, reduce_mean, reduce_min, reduce_sum,
                     reshape, scale, split, sums, transpose, zeros)

__all__ = [
    "accuracy", "addto", "argmax", "assign", "batch_norm", "beam_search_decoder",
    "cast", "chunk_eval", "clip", "concat", "conv1x1_bn_act", "conv2d",
    "cos_sim", "create_global_var", "create_tensor", "crf_decoding",
    "cross_entropy", "data", "dropout", "dynamic_gru", "dynamic_lstm",
    "embedding", "fc", "fill_constant", "fill_constant_batch_size_like",
    "fused_head_cross_entropy", "gaussian_random_batch_size_like",
    "increment", "layer_norm",
    "linear_chain_crf", "lrn", "make_stack_params", "matmul", "mean",
    "mul", "multi_head_attention", "one_hot", "ones",
    "pipelined_transformer_stack", "pool2d", "reduce_max", "reduce_mean",
    "reduce_min", "reduce_sum", "reshape", "rms_norm", "scale",
    "sequence_conv", "sequence_first_step", "sequence_last_step",
    "sequence_pool",
    "sigmoid_cross_entropy_with_logits", "simple_rnn",
    "softmax_with_cross_entropy", "split", "square_error_cost", "sums",
    "topk", "transformer_encoder_layer", "transpose", "zeros",
] + list(_ops_all)
