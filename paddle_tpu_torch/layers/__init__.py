"""User-facing layer functions (fluid layers package parity), cut to
what the training slice of the port builds."""
from .attention import make_stack_params, pipelined_transformer_stack
from .io import data
from .nn import embedding, fc, layer_norm, softmax_with_cross_entropy
from .tensor import assign, create_global_var, fill_constant, mean, reshape

__all__ = [
    "assign", "create_global_var", "data", "embedding", "fc",
    "fill_constant", "layer_norm", "make_stack_params", "mean",
    "pipelined_transformer_stack", "reshape", "softmax_with_cross_entropy",
]
