"""Tensor layers. Counterpart of ``paddle_tpu/layers/tensor.py``, cut to
what the training slices, the per-layer transformer and primitive
attention programs build."""
from __future__ import annotations

from ..core.types import dtype_name
from .layer_helper import LayerHelper


def _helper(name, main_program=None, startup_program=None):
    return LayerHelper(name, main_program=main_program,
                       startup_program=startup_program)


def fill_constant(shape, dtype, value, main_program=None,
                  startup_program=None):
    h = _helper("fill_constant", main_program, startup_program)
    return h.simple_op("fill_constant", {},
                       {"shape": list(shape), "dtype": dtype_name(dtype),
                        "value": value})


def create_global_var(shape, value, dtype, persistable=True, name=None,
                      main_program=None, startup_program=None):
    """A persistable var initialised in the startup program (learning
    rates, counters)."""
    h = _helper("global_var", main_program, startup_program)
    var = h.create_global_variable(name=name, shape=shape, dtype=dtype,
                                   persistable=persistable)
    sb = h.startup_program.global_block
    sv = sb.create_var(name=var.name, shape=shape, dtype=dtype,
                       persistable=True)
    sb.append_op("fill_constant", outputs={"Out": [sv.name]},
                 attrs={"shape": list(shape), "dtype": dtype_name(sv.dtype),
                        "value": value})
    return var


def assign(input, output=None, main_program=None, startup_program=None):
    h = _helper("assign", main_program, startup_program)
    if output is None:
        return h.simple_op("assign", {"X": [input]})
    h.append_op("assign", {"X": [input]}, {"Out": [output]}, {})
    return output


def mean(x, main_program=None, startup_program=None):
    h = _helper("mean", main_program, startup_program)
    return h.simple_op("mean", {"X": [x]})


def reshape(x, shape, main_program=None, startup_program=None):
    h = _helper("reshape", main_program, startup_program)
    return h.simple_op("reshape", {"X": [x]}, {"shape": list(shape)})


def transpose(x, perm, main_program=None, startup_program=None):
    h = _helper("transpose", main_program, startup_program)
    return h.simple_op("transpose", {"X": [x]}, {"axis": list(perm)})


def split(x, num_or_sections, dim=0, main_program=None, startup_program=None):
    """A list of Variables: ``x`` cut along ``dim`` into ``num_or_sections``
    equal parts (an int) or parts of those sizes (a list)."""
    h = _helper("split", main_program, startup_program)
    if isinstance(num_or_sections, int):
        attrs = {"num": num_or_sections, "axis": dim}
    else:
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs, _ = h.append_op("split", {"X": [x]}, ["Out"], attrs)
    return outs["Out"]


def scale(x, scale=1.0, bias=0.0, main_program=None, startup_program=None):
    h = _helper("scale", main_program, startup_program)
    return h.simple_op("scale", {"X": [x]}, {"scale": scale, "bias": bias})


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           main_program=None, startup_program=None):
    """Batched matmul: the score and context products of primitive
    attention over [B, H, T, D] heads."""
    h = _helper("matmul", main_program, startup_program)
    return h.simple_op(
        "matmul", {"X": [x], "Y": [y]},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y,
         "alpha": alpha})
