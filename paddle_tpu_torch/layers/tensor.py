"""Tensor layers. Counterpart of ``paddle_tpu/layers/tensor.py``: every
layer of it."""
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


def cast(x, dtype, main_program=None, startup_program=None):
    h = _helper("cast", main_program, startup_program)
    return h.simple_op("cast", {"X": [x]}, {"out_dtype": dtype_name(dtype)})


def assign(input, output=None, main_program=None, startup_program=None):
    h = _helper("assign", main_program, startup_program)
    if output is None:
        return h.simple_op("assign", {"X": [input]})
    h.append_op("assign", {"X": [input]}, {"Out": [output]}, {})
    return output


def concat(input, axis=0, main_program=None, startup_program=None):
    """The variables of ``input`` joined along ``axis``."""
    h = _helper("concat", main_program, startup_program)
    return h.simple_op("concat", {"X": list(input)}, {"axis": axis})


def sums(input, main_program=None, startup_program=None):
    h = _helper("sum", main_program, startup_program)
    return h.simple_op("sum", {"X": list(input)})


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


def one_hot(input, depth, main_program=None, startup_program=None):
    h = _helper("one_hot", main_program, startup_program)
    return h.simple_op("one_hot", {"X": [input]}, {"depth": depth})


def argmax(x, axis=-1, main_program=None, startup_program=None):
    h = _helper("argmax", main_program, startup_program)
    return h.simple_op("argmax", {"X": [x]}, {"axis": axis})


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  main_program=None, startup_program=None):
    """A constant whose batch dim copies ``input``'s (batch-shaped
    initial states, targets of a loss)."""
    h = _helper("fill_constant_batch_size_like", main_program,
                startup_program)
    return h.simple_op(
        "fill_constant_batch_size_like", {"Input": [input]},
        {"shape": list(shape), "dtype": dtype_name(dtype), "value": value,
         "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx})


def gaussian_random_batch_size_like(input, shape, mean=0.0, std=1.0,
                                    dtype="float32", input_dim_idx=0,
                                    output_dim_idx=0, main_program=None,
                                    startup_program=None):
    """Gaussian noise with a batch dim copied from ``input``, drawn from
    the executor's RNG plane; no gradient flows into it (the
    reparameterization trick's noise)."""
    h = _helper("gaussian_random_batch_size_like", main_program,
                startup_program)
    return h.simple_op(
        "gaussian_random_batch_size_like", {"Input": [input]},
        {"shape": list(shape), "dtype": dtype_name(dtype), "mean": mean,
         "std": std, "input_dim_idx": input_dim_idx,
         "output_dim_idx": output_dim_idx})


def _reduce_layer(op_type):
    def layer(x, dim=None, keep_dim=False, main_program=None,
              startup_program=None):
        h = _helper(op_type, main_program, startup_program)
        return h.simple_op(op_type, {"X": [x]},
                           {"dim": dim, "keep_dim": keep_dim,
                            "reduce_all": dim is None})

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")


def create_tensor(dtype="float32", name=None, main_program=None,
                  startup_program=None):
    """An empty named [1] variable to assign into."""
    h = _helper("create_tensor", main_program, startup_program)
    return h.block.create_var(
        name=name or h.main_program.unique_name("tensor"), shape=[1],
        dtype=dtype)


def ones(shape, dtype="float32", main_program=None, startup_program=None):
    return fill_constant(shape=shape, value=1.0, dtype=dtype,
                         main_program=main_program,
                         startup_program=startup_program)


def zeros(shape, dtype="float32", main_program=None, startup_program=None):
    return fill_constant(shape=shape, value=0.0, dtype=dtype,
                         main_program=main_program,
                         startup_program=startup_program)
