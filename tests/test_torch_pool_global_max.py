"""Global max pooling on tied maxima, against the JAX package.

``layers.pool2d(global_pooling=True, pool_type="max")`` pools each
channel's whole plane. The JAX package computes it as one
``reduce_window(max)`` window over the plane, whose gradient goes to the
window's first maximum (row-major order); the port must send it there
too, not split it among tied maxima. The program (a feed with gradients,
the pool, its mean as the loss) is built in both packages and run by
their ``Executor``s on the same f32 inputs (each executor casts a feed
to the declared dtype; halves are exact in bf16): rounded to halves, so
that planes hold tied maxima, and a [1, 1, 3, 4] plane with three. ``Out``
and ``x@GRAD`` are compared in NCHW and NHWC, in f32 and bf16: equal bit
for bit (a pool picks one of its inputs, and the gradient is the
cotangent placed at one position).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import backward as jback
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import backward as tback
from paddle_tpu_torch.core import program as tprog

torch.set_num_threads(1)

# name: NCHW input; every plane of "halves" has tied maxima somewhere
INPUTS = {
    "three_tied_1x1x3x4": np.array([[[[0.5, 2.0, -1.0, 2.0],
                                      [2.0, 0.0, 1.5, -2.0],
                                      [1.0, 1.0, 0.5, 0.0]]]], np.float32),
    "halves_2x3x7x9": np.round(2 * np.random.RandomState(3).uniform(
        -1.5, 1.5, (2, 3, 7, 9))).astype(np.float32) / 2,
}


def _build(pt, counter, back, shape, fmt, dtype):
    """(main, loss name, pool output name) of: x (a feed with gradients),
    y = pool2d(x, global max), loss = mean(y)."""
    counter.Program._uid_counter = 0
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=list(shape[1:]), dtype=dtype,
                           stop_gradient=False)
        y = pt.layers.pool2d(x, pool_type="max", global_pooling=True,
                             data_format=fmt)
        loss = pt.layers.mean(y)
        back.append_backward(loss)
    return main, loss.name, y.name


def _run(pt, counter, back, x, fmt, dtype):
    main, loss, out = _build(pt, counter, back, x.shape, fmt, dtype)
    exe = pt.Executor(pt.CPUPlace())
    got = exe.run(main, feed={"x": x},
                  fetch_list=[out, "x@GRAD"], scope=pt.Scope())
    return [np.asarray(a).astype(np.float32) for a in got]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_global_max_pool_gradient_goes_to_the_first_maximum(name, fmt,
                                                            dtype):
    x = INPUTS[name]
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    N, C = x.shape[0], x.shape[1 if fmt == "NCHW" else 3]
    jout, jgrad = _run(jpt, jprog, jback, x, fmt, dtype)
    tout, tgrad = _run(tpt, tprog, tback, x, fmt, dtype)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tgrad, jgrad)
    # one position a plane takes the whole cotangent: the first maximum
    planes = tgrad if fmt == "NCHW" else tgrad.transpose(0, 3, 1, 2)
    xs = np.asarray(x).astype(np.float32)
    xs = xs if fmt == "NCHW" else xs.transpose(0, 3, 1, 2)
    flat, xflat = planes.reshape(N * C, -1), xs.reshape(N * C, -1)
    assert ((flat != 0).sum(axis=1) == 1).all()
    assert (np.argmax(flat != 0, axis=1) == np.argmax(xflat, axis=1)).all()
    if name.startswith("three_tied"):
        assert (xflat == xflat.max(axis=1, keepdims=True)).sum() == 3
