"""Gradient accumulation (``minimize(accumulate_steps=k)``) and its five
ops in the port, against the JAX package.

The ops the accumulation plumbing builds, on numpy inputs from a seed:
``increment``, ``cast`` and ``equal`` forward (int64 values compared
modulo JAX's int32, ROADMAP.md Queue 3 "int64"), ``elementwise_sub``
and ``elementwise_mul`` forward and vjp with an ``axis`` broadcast, all
at rtol 1e-6 / atol 1e-7 (a subtraction or product of f32 values rounds
once in both packages).

The plumbing, for SGD, Momentum and Adam: a 2-layer MLP (16 -> 32 relu
-> 4, softmax cross-entropy), built in both packages from the same name
counter, trained with k = 4 on micro-batches of 8 rows:

- the three runs before the fourth leave every parameter and optimizer
  state bit-identical (each write goes through the gate);
- after four runs every parameter and state equals JAX's at rtol 1e-5 /
  atol 1e-6 (the packages' f32 rounding through one update);
- and equals the port's one step at k = 1 on the 32 rows at once at
  rtol 1e-5 / atol 1e-6 (the mean of four micro-batch means against one
  mean over the batch: another order of sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op as torch_op

torch.set_num_threads(1)
OP_TOL = dict(rtol=1e-6, atol=1e-7)
TOL = dict(rtol=1e-5, atol=1e-6)
K, MICRO, IN, HID, CLASSES = 4, 8, 16, 32, 4
OPTIMIZERS = {
    "sgd": lambda pt: pt.optimizer.SGDOptimizer(0.1),
    "momentum": lambda pt: pt.optimizer.MomentumOptimizer(0.1, 0.9),
    "adam": lambda pt: pt.optimizer.AdamOptimizer(1e-2),
}


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(op_type, attrs, ins):
    """The op's outputs in both packages on the same numpy inputs."""
    want = jax_op(op_type).fn(attrs, {k: [jnp.asarray(a) for a in v]
                                      for k, v in ins.items()})
    got = torch_op(op_type).fn(attrs, {k: [torch.from_numpy(a) for a in v]
                                       for k, v in ins.items()})
    return got["Out"][0], np.asarray(want["Out"][0])


@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_increment(dtype):
    x = (np.arange(6).reshape(2, 3) - 2).astype(dtype)
    got, want = _both("increment", {"step": 3.0}, {"X": [x]})
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("src,dst", [("float32", "int64"),
                                     ("float32", "bool"),
                                     ("bool", "float32"),
                                     ("int64", "float32")])
def test_cast(src, dst):
    x = (_rand(3, 4) * 3).astype(src)
    got, want = _both("cast", {"out_dtype": dst}, {"X": [x]})
    assert str(got.dtype) == f"torch.{dst}"
    np.testing.assert_array_equal(got.numpy(), want.astype(dst))


@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_equal(dtype):
    x = (np.arange(12).reshape(3, 4) % 3).astype(dtype)
    y = np.array([0, 1, 2, 1], dtype)
    got, want = _both("equal", {"axis": -1}, {"X": [x], "Y": [y]})
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op_type", ["elementwise_sub", "elementwise_mul"])
@pytest.mark.parametrize("axis,y_shape", [(-1, (2, 3, 4)), (-1, (4,)),
                                          (1, (3,))])
def test_elementwise_forward_and_vjp(op_type, axis, y_shape):
    x, y = _rand(2, 3, 4), _rand(*y_shape, seed=1)
    attrs = {"axis": axis}
    got, want = _both(op_type, attrs, {"X": [x], "Y": [y]})
    np.testing.assert_allclose(got.numpy(), want, **OP_TOL)
    ct = _rand(2, 3, 4, seed=2)
    jfn = jax_op(op_type).fn
    _, vjp = jax.vjp(lambda a, b: jfn(attrs, {"X": [a], "Y": [b]})["Out"][0],
                     jnp.asarray(x), jnp.asarray(y))
    jdx, jdy = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    tout = torch_op(op_type).fn(attrs, {"X": [tx], "Y": [ty]})["Out"][0]
    tdx, tdy = torch.autograd.grad(tout, [tx, ty], torch.from_numpy(ct))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **OP_TOL)
    np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy), **OP_TOL)


def _build(pt, counter, start, optimizer, k):
    """(main, startup, loss, state names): the MLP under ``optimizer``
    with ``accumulate_steps=k``; the state names are every startup
    output, paired with the other package's by position."""
    counter.Program._uid_counter = start
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[IN])
        y = pt.layers.data("y", shape=[1], dtype="int64")
        h = pt.layers.fc(x, size=HID, act="relu")
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.fc(h, size=CLASSES), y))
        OPTIMIZERS[optimizer](pt).minimize(loss, startup_program=startup,
                                           accumulate_steps=k)
    names = [n for op in startup.global_block.ops for n in op.output_names()]
    return main, startup, loss, names


def _micro_batches(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(K * MICRO, IN).astype(np.float32)
    y = rng.randint(0, CLASSES, (K * MICRO, 1)).astype(np.int64)
    return [{"x": x[i * MICRO:(i + 1) * MICRO],
             "y": y[i * MICRO:(i + 1) * MICRO]} for i in range(K)], \
        {"x": x, "y": y}


def _train_port(optimizer, k, feeds, start):
    main, startup, loss, names = _build(tpt, tprog, start, optimizer, k)
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    snapshots = [{n: scope.get(n).clone() for n in names}]
    for feed in feeds:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        snapshots.append({n: scope.get(n).clone() for n in names})
    return names, snapshots


def _is_plumbing(name):
    """The accumulation's own state: its step counter and gradient sums."""
    return "grad_acc_step" in name or name.endswith("_gradsum_acc")


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_off_step_runs_leave_every_state_bitwise(optimizer):
    micro, _ = _micro_batches()
    names, snaps = _train_port(optimizer, K, micro,
                               jprog.Program._uid_counter)
    state = [n for n in names if not _is_plumbing(n)]
    assert len(state) >= 4
    for i in range(1, K):
        for n in state:
            assert torch.equal(snaps[i][n], snaps[0][n]), (i, n)
        sums = [n for n in names if n.endswith("_gradsum_acc")]
        assert all(snaps[i][n].abs().sum() > 0 for n in sums), i
    moved = [n for n in state if not torch.equal(snaps[K][n], snaps[0][n])]
    assert any(n.startswith("fc.w") for n in moved)
    # the applying run resets the counter and the gradient sums
    assert all(not snaps[K][n].any() for n in names if _is_plumbing(n))


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_four_micro_batches_match_jax(optimizer):
    micro, _ = _micro_batches(seed=1)
    start = jprog.Program._uid_counter
    jmain, jstartup, jloss, jnames = _build(jpt, jprog, start, optimizer, K)
    jscope, jexe = jpt.Scope(), jpt.Executor(jpt.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    jlosses = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                         scope=jscope)[0])) for f in micro]
    names, snaps = _train_port(optimizer, K, micro, start)
    assert len(names) == len(jnames)
    for n, jn in zip(names, jnames):
        np.testing.assert_allclose(snaps[K][n].numpy(),
                                   np.asarray(jscope.get(jn)), err_msg=n,
                                   **TOL)
    main, startup, loss, _ = _build(tpt, tprog, start, optimizer, K)
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    tlosses = [float(exe.run(main, feed=f, fetch_list=[loss],
                             scope=scope)[0]) for f in micro]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_four_micro_batches_make_one_large_batch_step(optimizer):
    micro, whole = _micro_batches(seed=2)
    start = jprog.Program._uid_counter
    names, snaps = _train_port(optimizer, K, micro, start)
    big_names, big = _train_port(optimizer, 1, [whole], start)
    state = [n for n in names if not _is_plumbing(n)]
    assert state == big_names
    for n in state:
        np.testing.assert_allclose(snaps[K][n].numpy(), big[1][n].numpy(),
                                   err_msg=n, **TOL)
