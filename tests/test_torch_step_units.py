"""The control-flow plane's step ops against the JAX package's.

``lstm_unit``, ``gru_unit`` and ``sequence_reverse`` (with and without
``Length``) are run in both packages on the same seeded inputs, the JAX
op jitted as its executor runs it: forwards and input gradients (a
seeded cotangent on every float output) agree within ``ULPS`` f32 ulps
of each tensor's largest |value| (measured at most 4, ``gru_unit``'s
HiddenPrev gradient): XLA contracts the gate arithmetic into FMAs, and
its products sum in another order; ``sequence_reverse`` moves values
only, and agrees bit for bit. Their layers build the JAX
package's programs, and the registry holds the 180 ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.registry import get_op as torch_op
from test_torch_activation_ops import _ulps
from test_torch_layers_ops import program_dicts

torch.set_num_threads(1)
ULPS = 8
NEW_OPS = ("static_rnn", "while", "cond", "array_read", "array_write",
           "lstm_unit", "gru_unit", "sequence_reverse")


def _float_outs(outs):
    return [(slot, i) for slot in sorted(outs)
            for i, o in enumerate(outs[slot])
            if o is not None and np.issubdtype(np.asarray(o).dtype,
                                               np.floating)]


def op_parity(op_type, ins, attrs, diff, seed=0):
    """Run ``op_type`` in both packages on the numpy ``ins`` ({slot:
    [array]}). ``diff`` names the (slot, index) inputs to differentiate;
    the loss is the sum of every float output times a seeded cotangent.
    Returns ({(slot, i): (jax, port)} of outputs, the same of input
    gradients), numpy f64."""
    keys = list(diff)

    def jfwd(*vals):
        jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        for (s, i), v in zip(keys, vals):
            jins[s][i] = v
        return jax_op(op_type).fn(attrs, jins)

    jouts = jax.jit(jfwd)(*[jnp.asarray(ins[s][i]) for s, i in keys])
    fkeys = _float_outs(jouts)
    rng = np.random.RandomState(seed)
    cts = {k: rng.randn(*np.shape(jouts[k[0]][k[1]])).astype(np.float32)
           for k in fkeys}

    def jloss(*vals):
        o = jfwd(*vals)
        return sum((o[s][i] * cts[(s, i)]).sum() for s, i in fkeys)

    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(len(keys)))))(
        *[jnp.asarray(ins[s][i]) for s, i in keys])

    tins = {s: [torch.from_numpy(np.array(a)) for a in v]
            for s, v in ins.items()}
    leaves = []
    for s, i in keys:
        tins[s][i] = tins[s][i].requires_grad_(True)
        leaves.append(tins[s][i])
    touts = torch_op(op_type).fn(attrs, tins)
    loss = sum((touts[s][i] * torch.from_numpy(cts[(s, i)])).sum()
               for s, i in fkeys)
    tgrads = [torch.zeros_like(leaf) if g is None else g for leaf, g in
              zip(leaves, torch.autograd.grad(loss, leaves,
                                              allow_unused=True))]
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    outs = {k: (f64(jouts[k[0]][k[1]]), f64(touts[k[0]][k[1]].detach()))
            for k in _float_outs(jouts) + [
                (s, i) for s in sorted(jouts) for i, o in
                enumerate(jouts[s]) if (s, i) not in fkeys]}
    grads = {k: (f64(jg), f64(tg))
             for k, jg, tg in zip(keys, jgrads, tgrads)}
    return outs, grads


def assert_close(pairs, ulps=ULPS):
    for key, (want, got) in pairs.items():
        assert got.shape == want.shape, key
        gap = _ulps(got, want, "float32", at_max=True)
        assert gap <= ulps, (key, gap)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit(with_bias, forget_bias):
    rng = np.random.RandomState(1)
    b, h = 5, 6
    ins = {"X": [_rand(rng, b, 4 * h)], "C_prev": [_rand(rng, b, h)]}
    diff = [("X", 0), ("C_prev", 0)]
    if with_bias:
        ins["Bias"] = [_rand(rng, 1, 4 * h, scale=0.3)]
        diff.append(("Bias", 0))
    outs, grads = op_parity("lstm_unit", ins, {"forget_bias": forget_bias},
                            diff)
    assert set(outs) == {("C", 0), ("H", 0)}
    assert_close(outs)
    assert_close(grads)


@pytest.mark.parametrize("acts", [("tanh", "sigmoid"), ("relu", "sigmoid"),
                                  ("identity", "tanh")])
@pytest.mark.parametrize("with_bias", [False, True])
def test_gru_unit(acts, with_bias):
    rng = np.random.RandomState(2)
    b, h = 4, 5
    ins = {"Input": [_rand(rng, b, 3 * h)], "HiddenPrev": [_rand(rng, b, h)],
           "Weight": [_rand(rng, h, 3 * h, scale=0.5)]}
    diff = [("Input", 0), ("HiddenPrev", 0), ("Weight", 0)]
    if with_bias:
        ins["Bias"] = [_rand(rng, 1, 3 * h, scale=0.2)]
        diff.append(("Bias", 0))
    attrs = {"activation": acts[0], "gate_activation": acts[1]}
    outs, grads = op_parity("gru_unit", ins, attrs, diff)
    assert set(outs) == {("Hidden", 0), ("Gate", 0), ("ResetHiddenPrev", 0)}
    assert_close(outs)
    assert_close(grads)


@pytest.mark.parametrize("lengths", [None, [5, 2, 1, 4]])
@pytest.mark.parametrize("trailing", [(), (3,), (2, 3)])
def test_sequence_reverse(lengths, trailing):
    rng = np.random.RandomState(3)
    ins = {"X": [_rand(rng, 4, 5, *trailing)]}
    if lengths is not None:
        ins["Length"] = [np.array(lengths, np.int32)]
    outs, grads = op_parity("sequence_reverse", ins, {}, [("X", 0)])
    for want, got in list(outs.values()) + list(grads.values()):
        np.testing.assert_array_equal(got, want)
    if lengths is not None:  # the padding stays where it was
        y = outs[("Y", 0)][1]
        np.testing.assert_array_equal(y[1, 2:], ins["X"][0][1, 2:])


def _units(pt):
    L = pt.layers
    x = L.data("x", shape=[6])
    h = L.data("h", shape=[4])
    c = L.data("c", shape=[4])
    L.lstm_unit(x, h, c, forget_bias=0.5)
    xp = L.data("xp", shape=[12])
    L.gru_unit(xp, h, 4, activation="relu")
    L.gru_unit(xp, h, 4, bias_attr=False)
    s = L.data("s", shape=[3], lod_level=1)
    L.sequence_reverse(s)


def test_layers_build_the_jax_programs():
    jd, td = program_dicts(_units)
    assert td == jd
    types = [op["type"] for op in td[0]["blocks"][0]["ops"]]
    assert types.count("gru_unit") == 2 and "lstm_unit" in types
    assert "sequence_reverse" in types


def test_registry_holds_the_new_ops():
    from paddle_tpu.core.registry import _REGISTRY as JAX_REGISTRY
    from paddle_tpu_torch.core.registry import _REGISTRY

    assert set(NEW_OPS) <= set(_REGISTRY)
    assert not set(_REGISTRY) - set(JAX_REGISTRY)
    assert len(_REGISTRY) == 180
    for name in ("lstm_unit", "gru_unit", "sequence_reverse", "StaticRNN",
                 "While", "DynamicRNN", "create_array", "array_write",
                 "array_read", "array_length", "beam_search_decode"):
        assert name in tpt.layers.__all__, name
        assert name in jpt.layers.__all__, name
