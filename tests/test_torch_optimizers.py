"""The port's other optimizers against the JAX package.

One parametrised test over the eight update ops (``adamax``,
``adagrad``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
``proximal_gd``, ``proximal_adagrad``) and the seven optimizer classes
(AdamW, Adamax, Adagrad, DecayedAdagrad, Adadelta, RMSProp, Ftrl):

- an op takes three updates on numpy state and gradients from a seed,
  its outputs fed back as the next update's state, and every output of
  every update equals the JAX op's at rtol 1e-5 / atol 1e-7 (a few f32
  roundings per element, compounded over three updates);
- a class trains a 2-layer MLP (16 -> 32 relu -> 4, softmax
  cross-entropy) three steps in both packages from their own startups
  (equal by construction: constant and seeded draws); the losses and
  every parameter and accumulator after the third step equal JAX's at
  rtol 1e-5 / atol 1e-6, and the port's checkpoint of that state loads
  in the JAX package with every value equal bit for bit under the JAX
  package's accumulator names.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch import checkpoint as tckpt
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op as torch_op

torch.set_num_threads(1)
OP_TOL = dict(rtol=1e-5, atol=1e-7)
TOL = dict(rtol=1e-5, atol=1e-6)
SHAPE = (6, 5)
IN, HID, CLASSES, BATCH = 16, 32, 4, 8

# op -> (state slots with (output slot, kind), attrs, takes a learning
# rate); kind "pos" draws a positive state, "any" a signed one, "pow" a
# beta power [1]
OPS = {
    "adamax": ({"Moment": ("MomentOut", "any"),
                "InfNorm": ("InfNormOut", "pos"),
                "Beta1Pow": ("Beta1PowOut", "pow")},
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, True),
    "adagrad": ({"Moment": ("MomentOut", "pos")}, {"epsilon": 1e-6}, True),
    "decayed_adagrad": ({"Moment": ("MomentOut", "pos")},
                        {"decay": 0.95, "epsilon": 1e-6}, True),
    "adadelta": ({"AvgSquaredGrad": ("AvgSquaredGradOut", "pos"),
                  "AvgSquaredUpdate": ("AvgSquaredUpdateOut", "pos")},
                 {"rho": 0.95, "epsilon": 1e-6}, False),
    "rmsprop": ({"MeanSquare": ("MeanSquareOut", "pos"),
                 "Moment": ("MomentOut", "any")},
                {"decay": 0.9, "momentum": 0.9, "epsilon": 1e-10}, True),
    "ftrl": ({"SquaredAccumulator": ("SquaredAccumOut", "pos"),
              "LinearAccumulator": ("LinearAccumOut", "any")},
             {"l1": 0.01, "l2": 0.01, "lr_power": -0.5}, True),
    "proximal_gd": ({}, {"l1": 0.01, "l2": 0.01}, True),
    "proximal_adagrad": ({"Moment": ("MomentOut", "pos")},
                         {"l1": 0.01, "l2": 0.01}, True),
}
CLASSES_ = {
    "AdamW": lambda pt: pt.optimizer.AdamWOptimizer(1e-2,
                                                     weight_decay=0.1),
    "Adamax": lambda pt: pt.optimizer.AdamaxOptimizer(1e-2),
    "Adagrad": lambda pt: pt.optimizer.AdagradOptimizer(0.1),
    "DecayedAdagrad": lambda pt: pt.optimizer.DecayedAdagradOptimizer(0.1),
    "Adadelta": lambda pt: pt.optimizer.AdadeltaOptimizer(1.0),
    "RMSProp": lambda pt: pt.optimizer.RMSPropOptimizer(1e-2,
                                                        momentum=0.5),
    "Ftrl": lambda pt: pt.optimizer.FtrlOptimizer(0.1, l1=1e-3, l2=1e-3),
}


def _state(kind, rng):
    if kind == "pow":
        return np.array([0.9], np.float32)
    x = rng.randn(*SHAPE).astype(np.float32)
    return (np.abs(x) + 0.1).astype(np.float32) if kind == "pos" else x


def _op_three_updates(op_type):
    slots, attrs, with_lr = OPS[op_type]
    rng = np.random.RandomState(0)
    ins = {"Param": rng.randn(*SHAPE).astype(np.float32)}
    ins.update({s: _state(kind, rng) for s, (_, kind) in slots.items()})
    if with_lr:
        ins["LearningRate"] = np.array([0.05], np.float32)
    jins = {k: jnp.asarray(v) for k, v in ins.items()}
    tins = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    for step in range(3):
        g = rng.randn(*SHAPE).astype(np.float32)
        jins["Grad"], tins["Grad"] = jnp.asarray(g), torch.from_numpy(g)
        want = jax_op(op_type).fn(attrs, {k: [v] for k, v in jins.items()})
        got = torch_op(op_type).fn(attrs, {k: [v] for k, v in tins.items()})
        assert sorted(got) == sorted(want), (op_type, sorted(got))
        for slot in want:
            np.testing.assert_allclose(
                got[slot][0].numpy(), np.asarray(want[slot][0]),
                err_msg=f"{op_type}.{slot} update {step}", **OP_TOL)
        back = dict(slots, Param=("ParamOut", None))
        for s, (o, _) in back.items():
            jins[s], tins[s] = want[o][0], got[o][0]


def _build(pt, counter, start, name):
    counter.Program._uid_counter = start
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[IN])
        y = pt.layers.data("y", shape=[1], dtype="int64")
        h = pt.layers.fc(x, size=HID, act="relu")
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.fc(h, size=CLASSES), y))
        CLASSES_[name](pt).minimize(loss, startup_program=startup)
    names = [n for op in startup.global_block.ops for n in op.output_names()]
    return main, startup, loss, names


def _class_three_steps(name, tmp_path):
    rng = np.random.RandomState(1)
    feeds = [{"x": rng.randn(BATCH, IN).astype(np.float32),
              "y": rng.randint(0, CLASSES, (BATCH, 1)).astype(np.int64)}
             for _ in range(3)]
    start = jprog.Program._uid_counter
    runs = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        main, startup, loss, names = _build(pt, counter, start, name)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0]))
                  for f in feeds]
        runs.append((scope, names, losses))
    (jscope, jnames, jlosses), (tscope, tnames, tlosses) = runs
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert len(tnames) == len(jnames) >= 8
    for tn, jn in zip(tnames, jnames):
        np.testing.assert_allclose(tscope.get_numpy(tn),
                                   np.asarray(jscope.get(jn)), err_msg=tn,
                                   **TOL)
    # the port's checkpoint of that state loads in the JAX package
    d = str(tmp_path / name)
    tckpt.save_checkpoint(d, scope=tscope, step=3)
    loaded = jpt.Scope()
    assert jckpt.load_checkpoint(d, scope=loaded)["step"] == 3
    accs = [n for n in tnames if n.endswith("_acc")]
    assert accs
    for tn in tnames:
        np.testing.assert_array_equal(np.asarray(loaded.get(tn)),
                                      tscope.get_numpy(tn), err_msg=tn)


@pytest.mark.parametrize("case", [f"op:{k}" for k in OPS]
                         + [f"class:{k}" for k in CLASSES_])
def test_three_steps_match_jax(case, tmp_path):
    kind, name = case.split(":")
    if kind == "op":
        _op_three_updates(name)
    else:
        _class_three_steps(name, tmp_path)
