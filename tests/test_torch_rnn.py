"""The port's recurrent scans (``lstm``, ``gru``, ``simple_rnn``) against
the JAX package's.

The same numpy inputs go through ``paddle_tpu.ops.rnn_ops`` (a
``lax.scan``, gradients from ``jax.vjp``) and
``paddle_tpu_torch.ops.rnn_ops`` (an eager loop, gradients from torch
autograd): every output, and the gradient of random cotangents on all of
them with respect to every float input. The cases cover each attribute
and optional input: ``Bias`` (with peepholes in its columns 4h:7h for
the LSTM), ``H0``/``C0``, ``Length`` (ragged, one row of length 0),
``is_reverse`` (a reverse scan starts on padding), and the gate,
candidate and cell activations (sigmoid, tanh, relu, identity); in f32,
under AMP on bf16 inputs (an AMP program's ``fc`` output and the
parameters it declares) and under AMP on f32 inputs (the ops' own casts).

Tolerance: f32 rtol 1e-5, atol 1e-6 of the tensor's largest |value|
(at least 1e-6). Under AMP each output and gradient lies within 8 bf16
ulps of its largest |value| (|got - want| <= 8 * 2^(floor(log2 max|want|)
- 7)), and its dtype is JAX's: XLA's bf16 ``sigmoid`` rounds differently
from torch's on 1116 of the 65280 finite bf16 inputs (their ``tanh``
agree on all), and a gate one ulp apart moves the rest of the
recurrence (measured at most 4 ulps here). Without a transcendental
(``simple_rnn`` with relu or identity on bf16 inputs) the port's outputs
and its Input and Weight gradients equal JAX's bit for bit, which pins
every cast and the order of the operations.

A scan on meta tensors (build-time shape inference) runs one step for
all T, so building a ``dynamic_lstm`` on a sequence feed, whose time
axis is the 1297 sentinel, does not loop over it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch as tpt
import paddle_tpu_torch.ops.common as torch_common
from paddle_tpu.ops import rnn_ops as jrnn
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.ops import rnn_ops as trnn

torch.set_num_threads(1)
B, T, H = 4, 7, 5
LENGTHS = np.array([7, 3, 0, 5], np.int32)
F32_RTOL, F32_ATOL = 1e-5, 1e-6  # atol x max(1, max |value|)
AMP_ULPS = 8  # bf16 ulps of the largest |value|
GATES = {"lstm": 4, "gru": 3, "simple_rnn": 1}
STATES = {"lstm": ("H0", "C0"), "gru": ("H0",), "simple_rnn": ("H0",)}
OUTS = {"lstm": ("Hidden", "Cell", "LastH", "LastC"),
        "gru": ("Hidden", "LastH"), "simple_rnn": ("Hidden", "LastH")}

# (op, case name, attrs, optional inputs)
CASES = [
    ("lstm", "plain", {}, ()),
    ("lstm", "bias_length", {}, ("Bias", "Length")),
    ("lstm", "peepholes", {"use_peepholes": True}, ("Bias", "Length")),
    ("lstm", "reverse_h0_c0", {"is_reverse": True, "use_peepholes": True},
     ("Bias", "H0", "C0", "Length")),
    ("lstm", "activations",
     {"gate_activation": "sigmoid", "candidate_activation": "relu",
      "cell_activation": "identity"}, ("Bias", "Length")),
    ("lstm", "identity_gates",
     {"gate_activation": "identity", "candidate_activation": "tanh",
      "cell_activation": "relu", "is_reverse": True}, ("H0", "C0")),
    ("gru", "plain", {}, ()),
    ("gru", "bias_length", {}, ("Bias", "Length")),
    ("gru", "reverse_h0", {"is_reverse": True}, ("Bias", "H0", "Length")),
    ("gru", "activations",
     {"gate_activation": "relu", "activation": "identity"},
     ("Bias", "Length")),
    ("gru", "sigmoid_candidate",
     {"activation": "sigmoid", "is_reverse": True}, ("H0",)),
    ("simple_rnn", "plain", {}, ()),
    ("simple_rnn", "bias_length", {}, ("Bias", "Length")),
    ("simple_rnn", "reverse_h0", {"is_reverse": True},
     ("Bias", "H0", "Length")),
    ("simple_rnn", "relu", {"activation": "relu"}, ("Bias", "Length")),
    ("simple_rnn", "identity", {"activation": "identity",
                                "is_reverse": True}, ("H0", "Length")),
    ("simple_rnn", "sigmoid", {"activation": "sigmoid"}, ("Bias",)),
]
IDS = [f"{op}-{name}" for op, name, _, _ in CASES]


def _inputs(op, attrs, optional, seed):
    rng = np.random.RandomState(seed)
    g = GATES[op]
    bias_cols = 7 * H if attrs.get("use_peepholes") else g * H

    def rand(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    # small enough weights (and inputs behind unbounded gates) that
    # every case stays bounded over T steps
    bounded = attrs.get("gate_activation", "sigmoid") == "sigmoid"
    ins = {"Input": rand(B, T, g * H, scale=1.0 if bounded else 0.3),
           "Weight": rand(H, g * H, scale=0.3)}
    if "Bias" in optional:
        ins["Bias"] = rand(1, bias_cols, scale=0.5)
    for slot in STATES[op]:
        if slot in optional:
            ins[slot] = rand(B, H, scale=0.5)
    if "Length" in optional:
        ins["Length"] = LENGTHS
    cts = {slot: rand(B, T, H) if slot in ("Hidden", "Cell")
           else rand(B, H) for slot in OUTS[op]}
    return ins, cts


def _float_slots(ins):
    return [s for s in ins if s != "Length"]


def _jax_run(op, attrs, ins, cts, dtype):
    slots = _float_slots(ins)
    fixed = {s: [jnp.asarray(v)] for s, v in ins.items() if s == "Length"}

    def f(*vals):
        outs = getattr(jrnn, op)(attrs, dict(
            fixed, **{s: [v] for s, v in zip(slots, vals)}))
        return tuple(outs[s][0] for s in OUTS[op])

    primals = [jnp.asarray(ins[s]).astype(dtype) for s in slots]
    ys, vjp = jax.vjp(f, *primals)
    grads = vjp(tuple(jnp.asarray(cts[s]).astype(y.dtype)
                      for s, y in zip(OUTS[op], ys)))
    return dict(zip(OUTS[op], ys)), dict(zip(slots, grads))


def _torch_run(op, attrs, ins, cts, dtype):
    slots = _float_slots(ins)
    leaves = {s: torch.from_numpy(ins[s]).to(dtype).requires_grad_(True)
              for s in slots}
    tins = {s: [v] for s, v in leaves.items()}
    if "Length" in ins:
        tins["Length"] = [torch.from_numpy(ins["Length"])]
    outs = getattr(trnn, op)(attrs, tins)
    ys = [outs[s][0] for s in OUTS[op]]
    grads = torch.autograd.grad(
        ys, [leaves[s] for s in slots],
        [torch.from_numpy(cts[s]).to(y.dtype) for s, y in zip(OUTS[op], ys)])
    return dict(zip(OUTS[op], ys)), dict(zip(slots, grads))


def _tol(want, amp):
    top = float(np.abs(want).max())
    if amp:
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top else 2.0 ** -133
        return dict(rtol=0, atol=AMP_ULPS * ulp)
    return dict(rtol=F32_RTOL, atol=F32_ATOL * max(1.0, top))


def _compare(got, want, amp, what):
    for slot, w in want.items():
        g = got[slot]
        assert str(g.dtype).replace("torch.", "") == w.dtype.name, (
            what, slot, g.dtype, w.dtype)
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        assert np.isfinite(w).all(), (what, slot)
        np.testing.assert_allclose(g.detach().float().numpy(), w,
                                   err_msg=f"{what} {slot}",
                                   **_tol(w, amp))


def _both(op, name, attrs, optional, dtype):
    ins, cts = _inputs(op, attrs, optional, IDS.index(f"{op}-{name}"))
    jax_res = _jax_run(op, attrs, ins, cts, getattr(jnp, dtype))
    return jax_res, _torch_run(op, attrs, ins, cts, getattr(torch, dtype))


def _check(op, name, attrs, optional, dtype, amp):
    (jy, jg), (ty, tg) = _both(op, name, attrs, optional, dtype)
    _compare(ty, jy, amp, "output")
    _compare(tg, jg, amp, "gradient")
    return ty


@pytest.fixture
def amp(monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", True)
    monkeypatch.setattr(torch_common, "_AMP", True)


@pytest.fixture
def no_amp(monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", False)
    monkeypatch.setattr(torch_common, "_AMP", False)


@pytest.mark.parametrize("op,name,attrs,optional", CASES, ids=IDS)
def test_f32_matches_jax(no_amp, op, name, attrs, optional):
    ty = _check(op, name, attrs, optional, "float32", amp=False)
    if "Length" in optional:  # padding emits zeros
        pad = torch.arange(T)[None, :] >= torch.from_numpy(LENGTHS)[:, None]
        assert not ty["Hidden"][pad].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("op,name,attrs,optional", CASES, ids=IDS)
def test_amp_matches_jax(amp, op, name, attrs, optional, dtype):
    _check(op, name, attrs, optional, dtype, amp=True)


@pytest.mark.parametrize("name", ["relu", "identity"])
def test_amp_without_transcendentals_is_bitwise_jax(amp, name):
    case = CASES[IDS.index(f"simple_rnn-{name}")]
    (jy, jg), (ty, tg) = _both(*case, "bfloat16")
    for slot in ("Hidden", "LastH", "Input", "Weight"):
        got, want = (ty, jy) if slot in ty else (tg, jg)
        assert got[slot].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[slot].detach().float().numpy(),
            np.asarray(jnp.asarray(want[slot]).astype(jnp.float32)),
            err_msg=slot)


def test_length_freezes_finished_rows(no_amp):
    """LastH of a row is its Hidden at length - 1 (a forward scan), its
    initial state where the length is 0; a reverse scan ends at t = 0."""
    ins, _ = _inputs("lstm", {}, ("Bias", "H0", "C0", "Length"), seed=11)
    tins = {s: [torch.from_numpy(v)] for s, v in ins.items()}
    fwd = trnn.lstm({}, tins)
    rev = trnn.lstm({"is_reverse": True}, tins)
    hidden, last = fwd["Hidden"][0], fwd["LastH"][0]
    for row, n in enumerate(LENGTHS):
        want = hidden[row, n - 1] if n else tins["H0"][0][row]
        torch.testing.assert_close(last[row], want, rtol=0, atol=0)
        if n:
            torch.testing.assert_close(rev["LastH"][0][row],
                                       rev["Hidden"][0][row, 0],
                                       rtol=0, atol=0)


def test_building_on_a_sequence_feed_does_not_loop_over_the_sentinel(
        monkeypatch):
    """Shape inference of a ``dynamic_lstm``, ``dynamic_gru`` and
    ``simple_rnn`` on a ``lod_level=1`` feed (time axis -1, the 1297
    sentinel at build time) runs one step of each scan."""
    steps = {"n": 0}
    real = trnn._lstm_step

    def counted(*args):
        steps["n"] += 1
        return real(*args)

    monkeypatch.setattr(trnn, "_lstm_step", counted)
    monkeypatch.setattr(registry, "_INFER_CACHE", {})
    calls = []
    scan = trnn._scan

    def recorded(step, carry, seqs, reverse):
        carry, ys = scan(step, carry, seqs, reverse)
        calls.append(tuple(ys[0].shape))
        return carry, ys

    monkeypatch.setattr(trnn, "_scan", recorded)
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        words = tpt.layers.data("w", shape=[1], dtype="int64", lod_level=1)
        emb = tpt.layers.embedding(words, size=[20, 6])
        emb.seq_len = words.seq_len
        x = tpt.layers.fc(emb, size=4 * 6, num_flatten_dims=2)
        x.seq_len = words.seq_len
        h, c = tpt.layers.dynamic_lstm(x, 4 * 6, use_peepholes=True)
        g = tpt.layers.dynamic_gru(x, 8)
        r = tpt.layers.simple_rnn(h)
    assert steps["n"] == 1
    assert calls == [(1297, 1297, 6), (1297, 1297, 8), (1297, 1297, 6)]
    for v in (h, c, r):
        assert v.shape == (-1, -1, 6) and v.seq_len is words.seq_len
    assert g.shape == (-1, -1, 8)
    lstm_op = [op for op in main.global_block.ops if op.type == "lstm"][0]
    assert lstm_op.inputs["Length"] == ["w@len"]
