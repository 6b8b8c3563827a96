"""The contraction precision policy of the port (ops/common.py) against
the JAX package's, on the CPU.

- The tri-state: unset follows ``--mxu_precision``, an explicit
  ``set_mxu_precision`` wins, in both packages alike.
- On the CPU every policy computes in f32, as XLA's CPU backend does:
  ``mul``, ``conv2d`` (3x3 and the 1x1 dot path) and ``conv1x1_bn_act``
  (forward and gradients) equal the JAX package's f32 result at rtol
  1e-4 / atol 1e-6 under each policy, and the port's result is the same
  bits under all three.
- What the card does under each policy, reached on the CPU by its
  pieces: every f32 product and convolution runs, forward and backward,
  with cuBLAS's and cuDNN's TF32 switches set by the policy the forward
  saw (and the caller's settings back after it); the conv GEMM wrappers
  choose the 1xTF32 instance under ``default`` and the 3xTF32 one
  otherwise.
- The 1xTF32 kernels' plain version rounds as ``cvt.rna.tf32.f32``: bit
  for bit equal to a numpy emulation of round to nearest, ties away,
  at 10 mantissa bits, on ties, subnormals, infinities, NaN and random
  bit patterns.
- A CUDA graph's key holds the policy: the inference engine captures a
  new graph after a flip.
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu.ops import common as jcommon
from paddle_tpu_torch.core.registry import get_op as torch_op
from paddle_tpu_torch.kernels import conv_epilogue as ke
from paddle_tpu_torch.ops import common, nn_ops
from paddle_tpu_torch.serving import engine as engine_mod

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-6)
POLICIES = ("default", "high", "highest")


@pytest.fixture(autouse=True)
def _unset_policies(monkeypatch):
    """Both packages' policies unset (following the flag) for each test,
    restored after it."""
    monkeypatch.setattr(common, "_MXU_PRECISION", common._UNSET)
    monkeypatch.setattr(jcommon, "_MXU_PRECISION", jcommon._UNSET)
    yield
    tpt.flags.reset_flags()
    jpt.flags.reset_flags()


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# --- the tri-state -----------------------------------------------------------
def test_unset_follows_the_flag_and_a_set_wins():
    import jax

    jprec = {None: None, "high": jax.lax.Precision.HIGH,
             "highest": jax.lax.Precision.HIGHEST}
    assert tpt.mxu_precision() is None and jcommon.mxu_precision() is None
    for flag, want in (("highest", "highest"), ("high", "high"),
                       ("default", None)):
        tpt.parse_flags([f"--mxu_precision={flag}"])
        jpt.parse_flags([f"--mxu_precision={flag}"])
        assert tpt.mxu_precision() == want
        assert jcommon.mxu_precision() == jprec[want]
    tpt.set_flags({"mxu_precision": "highest"})
    assert tpt.mxu_precision() == "highest"
    # an explicit set wins over the flag, either way
    tpt.set_mxu_precision("default")
    assert tpt.mxu_precision() is None
    tpt.FLAGS.mxu_precision = "high"
    assert tpt.mxu_precision() is None
    tpt.set_mxu_precision("high")
    tpt.FLAGS.mxu_precision = "default"
    assert tpt.mxu_precision() == "high"
    tpt.set_mxu_precision(None)
    assert tpt.mxu_precision() is None
    assert common.policy_key() == (("amp", False), ("mxu_precision", None))


def test_unknown_policies_raise():
    with pytest.raises(ValueError, match="mxu precision"):
        tpt.set_mxu_precision("fast")
    tpt.FLAGS.mxu_precision = "medium"
    with pytest.raises(ValueError, match="medium"):
        tpt.mxu_precision()


# --- the CPU computes every policy in f32 ------------------------------------
def _set_both(policy):
    common.set_mxu_precision(policy)
    jcommon.set_mxu_precision(policy)


def _run_both(op, attrs, ins, wrt, seed=5):
    """Forward of ``op`` in both packages and the vjp of Out-like slot
    ``out`` with respect to the ``wrt`` slots (the port's by autograd,
    JAX's by jax.vjp of the op's kernel)."""
    import jax

    out = {"mul": "Out", "conv2d": "Output"}[op]
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}

    def jf(*args):
        given = dict(jins, **{s: [a] for s, a in zip(wrt, args)})
        return jax_op(op).fn(attrs, given)[out][0]

    jy, vjp = jax.vjp(jf, *[jins[s][0] for s in wrt])
    g = _rand(*jy.shape, seed=seed)
    jgrads = vjp(jnp.asarray(g))
    tins = {s: [torch.from_numpy(a.copy()).requires_grad_(s in wrt)
                for a in v] for s, v in ins.items()}
    ty = torch_op(op).fn(attrs, tins)[out][0]
    tgrads = torch.autograd.grad(ty, [tins[s][0] for s in wrt],
                                 torch.from_numpy(g))
    return ((np.asarray(jy), *map(np.asarray, jgrads)),
            (ty.detach().numpy(), *[t.numpy() for t in tgrads]))


CASES = {
    "mul": ({"x_num_col_dims": 1, "y_num_col_dims": 1},
            {"X": [_rand(6, 40)], "Y": [_rand(40, 24, seed=1)]}),
    "conv2d-3x3": ({"strides": 2, "paddings": 1, "data_format": "NHWC"},
                   {"Input": [_rand(2, 9, 9, 8)],
                    "Filter": [_rand(3, 3, 8, 16, seed=1, scale=0.2)]}),
    "conv2d-1x1": ({"strides": 1, "paddings": 0, "data_format": "NHWC"},
                   {"Input": [_rand(2, 5, 5, 16)],
                    "Filter": [_rand(1, 1, 16, 12, seed=1, scale=0.3)]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_products_equal_jax_under_every_policy(case):
    op = case.split("-")[0]
    attrs, ins = CASES[case]
    wrt = list(ins)
    first = None
    for policy in POLICIES:
        _set_both(policy)
        want, got = _run_both(op, attrs, ins, wrt)
        for w, g, what in zip(want, got, ("out", *wrt)):
            np.testing.assert_allclose(g, w, err_msg=f"{policy} {what}",
                                       **TOL)
        if first is None:
            first = got
        for a, b in zip(first, got):
            np.testing.assert_array_equal(a, b)  # the same f32 bits


@pytest.mark.parametrize("is_test", [False, True])
def test_conv1x1_bn_act_equals_jax_under_every_policy(is_test):
    B, H, W, I, O = 2, 8, 8, 32, 16  # R = 128: the JAX kernels' tiles
    ins = {"X": [_rand(B, H, W, I)], "Filter": [_rand(I, O, seed=1,
                                                      scale=0.2)],
           "Scale": [1 + 0.1 * _rand(O, seed=2)],
           "Bias": [0.1 * _rand(O, seed=3)],
           "Mean": [0.1 * _rand(O, seed=4)],
           "Variance": [1 + 0.1 * np.abs(_rand(O, seed=5))],
           "Residual": [_rand(B, H, W, O, seed=6)]}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "act": "relu"}
    og = {"Y": _rand(B, H, W, O, seed=7)}
    for policy in POLICIES:
        _set_both(policy)
        jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        tins = {s: [torch.from_numpy(a.copy())] for s, v in ins.items()
                for a in v}
        want = jax_op("conv1x1_bn_act").fn(attrs, jins)
        got = torch_op("conv1x1_bn_act").fn(attrs, tins)
        for slot in ("Y", "SavedMean", "SavedVariance"):
            np.testing.assert_allclose(got[slot][0].numpy(),
                                       np.asarray(want[slot][0]),
                                       err_msg=f"{policy} {slot}", **TOL)
        jg = jax_op("conv1x1_bn_act").grad_fn(
            attrs, jins, want, {"Y": [jnp.asarray(og["Y"])]})
        tg = torch_op("conv1x1_bn_act").grad_fn(
            attrs, tins, got, {"Y": [torch.from_numpy(og["Y"])]})
        for slot in ("X", "Filter", "Scale", "Bias"):
            np.testing.assert_allclose(tg[slot][0].numpy(),
                                       np.asarray(jg[slot][0]),
                                       err_msg=f"{policy} d{slot}",
                                       rtol=1e-4, atol=1e-5)


# --- the card's switches, by their pieces ------------------------------------
def _switches():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def _caller_switches(matmul, cudnn):
    prev = _switches()
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@pytest.mark.parametrize("mode,inside", [("tf32", (True, True)),
                                         ("f32", (False, False))])
def test_products_set_the_policy_in_forward_and_backward(monkeypatch, mode,
                                                         inside):
    """A product the policy made TF32 (or full f32) on the card runs its
    forward and, when the grad op differentiates it later, its backward
    with both switches so, and gives the caller's settings back."""
    seen = []
    real = torch.matmul

    def recording(*a, **kw):
        seen.append(_switches())
        return real(*a, **kw)

    monkeypatch.setattr(torch, "matmul", recording)
    x = torch.from_numpy(_rand(3, 4, 8)).requires_grad_()
    w = torch.from_numpy(_rand(8, 5, seed=1)).requires_grad_()
    caller = (not inside[0], not inside[1])
    with _caller_switches(*caller):
        y = common._Matmul.apply(x, w, mode)
        assert seen == [inside] and _switches() == caller
        gx, gw = torch.autograd.grad(y.sum(), [x, w])
        # both gradient products, under the forward's setting
        assert seen == [inside] * 3 and _switches() == caller
    np.testing.assert_allclose(gx.numpy(), np.broadcast_to(
        w.detach().numpy().sum(1), (3, 4, 8)), rtol=1e-6)
    np.testing.assert_allclose(
        gw.numpy(), np.broadcast_to(x.detach().numpy().reshape(12, 8)
                                    .sum(0)[:, None], (8, 5)), rtol=1e-5)


def test_the_mode_follows_the_policy_and_the_device():
    f32 = torch.ones(2, 2)
    bf16 = f32.to(torch.bfloat16)
    meta = torch.ones(2, 2, device="meta")
    cuda_like = types.SimpleNamespace(dtype=torch.float32, is_cuda=True)
    assert common.precision_mode(f32, f32) is None  # the CPU: f32
    assert common.precision_mode(bf16, bf16) == "bf16"
    assert common.precision_mode(meta, meta) is None
    for policy, want in (("default", "tf32"), ("high", "f32"),
                         ("highest", "f32")):
        common.set_mxu_precision(policy)
        assert common.precision_mode(cuda_like, cuda_like) == want
        assert common.precision_mode(f32) is None


@pytest.mark.parametrize("tf32", [True, False])
def test_conv2d_sets_the_policy_in_forward_and_backward(monkeypatch, tf32):
    seen = []
    real = nn_ops._conv_precision

    @contextlib.contextmanager
    def recording(flag):
        with real(flag):
            seen.append(torch.backends.cudnn.allow_tf32)
            yield

    monkeypatch.setattr(nn_ops, "_conv_precision", recording)
    x = torch.from_numpy(_rand(1, 2, 5, 5)).requires_grad_()
    w = torch.from_numpy(_rand(4, 2, 3, 3, seed=1)).requires_grad_()
    with _caller_switches(False, not tf32):
        y = nn_ops._Conv2dF32.apply(x, w, [1, 1], [1, 1], [1, 1], 1, tf32)
        y.sum().backward()
        assert seen == [tf32, tf32]
        assert torch.backends.cudnn.allow_tf32 is (not tf32)


def test_conv_gemm_wrappers_choose_the_instance_by_policy(monkeypatch):
    calls = []
    monkeypatch.setattr(ke, "_plain_device", lambda t: False)
    monkeypatch.setattr(ke, "_launch_stats",
                        lambda x, w, tf32=False: calls.append(tf32))
    monkeypatch.setattr(ke, "_launch_epilogue",
                        lambda *a: calls.append(a[-1]))
    x, w, v = torch.ones(4, 8), torch.ones(8, 2), torch.ones(2)
    for policy in POLICIES:
        common.set_mxu_precision(policy)
        ke.conv1x1_stats(x, w)
        ke.conv1x1_epilogue(x, w, v, v)
        ke.conv1x1_stats(x.to(torch.bfloat16), w.to(torch.bfloat16))
    assert calls == [True, True, False, False, False, False,
                     False, False, False]


# --- the 1xTF32 rounding -------------------------------------------------------
def _rna_tf32(a):
    """Round f32 to tf32 (11 significant bits) to nearest, ties away from
    zero, in f64 arithmetic: the quantum is 2^(e - 11) for |a| in
    [2^(e-1), 2^e), and 2^-136 among the subnormals (13 of their 23
    fraction bits dropped); past the largest tf32 a value rounds to
    infinity; NaN stays NaN."""
    with np.errstate(invalid="ignore"):  # signalling NaNs
        a = a.astype(np.float64)
    out = a.copy()
    finite = np.isfinite(a) & (a != 0)
    _, e = np.frexp(np.abs(a[finite]))
    q = np.ldexp(1.0, np.maximum(e, -125) - 11)
    out[finite] = np.sign(a[finite]) * np.floor(np.abs(a[finite]) / q
                                                + 0.5) * q
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def _edge_values():
    bits = []
    for exp in (0x00, 0x01, 0x7F, 0x80, 0xFE):  # subnormal .. the largest
        for frac in (0, 1, 0xFFF, 0x1000, 0x1001, 0x2000 - 1, 0x3000,
                     0x5000, 0x7FF000, 0x7FEFFF, 0x7FFFFF, 0x400000):
            bits.append((exp << 23) | frac)
    bits += [0x7F800000, 0x7FC00000, 0x7F800001, 0x7FFFFFFF]  # inf, NaNs
    bits = np.array(bits, dtype=np.uint32)
    bits = np.concatenate([bits, bits | 0x80000000])  # and negated
    rng = np.random.RandomState(0)
    rand = rng.randint(0, 2**32, size=200000, dtype=np.uint64).astype(
        np.uint32)
    return np.concatenate([bits, rand]).view(np.float32)


def test_tf32_rounding_equals_cvt_rna_bit_for_bit():
    a = _edge_values()
    got = ke.round_tf32(torch.from_numpy(a.copy())).numpy()
    want = _rna_tf32(a)
    nan = np.isnan(a)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
    # ties go away from zero; the largest finite values round to inf
    tie = np.array([1 + 2.0**-11, -(1 + 3 * 2.0**-11)], np.float32)
    np.testing.assert_array_equal(
        ke.round_tf32(torch.from_numpy(tie)).numpy(),
        np.array([1 + 2.0**-10, -(1 + 2 * 2.0**-10)], np.float32))
    assert np.isposinf(ke.round_tf32(torch.tensor([3.4028235e38])).item())


def test_tf32_plain_versions_multiply_the_rounded_operands():
    x, w = _rand(300, 40), _rand(40, 24, seed=1)
    sc, sh, res = 1 + _rand(24, seed=2) * 0.1, _rand(24, seed=3), _rand(
        300, 24, seed=4)
    want = _rna_tf32(x).astype(np.float64) @ _rna_tf32(w).astype(np.float64)
    y, stats = ke.conv1x1_stats_tf32_reference(torch.from_numpy(x),
                                               torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(stats[0].numpy(), want.sum(0), rtol=1e-4,
                               atol=1e-4)
    out = ke.conv1x1_epilogue_tf32_reference(
        *map(torch.from_numpy, (x, w, sc, sh, res)), act="relu")
    np.testing.assert_allclose(
        out.numpy(), np.maximum(want * sc + sh + res, 0), rtol=1e-5,
        atol=1e-5)
    # and they differ from the f32 product, by TF32's rounding
    full = ke.conv1x1_stats_reference(torch.from_numpy(x),
                                      torch.from_numpy(w))[0].numpy()
    err = np.abs(y.numpy() - full).max() / np.abs(full).max()
    assert 1e-5 < err < 2e-3, err


# --- the policy in a CUDA graph's key ----------------------------------------
def test_engine_signature_holds_the_policy():
    fake = types.SimpleNamespace(feed_names=["x"])
    fed = {"x": np.zeros((2, 3), np.float32)}
    sig = engine_mod.InferenceEngine._signature
    common.set_mxu_precision("default")
    a = sig(fake, fed)
    common.set_mxu_precision("highest")
    b = sig(fake, fed)
    assert a != b and a[:1] == b[:1] == (("x", (2, 3)),)


def _fake_graph_capture(fn, device):
    """The capture on the CPU: the static outputs of one call, and a
    replay that re-runs ``fn`` into them, as a CUDA graph does."""
    outs = fn()

    def replay():
        for o, new in zip(outs, fn()):
            o.copy_(new)

    return types.SimpleNamespace(replay=replay), outs


def test_engine_captures_a_new_graph_after_a_flip(monkeypatch, tmp_path):
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[6])
        y = tpt.layers.fc(tpt.layers.fc(x, size=8, act="relu"), size=3)
    exe = tpt.Executor(tpt.CPUPlace())
    scope = tpt.Scope()
    exe.run(startup, scope=scope)
    tpt.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                main_program=main, scope=scope)
    monkeypatch.setattr(engine_mod, "_graph_capture", _fake_graph_capture)
    common.set_mxu_precision("default")
    eng = tpt.InferenceEngine(str(tmp_path), place=tpt.CPUPlace(),
                              batch_buckets=(2,))
    eng._use_graphs = True
    assert eng.warmup() == 1 and eng.cache_stats() == {"graphs": 1}
    feed = {"x": _rand(2, 6, seed=9)}
    first = eng.run(feed)[0]
    common.set_mxu_precision("highest")
    second = eng.run(feed)[0]
    assert eng.cache_stats() == {"graphs": 2}
    assert sorted(dict(k)["mxu_precision"] or "default"
                  for k in eng._graphs) == ["default", "highest"]
    np.testing.assert_array_equal(first, second)  # the CPU's f32 both ways
    eng.close()
