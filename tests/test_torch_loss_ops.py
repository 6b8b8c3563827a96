"""The port's 12 loss ops and the row products ``dot`` and ``cos_sim``
against the JAX package's, forward and gradient, in f32 and bf16.

Each case runs the reference's registered ``fn`` jitted under
``jax.vjp`` and the port's under ``torch.autograd`` on the same seeded
numpy inputs (``run_both`` of ``test_torch_tensor_ops_more.py``), once
for every output slot the reference returns (``Residual``, ``Diff``,
``sub_result``, ``Activated``, ``XNorm``, ``YNorm``). The inputs hold
each loss's kinks: ``sigmoid_cross_entropy_with_logits`` at x = 0 (where
JAX's maximum splits its gradient and its abs passes +g, so both give
-label), ``hinge_loss`` at a margin of exactly 1, ``huber_loss`` at
|residual| = delta, ``smooth_l1_loss`` at |diff| = 1 / sigma^2 and
``margin_rank_loss`` at 0; the values there are dyadic, so both packages
land on the kink exactly.

Tolerance, with ``_ulps`` of ``test_torch_activation_ops.py``: at most
``F32_ULPS`` f32 or ``BF16_ULPS`` bf16 ulps of each tensor's largest
|value|, forward and every gradient. Every loss here is a sum or a
difference of terms of the output's size (a row sum, sigmoid(x) - label,
a cosine's x / |x||y| - sim x / |x|^2), so a last-bit gap of its terms is
measured at their scale. XLA fuses f32 products and sums into
multiply-adds, sums rows in another order and computes log, exp and
log1p with its own polynomials; in bf16 it keeps a product that feeds a
sum in f32, as ``common.sum_f32`` does. Measured: at most 4 f32 ulps
(``cos_sim``'s gradient of Y) and 1 bf16 ulp (the gradients of a
broadcast Y, summed over rows); the piecewise losses (``hinge_loss``,
``huber_loss``, ``margin_rank_loss``, ``smooth_l1_loss``,
``square_error_cost``) and the hard-label ``cross_entropy`` are held
equal bit for bit, kinks included (``EXACT``).
"""
import numpy as np
import pytest
import torch

from test_torch_activation_ops import BF16_ULPS, F32_ULPS, _ulps
from test_torch_tensor_ops_more import run_both

torch.set_num_threads(1)
N, D = 8, 12
EXACT = {"hinge_loss", "huber_loss", "margin_rank_loss", "smooth_l1_loss",
         "smooth_l1_loss_weighted", "square_error_cost", "cross_entropy_hard"}


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _dyadic(*shape, seed=0):
    """Multiples of 1/16 in [-3, 3]: differences of them are exact."""
    return (np.random.RandomState(seed).randint(-48, 49, size=shape)
            / 16.0).astype(np.float32)


def _probs(seed):
    e = np.exp(_rand(N, D, seed=seed))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _unit(*shape, seed=0):
    return np.random.RandomState(seed).uniform(0.02, 0.98, shape).astype(
        np.float32)


def _logits_with_zero():
    x = _rand(N, D, scale=2.0)
    x.reshape(-1)[::7] = 0.0
    return x


def _hinge():
    logits = _dyadic(N, 1)
    labels = (np.arange(N) % 2).astype(np.float32).reshape(N, 1)
    logits[:2, 0] = [-1.0, 1.0]  # 1 - sign * logit == 0 for labels 0, 1
    return {"Logits": [logits], "Labels": [labels]}


def _huber():
    x = _dyadic(N, 1)
    y = _dyadic(N, 1, seed=1)
    y[:3, 0] = x[:3, 0] + np.float32([1.0, -1.0, 0.0])
    return {"X": [x], "Y": [y]}


def _smooth_l1(weights):
    x = _dyadic(N, D)
    y = _dyadic(N, D, seed=1)
    y[0, :3] = x[0, :3] + np.float32([1.0, -1.0, 0.0])
    ins = {"X": [x], "Y": [y]}
    if weights:
        ins["InsideWeight"] = [np.abs(_dyadic(N, D, seed=2)) + 0.5]
        ins["OutsideWeight"] = [np.abs(_dyadic(N, D, seed=3)) + 0.5]
    return ins


def _margin():
    label = np.where(np.arange(N) % 2, 1.0, -1.0).astype(np.float32)[:, None]
    x1 = _dyadic(N, 1)
    x2 = _dyadic(N, 1, seed=1)
    x2[:2, 0] = x1[:2, 0] - np.float32([0.125, -0.125])  # o = 0 exactly
    return {"Label": [label], "X1": [x1], "X2": [x2]}


# name -> (op, attrs, ins, output slots)
CASES = {
    "cross_entropy_hard": (
        "cross_entropy", {}, {"X": [_probs(0)], "Label": [
            np.random.RandomState(1).randint(0, D, (N, 1)).astype(np.int64)]},
        ["Y"]),
    "cross_entropy_soft": (
        "cross_entropy", {"soft_label": True},
        {"X": [_probs(0)], "Label": [_probs(1)]}, ["Y"]),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits", {},
        {"X": [_logits_with_zero()], "Label": [_unit(N, D, seed=1)]},
        ["Out"]),
    "bce_loss": ("bce_loss", {}, {"X": [_unit(N, D)],
                                  "Label": [_unit(N, D, seed=1)]}, ["Out"]),
    "square_error_cost": ("square_error_cost", {},
                          {"X": [_rand(N, 1)], "Y": [_rand(N, 1, seed=1)]},
                          ["Out"]),
    "squared_l2_distance": ("squared_l2_distance", {},
                            {"X": [_rand(N, D)], "Y": [_rand(1, D, seed=1)]},
                            ["Out", "sub_result"]),
    "squared_l2_norm": ("squared_l2_norm", {}, {"X": [_rand(N, D)]},
                        ["Out"]),
    "hinge_loss": ("hinge_loss", {}, _hinge(), ["Loss"]),
    "huber_loss": ("huber_loss", {"delta": 1.0}, _huber(),
                   ["Out", "Residual"]),
    "log_loss": ("log_loss", {"epsilon": 1e-4},
                 {"Predicted": [_unit(N, 1)], "Labels": [
                     (np.arange(N) % 2).astype(np.float32)[:, None]]},
                 ["Loss"]),
    "rank_loss": ("rank_loss", {},
                  {"Label": [np.float32([[0.0], [0.5], [1.0]] * 3)[:N]],
                   "Left": [_rand(N, 1)], "Right": [_rand(N, 1, seed=1)]},
                  ["Out"]),
    "margin_rank_loss": ("margin_rank_loss", {"margin": 0.125}, _margin(),
                         ["Out", "Activated"]),
    "smooth_l1_loss": ("smooth_l1_loss", {"sigma": 1.0}, _smooth_l1(False),
                       ["Out", "Diff"]),
    "smooth_l1_loss_weighted": ("smooth_l1_loss", {"sigma": 2.0},
                                _smooth_l1(True), ["Out", "Diff"]),
    "dot": ("dot", {}, {"X": [_rand(N, D)], "Y": [_rand(N, D, seed=1)]},
            ["Out"]),
    "cos_sim": ("cos_sim", {}, {"X": [_rand(N, D)], "Y": [_rand(N, D,
                                                                seed=1)]},
                ["Out", "XNorm", "YNorm"]),
    "cos_sim_row": ("cos_sim", {}, {"X": [_rand(N, D)],
                                    "Y": [_rand(1, D, seed=1)]},
                    ["Out", "XNorm", "YNorm"]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_op_matches_jax(name, dtype):
    op, attrs, ins, slots = CASES[name]
    limit = F32_ULPS if dtype == "float32" else BF16_ULPS
    for slot in slots:
        jout, jgrads, tout, tgrads = run_both(op, attrs, ins, slot, dtype)
        if name in EXACT:
            for t, j in zip([tout] + tgrads, [jout] + jgrads):
                np.testing.assert_array_equal(t, j)
            continue
        gaps = [_ulps(tout, jout, dtype, at_max=True)] + [
            _ulps(t, j, dtype, at_max=True) for t, j in zip(tgrads, jgrads)]
        assert max(gaps) <= limit, (slot, gaps)


def test_sigmoid_cross_entropy_gradient_at_zero_is_minus_label():
    """At x = 0 JAX's gradient is -label (maximum's half plus abs's +1
    through log1p(exp(-|x|))); the port's is the same, where torch's own
    abs and clamp would give 0.5 - label."""
    from paddle_tpu_torch.core.registry import get_op

    x = torch.zeros(4, requires_grad=True)
    label = torch.tensor([0.0, 0.25, 0.5, 1.0])
    get_op("sigmoid_cross_entropy_with_logits").fn(
        {}, {"X": [x], "Label": [label]})["Out"][0].sum().backward()
    assert torch.equal(x.grad, -label)
