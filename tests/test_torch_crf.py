"""The port's linear-chain CRF ops against the JAX package's.

The same numpy inputs (b 4, T 7, n 5, lengths 1..7 across the rows, one
row at the full T) go through ``paddle_tpu.ops.crf_ops`` (gradients by
``jax.vjp``) and ``paddle_tpu_torch.ops.crf_ops`` (torch autograd through
the recursion):

- ``linear_chain_crf``: the NLL and Alpha, and the Emission and
  Transition gradients under a random cotangent, at rtol 1e-5 / atol
  1e-5 (log-sum-exps of a few terms summed in another order);
- ``crf_decoding``: the Viterbi paths equal JAX's exactly (0 at the
  padding) and the brute-force best path; with ``Label``, the 0/1
  correctness mask exactly; a planted tie goes to the lowest tag in
  both;
- ``chunk_eval``: the counts exact (int64 in the port, int32 in JAX
  without x64: compared as integers) and the f32 precision / recall / F1
  equal, on the hand cases of ``tests/test_crf.py`` and on random IOB
  sequences;
- meta tensors (build-time shape inference) give every output's shape
  and dtype.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op as jget
from paddle_tpu_torch.core.registry import get_op as tget

torch.set_num_threads(1)
B, T, N = 4, 7, 5
LENGTHS = np.array([7, 1, 4, 6], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0, b=B, t=T, n=N, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    em = rng.randn(b, t, n).astype(np.float32)
    trans = (rng.randn(n + 2, n) * 0.5).astype(np.float32)
    label = rng.randint(0, n, size=(b, t)).astype(np.int64)
    return em, trans, label, lengths


def _jrun(op, ins, attrs=None):
    return jget(op).fn(attrs or {}, {k: [jnp.asarray(v) for v in vs]
                                     for k, vs in ins.items()})


def _trun(op, ins, attrs=None):
    return tget(op).fn(attrs or {}, {k: [torch.as_tensor(v) for v in vs]
                                     for k, vs in ins.items()})


def _brute_best(em, trans, length):
    n = em.shape[-1]
    best, best_s = None, -np.inf
    for path in itertools.product(range(n), repeat=length):
        s = trans[0, path[0]] + trans[1, path[-1]]
        s += sum(em[t, path[t]] for t in range(length))
        s += sum(trans[2 + path[t], path[t + 1]] for t in range(length - 1))
        if s > best_s:
            best, best_s = list(path), s
    return best


@pytest.mark.parametrize("label_3d", [False, True])
def test_nll_alpha_and_gradients(label_3d):
    em, trans, label, lengths = _inputs()
    lab = label[..., None] if label_3d else label
    g = np.random.RandomState(1).randn(B, 1).astype(np.float32)

    def jf(e, tr):
        outs = jget("linear_chain_crf").fn({}, {
            "Emission": [e], "Transition": [tr],
            "Label": [jnp.asarray(lab)], "Length": [jnp.asarray(lengths)]})
        return outs["LogLikelihood"][0], outs["Alpha"][0]

    (jnll, jalpha), vjp = jax.vjp(jf, jnp.asarray(em), jnp.asarray(trans))
    jde, jdt = vjp((jnp.asarray(g), jnp.zeros_like(jalpha)))

    te = torch.from_numpy(em).requires_grad_(True)
    tt = torch.from_numpy(trans).requires_grad_(True)
    outs = tget("linear_chain_crf").fn({}, {
        "Emission": [te], "Transition": [tt],
        "Label": [torch.from_numpy(lab)],
        "Length": [torch.from_numpy(lengths)]})
    tnll, talpha = outs["LogLikelihood"][0], outs["Alpha"][0]
    tde, tdt = torch.autograd.grad(tnll, (te, tt), torch.from_numpy(g))
    assert tnll.shape == (B, 1) and talpha.shape == (B, T, N)
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll),
                               **TOL)
    np.testing.assert_allclose(talpha.detach().numpy(), np.asarray(jalpha),
                               **TOL)
    np.testing.assert_allclose(tde.numpy(), np.asarray(jde), **TOL)
    np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), **TOL)


def test_nll_without_length():
    em, trans, label, _ = _inputs(seed=3)
    ins = {"Emission": [em], "Transition": [trans], "Label": [label]}
    want = np.asarray(_jrun("linear_chain_crf", ins)["LogLikelihood"][0])
    got = _trun("linear_chain_crf", ins)["LogLikelihood"][0].numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_viterbi_paths_and_mask():
    em, trans, label, lengths = _inputs(seed=4)
    ins = {"Emission": [em], "Transition": [trans], "Length": [lengths]}
    want = np.asarray(_jrun("crf_decoding", ins)["ViterbiPath"][0])
    got = _trun("crf_decoding", ins)["ViterbiPath"][0]
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for r in range(B):
        L = lengths[r]
        assert got[r, :L].tolist() == _brute_best(em[r], trans, L)
        assert not got[r, L:].any()
    ins["Label"] = [label]
    want_c = np.asarray(_jrun("crf_decoding", ins)["ViterbiPath"][0])
    got_c = _trun("crf_decoding", ins)["ViterbiPath"][0].numpy()
    np.testing.assert_array_equal(got_c, want_c)
    mask = np.arange(T)[None, :] < lengths[:, None]
    np.testing.assert_array_equal(got_c, (got.numpy() == label) & mask)


def test_viterbi_tie_goes_to_the_lowest_tag():
    """Every score equal: argmax ties at each step and at the end; both
    packages pick tag 0 throughout."""
    em = np.zeros((2, 5, 3), np.float32)
    trans = np.zeros((5, 3), np.float32)
    lengths = np.array([5, 3], np.int32)
    ins = {"Emission": [em], "Transition": [trans], "Length": [lengths]}
    want = np.asarray(_jrun("crf_decoding", ins)["ViterbiPath"][0])
    got = _trun("crf_decoding", ins)["ViterbiPath"][0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.zeros((2, 5)))


def _chunk_both(infer, label, lengths, k):
    ins = {"Inference": [infer], "Label": [label]}
    if lengths is not None:
        ins["Length"] = [lengths]
    attrs = {"num_chunk_types": k}
    return _jrun("chunk_eval", ins, attrs), _trun("chunk_eval", ins, attrs)


def _assert_chunks_equal(j, t):
    for slot in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"):
        assert t[slot][0].dtype == torch.int64
        assert t[slot][0].tolist() == np.asarray(j[slot][0]).tolist(), slot
    for slot in ("Precision", "Recall", "F1-Score"):
        assert t[slot][0].dtype == torch.float32
        np.testing.assert_array_equal(t[slot][0].numpy(),
                                      np.asarray(j[slot][0]))


HAND_CASES = [
    # tests/test_crf.py:91-128: 2 types, tags 0=B-0 1=I-0 2=B-1 3=I-1 4=O
    (np.array([[0, 1, 4, 2, 3, 4], [2, 0, 1, 1, 0, 4]]),
     np.array([[0, 1, 4, 2, 3, 3], [2, 0, 1, 1, 4, 4]]),
     np.array([6, 6]), 2, (5, 4, 3)),
    # an over-long inference chunk is not a match
    (np.array([[0, 1, 1, 1]]), np.array([[0, 1, 0, 1]]), np.array([4]), 1,
     (1, 2, 0)),
    # tests/test_crf.py:177-187: matching by (begin, end, type)
    (np.array([[1, 1, 2]]), np.array([[0, 1, 2]]), np.array([3]), 1,
     (1, 1, 1)),
]


@pytest.mark.parametrize("case", range(len(HAND_CASES)))
def test_chunk_eval_hand_cases(case):
    infer, label, lengths, k, (ni, nl, nc) = HAND_CASES[case]
    j, t = _chunk_both(infer.astype(np.int64), label.astype(np.int64),
                       lengths.astype(np.int32), k)
    _assert_chunks_equal(j, t)
    assert (int(t["NumInferChunks"][0]), int(t["NumLabelChunks"][0]),
            int(t["NumCorrectChunks"][0])) == (ni, nl, nc)


@pytest.mark.parametrize("with_length", [True, False])
def test_chunk_eval_random_iob(with_length):
    """Random IOB tags (4 types and O = 8, as conll05 labels them), the
    inference a noisy copy of the label, [b, T, 1] as a feeder gives."""
    rng = np.random.RandomState(5)
    b, t = 16, 12
    label = rng.randint(0, 9, size=(b, t, 1)).astype(np.int64)
    infer = np.where(rng.rand(b, t, 1) < 0.3,
                     rng.randint(0, 9, size=(b, t, 1)), label)
    lengths = (rng.randint(0, t + 1, size=b).astype(np.int32)
               if with_length else None)
    j, tt = _chunk_both(infer.astype(np.int64), label, lengths, 4)
    _assert_chunks_equal(j, tt)
    assert int(tt["NumCorrectChunks"][0]) > 0


def test_meta_shapes():
    m = lambda *s, dtype=torch.float32: torch.empty(  # noqa: E731
        s, dtype=dtype, device="meta")
    outs = tget("linear_chain_crf").fn({}, {
        "Emission": [m(3, 9, N)], "Transition": [m(N + 2, N)],
        "Label": [m(3, 9, 1, dtype=torch.int64)],
        "Length": [m(3, dtype=torch.int32)]})
    assert outs["LogLikelihood"][0].shape == (3, 1)
    assert outs["Alpha"][0].shape == (3, 9, N)
    outs = tget("crf_decoding").fn({}, {
        "Emission": [m(3, 9, N)], "Transition": [m(N + 2, N)]})
    assert outs["ViterbiPath"][0].shape == (3, 9)
    assert outs["ViterbiPath"][0].dtype == torch.int64
