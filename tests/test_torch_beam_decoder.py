"""The port's fused ``beam_search_decoder`` against the JAX package's.

The same numpy weights go through ``paddle_tpu.ops.control_flow_ops``
and ``paddle_tpu_torch.ops.control_flow_ops``, for the GRU and the LSTM
cell, with and without the biases and the LSTM's InitCell. Ids and
SeqLen must be equal token for token, SeqScores within 1e-5. Cases:

- random weights (V 11, e 4, h 6, b 3, beam 4, max_len 7);
- every beam finishing early: a large EOS bias ends every hypothesis by
  step 2, so JAX's ``while_loop`` stops there while the port runs all
  ``max_len`` steps; the outputs still agree;
- tied scores: tokens 3 and 4 have identical output columns and biases,
  so their log-probs tie bit for bit at every step; both packages put
  the lower index first (``lax.top_k``'s rule, the port's stable sort);
- beam wider than the first step's live candidates are distinct (beam 4
  over V 5), so beams fed from the ``finfo.min`` start take part.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op as jget
from paddle_tpu_torch.core.registry import get_op as tget

torch.set_num_threads(1)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _weights(cell, V=11, e=4, h=6, b=3, seed=0, biases=True):
    rng = np.random.RandomState(seed)
    G = 3 if cell == "gru" else 4
    ins = {"InitState": rng.randn(b, h).astype(np.float32),
           "Embedding": rng.randn(V, e).astype(np.float32),
           "WeightX": (rng.randn(e, G * h) * 0.5).astype(np.float32),
           "WeightH": (rng.randn(h, G * h) * 0.5).astype(np.float32),
           "WeightOut": rng.randn(h, V).astype(np.float32)}
    if biases:
        ins["Bias"] = (rng.randn(1, G * h) * 0.1).astype(np.float32)
        ins["OutBias"] = (rng.randn(V) * 0.5).astype(np.float32)
    if cell == "lstm":
        ins["InitCell"] = rng.randn(b, h).astype(np.float32)
    return ins


def _both(ins, **attrs):
    attrs = {"beam_size": 4, "max_len": 7, "bos_id": 0, "eos_id": 1,
             **attrs}
    j = jget("beam_search_decoder").fn(
        attrs, {k: [jnp.asarray(v)] for k, v in ins.items()})
    t = tget("beam_search_decoder").fn(
        attrs, {k: [torch.from_numpy(v)] for k, v in ins.items()})
    return j, t


def _assert_equal(j, t):
    assert t["Ids"][0].dtype == torch.int32
    assert t["SeqLen"][0].dtype == torch.int32
    np.testing.assert_array_equal(t["Ids"][0].numpy(), np.asarray(j["Ids"][0]))
    np.testing.assert_array_equal(t["SeqLen"][0].numpy(),
                                  np.asarray(j["SeqLen"][0]))
    np.testing.assert_allclose(t["SeqScores"][0].numpy(),
                               np.asarray(j["SeqScores"][0]), **SCORE_TOL)


@pytest.mark.parametrize("biases", [True, False])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_random_weights(cell, biases):
    ins = _weights(cell, biases=biases)
    j, t = _both(ins, cell=cell)
    _assert_equal(j, t)
    scores = t["SeqScores"][0].numpy()
    assert np.all(np.diff(scores, axis=1) <= 0)  # best first


def test_lstm_without_init_cell():
    ins = _weights("lstm", seed=1)
    del ins["InitCell"]
    _assert_equal(*_both(ins, cell="lstm"))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_every_beam_finishes_early(cell):
    ins = _weights(cell, seed=2)
    ins["OutBias"][1] = 30.0  # EOS dominates every step
    j, t = _both(ins, cell=cell, beam_size=3, max_len=9)
    _assert_equal(j, t)
    lens = t["SeqLen"][0].numpy()
    assert lens.max() <= 1, lens  # every hypothesis ended by step 2
    ids = t["Ids"][0].numpy()
    assert np.all(ids[:, :, 2:] == 1)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_tied_scores(cell):
    ins = _weights(cell, seed=3)
    ins["WeightOut"][:, 4] = ins["WeightOut"][:, 3]
    ins["OutBias"][4] = ins["OutBias"][3]
    ins["OutBias"][3] += 3.0  # make the tied pair popular
    ins["OutBias"][4] += 3.0
    j, t = _both(ins, cell=cell)
    _assert_equal(j, t)
    ids = t["Ids"][0].numpy()
    assert (ids == 3).any() and (ids == 4).any()


def test_narrow_vocab_wide_beam():
    ins = _weights("gru", V=5, seed=4)
    _assert_equal(*_both(ins, cell="gru", beam_size=4, max_len=5))
