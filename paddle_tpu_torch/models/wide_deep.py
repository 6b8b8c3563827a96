"""Wide&Deep CTR model with high-dimensional sparse embeddings.

Counterpart of ``paddle_tpu/models/wide_deep.py``, the fifth flagship
configuration of BASELINE.json. ``is_sparse=True`` embeddings give
SelectedRows gradients that the optimizer applies to the looked-up rows
only, never through a [V, D] buffer, so the step's update traffic
follows the batch and not the vocabulary.
"""
from __future__ import annotations

from .. import layers
from ..layers.layer_helper import LayerHelper


def wide_deep(sparse_ids, dense_input, vocab_size, embed_dim=16,
              hidden_sizes=(64, 32), is_sparse=True,
              main_program=None, startup_program=None):
    """Build the Wide&Deep CTR tower; returns the [b, 1] logit.

    sparse_ids:  int [b, S], S categorical slots, ids pre-offset into a
                 shared vocabulary of ``vocab_size``.
    dense_input: float [b, Dd] continuous features (may be None).

    wide  = the sum over slots of a per-id scalar weight (an embedding of
            dim 1) [+ a linear map of the dense features]
    deep  = an MLP over the concatenated [b, S*embed_dim] slot
            embeddings [+ the dense features]
    logit = wide + the deep head
    """
    kw = dict(main_program=main_program, startup_program=startup_program)
    num_slots = sparse_ids.shape[-1]

    wide_emb = layers.embedding(
        sparse_ids, size=[vocab_size, 1], is_sparse=is_sparse, **kw)
    helper = LayerHelper("wide_deep", **kw)
    wide = helper.simple_op(
        "reduce_sum", {"X": [wide_emb]}, {"dim": [1], "keep_dim": False})

    deep_emb = layers.embedding(
        sparse_ids, size=[vocab_size, embed_dim], is_sparse=is_sparse, **kw)
    deep = layers.reshape(deep_emb, [-1, num_slots * embed_dim], **kw)
    if dense_input is not None:
        deep = layers.concat([deep, dense_input], axis=1, **kw)
        wide = layers.elementwise_add(
            wide, layers.fc(dense_input, size=1, **kw), **kw)
    for size in hidden_sizes:
        deep = layers.fc(deep, size=size, act="relu", **kw)
    deep_logit = layers.fc(deep, size=1, **kw)
    return layers.elementwise_add(wide, deep_logit, **kw)


def wide_deep_loss(logit, label, main_program=None, startup_program=None):
    """Mean sigmoid cross-entropy CTR loss; returns (loss, probability)."""
    kw = dict(main_program=main_program, startup_program=startup_program)
    helper = LayerHelper("wide_deep", **kw)
    ce = helper.simple_op(
        "sigmoid_cross_entropy_with_logits",
        {"X": [logit], "Label": [label]}, {})
    prob = layers.sigmoid(logit, **kw)
    return layers.mean(ce, **kw), prob
