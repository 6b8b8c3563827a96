"""The stacked LM's beam search and self-speculative decoders against the
JAX package's.

``transformer_stack_beam_search`` and
``transformer_stack_speculative_generate`` are called directly in both
packages with the same ``ins``, made from a numpy seed (the prefill runs
the flash kernel's plain version here and the Pallas kernel's reference
path in JAX). Beam ``Out`` must equal JAX's token for token and
``Scores`` agree within 1e-5 relative (the GNMT penalty's ``pow`` may
round an ulp apart); beam 1 must equal the greedy decode. The
speculative ``Out`` must equal JAX's and the port's own greedy output,
and ``Rounds`` JAX's. The two model builders must build the JAX
package's programs (``program_to_dict``, name counters synced). A tiny
LM (V97 d32 L3 H4), f32 on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pipeline_ops as jops
from paddle_tpu_torch.models.transformer import init_params
from paddle_tpu_torch.ops import pipeline_ops as tops
from paddle_tpu_torch.serving import LMSpec
from test_torch_layers_ops import program_dicts

torch.set_num_threads(1)
V, D, L, H, MAXLEN = 97, 32, 3, 4, 64
SCORE_RTOL = 1e-5

VARIANTS = {
    "mha_pos_emb": dict(),
    "gqa_rope": dict(num_kv_heads=2, use_rope=True),
}


def _ins(variant, seed=0, b=2, tp=7):
    spec = LMSpec(vocab_size=V, d_model=D, n_layers=L, num_heads=H,
                  max_len=MAXLEN, **VARIANTS[variant])
    params = init_params(spec, seed)
    rng = np.random.RandomState(seed + 1)
    for name in params:  # non-trivial norms and biases
        if name.endswith(("_s", "_b", "_b1", "_b2", ".scale", ".bias")):
            params[name] = (params[name]
                            + 0.1 * rng.randn(*params[name].shape)
                            ).astype(np.float32)
    slot_of = {"tok_emb": "TokEmb", "pos_emb": "PosEmb",
               "final_ln.scale": "FinalLnS", "final_ln.bias": "FinalLnB",
               "lm_head.w": "HeadW"}
    slot_of.update({f"lm_stack.stack_{k}": s
                    for s, k in tops._STACK_SLOTS.items()})
    ins = {slot_of[n]: a for n, a in params.items()}
    ins["Prompt"] = rng.randint(0, V, (b, tp)).astype(np.int64)
    attrs = {"num_heads": H, "num_kv_heads": spec.num_kv_heads,
             "use_rope": spec.use_rope}
    return attrs, ins


def _both(arrays):
    return ({k: [jnp.asarray(a)] for k, a in arrays.items()},
            {k: [torch.from_numpy(np.array(a))] for k, a in arrays.items()})


def _beam(attrs, ins, **kw):
    jins, tins = _both(ins)
    a = dict(attrs, **kw)
    return (jops.transformer_stack_beam_search(a, jins),
            tops.transformer_stack_beam_search(a, tins))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("K,alpha,eos", [(3, 0.0, -1), (4, 0.6, 5),
                                         (4, 1.0, -1)])
def test_beam_search_matches_jax(variant, K, alpha, eos):
    attrs, ins = _ins(variant)
    jout, tout = _beam(attrs, ins, max_new_tokens=9, beam_size=K,
                       length_penalty=alpha, eos_id=eos)
    np.testing.assert_array_equal(tout["Out"][0].numpy(),
                                  np.asarray(jout["Out"][0]))
    assert tout["Out"][0].dtype == torch.int64
    np.testing.assert_allclose(tout["Scores"][0].numpy(),
                               np.asarray(jout["Scores"][0]),
                               rtol=SCORE_RTOL, atol=0)


def test_beam_search_with_frequent_eos_matches_jax():
    """An eos that beams take early: frozen hypotheses keep their score
    and trail eos, as in JAX."""
    attrs, ins = _ins("mha_pos_emb", seed=3)
    logits = tops._logits_fn(*(torch.from_numpy(ins[k]) for k in
                               ("FinalLnS", "FinalLnB", "HeadW")))
    # the id the untrained head favours most on average: beams hit it
    emb = torch.from_numpy(ins["TokEmb"])
    eos = int(logits(emb).argmax(-1).mode().values)
    jout, tout = _beam(attrs, ins, max_new_tokens=8, beam_size=4,
                       length_penalty=0.6, eos_id=eos)
    np.testing.assert_array_equal(tout["Out"][0].numpy(),
                                  np.asarray(jout["Out"][0]))
    np.testing.assert_allclose(tout["Scores"][0].numpy(),
                               np.asarray(jout["Scores"][0]),
                               rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_beam_one_is_greedy(variant):
    attrs, ins = _ins(variant)
    _, tout = _beam(attrs, ins, max_new_tokens=8, beam_size=1)
    greedy = tops.transformer_stack_generate(
        dict(attrs, max_new_tokens=8), _both(ins)[1])
    np.testing.assert_array_equal(tout["Out"][0][:, 0].numpy(),
                                  greedy["Out"][0].numpy())


def test_beam_search_rejects_what_jax_rejects():
    attrs, ins = _ins("mha_pos_emb")
    tins = _both(ins)[1]
    for kw, msg in ((dict(max_new_tokens=0, beam_size=2), "max_new_tokens"),
                    (dict(max_new_tokens=4, beam_size=V + 1), "beam_size"),
                    (dict(max_new_tokens=MAXLEN, beam_size=2), "max_len")):
        with pytest.raises(ValueError, match=msg):
            tops.transformer_stack_beam_search(dict(attrs, **kw), tins)


def _draft_ins(ins, copy_head, seed=5):
    """The draft head: a copy of the target's (as the demo sets it) or
    random."""
    if copy_head:
        return dict(ins, DraftLnS=ins["FinalLnS"], DraftLnB=ins["FinalLnB"],
                    DraftHeadW=ins["HeadW"])
    rng = np.random.RandomState(seed)
    return dict(ins, DraftLnS=np.ones(D, np.float32),
                DraftLnB=np.zeros(D, np.float32),
                DraftHeadW=(0.2 * rng.randn(D, V)).astype(np.float32))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("draft_layers,gamma,copy_head",
                         [(1, 3, True), (2, 4, True), (2, 2, False)])
def test_speculative_matches_jax_and_greedy(variant, draft_layers, gamma,
                                            copy_head):
    attrs, ins = _ins(variant, b=3)
    ins = _draft_ins(ins, copy_head)
    a = dict(attrs, max_new_tokens=12, draft_layers=draft_layers,
             gamma=gamma)
    jins, tins = _both(ins)
    jout = jops.transformer_stack_speculative_generate(a, jins)
    tout = tops.transformer_stack_speculative_generate(a, tins)
    np.testing.assert_array_equal(tout["Out"][0].numpy(),
                                  np.asarray(jout["Out"][0]))
    assert int(tout["Rounds"][0][0]) == int(np.asarray(jout["Rounds"][0])[0])
    assert tout["Rounds"][0].dtype == torch.int32
    greedy = tops.transformer_stack_generate(dict(attrs, max_new_tokens=12),
                                             tins)
    np.testing.assert_array_equal(tout["Out"][0].numpy(),
                                  greedy["Out"][0].numpy())


def test_speculative_rejects_what_jax_rejects():
    attrs, ins = _ins("mha_pos_emb")
    tins = _both(_draft_ins(ins, True))[1]
    for kw, msg in ((dict(draft_layers=L), "draft_layers"),
                    (dict(draft_layers=1, gamma=0), "gamma"),
                    (dict(draft_layers=1, max_new_tokens=MAXLEN), "max_len")):
        a = {**attrs, "max_new_tokens": 4, **kw}
        with pytest.raises(ValueError, match=msg):
            tops.transformer_stack_speculative_generate(a, tins)


def _beam_builder(pt):
    prompt = pt.layers.data("prompt", shape=[6], dtype="int64")
    pt.models.transformer_lm_beam_search(
        prompt, vocab_size=V, d_model=D, n_layers=L, num_heads=H,
        max_len=MAXLEN, max_new_tokens=5, beam_size=3, length_penalty=0.6,
        eos_id=2)


def _speculative_builder(pt):
    prompt = pt.layers.data("prompt", shape=[6], dtype="int64")
    pt.models.transformer_lm_speculative_generate(
        prompt, vocab_size=V, d_model=D, n_layers=L, num_heads=H,
        num_kv_heads=2, use_rope=True, max_len=MAXLEN, max_new_tokens=5,
        draft_layers=1, gamma=3)


@pytest.mark.parametrize("builder", [_beam_builder, _speculative_builder])
def test_builders_build_the_jax_programs(builder):
    jd, td = program_dicts(builder)
    assert td == jd
