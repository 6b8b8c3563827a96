"""paddle_tpu_torch.ops.pipeline_ops against the JAX op functions.

The slot-cache ops of the dense serving engine (prefill, which runs the
flash kernel's path, and decode) and the one-shot generate op are called
directly in both packages with the same ``ins``, made from a numpy seed
(the JAX registry's ``register_op`` returns the op function itself).
Next tokens must be equal and the caches must agree to atol 1e-5 (f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pipeline_ops as jops
from paddle_tpu_torch.models.transformer import init_params
from paddle_tpu_torch.ops import pipeline_ops as tops
from paddle_tpu_torch.serving import LMSpec

torch.set_num_threads(1)
V, D, L, H, MAXLEN, TMAX = 97, 32, 2, 4, 64, 32
SLOTS = 3  # + one scrap slot at index SLOTS

VARIANTS = {
    "mha_pos_emb": dict(),
    "gqa_rope": dict(num_kv_heads=2, use_rope=True),
}


def _weights(variant, seed=0):
    spec = LMSpec(vocab_size=V, d_model=D, n_layers=L, num_heads=H,
                  max_len=MAXLEN, **VARIANTS[variant])
    params = init_params(spec, seed)
    rng = np.random.RandomState(seed + 1)
    # non-trivial norms and biases, so every weight plane is exercised
    for name in params:
        if name.endswith(("_s", "_b", "_b1", "_b2", ".scale", ".bias")):
            params[name] = (params[name]
                            + 0.1 * rng.randn(*params[name].shape)
                            ).astype(np.float32)
    slot_of = {"tok_emb": "TokEmb", "pos_emb": "PosEmb",
               "final_ln.scale": "FinalLnS", "final_ln.bias": "FinalLnB",
               "lm_head.w": "HeadW"}
    slot_of.update({f"lm_stack.stack_{k}": s
                    for s, k in tops._STACK_SLOTS.items()})
    attrs = {"num_heads": H, "num_kv_heads": spec.num_kv_heads,
             "use_rope": spec.use_rope, "temperature": 0.0, "top_k": 0}
    return spec, attrs, {slot_of[n]: a for n, a in params.items()}


def _both(arrays):
    """numpy ins -> (JAX ins, torch ins)."""
    return ({k: [jnp.asarray(a)] for k, a in arrays.items()},
            {k: [torch.from_numpy(np.array(a))] for k, a in arrays.items()})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_slot_prefill_then_decode_match_jax(variant):
    spec, attrs, weights = _weights(variant)
    rng = np.random.RandomState(3)
    cache_shape = (L, SLOTS + 1, spec.kv_heads, TMAX, spec.head_dim)
    tp = 16
    # a bucket of 4 rows: three requests and one pad row sent to the
    # scrap slot; slots given out of order
    prompt = rng.randint(0, V, (4, tp)).astype(np.int64)
    lengths = np.array([16, 5, 11, 1], np.int32)
    prompt[np.arange(tp)[None, :] >= lengths[:, None]] = 0
    ins = dict(weights, Prompt=prompt,
               SlotIds=np.array([2, 0, 1, SLOTS], np.int32),
               Lengths=lengths,
               CacheK=rng.randn(*cache_shape).astype(np.float32),
               CacheV=rng.randn(*cache_shape).astype(np.float32))
    jins, tins = _both(ins)
    jout = jops.transformer_stack_slot_prefill(attrs, jins)
    tout = tops.transformer_stack_slot_prefill(attrs, tins)
    np.testing.assert_array_equal(_np(tout["NextTok"][0]),
                                  _np(jout["NextTok"][0]))
    assert tout["NextTok"][0].dtype == torch.int64
    for slot in ("CacheK", "CacheV"):
        np.testing.assert_allclose(_np(tout[slot][0]), _np(jout[slot][0]),
                                   atol=1e-5, rtol=0)

    # three decode ticks over every slot, each at its own position (the
    # scrap slot included, as the engine feeds it)
    tok = _np(jout["NextTok"][0]).astype(np.int64)
    pos = np.array([16, 5, 11, 1], np.int32)[[1, 2, 0, 3]]  # by slot id
    tok = tok[[1, 2, 0, 3]]
    jck, jcv = jout["CacheK"][0], jout["CacheV"][0]
    tck, tcv = tout["CacheK"][0], tout["CacheV"][0]
    for _ in range(3):
        step = {"Tok": tok, "Pos": pos}
        jstep, tstep = _both(step)
        jstep.update({k: [jnp.asarray(a)] for k, a in weights.items()},
                     CacheK=[jck], CacheV=[jcv])
        tstep.update({k: [torch.from_numpy(np.array(a))]
                      for k, a in weights.items()},
                     CacheK=[tck], CacheV=[tcv])
        jres = jops.transformer_stack_slot_decode(attrs, jstep)
        tres = tops.transformer_stack_slot_decode(attrs, tstep)
        np.testing.assert_array_equal(_np(tres["NextTok"][0]),
                                      _np(jres["NextTok"][0]))
        jck, jcv = jres["CacheK"][0], jres["CacheV"][0]
        tck, tcv = tres["CacheK"][0], tres["CacheV"][0]
        np.testing.assert_allclose(_np(tck), _np(jck), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(tcv), _np(jcv), atol=1e-5, rtol=0)
        tok = _np(jres["NextTok"][0]).astype(np.int64)
        pos = pos + 1


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_one_shot_generate_matches_jax(variant):
    _, attrs, weights = _weights(variant, seed=4)
    attrs = dict(attrs, max_new_tokens=6)
    prompt = np.random.RandomState(6).randint(0, V, (3, 9)).astype(np.int64)
    jins, tins = _both(dict(weights, Prompt=prompt))
    want = _np(jops.transformer_stack_generate(attrs, jins, None)["Out"][0])
    got = tops.transformer_stack_generate(attrs, tins)["Out"][0]
    np.testing.assert_array_equal(got.numpy(), want)
