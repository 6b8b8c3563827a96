"""Transformer NMT (encoder-decoder with cross-attention).

Counterpart of ``paddle_tpu/models/seq2seq.py``. The decoder side is the
stacked LM: it reuses ``transformer_lm``'s shared-by-name weight contract
(tok_emb / pos_emb / lm_stack.* / final_ln.* / lm_head.w, here the
target embedding, stack and head) extended with per-layer
cross-attention weights (``xattn.stack_*``); the encoder carries its own
stack (``enc_stack.*`` / src_emb / src_pos_emb / enc_ln.*). One scope
therefore serves training (the teacher-forced
``transformer_encdec_teacher`` op), the admission-time encoder pass and
the paged cross-attention decode of
:class:`~paddle_tpu_torch.decoding.Seq2SeqGenerationEngine`.
"""
from __future__ import annotations

from ..initializer import ConstantInitializer
from ..layers.attention import make_stack_params
from ..layers.layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .transformer import _shared_lm_params


def _cross_params(helper, n_layers, d_model, d_kv):
    """The stacked cross-attention weights (xattn.stack_*): per-layer
    pre-LN + query/out projections for the decoder, plus the K/V
    projection the encode op applies to the encoder memory."""
    one = ConstantInitializer(1.0)

    def mk(suffix, shape, bias=False, init=None):
        return helper.create_parameter(
            ParamAttr(name=f"xattn.stack_{suffix}"), shape=shape,
            dtype="float32", is_bias=bias, default_initializer=init)

    return {
        "XLnS": [mk("ln_s", [n_layers, d_model], bias=True, init=one)],
        "XLnB": [mk("ln_b", [n_layers, d_model], bias=True)],
        "XQW": [mk("q_w", [n_layers, d_model, d_model])],
        "XOutW": [mk("out_w", [n_layers, d_model, d_model])],
        "XKvW": [mk("kv_w", [n_layers, d_model, 2 * d_kv])],
    }


def _encoder_params(helper, src_vocab_size, d_model, d_ff, max_src_len,
                    n_layers, num_heads, num_kv_heads):
    one = ConstantInitializer(1.0)
    ins = {
        "SrcTokEmb": [helper.create_parameter(
            ParamAttr(name="src_emb"), shape=[src_vocab_size, d_model],
            dtype="float32")],
        "SrcPosEmb": [helper.create_parameter(
            ParamAttr(name="src_pos_emb"), shape=[max_src_len, d_model],
            dtype="float32")],
        "EncLnS": [helper.create_parameter(
            ParamAttr(name="enc_ln.scale"), shape=[d_model],
            dtype="float32", default_initializer=one)],
        "EncLnB": [helper.create_parameter(
            ParamAttr(name="enc_ln.bias"), shape=[d_model],
            dtype="float32", is_bias=True)],
    }
    enc = make_stack_params(helper, "enc_stack", n_layers, d_model, d_ff,
                            num_heads=num_heads, num_kv_heads=num_kv_heads)
    ins.update({f"Enc{slot}": v for slot, v in enc.items()})
    return ins


def shared_nmt_params(helper, src_vocab_size, tgt_vocab_size, d_model,
                      d_ff, max_src_len, max_tgt_len, n_layers,
                      num_heads, num_kv_heads=None):
    """Every weight the NMT op family shares, keyed by op slot: build
    (or rejoin by name) in any program that needs the model."""
    d_kv = (d_model if not (num_heads and num_kv_heads)
            else d_model // num_heads * num_kv_heads)
    ins = _shared_lm_params(helper, tgt_vocab_size, d_model, d_ff,
                            max_tgt_len, n_layers, num_heads, num_kv_heads)
    ins.update(_cross_params(helper, n_layers, d_model, d_kv))
    ins.update(_encoder_params(helper, src_vocab_size, d_model, d_ff,
                               max_src_len, n_layers, num_heads,
                               num_kv_heads))
    return ins


def transformer_nmt_teacher(src_ids, src_len, tgt_in, src_vocab_size,
                            tgt_vocab_size, d_model=256, n_layers=4,
                            num_heads=8, d_ff=None, num_kv_heads=None,
                            max_src_len=128, max_tgt_len=128,
                            main_program=None, startup_program=None):
    """Teacher-forced NMT training forward: src_ids [b, Ts] int64 +
    src_len [b] int32 + tgt_in [b, Tt] int64 -> logits [b, Tt, Vt].
    Wrap with softmax_with_cross_entropy against the next target ids for
    the loss; the trained scope serves through
    :class:`paddle_tpu_torch.decoding.Seq2SeqGenerationEngine`."""
    kw = dict(main_program=main_program, startup_program=startup_program)
    d_ff = d_ff or 4 * d_model
    helper = LayerHelper("transformer_nmt", **kw)
    ins = {"SrcIds": [src_ids], "SrcLen": [src_len], "TgtIn": [tgt_in]}
    ins.update(shared_nmt_params(helper, src_vocab_size, tgt_vocab_size,
                                 d_model, d_ff, max_src_len, max_tgt_len,
                                 n_layers, num_heads, num_kv_heads))
    return helper.simple_op(
        "transformer_encdec_teacher", ins,
        {"num_heads": num_heads, "num_kv_heads": num_kv_heads},
        out_slot="Logits")
