"""v2 network composites. Counterpart of ``paddle_tpu/v2/networks.py``
(reference trainer_config_helpers/networks.py via v2): the recipes built
from the layer namespace. The attention composites mask padding with the
``sequence_mask`` op, which the port lacks (ROADMAP item 3): with a
sequence-length input they raise naming it."""
from __future__ import annotations

from .. import layers as L
from . import activation as _act
from . import layer as l2


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride=1, act=None, pool_type=None,
                         groups=1, conv_stride=1, conv_padding=0,
                         bias_attr=None, param_attr=None, pool_padding=0,
                         data_format="NHWC", **kw):
    """conv -> pool with the REFERENCE defaults (reference networks.py:144:
    conv_padding=0, conv_stride=1, pool_stride=1, pool_padding=0) so
    unmodified configs reproduce the reference's output geometry."""
    conv = l2.img_conv(input, filter_size=filter_size,
                       num_filters=num_filters, act=act,
                       stride=conv_stride, padding=conv_padding,
                       groups=groups, param_attr=param_attr,
                       bias_attr=bias_attr, data_format=data_format)
    return l2.img_pool(conv, pool_size=pool_size, stride=pool_stride,
                       padding=pool_padding, pool_type=pool_type,
                       data_format=data_format)


def simple_lstm(input, size, reverse=False, **kw):
    """fc(4*size) + lstmemory — the v1 simple_lstm recipe."""
    proj = L.fc(input, size=4 * size, num_flatten_dims=2, bias_attr=False)
    return l2.lstmemory(proj, size=size, reverse=reverse)


def bidirectional_lstm(input, size, return_concat=True, **kw):
    fwd = simple_lstm(input, size)
    bwd = simple_lstm(input, size, reverse=True)
    if return_concat:
        out = L.concat([fwd, bwd], axis=-1)
        sl = getattr(input, "seq_len", None)
        if sl is not None:
            out.seq_len = sl  # concat keeps [b, T, .] — the mask survives
        return out
    return fwd, bwd


def simple_gru(input, size, reverse=False, **kw):
    proj = L.fc(input, size=3 * size, num_flatten_dims=2, bias_attr=False)
    return l2.grumemory(proj, size=size, reverse=reverse)


def sequence_conv_pool(input, context_len, hidden_size, pool_type=None,
                       **kw):
    conv = L.sequence_conv(input, num_filters=hidden_size,
                           filter_size=context_len, act="relu")
    return l2.pooling(conv, pooling_type=pool_type or "max")


def img_conv_bn_pool(input, filter_size, num_filters, pool_size,
                     pool_stride=None, act=None, conv_padding=None,
                     drop_rate=0.0, data_format="NHWC", pool_type=None,
                     **kw):
    """conv -> batch_norm(+act) -> [dropout] -> pool (reference
    trainer_config_helpers/networks.py:231 img_conv_bn_pool)."""
    tmp = l2.img_conv(input, filter_size=filter_size,
                      num_filters=num_filters, act=None,
                      padding=(filter_size - 1) // 2
                      if conv_padding is None else conv_padding,
                      data_format=data_format)
    tmp = l2.batch_norm(tmp, act=act, data_format=data_format)
    if drop_rate:
        tmp = l2.dropout(tmp, drop_rate)
    return l2.img_pool(tmp, pool_size=pool_size,
                       stride=pool_stride or pool_size,
                       pool_type=pool_type, data_format=data_format)


def img_conv_group(input, conv_num_filter, num_channels=None, pool_size=2,
                   pool_stride=2, conv_padding=1, conv_filter_size=3,
                   conv_act=None, conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=0.0, pool_type=None,
                   data_format="NHWC", **kw):
    """VGG-style group: N convs (+BN (+dropout)) then one pool (reference
    trainer_config_helpers/networks.py img_conv_group). Honors the v1
    conv_padding contract."""
    n = len(conv_num_filter)

    def per(x):
        return list(x) if isinstance(x, (list, tuple)) else [x] * n

    pads, sizes = per(conv_padding), per(conv_filter_size)
    with_bn, drops = per(conv_with_batchnorm), per(conv_batchnorm_drop_rate)
    tmp = input
    for i in range(n):
        tmp = l2.img_conv(tmp, sizes[i], conv_num_filter[i], stride=1,
                          padding=pads[i],
                          act=None if with_bn[i] else conv_act,
                          data_format=data_format)
        if with_bn[i]:
            tmp = l2.batch_norm(tmp, act=conv_act, data_format=data_format)
            if drops[i] > 0:
                tmp = l2.dropout(tmp, drops[i])
    return l2.img_pool(tmp, pool_size, stride=pool_stride,
                       pool_type=pool_type, data_format=data_format)


def small_vgg(input_image, num_channels=None, num_classes=10, **kw):
    """The 2-2-3-3 batchnormed VGG (reference networks.py:517)."""
    tmp = input_image
    for filt, times, drops in ((64, 2, [0.3, 0]), (128, 2, [0.4, 0]),
                               (256, 3, [0.4, 0.4, 0]),
                               (512, 3, [0.4, 0.4, 0])):
        tmp = img_conv_group(tmp, [filt] * times, pool_size=2,
                             pool_stride=2, conv_padding=1,
                             conv_filter_size=3, conv_act="relu",
                             conv_with_batchnorm=True,
                             conv_batchnorm_drop_rate=drops)
    tmp = l2.img_pool(tmp, 2, stride=2)
    tmp = l2.dropout(tmp, 0.5)
    tmp = L.fc(tmp, size=512)
    tmp = l2.dropout(tmp, 0.5)
    tmp = l2.batch_norm(tmp, act="relu")
    return L.fc(tmp, size=num_classes, act="softmax")


def vgg_16_network(input_image, num_channels=None, num_classes=1000, **kw):
    """VGG-16 (reference networks.py:547)."""
    tmp = input_image
    for filters in ([64, 64], [128, 128], [256, 256, 256],
                    [512, 512, 512], [512, 512, 512]):
        tmp = img_conv_group(tmp, filters, pool_size=2, pool_stride=2,
                             conv_padding=1, conv_filter_size=3,
                             conv_act="relu")
    tmp = L.fc(tmp, size=4096, act="relu")
    tmp = l2.dropout(tmp, 0.5)
    tmp = L.fc(tmp, size=4096, act="relu")
    tmp = l2.dropout(tmp, 0.5)
    return L.fc(tmp, size=num_classes, act="softmax")


def text_conv_pool(input, context_len=5, hidden_size=128, **kw):
    """Context conv + max pool over time (reference networks.py
    text_conv_pool)."""
    return sequence_conv_pool(input, context_len, hidden_size,
                              pool_type="max")


def bidirectional_gru(input, size, return_concat=True, **kw):
    """Forward + backward simple_gru (reference networks.py:1226)."""
    fwd = simple_gru(input, size)
    bwd = simple_gru(input, size, reverse=True)
    if return_concat:
        out = L.concat([fwd, bwd], axis=-1)
        sl = getattr(input, "seq_len", None)
        if sl is not None:
            out.seq_len = sl
        return out
    return fwd, bwd


def simple_gru2(input, size, reverse=False, **kw):
    """simple_gru with the alternative parameter grouping (reference
    networks.py:1163) — numerically the same recurrence here."""
    return simple_gru(input, size, reverse=reverse)


def _masked_softmax_over_time(scores, seq_len):
    """softmax over the last (source-time) axis, padding masked out.
    scores [b, Td, Te]; seq_len int32 [b] or None."""
    if seq_len is None:
        return L.softmax(scores)
    from ..layers.layer_helper import LayerHelper

    l2._need_op("sequence_mask")
    helper = LayerHelper("attn_mask")
    Te = int(scores.shape[-1])
    if Te > 0:
        mask = helper.simple_op(  # [b, Te] 1/0
            "sequence_mask", {"X": [seq_len]},
            {"maxlen": Te, "out_dtype": "float32"}, out_slot="Y")
    else:
        # Dynamic source-time dim: resolve maxlen from the scores' own
        # runtime shape at executor compile time.
        mask = helper.simple_op(
            "sequence_mask", {"X": [seq_len], "MaxLenRef": [scores]},
            {"maxlen": -1, "out_dtype": "float32"}, out_slot="Y")
    penalty = L.scale(mask, 1e9, bias=-1e9)  # 0 where valid, -1e9 at pads
    penalty = L.reshape(penalty, shape=[0, 1, Te if Te > 0 else -1])
    return L.softmax(L.elementwise_add(scores, penalty))


def dot_product_attention(encoded_sequence, attending_sequence=None,
                          attended_sequence=None, softmax_param_attr=None,
                          **kw):
    """Luong dot-product attention (reference networks.py:1498), batched
    over every decoder step at once in place of the per-step
    recurrent_group form: context[i] = sum_j softmax(s_i.h_j) h_j.

    ``encoded_sequence`` [b, Te, H] attends; the query states are
    ``attending_sequence`` [b, Td, H] (teacher-forced decoder states)."""
    q = attending_sequence
    v = attended_sequence if attended_sequence is not None \
        else encoded_sequence
    scores = L.matmul(q, encoded_sequence, transpose_y=True)
    attn = _masked_softmax_over_time(
        scores, getattr(encoded_sequence, "seq_len", None))
    ctx = L.matmul(attn, v)
    sl = getattr(q, "seq_len", None)
    if sl is not None:
        ctx.seq_len = sl
    return ctx


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     weight_act=None, **kw):
    """Bahdanau additive attention (reference networks.py:1400), batched:
    e_ij = v . f(W s_i + U h_j) with f=tanh; U h_j is the pre-computed
    ``encoded_proj`` [b, Te, A]. ``decoder_state`` may be [b, D] (one
    step) or [b, Td, D] (all steps, teacher-forced)."""
    from ..layers.layer_helper import LayerHelper

    A = int(encoded_proj.shape[-1])
    single_step = len(decoder_state.shape) == 2
    dec = decoder_state
    if single_step:
        dec = L.reshape(dec, shape=[0, 1, int(dec.shape[-1])])
    dec_proj = L.fc(dec, size=A, num_flatten_dims=2, bias_attr=False,
                    param_attr=transform_param_attr)  # [b, Td, A]
    Te = int(encoded_proj.shape[1])
    Td = int(dec_proj.shape[1])
    dp = L.reshape(dec_proj, shape=[0, Td, 1, A])
    ep = L.reshape(encoded_proj, shape=[0, 1, Te, A])
    act = _act.resolve(weight_act) or "tanh"
    helper = LayerHelper("simple_attention")
    pre = helper.append_activation(L.elementwise_add(dp, ep), act)
    vvec = helper.create_parameter(softmax_param_attr, shape=[A],
                                   dtype="float32")
    scores = L.reduce_sum(L.elementwise_mul(pre, vvec), dim=-1)  # [b,Td,Te]
    attn = _masked_softmax_over_time(
        scores, getattr(encoded_sequence, "seq_len", None))
    ctx = L.matmul(attn, encoded_sequence)
    if single_step:
        ctx = L.reshape(ctx, shape=[0, int(encoded_sequence.shape[-1])])
    else:
        sl = getattr(decoder_state, "seq_len", None)
        if sl is not None:
            ctx.seq_len = sl
    return ctx


def gru_encoder_decoder(src, trg_in, src_dict_dim, trg_dict_dim,
                        word_vector_dim=512, encoder_size=512,
                        decoder_size=512, with_attention=True,
                        bidirectional=False, **kw):
    """Teacher-forced GRU encoder-decoder (the seqToseq recipe the
    reference builds from recurrent_group in demo configs; here batched:
    encoder GRU -> decoder GRU seeded with the final encoder state ->
    [dot attention ->] per-step vocabulary logits [b, Td, trg_dict_dim].

    ``src``/``trg_in`` are integer id sequences (data vars, lod_level=1).
    Pair the result with softmax_with_cross_entropy over trg_next for the
    training cost (demos/nmt_seq2seq.py shows the full loop)."""
    s_emb = l2.embedding(src, word_vector_dim, vocab_size=src_dict_dim)
    s_emb.seq_len = src.seq_len
    if bidirectional:
        enc = bidirectional_gru(s_emb, encoder_size)
        enc_dim = 2 * encoder_size
    else:
        enc = simple_gru(s_emb, encoder_size)
        enc_dim = encoder_size
    # simple_gru's fc projection drops seq_len; without it
    # sequence_last_step would read the last PADDED timestep and the
    # attention softmax would attend to padding.
    enc.seq_len = src.seq_len
    enc_last = L.sequence_last_step(enc)
    t_emb = l2.embedding(trg_in, word_vector_dim, vocab_size=trg_dict_dim)
    t_emb.seq_len = trg_in.seq_len
    t_proj = L.fc(t_emb, size=3 * decoder_size, num_flatten_dims=2,
                  bias_attr=False)
    h0 = enc_last if enc_dim == decoder_size \
        else L.fc(enc_last, size=decoder_size, act="tanh")
    dec = L.dynamic_gru(t_proj, size=decoder_size, h0=h0)
    dec.seq_len = trg_in.seq_len
    if with_attention:
        if enc_dim == decoder_size:
            ctx = dot_product_attention(enc, attending_sequence=dec)
        else:
            keys = L.fc(enc, size=decoder_size, num_flatten_dims=2,
                        bias_attr=False)
            keys.seq_len = src.seq_len  # mask must survive the projection
            ctx = dot_product_attention(keys, attending_sequence=dec,
                                        attended_sequence=enc)
        both = L.concat([dec, ctx], axis=2)
    else:
        both = dec
    both.seq_len = trg_in.seq_len
    logits = L.fc(both, size=trg_dict_dim, num_flatten_dims=2)
    logits.seq_len = trg_in.seq_len
    return logits
