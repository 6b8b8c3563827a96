"""Control-flow ops, cut to the fused beam-search decoder.

Counterpart of ``paddle_tpu/ops/control_flow_ops.py``'s
``beam_search_decoder`` (``while``, ``static_rnn``, ``cond`` and the
tensor arrays are a later slice). The decode loop, top-k prune and
backtrack of the reference (while_op + beam_search_op +
beam_search_decode_op) are one op: a loop of at most ``max_len`` steps
over the whole [b, beam] lattice, each step one [b*beam, h] x [h, G*h]
product for the cell, one [b*beam, h] x [h, V] product for the logits and
a top-k over beam*V candidates.

The JAX op stops once every beam has emitted EOS (``lax.while_loop``).
The port runs all ``max_len`` steps, with no host synchronisation: a
step after every beam has finished is a no-op on the outputs (each
finished beam's one candidate is EOS at zero cost, every other
candidate lies at ``finfo.min`` below it, and the already sorted beams
keep their order), so Ids, SeqScores and SeqLen equal JAX's.

Ties: ``lax.top_k`` puts the lower flat index first among equal values;
so does the port's stable descending sort, on the CPU and on CUDA.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from . import common
from .common import maybe, out


def _top_k(x, k):
    """``lax.top_k`` over the last axis: the k largest, best first, the
    lower index first among equal values."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _log_softmax(x):
    """``jax.nn.log_softmax``: shifted - log(sum(exp(shifted)))."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


@register_op("beam_search_decoder",
             optional_inputs=("InitCell", "Bias", "OutBias"))
def beam_search_decoder(attrs, ins):
    """Fused beam-search generation with a GRU or LSTM cell.

    Inputs: InitState [b, h]; InitCell [b, h] (LSTM only); Embedding
    [V, e]; WeightX [e, G*h] (G = 3 GRU, 4 LSTM); WeightH [h, G*h]; Bias
    [1, G*h]; WeightOut [h, V], OutBias [V].

    Outputs: Ids [b, beam, max_len] int32 (the tokens after BOS, padded
    with eos_id), SeqScores [b, beam] f32 total log-prob (best first),
    SeqLen [b, beam] int32 (generated lengths without EOS)."""
    init_h = ins["InitState"][0]
    init_c = maybe(ins, "InitCell")
    emb = ins["Embedding"][0]
    wx = ins["WeightX"][0]
    wh = ins["WeightH"][0]
    bias = maybe(ins, "Bias")
    w_out = ins["WeightOut"][0]
    b_out = maybe(ins, "OutBias")

    beam = int(attrs.get("beam_size", 4))
    max_len = int(attrs.get("max_len", 32))
    bos = int(attrs.get("bos_id", 0))
    eos = int(attrs.get("eos_id", 1))
    cell_kind = attrs.get("cell", "gru")
    b, h = init_h.shape
    V = emb.shape[0]
    dev = init_h.device
    neg_inf = torch.finfo(torch.float32).min

    def cell_step(tok, hs, cs):
        """One decoder cell step over the flattened [b*beam] rows."""
        x = emb[tok]  # [N, e]
        gates_x = common.matmul(x, wx)
        if bias is not None:
            gates_x = gates_x + bias
        if cell_kind == "gru":
            gx, cx = gates_x[..., : 2 * h], gates_x[..., 2 * h:]
            g = common.sigmoid(gx + common.matmul(hs, wh[:, : 2 * h]))
            u, r = g[..., :h], g[..., h:]
            cand = torch.tanh(cx + common.matmul(r * hs, wh[:, 2 * h:]))
            new_h = (1.0 - u) * hs + u * cand
            return new_h, cs
        gates = gates_x + common.matmul(hs, wh)
        gc, gi, gf, go = torch.chunk(gates, 4, dim=-1)
        c_new = (common.sigmoid(gf) * cs
                 + common.sigmoid(gi) * torch.tanh(gc))
        return common.sigmoid(go) * torch.tanh(c_new), c_new

    # state over the [b, beam] lattice; only beam 0 is live at t = 0 (all
    # beams start identical)
    hs = init_h[:, None].expand(b, beam, h).reshape(b * beam, h)
    cs = (init_c[:, None].expand(b, beam, h).reshape(b * beam, h)
          if init_c is not None else torch.zeros_like(hs))
    scores = torch.where(torch.arange(beam, device=dev)[None, :] == 0,
                         0.0, neg_inf).to(torch.float32).expand(b, beam)
    finished = torch.zeros((b, beam), dtype=torch.bool, device=dev)
    last = torch.full((b, beam), bos, dtype=torch.int64, device=dev)
    ids = torch.full((b, beam, max_len), eos, dtype=torch.int32, device=dev)
    lens = torch.zeros((b, beam), dtype=torch.int32, device=dev)
    # finished beams may only "emit" EOS at zero cost: one live
    # continuation per finished beam (beam_search_op.cc prune)
    eos_only = torch.full((V,), neg_inf, dtype=torch.float32, device=dev)
    eos_only[eos] = 0.0
    steps = torch.arange(max_len, device=dev)
    for t in range(max_len):
        new_h, new_c = cell_step(last.reshape(-1), hs, cs)
        logits = common.matmul(new_h, w_out)
        if b_out is not None:
            logits = logits + b_out
        logp = _log_softmax(logits.to(torch.float32)).reshape(b, beam, V)
        logp = torch.where(finished[..., None], eos_only, logp)
        cand = scores[..., None] + logp  # [b, beam, V]
        scores, top_idx = _top_k(cand.reshape(b, beam * V), beam)
        src_beam = torch.div(top_idx, V, rounding_mode="floor")  # [b, beam]
        tok = top_idx % V

        take = lambda a: torch.take_along_dim(  # noqa: E731
            a, src_beam.reshape((b, beam) + (1,) * (a.ndim - 2)), dim=1)
        hs = take(new_h.reshape(b, beam, h)).reshape(b * beam, h)
        cs = take(new_c.reshape(b, beam, h)).reshape(b * beam, h)
        ids = take(ids)
        lens = torch.take_along_dim(lens, src_beam, dim=1)
        was_fin = torch.take_along_dim(finished, src_beam, dim=1)
        ids = torch.where((steps == t)[None, None, :] & ~was_fin[..., None],
                          tok[..., None].to(torch.int32), ids)
        finished = was_fin | (tok == eos)
        lens = torch.where(~was_fin & (tok != eos), lens + 1, lens)
        last = tok
    return out(Ids=ids, SeqScores=scores, SeqLen=lens)
