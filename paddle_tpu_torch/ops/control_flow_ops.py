"""Control-flow ops: the body runner, ``static_rnn``, ``while``, the
tensor arrays, ``cond`` and the fused beam-search decoder.

Counterpart of ``paddle_tpu/ops/control_flow_ops.py``. A sub-block is
data: the layer builders (``layers/control_flow.py``) serialize the
body's ops (type, inputs, outputs, attrs: plain values) into the parent
op's attrs, and the op runs them with ``run_body`` over a dict of names.
Where the JAX package traces the body once under ``lax.scan`` /
``lax.while_loop`` / ``lax.cond``, the port runs it eagerly, op by op,
once a step: each op's torch function, as the executor calls it. The
backward is torch autograd over those steps
(``core/backward.forward_with_vjp``), so ``static_rnn`` and a ``while``
with ``max_iters`` train through the generic grad op unchanged.

Host cost: a body of k ops run over T steps launches k*T op functions
from the host, a few kernels each; the device work per step is small, so
a long recurrence is bound by the host's launch rate, not by the card.

Body environment (``static_rnn`` and ``while``):
  x_names     -- per-step values (sliced from the time axis / carried)
  mem_names   -- loop-carried state, seeded from MemInit
  param_names -- external reads (weights etc.), constant across steps

The fused beam-search decoder: the decode loop, top-k prune and
backtrack of the reference (while_op + beam_search_op +
beam_search_decode_op) are one op, a loop of at most ``max_len`` steps
over the whole [b, beam] lattice, each step one [b*beam, h] x [h, G*h]
product for the cell, one [b*beam, h] x [h, V] product for the logits
and a top-k over beam*V candidates. The JAX op stops once every beam has
emitted EOS (``lax.while_loop``). The port runs all ``max_len`` steps,
with no host synchronisation: a step after every beam has finished is a
no-op on the outputs (each finished beam's one candidate is EOS at zero
cost, every other candidate lies at ``finfo.min`` below it, and the
already sorted beams keep their order), so Ids, SeqScores and SeqLen
equal JAX's. Ties: ``lax.top_k`` puts the lower flat index first among
equal values; so does the port's stable descending sort, on the CPU and
on CUDA.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.registry import get_op, register_op
from . import common
from .common import maybe, out
from .sequence_ops import time_mask


def _device_of(*groups):
    """The device of the first tensor in ``groups`` (lists of tensors)."""
    for group in groups:
        for t in group:
            if isinstance(t, torch.Tensor):
                return t.device
    return None


def run_body(body_ops: List[dict], env: Dict[str, torch.Tensor],
             device=None) -> Dict:
    """Run serialized body ops over ``env`` (name -> tensor), in order,
    each op's function as the executor calls it; an op without inputs
    makes its outputs on ``device``. Refuses an op that draws random
    numbers or that the executor runs itself, as the JAX package does."""
    for od in body_ops:
        opdef = get_op(od["type"])
        if opdef.needs_rng or opdef.special:
            raise NotImplementedError(
                f"op {od['type']!r} cannot run inside a control-flow body")
        ins = {slot: [env[n] for n in names]
               for slot, names in od["inputs"].items() if names}
        if not ins and device is not None:
            with torch.device(device):
                outs = opdef.fn(od["attrs"], ins)
        else:
            outs = opdef.fn(od["attrs"], ins)
        for slot, names in od["outputs"].items():
            vals = outs.get(slot, [])
            for n, v in zip(names, vals):
                env[n] = v
    return env


def _blend(m, new, old):
    """JAX's ``mm * new + (1 - mm) * old`` with the [b] mask broadcast
    over new's trailing dims: arithmetic, not a select, so finished rows
    round and carry NaN as JAX's do."""
    mm = m.reshape(tuple(m.shape) + (1,) * (new.ndim - 1))
    return mm * new + (1 - mm) * old


@register_op("static_rnn",
             optional_inputs=("X", "MemInit", "Param", "Length"))
def static_rnn(attrs, ins):
    """User-defined recurrence over the time axis (recurrent_op.cc:222).

    Sequence inputs [b, T, ...] are sliced per step; memories carry
    across steps; per-step outputs are restacked to [b, T, ...]. With
    Length, finished rows freeze their memories and zero their outputs
    (the lstm/gru ops' masking). On meta tensors (build-time shape
    inference, where T may be the batch sentinel) one step stands for
    all T."""
    xs = ins.get("X", [])
    mem_init = ins.get("MemInit", [])
    params = ins.get("Param", [])
    lengths = maybe(ins, "Length")
    body_ops = attrs["body_ops"]
    x_names = attrs["x_names"]
    mem_names = attrs["mem_names"]
    mem_out_names = attrs["mem_out_names"]
    out_names = attrs["out_names"]
    param_names = attrs["param_names"]

    T = xs[0].shape[1] if xs else attrs["seq_len_static"]
    device = _device_of(xs, mem_init, params)
    meta = device is not None and device.type == "meta"
    n = min(T, 1) if meta else T
    base_env = dict(zip(param_names, params))
    # time-major views: unbind's backward is one stack, where x[:, t]
    # would give each step a full-size zero gradient
    cols = [x[:, :n].transpose(0, 1).unbind(0) for x in xs]
    masks = None
    if lengths is not None:
        dtype = mem_init[0].dtype if mem_init else torch.float32
        masks = time_mask(lengths, T, dtype)[:, :n].transpose(0, 1).unbind(0)

    carry = list(mem_init)
    ys = []
    for t in range(n):
        env = dict(base_env)
        env.update(zip(x_names, [col[t] for col in cols]))
        env.update(zip(mem_names, carry))
        env = run_body(body_ops, env, device)
        m = masks[t] if masks is not None else None
        carry = [env[name] if m is None else _blend(m, env[name], old)
                 for old, name in zip(carry, mem_out_names)]
        step = []
        for name in out_names:
            y = env[name]
            if m is not None:
                mm = m.reshape(tuple(m.shape) + (1,) * (y.ndim - 1))
                y = y * mm.to(y.dtype)
            step.append(y)
        ys.append(step)
    outputs = [torch.stack(col, 1) for col in zip(*ys)] if ys else []
    if n != T:
        outputs = [o.expand((o.shape[0], T) + tuple(o.shape[2:]))
                   for o in outputs]
    return {"Out": outputs, "LastMem": carry}


@register_op("while", optional_inputs=("Param",))
def while_op(attrs, ins):
    """Functional while (while_op.cc): the body runs until the carried
    cond var is false. Carried vars are the loop state; the body
    reassigns each.

    - ``max_iters`` set: a fixed-trip loop of ``max_iters`` steps; a step
      whose cond has gone false passes the carry through
      (``where(active, new, old)``, on the device). Autograd records it,
      so such a while trains.
    - otherwise: a true early exit. The host reads the carried cond once
      a trip, a device sync each time (``lax.while_loop`` keeps the loop
      on the chip). Not trained through; pass ``max_iters`` for that.

    On meta tensors the carried vars keep their shapes, so the loop is
    not run."""
    carried_in = list(ins["Carried"])
    params = ins.get("Param", [])
    body_ops = attrs["body_ops"]
    carried_names = attrs["carried_names"]
    param_names = attrs["param_names"]
    cond_name = attrs["cond_name"]
    max_iters = attrs.get("max_iters")
    base_env = dict(zip(param_names, params))
    cond_pos = carried_names.index(cond_name)
    device = _device_of(carried_in, params)
    if device is not None and device.type == "meta":
        return {"Out": carried_in}

    def body_fn(carry):
        env = dict(base_env)
        env.update(zip(carried_names, carry))
        env = run_body(body_ops, env, device)
        return [env[n] for n in carried_names]

    carry = carried_in
    if max_iters is not None:
        for _ in range(int(max_iters)):
            active = carry[cond_pos].reshape(()).to(torch.bool)
            new = body_fn(carry)
            carry = [torch.where(active, nv, ov)
                     for nv, ov in zip(new, carry)]
        return {"Out": carry}
    while bool(carry[cond_pos].reshape(())):
        carry = body_fn(carry)
    return {"Out": carry}


def _array_index(i, n):
    """The [1] index of a length-``n`` array at scalar ``i``, as
    ``lax.dynamic_index_in_dim`` takes it: a negative index counts from
    the end, then clamps into [0, n-1]. On the device, no host read."""
    i = i.reshape(()).to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, n - 1).reshape(1)


@register_op("array_write")
def array_write(attrs, ins):
    """Write X into Array (a [max_len, ...] buffer) at scalar I: the
    functional LoDTensorArray write (tensor_array_read_write ops)."""
    x = ins["X"][0]
    arr = ins["Array"][0]
    idx = _array_index(ins["I"][0], arr.shape[0])
    return out(Out=arr.index_put((idx,), x.unsqueeze(0)))


@register_op("array_read")
def array_read(attrs, ins):
    arr = ins["Array"][0]
    idx = _array_index(ins["I"][0], arr.shape[0])
    return out(Out=arr.index_select(0, idx).squeeze(0))


@register_op("cond", optional_inputs=("Param",))
def cond_op(attrs, ins):
    """Functional two-branch conditional (cond_op.cc): scalar Cond picks
    which serialized branch runs. Both branches write ``out_names``;
    their reads come in the Param slot. The host reads Cond (one device
    sync) and runs the taken branch alone, as ``lax.cond`` does; on meta
    tensors the true branch gives the shapes."""
    params = ins.get("Param", [])
    base_env = dict(zip(attrs["param_names"], params))
    pred = ins["Cond"][0]
    device = _device_of(params, [pred])
    taken = True if pred.is_meta else bool(pred.reshape(()))
    env = run_body(attrs["true_ops"] if taken else attrs["false_ops"],
                   dict(base_env), device)
    return {"Out": [env[n] for n in attrs["out_names"]]}


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
