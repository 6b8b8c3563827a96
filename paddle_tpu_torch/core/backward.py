"""Symbolic backward-pass construction over the Program IR.

Counterpart of ``paddle_tpu/core/backward.py``: walks the block in
reverse from the loss, emits one gradient op per forward op, and
sum-accumulates fan-out gradients, naming grad variables ``<var>@GRAD``.
The generic ``grad`` op's kernel is the vjp of the registered forward;
ops with a registered ``grad_fn`` get a ``grad_custom`` op instead.

Where the JAX package recomputes the forward inside ``jax.vjp`` and
relies on XLA to merge it with the real forward, an eager executor gets
no such merge. So each forward op that has a generic ``grad`` op carries
a ``_vjp_key`` attr naming it, and the executor runs that forward once
under autograd (``forward_with_vjp``), keeps the closure, and hands it to
the grad op (``apply_vjp``): no forward runs twice in a step. The
``grad`` op run on its own (``generic_grad``) recomputes the forward, as
the JAX kernel does.

Recompute segments (``recompute_guard``): a run of ops tagged with one
segment id is differentiated as one ``seg_fwd`` op, which takes the
ops' place in the forward, and one ``grad_seg`` op in the backward, the
torch counterpart of the JAX package's ``jax.checkpoint`` with a
save-only-these-names policy. ``seg_fwd`` runs the ops once and keeps in
its ``SegmentStash`` only the external inputs, the outputs of
``SEGMENT_SAVE_OPS`` ops and tensors of at most one dim; a saved op's
vjp is recorded with the segment's other intermediates packed as
placeholders (``torch.autograd.graph.saved_tensors_hooks``).
``grad_seg`` reruns the other ops under autograd, with each saved op
standing in as its stashed outputs and its recorded vjp, and returns
``torch.autograd.grad`` for the differentiable external inputs. The
executor keeps the stash for one run, and ``grad_seg`` frees it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from .program import Block, Operator, Variable, grad_var_name
from .registry import get_op, op_uses_rng, register_op
from .types import dtype_name, is_floating

# Ops after which there is nothing to differentiate.
NON_DIFFERENTIABLE = {
    "fill_constant", "gaussian_random", "uniform_random", "feed", "fetch",
    "accuracy", "top_k", "assign_value", "fill_constant_batch_size_like",
    "sgd", "momentum", "adam", "adamax", "adagrad", "decayed_adagrad",
    "adadelta", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "argmax", "one_hot", "truncated_gaussian_random",
    "gaussian_random_batch_size_like",
    "beam_search_decoder",
}

VJP_KEY = "_vjp_key"


# --------------------------------------------------------------------------
# Generic grad kernels
# --------------------------------------------------------------------------
def _rebuild_ins(attrs, ins):
    """Reconstruct the forward op's input dict from the grad op's I: slots."""
    return {slot: ins["I:" + slot] for slot in attrs["in_slots"]
            if "I:" + slot in ins}


def forward_with_vjp(opdef, fwd_attrs, primal, diff_mask):
    """Run a forward op once with autograd recording from the inputs that
    ``diff_mask`` ({slot: [bool per input]}) marks. Returns (outputs,
    closure): the outputs detached, for the rest of the program, and the
    closure that ``apply_vjp`` turns into input gradients."""
    ins = {}
    for slot, arrs in primal.items():
        mask = diff_mask.get(slot) or [False] * len(arrs)
        ins[slot] = [a.detach().requires_grad_(True) if d else a
                     for a, d in zip(arrs, mask)]
    with torch.enable_grad():
        outs = opdef.fn(fwd_attrs, ins)
    detached = {slot: [None if o is None else o.detach() for o in vals]
                for slot, vals in outs.items()}
    return detached, (ins, diff_mask, outs)


def apply_vjp(closure, attrs, ins):
    """Input gradients of a forward recorded by ``forward_with_vjp``,
    given the grad op's output-gradient slots (OG:<slot>, masked by
    attrs["og"]). Outputs without an incoming gradient contribute zero;
    inputs the forward does not reach get zeros."""
    fwd_ins, diff_mask, outs = closure
    ys, cts = [], []
    for slot, mask in attrs["og"].items():
        grads = iter(ins.get("OG:" + slot, []))
        for i, m in enumerate(mask):
            if not m:
                continue
            g = next(grads)
            y = outs[slot][i]
            if y is not None and y.requires_grad:
                ys.append(y)
                cts.append(g.to(y.dtype))
    leaves = [a for slot, mask in diff_mask.items()
              for a, d in zip(fwd_ins.get(slot, []), mask) if d]
    if ys:
        grads = torch.autograd.grad(ys, leaves, cts, allow_unused=True)
    else:
        grads = [None] * len(leaves)
    it = iter(zip(leaves, grads))
    result = {}
    for slot, mask in diff_mask.items():
        if not any(mask):
            continue
        picked = []
        for _ in range(sum(1 for d in mask if d)):
            leaf, g = next(it)
            picked.append(torch.zeros_like(leaf) if g is None else g)
        result["IG:" + slot] = picked
    return result


@register_op("grad")
def generic_grad(attrs, ins):
    """vjp-of-forward gradient kernel, recomputing the forward.

    attrs:
      fwd_type, fwd_attrs — the forward op
      in_slots  — {slot: n_inputs} of the forward op
      out_slots — [slot, ...] deterministic output slot order
      og        — {slot: [bool per output]} which outputs have incoming grads
      diff      — {slot: [bool per input]} which inputs need gradients
    """
    opdef = get_op(attrs["fwd_type"])
    primal = _rebuild_ins(attrs, ins)
    _, closure = forward_with_vjp(opdef, attrs["fwd_attrs"], primal,
                                  attrs["diff"])
    return apply_vjp(closure, attrs, ins)


# --------------------------------------------------------------------------
# Recompute segments
# --------------------------------------------------------------------------
# Outputs of these op types survive a segment's forward; every other
# intermediate is recomputed in its backward. Products and convolutions
# are saved because recomputing them costs real work; tensors of at most
# one dim because storing them costs nothing.
SEGMENT_SAVE_OPS = {
    "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "depthwise_conv2d", "mul", "matmul", "pool2d", "pool3d",
    "max_pool2d_with_index", "max_pool3d_with_index", "sequence_conv",
    "lstm", "gru",
}


class SegmentStash:
    """What a ``seg_fwd`` op keeps for its ``grad_seg`` within one run:
    ``seg_ops`` the segment's op descriptions, ``ext`` the external
    inputs, ``saved`` the surviving tensors by
    name (a saved op's outputs, tensors of at most one dim),
    ``closures`` each saved op's recorded vjp by its index in the
    segment, and during ``grad_seg`` ``recomputed`` the rerun values by
    (name, writing op's index), which the closures' placeholders
    resolve to."""

    __slots__ = ("seg_ops", "ext", "saved", "closures", "recomputed")

    def __init__(self):
        self.seg_ops: List[dict] = []
        self.ext: Dict[str, torch.Tensor] = {}
        self.saved: Dict[str, torch.Tensor] = {}
        self.closures: Dict[int, tuple] = {}
        self.recomputed: Dict[tuple, torch.Tensor] = {}

    def release(self):
        self.seg_ops = []
        self.ext, self.saved, self.closures, self.recomputed = {}, {}, {}, {}


def _seg_op_ins(sop, env):
    return {slot: [env[n] for n in names]
            for slot, names in sop["ins"].items() if names}


def _seg_diff_mask(sop, env, fixed):
    """Which inputs of a saved op its vjp is recorded from: floating
    tensors, except external inputs that take no gradient."""
    return {slot: [env[n].is_floating_point() and n not in fixed
                   for n in names]
            for slot, names in sop["ins"].items() if names}


def _storage_key(t):
    return t.untyped_storage().data_ptr()


def _record_saved_op(opdef, sop, op_ins, mask, internal, stash):
    """Run a saved op under autograd with the tensors its vjp saves that
    share storage with a recomputed intermediate (``internal``: storage
    -> (name, writer)) packed as placeholders, so that only the rerun
    keeps them."""
    def pack(t):
        ref = internal.get(_storage_key(t)) if t.numel() else None
        if ref is None:
            return t
        return (ref, t.size(), t.stride(), t.storage_offset(),
                t.untyped_storage().nbytes())

    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        ref, size, stride, offset, nbytes = packed
        rec = stash.recomputed[ref]
        if rec.untyped_storage().nbytes() != nbytes:
            raise RuntimeError(
                f"recompute segment: the rerun of {ref[0]!r} has another "
                "layout than its forward")
        return rec.detach().as_strided(size, stride, offset)

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        outs, closure = forward_with_vjp(opdef, sop["attrs"], op_ins, mask)
    # a recorded input the rerun supplies keeps only its place in the
    # graph: its leaf would otherwise hold the intermediate's storage
    for leaves in closure[0].values():
        for leaf in leaves:
            if leaf.requires_grad and leaf.numel() \
                    and _storage_key(leaf) in internal:
                leaf.data = leaf.new_empty(()).expand(leaf.shape)
    return outs, closure


def segment_forward(attrs, ins, stash: Optional[SegmentStash] = None):
    """The forward of a recompute segment: runs ``attrs["seg_ops"]`` in
    order without recording autograd and returns ``{"O": [...]}`` in
    ``attrs["all_outs"]``'s order. With a ``stash`` it keeps there what
    the paired ``grad_seg`` needs: the external inputs, the outputs of
    the ``SEGMENT_SAVE_OPS`` ops, each with its vjp recorded, and every
    output of at most one dim."""
    ext = attrs["ext_in"]
    env = dict(zip(ext, ins["I"]))
    fixed = {n for n, d in zip(ext, attrs["diff"]) if not d}
    internal: Dict[int, tuple] = {}  # storage -> (name, writer)
    if stash is not None:
        stash.seg_ops, stash.ext = attrs["seg_ops"], dict(env)
    for i, sop in enumerate(attrs["seg_ops"]):
        opdef = get_op(sop["type"])
        op_ins = _seg_op_ins(sop, env)
        saved_op = sop["type"] in SEGMENT_SAVE_OPS
        if stash is not None and saved_op:
            outs, stash.closures[i] = _record_saved_op(
                opdef, sop, op_ins, _seg_diff_mask(sop, env, fixed),
                internal, stash)
        else:
            outs = opdef.fn(sop["attrs"], op_ins)
        for slot, names in sop["outs"].items():
            for name, val in zip(names, outs.get(slot, [])):
                env[name] = val
                if stash is None or not isinstance(val, torch.Tensor):
                    continue
                if saved_op or val.ndim <= 1:
                    stash.saved[name] = val
                elif val.numel():
                    internal[_storage_key(val)] = (name, i)
    return {"O": [env[n] for n in attrs["all_outs"]]}


class _SavedOp(torch.autograd.Function):
    """A saved op inside a segment's rerun: its stashed outputs, with the
    vjp its forward recorded as the backward. ``inputs`` are the rerun's
    tensors for the closure's differentiated inputs, in slot order."""

    @staticmethod
    def forward(ctx, closure, recorded, *inputs):
        ctx.closure, ctx.recorded = closure, recorded
        return tuple(v.detach() for v in recorded)

    @staticmethod
    def backward(ctx, *grads):
        fwd_ins, diff_mask, _ = ctx.closure
        ys, cts = [], []
        for y, g in zip(ctx.recorded, grads):
            if g is not None and y.requires_grad:
                ys.append(y)
                cts.append(g.to(y.dtype))
        leaves = [a for slot in sorted(diff_mask)
                  for a, d in zip(fwd_ins[slot], diff_mask[slot]) if d]
        if not ys:
            return (None, None) + tuple(None for _ in leaves)
        got = torch.autograd.grad(ys, leaves, cts, allow_unused=True)
        return (None, None) + tuple(got)


def segment_grad(stash: SegmentStash, attrs, ins):
    """The backward of a recompute segment: reruns the segment's ops
    that ``seg_fwd`` did not save, under autograd, from its stashed
    inputs, each saved op entering through ``_SavedOp``, and returns
    ``{"IG": [...]}`` for the differentiable external inputs. Frees the
    stash."""
    ext, diff = attrs["ext_in"], attrs["diff"]
    env, leaves = {}, []
    for name, d in zip(ext, diff):
        val = stash.ext[name]
        if d:
            val = val.detach().requires_grad_(True)
            leaves.append(val)
        env[name] = val
    with torch.enable_grad():
        for i, sop in enumerate(stash.seg_ops):
            closure = stash.closures.get(i)
            if closure is None:
                outs = get_op(sop["type"]).fn(sop["attrs"],
                                              _seg_op_ins(sop, env))
            else:
                _, diff_mask, recorded = closure
                inputs = [env[n] for slot in sorted(diff_mask)
                          for n, d in zip(sop["ins"][slot], diff_mask[slot])
                          if d]
                flat = [(slot, k) for slot in sorted(recorded)
                        for k, v in enumerate(recorded[slot])
                        if v is not None]
                values = _SavedOp.apply(
                    closure, [recorded[s][k] for s, k in flat], *inputs)
                outs = {slot: list(vals) for slot, vals in recorded.items()}
                for (slot, k), v in zip(flat, values):
                    outs[slot][k] = v
            for slot, names in sop["outs"].items():
                for name, val in zip(names, outs.get(slot, [])):
                    env[name] = val
                    stash.recomputed[(name, i)] = val
        og = dict(zip(attrs["og_outs"], ins["OG"]))
        ys, cts = [], []
        for name in attrs["all_outs"]:
            g, y = og.get(name), env[name]
            if g is not None and isinstance(y, torch.Tensor) \
                    and y.requires_grad:
                ys.append(y)
                cts.append(g.to(y.dtype))
    grads = (torch.autograd.grad(ys, leaves, cts, allow_unused=True)
             if ys else [None] * len(leaves))
    stash.release()
    return {"IG": [torch.zeros_like(a) if g is None else g
                   for a, g in zip(leaves, grads)]}


@register_op("seg_fwd", special=True)
def seg_fwd(attrs, ins):
    """A recompute segment's forward run on its own: the ops once,
    nothing kept (the executor runs it with a stash when its
    ``grad_seg`` follows)."""
    return segment_forward(attrs, ins)


@register_op("grad_seg", special=True)
def grad_seg(attrs, ins):
    raise RuntimeError(
        "grad_seg consumes the stash of its seg_fwd in the same executor "
        "run and cannot run on its own")


@register_op("grad_custom")
def custom_grad(attrs, ins):
    """Dispatch to an op's registered grad_fn."""
    opdef = get_op(attrs["fwd_type"])
    fwd_attrs = attrs["fwd_attrs"]
    primal = _rebuild_ins(attrs, ins)
    outs = {slot: ins["O:" + slot] for slot in attrs["out_slots"]
            if "O:" + slot in ins}
    ogs = {}
    for slot, mask in attrs["og"].items():
        arrs = iter(ins.get("OG:" + slot, []))
        vals = [next(arrs) if m else None for m in mask]
        if any(mask):
            ogs[slot] = vals
    grads = opdef.grad_fn(fwd_attrs, primal, outs, ogs)
    result = {}
    for slot, mask in attrs["diff"].items():
        if not any(mask):
            continue
        vals = grads.get(slot, [None] * len(mask))
        picked = []
        for idx, (v, d) in enumerate(zip(vals, mask)):
            if not d:
                continue
            if v is None:  # grad_fn declined: zero gradient
                v = torch.zeros_like(primal[slot][idx])
            picked.append(v)
        result["IG:" + slot] = picked
    return result


# --------------------------------------------------------------------------
# append_backward
# --------------------------------------------------------------------------
def _is_float_var(block: Block, name: str) -> bool:
    if not block.has_var(name):
        return True  # unknown vars: assume float tensors
    return is_floating(block.var(name).dtype)


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[str]] = None,
    no_grad_set: Optional[Set[str]] = None,
) -> List[Tuple[Variable, Variable]]:
    """Append gradient ops for ``loss`` to its program's global block.

    Returns [(param, grad_var)] pairs, the contract of
    ``Optimizer.minimize``.
    """
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    # 1. Find ops on the path to the loss.
    n_fwd = len(block.ops)
    relevant: Set[str] = {loss.name}
    op_needed = [False] * n_fwd
    for i in range(n_fwd - 1, -1, -1):
        op = block.ops[i]
        if any(n in relevant for n in op.output_names()):
            if op.type in NON_DIFFERENTIABLE:
                continue
            op_needed[i] = True
            for name in op.input_names():
                if _is_float_var(block, name) and name not in no_grad:
                    var = block.var(name) if block.has_var(name) else None
                    if (var is not None and var.stop_gradient
                            and not var.is_parameter):
                        continue
                    relevant.add(name)

    contributions: Dict[str, List[str]] = {}

    # 2. Seed: d loss / d loss = 1.
    loss_grad_name = grad_var_name(loss.name)
    block.create_var(name=loss_grad_name,
                     shape=loss.shape if loss.shape is not None else (),
                     dtype=loss.dtype, stop_gradient=True)
    block.append_op(
        "fill_constant",
        outputs={"Out": [loss_grad_name]},
        attrs={"shape": list(loss.shape or ()), "value": 1.0,
               "dtype": dtype_name(loss.dtype)},
    )
    contributions[loss.name] = [loss_grad_name]
    finalized: Dict[str, Optional[str]] = {}

    def finalize_grad(name: str) -> Optional[str]:
        """Emit accumulation op if needed; returns grad var name or None."""
        if name in finalized:
            return finalized[name]
        contribs = contributions.get(name, [])
        gname = grad_var_name(name)
        if not contribs:
            result = None
        elif len(contribs) == 1:
            result = contribs[0]
        else:
            block.create_var(name=gname, stop_gradient=True)
            block.append_op("sum", inputs={"X": contribs},
                            outputs={"Out": [gname]})
            result = gname
        finalized[name] = result
        return result

    def add_contribution(name: str, gname: str):
        contributions.setdefault(name, []).append(gname)

    # The program is not SSA: gradient accounting is per version of a
    # name, and a primal value a grad op reads is snapshotted (@PRE/@POST
    # assigns) when some op at or after its forward re-writes that name.
    last_write: Dict[str, int] = {}
    for pos in range(n_fwd):
        for names in block.ops[pos].outputs.values():
            for name in names:
                last_write[name] = pos

    canonical_first: Dict[str, str] = {}

    def kill_versions(op):
        for names in op.outputs.values():
            for name in names:
                g = finalized.get(name)
                if g is not None and name not in canonical_first:
                    canonical_first[name] = g
                contributions.pop(name, None)
                finalized.pop(name, None)

    def _seg_eligible(op) -> bool:
        """May this op be folded into a recompute segment's grad?"""
        if op.type in NON_DIFFERENTIABLE:
            return False
        opdef = get_op(op.type)
        return not (opdef.special or opdef.needs_rng
                    or (opdef.grad_fn is not None
                        and not opdef.grad_fn_is_optimization))

    def _diffable_input(name: str) -> bool:
        ok = (name in relevant and _is_float_var(block, name)
              and name not in no_grad)
        if ok and block.has_var(name):
            v = block.var(name)
            if v.stop_gradient and not v.is_parameter:
                ok = False
        return ok

    def _emit_segment_grad(j: int, i: int) -> None:
        """Differentiate block.ops[j..i], one recompute segment: one
        ``seg_fwd`` op takes the run's place and a ``grad_seg`` op is
        appended. No primal snapshots are needed: the stash holds the
        segment's inputs as the forward read them."""
        run = block.ops[j:i + 1]
        seg_ops_desc = []
        written: Set[str] = set()
        ext_in: List[str] = []
        all_outs: List[str] = []
        for op2 in run:
            for name in op2.input_names():
                if name not in written and name not in ext_in:
                    ext_in.append(name)
            for name in op2.output_names():
                written.add(name)
                all_outs.append(name)
            seg_ops_desc.append({
                "type": op2.type,
                "attrs": dict(op2.attrs),
                "ins": {s: list(v) for s, v in op2.inputs.items()},
                "outs": {s: list(v) for s, v in op2.outputs.items()},
            })
        # a name written more than once is seen outside in its last
        # version only
        all_outs = list(reversed(list(dict.fromkeys(reversed(all_outs)))))
        og_outs, og_vars = [], []
        for name in all_outs:
            g = finalize_grad(name)
            if g is not None:
                og_outs.append(name)
                og_vars.append(g)
        for op2 in reversed(run):
            kill_versions(op2)
        diff = [_diffable_input(n) for n in ext_in]
        vjp_key = program.unique_name("seg")
        fwd_op = Operator(block, "seg_fwd", inputs={"I": list(ext_in)},
                          outputs={"O": list(all_outs)},
                          attrs={"seg_ops": seg_ops_desc,
                                 "ext_in": list(ext_in), "diff": list(diff),
                                 "all_outs": all_outs, "vjp_key": vjp_key})
        block.ops[j:i + 1] = [fwd_op]
        program._bump()
        if not og_outs or not any(diff):
            return
        ig_vars = []
        for name, d in zip(ext_in, diff):
            if not d:
                continue
            gvar = program.unique_name(grad_var_name(name) + "@R")
            block.create_var(name=gvar, stop_gradient=True)
            add_contribution(name, gvar)
            ig_vars.append(gvar)
        block.append_op(
            "grad_seg", inputs={"OG": og_vars}, outputs={"IG": ig_vars},
            attrs={"vjp_key": vjp_key, "ext_in": list(ext_in),
                   "diff": list(diff), "og_outs": og_outs,
                   "all_outs": all_outs})

    # 3. Walk forward ops in reverse, emitting grad ops; a contiguous run
    # of ops tagged by recompute_guard collapses into one segment.
    i = n_fwd
    while i > 0:
        i -= 1
        op = block.ops[i]
        if not op_needed[i]:
            kill_versions(op)
            continue
        if op.type == "seg_fwd":
            raise NotImplementedError(
                "append_backward over a program that already contains a "
                "compiled recompute segment (seg_fwd): differentiate each "
                "loss from its own program build (clone before the first "
                "minimize), or disable recompute_guard for multi-loss "
                "programs")
        seg = op.attrs.get("__recompute_seg__")
        if seg is not None and _seg_eligible(op):
            j = i
            while j > 0 and (
                    block.ops[j - 1].attrs.get("__recompute_seg__") == seg
                    and op_needed[j - 1]
                    and _seg_eligible(block.ops[j - 1])):
                j -= 1
            _emit_segment_grad(j, i)
            i = j
            continue
        opdef = get_op(op.type)

        out_slots = sorted(op.outputs)
        og_mask = {}
        og_inputs = {}
        any_og = False
        for slot in out_slots:
            mask = []
            arrs = []
            for name in op.outputs[slot]:
                g = finalize_grad(name)
                mask.append(g is not None)
                if g is not None:
                    arrs.append(g)
                    any_og = True
            og_mask[slot] = mask
            if arrs:
                og_inputs["OG:" + slot] = arrs
        kill_versions(op)
        if not any_og:
            continue

        diff_mask = {}
        ig_outputs = {}
        for slot, names in op.inputs.items():
            mask = []
            outs_for_slot = []
            for name in names:
                ok = _diffable_input(name)
                mask.append(ok)
                if ok:
                    g = program.unique_name(grad_var_name(name) + "@R")
                    outs_for_slot.append((name, g))
            diff_mask[slot] = mask
            if outs_for_slot:
                ig_outputs[slot] = outs_for_slot
        if not ig_outputs:
            continue

        use_custom = opdef.grad_fn is not None
        if op_uses_rng(opdef, op.attrs) and not use_custom:
            raise NotImplementedError(
                f"op {op.type!r} uses randomness and has no custom grad_fn")

        in_names = {n for names in op.inputs.values() for n in names}
        snap = {}
        for name in sorted(in_names):
            if last_write.get(name, -1) >= i:
                sname = program.unique_name(name + "@PRE")
                block.create_var(name=sname, stop_gradient=True)
                block.insert_op(i, "assign", inputs={"X": [name]},
                                outputs={"Out": [sname]})
                snap[name] = sname
        osnap = {}
        if use_custom:
            out_names = {n for names in op.outputs.values() for n in names}
            for name in sorted(out_names):
                if last_write.get(name, -1) > i:
                    sname = program.unique_name(name + "@POST")
                    block.create_var(name=sname, stop_gradient=True)
                    block.insert_op(i + 1 + len(snap), "assign",
                                    inputs={"X": [name]},
                                    outputs={"Out": [sname]})
                    osnap[name] = sname

        grad_inputs = {("I:" + slot): [snap.get(n, n) for n in names]
                       for slot, names in op.inputs.items() if names}
        if use_custom:
            for slot, names in op.outputs.items():
                if names:
                    grad_inputs["O:" + slot] = [osnap.get(n, n)
                                                for n in names]
        grad_inputs.update(og_inputs)

        grad_outputs = {}
        for slot, pairs in ig_outputs.items():
            slot_outs = []
            for name, gvar in pairs:
                block.create_var(name=gvar, stop_gradient=True)
                slot_outs.append(gvar)
                add_contribution(name, gvar)
            grad_outputs["IG:" + slot] = slot_outs

        attrs = {
            "fwd_type": op.type,
            "fwd_attrs": dict(op.attrs),
            "in_slots": {slot: len(names)
                         for slot, names in op.inputs.items()},
            "out_slots": out_slots,
            "og": og_mask,
            "diff": diff_mask,
        }
        if not use_custom:
            # pairs the forward with its grad op, so the executor records
            # the forward's vjp once instead of recomputing it
            key = program.unique_name("vjp")
            op.attrs[VJP_KEY] = key
            attrs[VJP_KEY] = key
        block.append_op("grad_custom" if use_custom else "grad",
                        inputs=grad_inputs, outputs=grad_outputs,
                        attrs=attrs)

    # 4. Finalize remaining contributions (producer-less vars: feeds and
    # params) and give every finalized grad its canonical ``<var>@GRAD``
    # alias; multi-version names resolve to the latest version's grad.
    for name in list(contributions):
        g = finalize_grad(name)
        canonical_first.setdefault(name, g)
    for name, g in canonical_first.items():
        canonical = grad_var_name(name)
        if g is not None and g != canonical and not block.has_var(canonical):
            src = block.var(name) if block.has_var(name) else None
            block.create_var(name=canonical,
                             shape=src.shape if src is not None else None,
                             dtype=src.dtype if src is not None else "float32",
                             stop_gradient=True)
            block.append_op("assign", inputs={"X": [g]},
                            outputs={"Out": [canonical]})

    # 5. Collect (param, grad) pairs.
    params = ([block.var(n) for n in parameter_list] if parameter_list
              else block.all_parameters())
    result = []
    for p in params:
        g = finalize_grad(p.name)
        if g is None:
            continue
        canonical = grad_var_name(p.name)
        if not block.has_var(canonical):  # single direct contribution
            block.create_var(name=canonical, shape=p.shape, dtype=p.dtype,
                             stop_gradient=True)
            block.append_op("assign", inputs={"X": [g]},
                            outputs={"Out": [canonical]})
        result.append((p, block.var(canonical)))
    return result
