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

Recompute segments (``recompute_guard``) are a later slice of the port.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from .program import Block, Variable, grad_var_name
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

    def _diffable_input(name: str) -> bool:
        ok = (name in relevant and _is_float_var(block, name)
              and name not in no_grad)
        if ok and block.has_var(name):
            v = block.var(name)
            if v.stop_gradient and not v.is_parameter:
                ok = False
        return ok

    # 3. Walk forward ops in reverse, emitting grad ops.
    for i in range(n_fwd - 1, -1, -1):
        op = block.ops[i]
        if not op_needed[i]:
            kill_versions(op)
            continue
        if op.attrs.get("__recompute_seg__") is not None:
            raise NotImplementedError(
                "recompute segments (recompute_guard) are not ported to "
                "paddle_tpu_torch yet: they land with the per-layer "
                "transformer training slice")
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
