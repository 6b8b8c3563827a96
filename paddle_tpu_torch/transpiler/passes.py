"""The standard pass library.

Counterpart of ``paddle_tpu/transpiler/passes.py``, the passes
``inference_pipeline`` runs, with the same matches, rewrites and
provenance attrs (``__fused_from__`` / ``__folded_from__``), so both
packages transpile a program to the same program dict:

- ``ExpandRecomputeSegments``: each ``seg_fwd`` recompute segment is
  inlined back into its ops (an inference program keeps no stash).
- ``CanonicalizeIsTest``: every ``is_test`` attr to True.
- ``DropoutToScale``: inference dropout (downscale-in-infer) becomes a
  ``scale`` op, equal to the untranspiled program.
- ``DeadOpElimination``: the backward slice from the fetch targets.
- ``ConstantFolding``: feed-independent subgraphs evaluated once through
  the port's op registry; results land in the scope as new persistables.
- ``FoldBatchNorm``: an inference batch_norm folded into the preceding
  conv2d filter or mul weight plus a bias add, the affine in numpy f32 as
  in the JAX package (so folded weights are bitwise equal); with
  ``lower_fused`` also ``conv1x1_bn_act`` lowered to folded conv2d + add.
- ``FusePatterns``: NHWC 1x1 ``conv2d → batch_norm [→ elementwise_add]
  [→ relu]`` chains become ``conv1x1_bn_act`` (the conv-epilogue
  kernels), and primitive ``matmul → [scale] → softmax → matmul``
  attention becomes ``scaled_dot_product_attention`` (the flash kernels).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.program import Block, Operator, Program
from ..core.registry import get_op, has_op, op_uses_rng
from ..core.types import dtype_name, to_dtype
from .framework import Pass, PassContext, register_pass

SEG_ATTR = "__recompute_seg__"


def _drop_unused_vars(program: Program, ctx: PassContext) -> None:
    """Drop global-block vars referenced by no op in ANY block (sub-block
    ops read outer vars through the ancestor chain, so usage must be
    collected program-wide). Feeds/fetches always survive."""
    used = set(ctx.feed_names) | set(ctx.fetch_names)
    for b in program.blocks:
        for op in b.ops:
            used.update(op.input_names())
            used.update(op.output_names())
    gb = program.global_block
    for n in [n for n in gb.vars if n not in used]:
        del gb.vars[n]


def _same_segment(*ops: Operator) -> bool:
    """Fusing across recompute-segment boundaries would regroup the
    backward's composite vjp — only rewrite chains wholly inside one
    segment (or wholly outside any)."""
    segs = {op.attrs.get(SEG_ATTR) for op in ops}
    return len(segs) == 1


# --------------------------------------------------------------------------
@register_pass
class ExpandRecomputeSegments(Pass):
    """Inline ``seg_fwd`` composites back into their plain forward ops.

    Must be followed by DCE before the program runs again: a surviving
    ``grad_seg`` op needs the stash only a live ``seg_fwd`` fills."""

    name = "expand_recompute_segments"

    def apply(self, program: Program, ctx: PassContext) -> None:
        for block in program.blocks:
            if not any(op.type == "seg_fwd" for op in block.ops):
                continue
            flat: List[Operator] = []
            for op in block.ops:
                if op.type != "seg_fwd":
                    flat.append(op)
                    continue
                for sop in op.attrs["seg_ops"]:
                    flat.append(Operator(block, sop["type"], sop["ins"],
                                         sop["outs"], dict(sop["attrs"])))
            block.ops = flat
            program._bump()


# --------------------------------------------------------------------------
@register_pass
class CanonicalizeIsTest(Pass):
    """Flip every op-level ``is_test`` attr to True (inference
    canonicalization; Program.clone(for_test=True) semantics)."""

    name = "canonicalize_is_test"

    def apply(self, program: Program, ctx: PassContext) -> None:
        for block in program.blocks:
            for op in block.ops:
                if "is_test" in op.attrs and not op.attrs["is_test"]:
                    op.attrs = dict(op.attrs)
                    op.attrs["is_test"] = True
                    program._bump()


# --------------------------------------------------------------------------
@register_pass
class DropoutToScale(Pass):
    """Rewrite inference-mode dropout to an explicit ``scale`` op.

    This repo's dropout is downscale-in-infer: the test-mode kernel
    multiplies by ``(1 - p)`` (ops/nn_ops.py), so deleting the op — the
    folk transpiler move — would change the math. Emitting
    ``scale(scale=1-p)`` is token-exact with the untranspiled is_test
    program while freeing the executor from threading RNG state through
    a program that no longer draws randomness.
    """

    name = "dropout_to_scale"

    def apply(self, program: Program, ctx: PassContext) -> None:
        fetches = set(ctx.fetch_names)
        for block in program.blocks:
            consumers = block.var_consumers()
            for op in list(block.ops):
                if op.type != "dropout" or not op.attrs.get("is_test"):
                    continue
                mask = op.output("Mask")
                if mask and (mask in fetches or consumers.get(mask)):
                    continue  # someone reads the mask; keep the real op
                p = op.attrs.get("dropout_prob", 0.5)
                block.replace_ops(
                    [op], "scale",
                    {"X": [op.input("X")]}, {"Out": [op.output("Out")]},
                    {"scale": 1.0 - p, "bias": 0.0,
                     "bias_after_scale": True,
                     "__rewritten_from__": "dropout"})
        _drop_unused_vars(program, ctx)


# --------------------------------------------------------------------------
@register_pass
class DeadOpElimination(Pass):
    """Backward slice from the fetch targets: keep exactly the ops whose
    outputs are (transitively) needed, drop everything else — optimizer
    updates, loss branches, metrics. With ``ctx.preserve_state_writes``
    ops that write a scope-resident name (KV-cache updates and other
    unfetched state) count as roots too.
    """

    name = "dead_op_elimination"

    def apply(self, program: Program, ctx: PassContext) -> None:
        block = program.global_block
        needed = set(ctx.fetch_names)
        if ctx.preserve_state_writes and ctx.scope is not None:
            for op in block.ops:
                needed.update(n for n in op.output_names()
                              if ctx.scope.has(n))
        feeds = set(ctx.feed_names)
        keep: List[Operator] = []
        for op in reversed(block.ops):
            if any(o in needed for o in op.output_names()):
                keep.append(op)
                needed.update(n for n in op.input_names() if n not in feeds)
        keep.reverse()
        if len(keep) != len(block.ops):
            block.ops = keep
            program._bump()
        _drop_unused_vars(program, ctx)


# --------------------------------------------------------------------------
@register_pass
class ConstantFolding(Pass):
    """Evaluate feed-independent subgraphs once at transpile time.

    Constant sources are literal generators (ops with no inputs, e.g.
    ``fill_constant``) and — when ``fold_params`` and a scope is given —
    persistable parameters the program never writes (weights are frozen
    at transpile time; the inference-pipeline premise). Folded values
    are written into the scope as new persistable vars; the executor
    then reads them as read-only state, and ``save_inference_model``
    persists them like any other parameter.

    Foldable ops are evaluated through the SAME kernel registry the
    executor traces, so a folded subgraph computes exactly what the
    compiled program would have.
    """

    name = "constant_fold"

    def __init__(self, fold_params: bool = True,
                 max_elems: int = 1 << 22):
        self.fold_params = fold_params
        self.max_elems = max_elems

    def apply(self, program: Program, ctx: PassContext) -> None:
        scope = ctx.scope
        if scope is None:
            ctx.note("constant_fold: skipped (no scope to hold results)")
            return
        block = program.global_block
        written = {n for b in program.blocks for op in b.ops
                   for n in op.output_names()}
        fetches = set(ctx.fetch_names)
        feeds = set(ctx.feed_names)

        const: Dict[str, object] = {}
        if self.fold_params:
            for name, v in block.vars.items():
                if (v.persistable and not v.is_data and name not in written
                        and name not in feeds and scope.has(name)):
                    const[name] = scope.get(name)

        folded: Dict[str, object] = {}
        new_ops: List[Operator] = []
        device = _scope_device(scope, block)
        for op in block.ops:
            if not self._try_fold(op, block, const, folded, fetches, device):
                new_ops.append(op)
                # outputs of a live op are runtime values, never constants
                for n in op.output_names():
                    const.pop(n, None)
                    folded.pop(n, None)
        if len(new_ops) == len(block.ops):
            return
        block.ops = new_ops
        # materialize only the folded values something still reads —
        # sub-block ops (while/cond bodies) read outer names too
        live = set(fetches)
        for b in program.blocks:
            for op in (new_ops if b is block else b.ops):
                live.update(op.input_names())
        for name, val in folded.items():
            if name not in live:
                continue
            scope.set(name, val)
            if name in block.vars:
                v = block.vars[name]
                v.persistable = True
                v.stop_gradient = True
        program._bump()
        _drop_unused_vars(program, ctx)

    # ------------------------------------------------------------------
    def _try_fold(self, op: Operator, block: Block, const: dict,
                  folded: dict, fetches: set, device) -> bool:
        if not has_op(op.type):
            return False
        opdef = get_op(op.type)
        if op.type in ("grad", "grad_custom") or op_uses_rng(opdef, op.attrs):
            return False
        in_names = op.input_names()
        if not all(n in const for n in in_names):
            return False
        out_names = op.output_names()
        for n in out_names:
            if n in fetches or n in in_names:
                return False  # fetch roots / in-place state aliases stay
            if n in const and n not in folded:
                return False  # would clobber a live scope entry
            v = block.vars.get(n)
            if v is not None and v.shape is not None and -1 in v.shape:
                return False  # batch-dependent by declaration
        ins = {slot: [torch.as_tensor(const[n], device=device)
                      for n in names]
               for slot, names in op.inputs.items() if names}
        try:
            with torch.no_grad(), torch.device(device):
                if callable(opdef.needs_rng):
                    outs = opdef.fn(op.attrs, ins, rng=None)
                else:
                    outs = opdef.fn(op.attrs, ins)
        except Exception:
            return False  # keep the op; folding is best-effort
        vals = {}
        for slot, names in op.outputs.items():
            for name, val in zip(names, outs.get(slot, [])):
                if not isinstance(val, torch.Tensor) \
                        or val.numel() > self.max_elems:
                    return False
                vals[name] = val
        if set(vals) != set(out_names):
            return False  # kernel returned fewer slots than the op declares
        for name, val in vals.items():
            const[name] = val
            folded[name] = val
        return True


def _scope_device(scope, block: Block) -> torch.device:
    """Where the scope keeps the block's persistable values (the first
    one found): folded values are made there too."""
    for name, v in block.vars.items():
        if v.persistable and scope.has(name):
            val = scope.get(name)
            if isinstance(val, torch.Tensor):
                return val.device
    return torch.device("cpu")


# --------------------------------------------------------------------------
def _bn_affine(scope, bn_op: Operator):
    """(k, b) with y = x*k + b from a BN op's parameters/running stats:
    k = gamma * rsqrt(var + eps), b = beta - mean*k (f32, matching the
    kernel's compute dtype)."""
    eps = np.float32(bn_op.attrs.get("epsilon", 1e-5))
    g = scope.get_numpy(bn_op.input("Scale")).astype(np.float32)
    beta = scope.get_numpy(bn_op.input("Bias")).astype(np.float32)
    mean = scope.get_numpy(bn_op.input("Mean")).astype(np.float32)
    var = scope.get_numpy(bn_op.input("Variance")).astype(np.float32)
    k = g / np.sqrt(var + eps)
    return k, beta - mean * k


def _weight_out_axis(op: Operator, w_shape) -> Optional[int]:
    """Output-channel axis of the producer's weight, or None if this
    producer/layout combination is not foldable."""
    if op.type in ("conv2d", "depthwise_conv2d"):
        fmt = op.attrs.get("data_format", "NCHW")
        if len(w_shape) != 4:
            return None
        return 3 if fmt == "NHWC" else 0  # HWIO vs OIHW
    if op.type == "mul":
        if len(w_shape) == 2 and op.attrs.get("y_num_col_dims", 1) == 1:
            return 1
        return None
    return None


@register_pass
class FoldBatchNorm(Pass):
    """Fold inference batch_norm into the preceding conv2d/mul weights.

    Matches ``{conv2d|depthwise_conv2d|mul} [→ elementwise_add(bias)] →
    batch_norm(is_test=True)`` where the intermediate activations have a
    single consumer and the weight lives in the scope. The weight is
    scaled per output channel (W' = W·k) under a NEW name — the caller's
    original tensors are never mutated — and the batch_norm collapses to
    one per-channel bias add (b = beta − mean·k, plus any pre-existing
    bias folded through).

    ``lower_fused=True`` additionally lowers inference ``conv1x1_bn_act``
    ops to folded conv2d + bias add (+residual add, +relu) — the
    portable/int8 deployment form, where a plain conv2d filter is
    eligible for weight-only quantization and the native C machine's
    simplest kernels apply.
    """

    name = "fold_batch_norm"

    def __init__(self, lower_fused: bool = False):
        self.lower_fused = lower_fused

    def apply(self, program: Program, ctx: PassContext) -> None:
        scope = ctx.scope
        if scope is None:
            ctx.note("fold_batch_norm: skipped (no scope with weights)")
            return
        block = program.global_block
        written = {n for op in block.ops for n in op.output_names()}
        changed = True
        while changed:
            changed = False
            producers = block.var_producers()
            consumers = block.var_consumers()
            for op in list(block.ops):
                if (op.type == "batch_norm" and op.attrs.get("is_test")
                        and self._fold_bn(block, op, producers, consumers,
                                          written, scope, ctx)):
                    changed = True
                    break
                if (self.lower_fused and op.type == "conv1x1_bn_act"
                        and op.attrs.get("is_test")
                        and self._lower_fused(block, op, consumers, scope,
                                              ctx)):
                    changed = True
                    break
        _drop_unused_vars(program, ctx)

    # ------------------------------------------------------------------
    @staticmethod
    def _aux_outputs_unused(op: Operator, consumers, skip_slots=("Y",)):
        for slot, names in op.outputs.items():
            if slot in skip_slots:
                continue
            for n in names:
                for _, c in consumers.get(n, []):
                    if c is not op:
                        return False
        return True

    def _new_param(self, block: Block, scope, base: str, value: np.ndarray,
                   dtype):
        """A new parameter holding ``value`` (computed in f32) in
        ``dtype``, rounded by torch: numpy has no bfloat16, and an AMP
        program's folded weights and biases may be bf16."""
        name = base
        i = 0
        while name in block.vars or scope.has(name):
            i += 1
            name = f"{base}{i}"
        block.create_parameter(name=name, shape=value.shape,
                               dtype=dtype_name(dtype), trainable=False)
        # on the scope's device, beside the weights it replaces
        scope.set(name, torch.from_numpy(np.ascontiguousarray(
            value, np.float32)).to(_scope_device(scope, block),
                                   to_dtype(dtype)))
        return name

    def _fold_bn(self, block: Block, bn: Operator, producers, consumers,
                 written, scope, ctx: PassContext) -> bool:
        x = bn.input("X")
        if x in ctx.fetch_names or len(consumers.get(x, [])) != 1:
            return False
        stat_names = [bn.input(s) for s in ("Scale", "Bias", "Mean",
                                            "Variance")]
        if any(n is None or not scope.has(n) for n in stat_names):
            return False
        p = block.sole_producer(x, producers)
        if p is None:
            return False
        if not self._aux_outputs_unused(bn, consumers):
            return False
        add_op, prior_bias = None, None
        base = p
        if p.type == "elementwise_add":
            bias_name = p.input("Y")
            mid = p.input("X")
            if (bias_name is None or mid is None or not scope.has(bias_name)
                    or bias_name in written
                    or scope.get(bias_name).ndim != 1
                    or mid in ctx.fetch_names
                    or len(consumers.get(mid, [])) != 1):
                return False
            base = block.sole_producer(mid, producers)
            if base is None:
                return False
            add_op, prior_bias = p, scope.get_numpy(bias_name)
        w_slot = "Filter" if base.type != "mul" else "Y"
        w_name = base.input(w_slot) if base.inputs.get(w_slot) else None
        if w_name is None or not scope.has(w_name) or w_name in written:
            return False
        w = scope.get_numpy(w_name)
        axis = _weight_out_axis(base, w.shape)
        if axis is None:
            return False
        fmt = base.attrs.get("data_format", "NCHW")
        xv = block.vars.get(x)
        if xv is not None and xv.shape is not None and len(xv.shape) == 4:
            bn_fmt = bn.attrs.get("data_layout",
                                  bn.attrs.get("data_format", "NCHW"))
            if bn_fmt != fmt:
                return False
        if not _same_segment(*(o for o in (base, add_op, bn) if o)):
            return False

        k, b = _bn_affine(scope, bn)
        if k.shape[0] != w.shape[axis]:
            return False
        bshape = tuple(-1 if a == axis else 1 for a in range(w.ndim))
        new_w = w.astype(np.float32) * k.reshape(bshape)
        if prior_bias is not None:
            b = b + prior_bias.astype(np.float32) * k
        out_dtype = (xv.dtype if xv is not None and xv.shape is not None
                     else "float32")

        bn_y = bn.output("Y")
        new_w_name = self._new_param(block, scope, w_name + "@bnfold", new_w,
                                     scope.get(w_name).dtype)
        bias_name = self._new_param(block, scope, bn_y + "@bnfold_bias", b,
                                    out_dtype)
        base.inputs[w_slot] = [new_w_name]
        base.attrs["__bn_folded__"] = True
        add_axis = 1 if (w.ndim == 4 and fmt == "NCHW") else -1
        if add_op is not None:
            add_op.inputs["Y"] = [bias_name]
            add_op.outputs["Out"] = [bn_y]
            add_op.attrs["axis"] = add_axis
            add_op.attrs["__folded_from__"] = "batch_norm"
            block.remove_ops([bn])
        else:
            block.replace_ops(
                [bn], "elementwise_add",
                {"X": [x], "Y": [bias_name]}, {"Out": [bn_y]},
                {"axis": add_axis, "__folded_from__": "batch_norm",
                 SEG_ATTR: bn.attrs.get(SEG_ATTR)}
                if bn.attrs.get(SEG_ATTR) is not None else
                {"axis": add_axis, "__folded_from__": "batch_norm"})
        return True

    # ------------------------------------------------------------------
    def _lower_fused(self, block: Block, op: Operator, consumers, scope,
                     ctx: PassContext) -> bool:
        w_name = op.input("Filter")
        if w_name is None or not scope.has(w_name):
            return False
        if any(op.input(s) is None or not scope.has(op.input(s))
               for s in ("Scale", "Bias", "Mean", "Variance")):
            return False
        if not self._aux_outputs_unused(op, consumers):
            return False
        w = scope.get_numpy(w_name)
        wm = w.reshape(w.shape[-2], w.shape[-1])  # [1,1,I,O] or [I,O]
        k, b = _bn_affine(scope, op)
        if k.shape[0] != wm.shape[1]:
            return False
        new_w = wm.astype(np.float32) * k[None, :]
        new_w = new_w.reshape(1, 1, *new_w.shape)  # conv2d HWIO
        x = op.input("X")
        y = op.output("Y")
        xv = block.vars.get(x)
        new_w_name = self._new_param(block, scope, w_name + "@bnfold", new_w,
                                     scope.get(w_name).dtype)
        bias_name = self._new_param(block, scope, y + "@bnfold_bias", b,
                                    xv.dtype if xv is not None else "float32")
        res = op.input("Residual") if op.inputs.get("Residual") else None
        act = op.attrs.get("act") or ""
        yv = block.vars.get(y)
        oshape = yv.shape if yv is not None else None
        odtype = dtype_name(yv.dtype) if yv is not None else "float32"

        def tmp(tag):
            v = block.create_var(
                name=block.program.unique_name(y + tag), shape=oshape,
                dtype=odtype, stop_gradient=True)
            return v.name

        conv_attrs = {"data_format": "NHWC", "strides": [1, 1],
                      "paddings": [0, 0], "dilations": [1, 1], "groups": 1,
                      "__folded_from__": "conv1x1_bn_act"}
        chain = [("conv2d", {"Input": [x], "Filter": [new_w_name]},
                  "Output", conv_attrs),
                 ("elementwise_add", {"Y": [bias_name]}, "Out",
                  {"axis": -1})]
        if res is not None:
            chain.append(("elementwise_add", {"Y": [res]}, "Out", {}))
        if act == "relu":
            chain.append(("relu", {}, "Out", {}))
        idx = next(i for i, o in enumerate(block.ops) if o is op)
        new_ops, cur = [], None
        for j, (typ, ins, out_slot, attrs) in enumerate(chain):
            ins = dict(ins)
            if cur is not None:
                key = "Input" if typ == "conv2d" else "X"
                ins[key] = [cur]
            cur = y if j == len(chain) - 1 else tmp(f"@unfused{j}")
            new_ops.append(Operator(block, typ, ins, {out_slot: [cur]},
                                    attrs))
        block.ops[idx:idx + 1] = new_ops
        block.program._bump()
        return True


# --------------------------------------------------------------------------
@register_pass
class FusePatterns(Pass):
    """Pattern rewriter onto the repo's fused kernels.

    1. ``conv2d(1x1, stride 1, pad 0, NHWC) → batch_norm [→
       elementwise_add(residual)] [→ relu]`` becomes one
       ``conv1x1_bn_act`` op (kernels/conv_epilogue.py) — valid in both
       training and inference (the fused op implements the full
       batch-stat + running-stat contract and registers a grad_fn).
       Gated on ``--fused_conv_epilogue`` unless ``epilogue`` is forced,
       mirroring the model-layer gate.
    2. ``matmul(Q, K, transpose_Y) → [scale] → softmax → matmul(·, V)``
       over [B, H, T, D] heads becomes one
       ``scaled_dot_product_attention`` op (the flash-attention path);
       non-causal patterns only — a causal mask add is left alone.
    """

    name = "fuse_patterns"

    def __init__(self, epilogue: Optional[bool] = None,
                 attention: bool = True):
        self.epilogue = epilogue
        self.attention = attention

    def apply(self, program: Program, ctx: PassContext) -> None:
        from ..flags import FLAGS

        epilogue = (FLAGS.fused_conv_epilogue if self.epilogue is None
                    else self.epilogue)
        block = program.global_block
        changed = True
        while changed:
            changed = False
            producers = block.var_producers()
            consumers = block.var_consumers()
            for op in list(block.ops):
                if (epilogue and op.type == "conv2d"
                        and self._fuse_epilogue(block, op, consumers, ctx)):
                    changed = True
                    break
                if (self.attention and op.type == "matmul"
                        and self._fuse_attention(block, op, consumers, ctx)):
                    changed = True
                    break
        _drop_unused_vars(program, ctx)

    # ------------------------------------------------------------------
    @staticmethod
    def _sole_consumer(consumers, name, fetches) -> Optional[Operator]:
        if name in fetches:
            return None
        cs = consumers.get(name, [])
        return cs[0][1] if len(cs) == 1 else None

    def _fuse_epilogue(self, block: Block, conv: Operator, consumers,
                      ctx: PassContext) -> bool:
        from ..ops.common import normalize_pair

        if conv.attrs.get("data_format", "NCHW") != "NHWC":
            return False
        if (normalize_pair(conv.attrs.get("strides", [1, 1])) != [1, 1]
                or normalize_pair(conv.attrs.get("paddings", [0, 0]))
                != [0, 0]
                or normalize_pair(conv.attrs.get("dilations", [1, 1]))
                != [1, 1]
                or conv.attrs.get("groups", 1) != 1):
            return False
        w_name = conv.input("Filter")
        wv = block.vars.get(w_name)
        if wv is None or wv.shape is None or len(wv.shape) != 4 \
                or wv.shape[0] != 1 or wv.shape[1] != 1:
            return False
        fetches = set(ctx.fetch_names)
        out = conv.output("Output")
        bn = self._sole_consumer(consumers, out, fetches)
        if bn is None or bn.type != "batch_norm" or bn.input("X") != out:
            return False
        if bn.attrs.get("data_layout",
                        bn.attrs.get("data_format", "NCHW")) != "NHWC":
            return False
        if not FoldBatchNorm._aux_outputs_unused(bn, consumers):
            return False
        if any(bn.output(s) is None or bn.input(s2) is None
               for s in ("MeanOut", "VarianceOut", "SavedMean",
                         "SavedVariance")
               for s2 in ("Scale", "Bias", "Mean", "Variance")):
            return False  # hand-built bn missing the full slot contract
        y = bn.output("Y")
        matched = [conv, bn]
        residual, final = None, y
        nxt = self._sole_consumer(consumers, y, fetches)
        if nxt is not None and nxt.type == "elementwise_add":
            other = [n for n in nxt.input_names() if n != y]
            yv, ov = block.vars.get(y), None
            if len(other) == 1:
                ov = block.vars.get(other[0])
            if (ov is not None and yv is not None and ov.shape is not None
                    and ov.shape == yv.shape):
                residual, final = other[0], nxt.output("Out")
                matched.append(nxt)
                nxt = self._sole_consumer(consumers, final, fetches)
        act = ""
        if nxt is not None and nxt.type == "relu" \
                and nxt.input("X") == final:
            act, final = "relu", nxt.output("Out")
            matched.append(nxt)
        if not _same_segment(*matched):
            return False

        is_test = bool(bn.attrs.get("is_test", False))
        fv = block.vars.get(final)
        conv_out_shape = ([1, 1] if is_test
                          else (fv.shape if fv is not None else None))
        conv_out = block.create_var(
            name=block.program.unique_name(out + "@convout"),
            shape=conv_out_shape,
            dtype=dtype_name(fv.dtype) if fv is not None else "float32",
            stop_gradient=True)
        ins = {"X": [conv.input("Input")], "Filter": [w_name],
               "Scale": [bn.input("Scale")], "Bias": [bn.input("Bias")],
               "Mean": [bn.input("Mean")],
               "Variance": [bn.input("Variance")]}
        if residual is not None:
            ins["Residual"] = [residual]
        outs = {"Y": [final],
                "MeanOut": [bn.output("MeanOut")],
                "VarianceOut": [bn.output("VarianceOut")],
                "SavedMean": [bn.output("SavedMean")],
                "SavedVariance": [bn.output("SavedVariance")],
                "ConvOut": [conv_out.name]}
        attrs = {"momentum": bn.attrs.get("momentum", 0.9),
                 "epsilon": bn.attrs.get("epsilon", 1e-5),
                 "is_test": is_test, "act": act,
                 "__fused_from__": [o.type for o in matched]}
        if conv.attrs.get(SEG_ATTR) is not None:
            attrs[SEG_ATTR] = conv.attrs[SEG_ATTR]
        block.replace_ops(matched, "conv1x1_bn_act", ins, outs, attrs)
        return True

    # ------------------------------------------------------------------
    def _fuse_attention(self, block: Block, m1: Operator, consumers,
                        ctx: PassContext) -> bool:
        if m1.attrs.get("transpose_X") or not m1.attrs.get("transpose_Y"):
            return False
        q, k = m1.input("X"), m1.input("Y")
        qv, kv = block.vars.get(q), block.vars.get(k)
        if (qv is None or kv is None or qv.shape is None or kv.shape is None
                or len(qv.shape) != 4 or len(kv.shape) != 4
                or qv.shape[3] != kv.shape[3]
                or kv.shape[1] <= 0 or qv.shape[1] % kv.shape[1]):
            return False
        fetches = set(ctx.fetch_names)
        sm = float(m1.attrs.get("alpha", 1.0))
        matched = [m1]
        cur = m1.output("Out")
        nxt = self._sole_consumer(consumers, cur, fetches)
        if nxt is not None and nxt.type == "scale":
            if nxt.attrs.get("bias", 0.0):
                return False
            sm *= float(nxt.attrs.get("scale", 1.0))
            matched.append(nxt)
            cur = nxt.output("Out")
            nxt = self._sole_consumer(consumers, cur, fetches)
        if nxt is None or nxt.type != "softmax" \
                or nxt.attrs.get("axis", -1) not in (-1, 3):
            return False
        matched.append(nxt)
        cur = nxt.output("Out")
        m2 = self._sole_consumer(consumers, cur, fetches)
        if (m2 is None or m2.type != "matmul" or m2.input("X") != cur
                or m2.attrs.get("transpose_X") or m2.attrs.get("transpose_Y")
                or float(m2.attrs.get("alpha", 1.0)) != 1.0):
            return False
        v = m2.input("Y")
        vv = block.vars.get(v)
        if vv is None or vv.shape is None or tuple(vv.shape) != \
                tuple(kv.shape):
            return False
        matched.append(m2)
        if not _same_segment(*matched):
            return False
        attrs = {"causal": False, "sm_scale": sm,
                 "__fused_from__": [o.type for o in matched]}
        if m1.attrs.get(SEG_ATTR) is not None:
            attrs[SEG_ATTR] = m1.attrs[SEG_ATTR]
        block.replace_ops(matched, "scaled_dot_product_attention",
                          {"Q": [q], "K": [k], "V": [v]},
                          {"Out": [m2.output("Out")]}, attrs)
        return True
