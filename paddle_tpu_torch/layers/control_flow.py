"""Control-flow builders: StaticRNN, While, the tensor arrays,
DynamicRNN, and the fused beam-search decoder.

Counterpart of ``paddle_tpu/layers/control_flow.py`` (the reference's
fluid control_flow layer API: StaticRNN, While, array_write/array_read/
increment, DynamicRNN). Entering ``rnn.step()`` / ``while.block()``
pushes a sub-block on the program; layers called inside append ops there
as usual. On exit the builder serializes the sub-block's ops into the
parent ``static_rnn`` / ``while`` op's attrs (plain data), and
``ops/control_flow_ops.py`` runs them once a step. External variables the
body reads (weights made by fc etc.) are collected into the op's Param
input slot.

DynamicRNN is StaticRNN over the sequence's Length: the ``static_rnn``
op freezes each row's memories and zeroes its outputs past its length,
where the reference sorts rows through a lod_rank_table and shrinks the
batch.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..core.program import Variable
from .layer_helper import LayerHelper
from .sequence import get_seq_len


def _collect_body(block, bound_names):
    """Serialize a sub-block's ops; classify external reads as params."""
    body_ops = []
    produced = set(bound_names)
    params: List[str] = []
    for op in block.ops:
        for slot, names in op.inputs.items():
            for n in names:
                if n not in produced and n not in params:
                    params.append(n)
        for n in op.output_names():
            produced.add(n)
        body_ops.append({
            "type": op.type,
            "inputs": {s: list(ns) for s, ns in op.inputs.items()},
            "outputs": {s: list(ns) for s, ns in op.outputs.items()},
            "attrs": dict(op.attrs),
        })
    return body_ops, params


class StaticRNN:
    """User-defined recurrence (fluid StaticRNN; reference runtime
    recurrent_op.cc:222), one ``static_rnn`` op.

    with rnn.step():
        xt = rnn.step_input(seq)         # [b, d] slice of [b, T, d]
        h  = rnn.memory(init=h0)         # loop-carried
        new_h = some_layers(xt, h)
        rnn.update_memory(h, new_h)
        rnn.step_output(new_h)
    out, = rnn()                          # [b, T, ...]
    """

    def __init__(self, name=None, main_program=None, startup_program=None):
        self.helper = LayerHelper("static_rnn", main_program=main_program,
                                  startup_program=startup_program)
        self.seq_vars: List[Variable] = []
        self.x_vars: List[Variable] = []
        self.mem_init: List[Variable] = []
        self.mem_vars: List[Variable] = []
        self.mem_out: Dict[str, Optional[str]] = {}
        self.out_vars: List[Variable] = []
        self.step_block = None
        self._len_var = None

    # -- context ----------------------------------------------------------
    class _Step:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            prog = self.rnn.helper.main_program
            self.rnn.step_block = prog.create_block()
            return self.rnn

        def __exit__(self, exc_type, *a):
            prog = self.rnn.helper.main_program
            prog.rollback()
            if exc_type is None:
                self.rnn._complete()

    def step(self):
        return StaticRNN._Step(self)

    # -- body API ---------------------------------------------------------
    def step_input(self, seq: Variable) -> Variable:
        """Register a [b, T, ...] sequence; returns its per-step [b, ...]
        view usable inside the body."""
        prog = self.helper.main_program
        if self._len_var is None:
            self._len_var = get_seq_len(seq)
        shape = (seq.shape[0],) + tuple(seq.shape[2:])
        xt = self.step_block.create_var(
            name=prog.unique_name("static_rnn.x"), shape=shape,
            dtype=seq.dtype)
        self.seq_vars.append(seq)
        self.x_vars.append(xt)
        return xt

    def memory(self, init: Variable) -> Variable:
        """Loop-carried state seeded from ``init`` ([b, ...])."""
        prog = self.helper.main_program
        mem = self.step_block.create_var(
            name=prog.unique_name("static_rnn.mem"), shape=init.shape,
            dtype=init.dtype)
        self.mem_init.append(init)
        self.mem_vars.append(mem)
        self.mem_out[mem.name] = None
        return mem

    def update_memory(self, mem: Variable, new: Variable):
        self.mem_out[mem.name] = new.name

    def step_output(self, o: Variable):
        self.out_vars.append(o)

    output = step_output

    # -- completion -------------------------------------------------------
    def _complete(self):
        for m, tgt in self.mem_out.items():
            if tgt is None:
                raise ValueError(f"memory {m!r} was never update_memory()'d")
        bound = [v.name for v in self.x_vars] + [v.name for v in self.mem_vars]
        body_ops, params = _collect_body(self.step_block, bound)
        ins = {
            "X": self.seq_vars,
            "MemInit": self.mem_init,
            "Param": [self.helper.block.var(n) if self.helper.block.has_var(n)
                      else n for n in params],
        }
        if self._len_var is not None:
            ins["Length"] = [self._len_var]
        attrs = {
            "body_ops": body_ops,
            "x_names": [v.name for v in self.x_vars],
            "mem_names": [v.name for v in self.mem_vars],
            "mem_out_names": [self.mem_out[v.name] for v in self.mem_vars],
            "out_names": [v.name for v in self.out_vars],
            "param_names": params,
            "seq_len_static": (self.seq_vars[0].shape[1]
                               if self.seq_vars else 0),
        }
        outs, _ = self.helper.append_op("static_rnn", ins,
                                        ["Out", "LastMem"], attrs)
        self._outputs = outs["Out"]
        self._last_mems = outs["LastMem"]
        for o in self._outputs:
            o.seq_len = self._len_var

    def __call__(self):
        outs = self._outputs
        return outs[0] if len(outs) == 1 else outs


def _static_scalar_value(blocks, name):
    """The value of ``name`` if its producer is a static fill_constant."""
    for blk in blocks:
        producer = None
        for op in blk.ops:
            if name in op.output_names():
                producer = op  # keep the LAST producer (current version)
        if producer is not None:
            if producer.type == "fill_constant":
                return producer.attrs.get("value")
            return None
    return None


# Refuse to run absurdly long loops as a masked loop: a sentinel
# limit like less_than(i, 1e9) must keep the dynamic lowering.
_MAX_INFERRED_TRIP = 10_000


def _producer_through_assigns(sub, name):
    """The body op producing ``name``'s final value, assign chains
    followed."""
    writer = None
    for op in sub.ops:
        if name in op.output_names():
            writer = op
    seen = 0
    while writer is not None and writer.type == "assign" and seen < 16:
        seen += 1
        src = (writer.inputs.get("X") or [None])[0]
        writer = None
        for op in sub.ops:
            if src in op.output_names():
                writer = op
    return writer


def _counter_step(sub, name) -> Optional[float]:
    """If ``name`` is a verified loop counter — the body reassigns it to
    increment(name, step) with step >= 1 (possibly through assigns) —
    return the step; else None."""
    writer = _producer_through_assigns(sub, name)
    if (writer is not None and writer.type == "increment"
            and (writer.inputs.get("X") or [None])[0] == name):
        step = float(writer.attrs.get("step", 1.0))
        if step >= 1.0:
            return step
    return None


def _infer_trip_bound(sub, outer, cond_name) -> Optional[int]:
    """Derive a static trip-count bound for a while body, the analogue of
    the reference reading extents off the lod_rank_table when it
    differentiates a dynamic while sub-block
    (backward.cc:415 + lod_rank_table.h).

    Inference is deliberately conservative: it only fires when the
    condition is ``less_than/less_equal(i, n)`` where ``i`` is a VERIFIED
    counter (the body reassigns it to ``increment(i, step>=1)``) with a
    static, non-negative start AND ``n`` is a static fill_constant — then
    the bound is exactly ceil((n - start) / step), so the masked scan runs
    the same trips the dynamic loop would. Anything else (runtime limits,
    non-counter conditions, sentinel limits past _MAX_INFERRED_TRIP) keeps
    the dynamic lowering (a host-read early exit): a merely plausible bound
    (e.g. a tensor-array extent) could silently truncate a loop whose
    runtime limit runs longer.
    """
    import math

    cond_op = _producer_through_assigns(sub, cond_name)
    if cond_op is None or cond_op.type not in ("less_than", "less_equal"):
        return None
    xname = (cond_op.inputs.get("X") or [None])[0]
    yname = (cond_op.inputs.get("Y") or [None])[0]
    if xname is None or yname is None:
        return None
    step = _counter_step(sub, xname)
    if step is None:
        return None
    start = _static_scalar_value((outer,), xname)
    if start is None or start < 0:
        return None
    limit = _static_scalar_value((sub, outer), yname)
    if limit is None:
        return None
    extra = 1 if cond_op.type == "less_equal" else 0
    trips = max(int(math.ceil((float(limit) - start) / step)) + extra, 0)
    return trips if trips <= _MAX_INFERRED_TRIP else None


class While:
    """Functional while loop (fluid layers.While / while_op.cc).

    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        ... body ops; every loop-carried var (including cond) must be
        written each iteration (use layers.assign(new, output=var)) ...
    Loop-carried vars are detected as body-written names that exist in the
    enclosing block.
    """

    def __init__(self, cond: Variable, max_iters=None, main_program=None,
                 startup_program=None):
        """``max_iters``: static trip-count bound. Setting it runs the
        loop as a fixed-length masked loop, which autograd records, so
        the while trains (ops/control_flow_ops.py while_op). When left
        None, a bound is inferred from the loop structure (a static
        ``less_than`` limit over a verified counter, _infer_trip_bound)
        so decode-train loops differentiate without hand-passing one;
        pass ``max_iters=0`` to force the dynamic lowering (a true early
        exit that reads the cond on the host each trip; not trainable)."""
        self.helper = LayerHelper("while", main_program=main_program,
                                  startup_program=startup_program)
        self.cond = cond
        self.max_iters = max_iters
        self.sub_block = None

    class _Block:
        def __init__(self, w):
            self.w = w

        def __enter__(self):
            self.w.outer_block = self.w.helper.main_program.current_block()
            self.w.sub_block = self.w.helper.main_program.create_block()
            return self.w

        def __exit__(self, exc_type, *a):
            self.w.helper.main_program.rollback()
            if exc_type is None:
                self.w._complete()

    def block(self):
        return While._Block(self)

    def _complete(self):
        sub = self.sub_block
        outer = self.outer_block
        # Carried vars: body-written names resolvable in the OUTER scope.
        written = []
        for op in sub.ops:
            for n in op.output_names():
                if outer.has_var(n) and n not in written:
                    written.append(n)
        if self.cond.name not in written:
            raise ValueError(
                "While body must reassign the condition variable "
                f"{self.cond.name!r} (layers.assign(new_cond, output=cond))")
        carried = written
        body_ops, params = _collect_body(sub, carried)
        max_iters = self.max_iters
        if max_iters is None:
            max_iters = _infer_trip_bound(sub, outer, self.cond.name)
        elif max_iters == 0:
            max_iters = None  # explicit request for the dynamic lowering
        ins = {
            "Carried": [outer.var(n) for n in carried],
            "Param": [outer.var(n) if outer.has_var(n) else n
                      for n in params],
        }
        attrs = {
            "body_ops": body_ops,
            "carried_names": carried,
            "param_names": params,
            "cond_name": self.cond.name,
            "max_iters": max_iters,
        }
        # Outputs write back to the SAME outer variables (final loop state).
        outputs = {"Out": [outer.var(n) for n in carried]}
        self.helper.append_op("while", ins, outputs, attrs)


def create_array(element_shape, max_len, dtype="float32", main_program=None,
                 startup_program=None):
    """A [max_len, ...] zero buffer: the functional LoDTensorArray."""
    from . import tensor as tensor_layers

    return tensor_layers.fill_constant(
        shape=[max_len] + list(element_shape), dtype=dtype, value=0.0,
        main_program=main_program, startup_program=startup_program)


def array_write(x, i, array, main_program=None, startup_program=None):
    helper = LayerHelper("array_write", main_program=main_program,
                         startup_program=startup_program)
    return helper.simple_op("array_write",
                            {"X": [x], "I": [i], "Array": [array]})


def array_read(array, i, main_program=None, startup_program=None):
    helper = LayerHelper("array_read", main_program=main_program,
                         startup_program=startup_program)
    return helper.simple_op("array_read", {"Array": [array], "I": [i]})


def increment(x, value=1.0, main_program=None, startup_program=None):
    helper = LayerHelper("increment", main_program=main_program,
                         startup_program=startup_program)
    return helper.simple_op("increment", {"X": [x]}, {"step": value})


def beam_search_decoder(init_state, embedding_param, cell_params, out_params,
                        beam_size=4, max_len=32, bos_id=0, eos_id=1,
                        cell="gru", init_cell=None, main_program=None,
                        startup_program=None):
    """Fused beam-search generation (see ops/control_flow_ops.py
    beam_search_decoder for semantics and reference citations).

    cell_params = (weight_x, weight_h, bias_or_None);
    out_params = (weight_out, bias_or_None).
    Returns (ids [b, beam, max_len], scores [b, beam], lengths [b, beam]).
    """
    helper = LayerHelper("beam_search_decoder", main_program=main_program,
                         startup_program=startup_program)
    wx, wh, bias = cell_params
    w_out, b_out = out_params
    ins = {"InitState": [init_state], "Embedding": [embedding_param],
           "WeightX": [wx], "WeightH": [wh], "WeightOut": [w_out]}
    if bias is not None:
        ins["Bias"] = [bias]
    if b_out is not None:
        ins["OutBias"] = [b_out]
    if init_cell is not None:
        ins["InitCell"] = [init_cell]
    outs, _ = helper.append_op(
        "beam_search_decoder", ins, ["Ids", "SeqScores", "SeqLen"],
        {"beam_size": beam_size, "max_len": max_len, "bos_id": bos_id,
         "eos_id": eos_id, "cell": cell})
    return outs["Ids"][0], outs["SeqScores"][0], outs["SeqLen"][0]


def array_length(array, main_program=None, startup_program=None):
    """Length of a functional LoDTensorArray (fluid control_flow.py
    array_length): the [max_len, ...] buffer's leading extent, as a
    [1] int64 constant."""
    from . import tensor as tensor_layers

    return tensor_layers.fill_constant(
        shape=[1], value=int(array.shape[0]), dtype="int64",
        main_program=main_program, startup_program=startup_program)


class DynamicRNN(StaticRNN):
    """fluid DynamicRNN: user-defined recurrence over variable-length
    sequences. The reference sorts rows by length through a
    lod_rank_table and shrinks the batch as sequences end; here it is
    StaticRNN whose loop carries each row's state through unchanged past
    its length (the static_rnn op masks on Length).

    API differences served: ``block()`` (the fluid name for the step
    context) and ``memory(init=... | shape/value zeros-boot)``.
    """

    def block(self):
        return self.step()

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               **kw):
        if init is None:
            if not self.seq_vars:
                raise ValueError(
                    "DynamicRNN.memory(shape=...) needs a step_input "
                    "first (the zeros boot sizes its batch from it)")
            from . import tensor as tensor_layers

            prog = self.helper.main_program
            cur = prog.current_block_idx
            prog.current_block_idx = prog.blocks[cur].parent_idx
            try:
                init = tensor_layers.fill_constant_batch_size_like(
                    input=self.seq_vars[0],
                    shape=[-1] + list(shape or []), value=value,
                    dtype=dtype)
            finally:
                prog.current_block_idx = cur
        return super().memory(init)


def beam_search_decode(ids, scores, main_program=None,
                       startup_program=None):
    """fluid's beam_search_decode converts the While-loop beam arrays
    (LoDTensorArray ids/scores) into final sequences — machinery the
    fused in-graph decoder makes unnecessary."""
    raise NotImplementedError(
        "beam_search_decode (array-to-tensor conversion for the "
        "While-loop beam) is served by the fused in-graph decoders, "
        "which return finished sequences directly: "
        "layers.beam_search_decoder / models.transformer_lm_beam_search")
