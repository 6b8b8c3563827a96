"""Program IR: Program / Block / Operator / Variable.

Counterpart of ``paddle_tpu/core/program.py``: the same graph-capture
structure (a program is a list of blocks; a block is an ordered list of
ops plus a symbol table of variables), with torch dtypes. Each op type
names a torch function in the port's registry (``core/registry.py``);
the executor (``core/executor.py``) interprets the block op by op.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .types import VarType, dtype_name, to_dtype

# Stands in for the -1 (unknown batch) dim during build-time shape
# inference; the executor concretises shapes from the actual feeds.
BATCH_DIM_SENTINEL = 1297

# Name under which the executor keeps the scope's threefry key.
RNG_VAR = "@RNG_STATE@"

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Variable:
    """A named tensor slot in a Block: build-time shape and dtype only;
    values live in a Scope at run time. ``shape`` may use -1 for the
    batch dimension."""

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        var_type: VarType = VarType.DENSE_TENSOR,
        lod_level: int = 0,
        is_data: bool = False,
        trainable: bool = True,
        initializer: Optional[dict] = None,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(d) for d in shape) if shape is not None else None
        self.dtype = to_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = var_type
        self.lod_level = lod_level
        self.is_data = is_data
        self.trainable = trainable
        self.initializer = initializer
        self.is_parameter = False

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={dtype_name(self.dtype)}, "
                f"persistable={self.persistable})")


class Parameter(Variable):
    """A trainable persistable variable."""

    def __init__(self, block, name, **kw):
        kw.setdefault("persistable", True)
        super().__init__(block, name, **kw)
        self.is_parameter = True


class Operator:
    """One operation: type + named input/output slots + attrs. Inputs and
    outputs are ``slot -> [var names]`` multimaps."""

    def __init__(self, block: "Block", op_type: str,
                 inputs: Dict[str, List[str]],
                 outputs: Dict[str, List[str]],
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = op_type
        self.inputs = {k: list(v) for k, v in inputs.items()}
        self.outputs = {k: list(v) for k, v in outputs.items()}
        self.attrs = dict(attrs or {})

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    # -- single-name slot accessors (pattern matching) ----------------------
    def input(self, slot: str) -> Optional[str]:
        """The single var name in an input slot, or None when the slot is
        absent or empty; raises on a multi-name slot."""
        names = self.inputs.get(slot) or []
        if len(names) > 1:
            raise ValueError(
                f"op {self.type!r} input slot {slot!r} has {len(names)} "
                f"names; use .inputs[{slot!r}] for multi-arity slots")
        return names[0] if names else None

    def output(self, slot: str) -> Optional[str]:
        """Single-name accessor for an output slot (see ``input``)."""
        names = self.outputs.get(slot) or []
        if len(names) > 1:
            raise ValueError(
                f"op {self.type!r} output slot {slot!r} has {len(names)} "
                f"names; use .outputs[{slot!r}] for multi-arity slots")
        return names[0] if names else None

    def __repr__(self):
        return (f"Op({self.type}, inputs={self.inputs}, "
                f"outputs={self.outputs}, attrs={self.attrs})")


class Block:
    """An ordered list of ops plus a symbol table of variables."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, name: Optional[str] = None, **kw) -> Variable:
        if name is None:
            name = self.program.unique_name("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name: Optional[str] = None, **kw) -> Parameter:
        if name is None:
            name = self.program.unique_name("param")
        p = Parameter(self, name, **kw)
        self.vars[name] = p
        self.program._bump()
        return p

    def var(self, name: str) -> Variable:
        """Look up ``name`` here or in any ancestor block."""
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        raise KeyError(f"Variable {name!r} not found in block {self.idx} "
                       "or ancestors")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def append_op(self, op_type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        op = Operator(self, op_type, inputs or {}, outputs or {}, attrs)
        seg = self.program._recompute_seg
        if seg is not None:
            op.attrs.setdefault("__recompute_seg__", seg)
        self.ops.append(op)
        self.program._bump()
        return op

    def insert_op(self, index: int, op_type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        op = Operator(self, op_type, inputs or {}, outputs or {}, attrs)
        self.ops.insert(index, op)
        self.program._bump()
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- pattern-match / rewrite helpers (transpiler) ----------------------
    def var_producers(self) -> Dict[str, List[Tuple[int, Operator]]]:
        """name -> [(op index, op)] of every op writing that name, in
        program order (aliased state, such as batch_norm's MeanOut onto
        Mean, shows up as several producers)."""
        prod: Dict[str, List[Tuple[int, Operator]]] = {}
        for i, op in enumerate(self.ops):
            for name in op.output_names():
                prod.setdefault(name, []).append((i, op))
        return prod

    def var_consumers(self) -> Dict[str, List[Tuple[int, Operator]]]:
        """name -> [(op index, op)] of every op reading that name."""
        cons: Dict[str, List[Tuple[int, Operator]]] = {}
        for i, op in enumerate(self.ops):
            for name in dict.fromkeys(op.input_names()):
                cons.setdefault(name, []).append((i, op))
        return cons

    def sole_producer(self, name: str,
                      producers=None) -> Optional[Operator]:
        """The op producing ``name`` if exactly one op writes it."""
        ps = (producers if producers is not None
              else self.var_producers()).get(name, [])
        return ps[0][1] if len(ps) == 1 else None

    def replace_ops(self, old_ops: Sequence[Operator], op_type: str,
                    inputs=None, outputs=None, attrs=None) -> Operator:
        """Replace a matched op chain with one new op at the position of
        the last replaced op, so every input is still produced upstream
        and every consumer still reads downstream."""
        idxs = []
        for op in old_ops:
            for i, o in enumerate(self.ops):
                if o is op:
                    idxs.append(i)
                    break
            else:
                raise ValueError(f"op {op.type!r} not in block {self.idx}")
        at = max(idxs)
        new = Operator(self, op_type, inputs or {}, outputs or {}, attrs)
        self.ops[at] = new
        drop = set(idxs) - {at}
        self.ops = [o for i, o in enumerate(self.ops) if i not in drop]
        self.program._bump()
        return new

    def remove_ops(self, old_ops: Sequence[Operator]) -> None:
        olds = {id(op) for op in old_ops}
        self.ops = [o for o in self.ops if id(o) not in olds]
        self.program._bump()


class Program:
    """A list of blocks; block 0 is the global block."""

    _uid_counter = 0

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0  # bumped on every mutation
        self.random_seed: Optional[int] = None
        self._recompute_seg: Optional[int] = None  # active recompute_guard

    def _bump(self):
        self._version += 1

    @property
    def version(self) -> int:
        return self._version

    def unique_name(self, prefix: str) -> str:
        Program._uid_counter += 1
        return f"{prefix}_{Program._uid_counter}"

    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def all_parameters(self) -> List[Parameter]:
        return [v for b in self.blocks for v in b.vars.values()
                if isinstance(v, Parameter)]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep-ish copy (vars and ops re-created; attrs shallow-copied).
        ``for_test=True`` flips every op's ``is_test`` attr to True."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                cls = Parameter if isinstance(v, Parameter) else Variable
                nv = cls.__new__(cls)
                nv.__dict__.update(v.__dict__)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                attrs = dict(op.attrs)
                if for_test and "is_test" in attrs:
                    attrs["is_test"] = True
                nb.ops.append(Operator(nb, op.type, op.inputs, op.outputs,
                                       attrs))
            p.blocks.append(nb)
        p.current_block_idx = self.current_block_idx
        return p

    def __str__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"-- block {b.idx} (parent {b.parent_idx}) --")
            for v in b.vars.values():
                flag = "P" if v.persistable else " "
                lines.append(f"  var[{flag}] {v.name}: {v.shape} "
                             f"{dtype_name(v.dtype)}")
            for op in b.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


# --- default program management (fluid program guards) ---------------------
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


_recompute_seg_counter = 0


@contextlib.contextmanager
def recompute_guard(main_program: Optional[Program] = None):
    """Mark the ops built inside this scope as one recompute segment.

    ``append_backward`` differentiates a run of ops tagged with the same
    segment id as one ``seg_fwd`` op and its ``grad_seg`` op
    (``core/backward.py``): the forward keeps only the outputs of
    ``SEGMENT_SAVE_OPS`` ops (products, convolutions, pools) and tensors
    of at most one dim, and the backward recomputes the rest of the
    segment under autograd. Nested guards are not supported; an RNG op,
    a special op or an op with a custom ``grad_fn`` (unless
    ``grad_fn_is_optimization``) splits the segment and keeps its own
    gradient."""
    p = main_program or default_main_program()
    global _recompute_seg_counter
    _recompute_seg_counter += 1
    old = p._recompute_seg
    p._recompute_seg = _recompute_seg_counter
    try:
        yield
    finally:
        p._recompute_seg = old


def maybe_recompute(enabled: bool, main_program: Optional[Program] = None):
    """``recompute_guard`` when ``enabled``, else a no-op context: the
    helper model builders share, so the guard lands on the program the
    ops are appended to."""
    if enabled:
        return recompute_guard(main_program)
    return contextlib.nullcontext()


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    """Route layer construction into the given programs."""
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
