"""LayerHelper: shared machinery for layer functions.

Counterpart of ``paddle_tpu/layers/layer_helper.py``: creates parameters
(with startup-program init ops), creates shape-inferred temporary
variables, and appends ops. Build-time shape inference evaluates the op
functions on ``meta`` tensors (``core/registry.infer_outputs``), with
-1 (batch) dims standing in as ``BATCH_DIM_SENTINEL``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..core.enforce import EnforceError
from ..core.program import (BATCH_DIM_SENTINEL, Program, default_main_program,
                            default_startup_program)
from ..core.registry import infer_outputs
from ..core.types import dtype_name
from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr


def _abstract(var):
    shape = tuple(BATCH_DIM_SENTINEL if d == -1 else d
                  for d in (var.shape or ()))
    return torch.empty(shape, dtype=var.dtype, device="meta")


def _concrete_to_build_shape(shape):
    return tuple(-1 if d == BATCH_DIM_SENTINEL else d for d in shape)


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        self.main_program: Program = (kwargs.get("main_program")
                                      or default_main_program())
        self.startup_program: Program = (kwargs.get("startup_program")
                                         or default_startup_program())

    @property
    def block(self):
        return self.main_program.current_block()

    # -- parameters --------------------------------------------------------
    def create_parameter(self, attr, shape: Sequence[int], dtype,
                         is_bias: bool = False, default_initializer=None):
        attr = ParamAttr.to_attr(attr)
        if attr is None:
            return None
        name = attr.name or self.main_program.unique_name(
            self.layer_type + ".w")
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        block = self.main_program.global_block
        if name in block.vars:
            return block.vars[name]
        param = block.create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            initializer={"lr": attr.learning_rate,
                         "regularizer": attr.regularizer})
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        param.regularizer = attr.regularizer
        param.gradient_clip = attr.gradient_clip
        param.update_hooks = list(attr.update_hooks)
        # mirror into the startup program with its init op
        sb = self.startup_program.global_block
        sv = sb.create_var(name=name, shape=shape, dtype=dtype,
                           persistable=True)
        init(sv, sb)
        return param

    # -- variables ---------------------------------------------------------
    def create_tmp_variable(self, dtype, shape=None, stop_gradient=False):
        return self.block.create_var(
            name=self.main_program.unique_name(self.layer_type + ".tmp"),
            dtype=dtype, shape=shape, stop_gradient=stop_gradient)

    def create_global_variable(self, name=None, shape=None, dtype="float32",
                               persistable=True):
        return self.main_program.global_block.create_var(
            name=name or self.main_program.unique_name(
                self.layer_type + ".gv"),
            shape=shape, dtype=dtype, persistable=persistable)

    # -- op + shape-inferred outputs ---------------------------------------
    def append_op(self, op_type: str, inputs: Dict[str, list], outputs,
                  attrs: Optional[dict] = None):
        """Append an op; ``outputs`` maps slot -> list of Variables (or is
        a list of slot names to auto-create shape-inferred tmp vars)."""
        attrs = attrs or {}
        in_names = {
            slot: [v.name if hasattr(v, "name") else str(v) for v in vs]
            for slot, vs in inputs.items() if vs
        }
        if isinstance(outputs, (list, tuple)):
            out_slots = list(outputs)
            for names in in_names.values():
                for n in names:
                    if not self.block.has_var(n):
                        raise EnforceError(
                            f"layer {self.layer_type!r}: input {n!r} is not "
                            "defined in the current program (layers must be "
                            "called inside the program_guard that owns "
                            "their inputs)")
            abstract_ins = {
                slot: [_abstract(self.block.var(n)) for n in names]
                for slot, names in in_names.items()
            }
            try:
                inferred = infer_outputs(op_type, attrs, abstract_ins)
            except EnforceError:
                raise
            except Exception as exc:
                shapes = {
                    slot: [f"{dtype_name(a.dtype)}"
                           f"{list(_concrete_to_build_shape(a.shape))}"
                           for a in arrs]
                    for slot, arrs in abstract_ins.items()}
                raise EnforceError(
                    f"op {op_type!r} shape inference failed\n"
                    f"  inputs: {shapes}\n"
                    f"  cause: {type(exc).__name__}: {exc}") from exc
            outputs = {}
            for slot in out_slots:
                vars_for_slot = []
                for t in inferred.get(slot, []):
                    v = self.block.create_var(
                        name=self.main_program.unique_name(
                            f"{self.layer_type}.{slot.lower()}"),
                        shape=_concrete_to_build_shape(t.shape),
                        dtype=t.dtype)
                    vars_for_slot.append(v)
                outputs[slot] = vars_for_slot
        out_names = {
            slot: [v.name if hasattr(v, "name") else str(v) for v in vs]
            for slot, vs in outputs.items() if vs
        }
        self.block.append_op(op_type, inputs=in_names, outputs=out_names,
                             attrs=attrs)
        flat = [v for slot in sorted(outputs) for v in outputs[slot]]
        return outputs, flat

    def simple_op(self, op_type: str, inputs: Dict[str, list], attrs=None,
                  out_slot: str = "Out"):
        """Common case: one auto-created output variable in ``out_slot``."""
        outputs, _ = self.append_op(op_type, inputs, [out_slot], attrs)
        result = outputs[out_slot][0]
        # thread sequence lengths through shape-preserving ops
        for vs in inputs.values():
            for v in vs:
                sl = getattr(v, "seq_len", None)
                if (sl is not None and result.shape is not None
                        and v.shape is not None
                        and result.shape[:2] == v.shape[:2]):
                    result.seq_len = sl
                    return result
        return result

    def append_activation(self, var, act: Optional[str]):
        if act is None:
            return var
        if isinstance(act, dict):
            act_type = act.pop("type")
            attrs = act
        else:
            act_type, attrs = act, {}
        helper = LayerHelper(act_type, main_program=self.main_program,
                             startup_program=self.startup_program)
        return helper.simple_op(act_type, {"X": [var]}, attrs)

    def append_bias_op(self, var, bias_attr, size, dim_start=1):
        attr = (ParamAttr.to_attr(bias_attr) if bias_attr is not False
                else None)
        if attr is None:
            return var
        b = self.create_parameter(attr, shape=[size], dtype=var.dtype,
                                  is_bias=True)
        return self.simple_op("elementwise_add", {"X": [var], "Y": [b]},
                              {"axis": dim_start})
