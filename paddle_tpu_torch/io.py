"""Checkpoint and inference-model persistence.

Counterpart of ``paddle_tpu/io.py``, with its on-disk format, so a model
saved by either package loads in the other: ``__model__.json`` holds the
program (``program_to_dict``, the JSON form of the IR) with its feed and
fetch names, and ``params/`` holds ``MANIFEST.json`` plus one ``.npy``
per persistable variable. Persistence is a host-side operation on the
scope (device to host copy, numpy files), as in the JAX package.

Loading accepts both packages' artefacts: the JAX package without
``jax_enable_x64`` writes int64 variables as int32, and its ops carry
``_``-prefixed call-site attrs; both are read as written, and a round
trip keeps every attr. ``quantize_inference_model`` and
``transpile_saved_model`` are later pieces of the port (they raise,
naming ``ROADMAP.md``).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core.program import (Block, Operator, Parameter, Program, Variable,
                           default_main_program)
from .core.scope import Scope, global_scope
from .core.types import dtype_name

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "read_inference_model_meta",
    "program_to_dict", "program_from_dict", "prune_program",
    "transpile_saved_model", "quantize_inference_model",
]

# the JAX package's cold-start manifest: a re-saved artefact drops it
_WARMUP_MANIFEST = "warmup_manifest.json"


# --------------------------------------------------------------------------
# Program (de)serialisation
# --------------------------------------------------------------------------
def program_to_dict(program: Program) -> dict:
    blocks = []
    for b in program.blocks:
        blocks.append({
            "idx": b.idx,
            "parent_idx": b.parent_idx,
            "vars": [
                {
                    "name": v.name,
                    "shape": list(v.shape) if v.shape is not None else None,
                    "dtype": dtype_name(v.dtype),
                    "persistable": v.persistable,
                    "stop_gradient": v.stop_gradient,
                    "lod_level": v.lod_level,
                    "is_data": v.is_data,
                    "is_parameter": isinstance(v, Parameter),
                }
                for v in b.vars.values()
            ],
            "ops": [
                {"type": op.type, "inputs": op.inputs, "outputs": op.outputs,
                 "attrs": op.attrs}
                for op in b.ops
            ],
        })
    return {"blocks": blocks, "version": 1}


def program_from_dict(d: dict) -> Program:
    p = Program()
    p.blocks = []
    for bd in d["blocks"]:
        b = Block(p, bd["idx"], bd["parent_idx"])
        for vd in bd["vars"]:
            cls = Parameter if vd.get("is_parameter") else Variable
            v = cls(b, vd["name"], shape=vd["shape"], dtype=vd["dtype"],
                    persistable=vd["persistable"],
                    stop_gradient=vd["stop_gradient"],
                    lod_level=vd.get("lod_level", 0),
                    is_data=vd.get("is_data", False))
            b.vars[vd["name"]] = v
        for od in bd["ops"]:
            b.ops.append(Operator(b, od["type"], od["inputs"], od["outputs"],
                                  od["attrs"]))
        p.blocks.append(b)
    return p


# --------------------------------------------------------------------------
# Variable persistence
# --------------------------------------------------------------------------
def _is_persistable(v: Variable) -> bool:
    return v.persistable


def _is_parameter(v: Variable) -> bool:
    return isinstance(v, Parameter)


# The dtypes numpy has no name for, by the names ml_dtypes gives them (the
# manifest's "dtype"), each with the integer type of its bit view: they go
# to disk as that view, as the JAX package stores ml_dtypes arrays.
_BIT_VIEW_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
    "float8_e4m3fnuz": (torch.float8_e4m3fnuz, torch.uint8, np.uint8),
    "float8_e5m2fnuz": (torch.float8_e5m2fnuz, torch.uint8, np.uint8),
}
_BIT_VIEW_NAMES = {d: name for name, (d, _, _) in _BIT_VIEW_DTYPES.items()}


def _to_numpy(value):
    """(array, logical dtype or None): a bf16 or fp8 tensor goes to disk
    as its unsigned integer bit view with the dtype's name in the
    manifest."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        name = _BIT_VIEW_NAMES.get(t.dtype)
        if name is not None:
            _, view, np_view = _BIT_VIEW_DTYPES[name]
            return t.view(view).numpy().view(np_view), name
        return t.numpy(), None
    return np.asarray(value), None


def _from_numpy(arr: np.ndarray, logical: Optional[str], device):
    if logical:
        if logical not in _BIT_VIEW_DTYPES:
            raise NotImplementedError(
                f"saved dtype {logical!r} has no torch counterpart in "
                f"paddle_tpu_torch (it reads {sorted(_BIT_VIEW_DTYPES)})")
        dtype, view, np_view = _BIT_VIEW_DTYPES[logical]
        bits = np.ascontiguousarray(arr).view(np_view)
        if view == torch.int16:  # torch has no uint16 view
            bits = bits.view(np.int16)
        return torch.from_numpy(bits).view(dtype).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _executor_device(executor):
    return getattr(executor, "device", None) or torch.device("cpu")


def save_vars(executor, dirname: str, main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None, predicate=None,
              scope: Optional[Scope] = None):
    """Save selected scope variables to ``dirname``: one .npy per var and
    a ``MANIFEST.json`` naming each file."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars() if predicate(v)]
    os.makedirs(dirname, exist_ok=True)
    manifest = []
    for v in vars:
        if not scope.has(v.name):
            continue
        arr, logical = _to_numpy(scope.get(v.name))
        fname = v.name.replace("/", "__")
        entry = {"name": v.name, "file": fname + ".npy"}
        if logical:
            entry["dtype"] = logical
        np.save(os.path.join(dirname, fname + ".npy"), arr)
        manifest.append(entry)
    with open(os.path.join(dirname, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def save_params(executor, dirname, main_program=None, scope=None):
    return save_vars(executor, dirname, main_program, None, _is_parameter,
                     scope)


def save_persistables(executor, dirname, main_program=None, scope=None):
    return save_vars(executor, dirname, main_program, None, _is_persistable,
                     scope)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              scope=None):
    """Load the saved values of the selected variables into ``scope``, as
    tensors on the executor's device (the CPU without an executor)."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars() if predicate(v)]
    with open(os.path.join(dirname, "MANIFEST.json")) as f:
        manifest = {e["name"]: e for e in json.load(f)}
    device = _executor_device(executor)
    for v in vars:
        if v.name not in manifest:
            continue
        entry = manifest[v.name]
        arr = np.load(os.path.join(dirname, entry["file"]))
        scope.set(v.name, _from_numpy(arr, entry.get("dtype"), device))


def load_params(executor, dirname, main_program=None, scope=None):
    return load_vars(executor, dirname, main_program, None, _is_parameter,
                     scope)


def load_persistables(executor, dirname, main_program=None, scope=None):
    return load_vars(executor, dirname, main_program, None, _is_persistable,
                     scope)


# --------------------------------------------------------------------------
# Inference model: program pruning + save
# --------------------------------------------------------------------------
def prune_program(program: Program, feed_names: List[str],
                  fetch_names: List[str], for_test: bool = True) -> Program:
    """Slice a clone of ``program`` to the subgraph producing
    ``fetch_names`` from ``feed_names``: the transpiler's
    ``prune_pipeline`` (flatten recompute segments, ``is_test`` when
    ``for_test``, dead-op elimination)."""
    from .transpiler import prune_pipeline

    return prune_pipeline(for_test=for_test).run(
        program.clone(), feed_names, fetch_names)


def save_inference_model(dirname: str, feeded_var_names: List[str],
                         target_vars: List[Variable], executor,
                         main_program: Optional[Program] = None, scope=None,
                         transpile: bool = True):
    """Prune to the inference subgraph, run the transpiler's inference
    pipeline (``transpile=False`` keeps the plain prune), and write the
    program and its persistable values to ``dirname``. Passes that
    rewrite weights write new names into a child scope: the caller's
    scope is never changed. Under ``--verify_program`` the pipelines
    raise (the analysis plane is not ported)."""
    program = main_program or default_main_program()
    fetch_names = [v.name if hasattr(v, "name") else v for v in target_vars]
    pruned = prune_program(program, feeded_var_names, fetch_names)
    save_scope = scope or global_scope()
    if transpile:
        from .transpiler import inference_pipeline

        work_scope = Scope(parent=save_scope)
        pruned = inference_pipeline().run(
            pruned, feeded_var_names, fetch_names, scope=work_scope)
        save_scope = work_scope
    os.makedirs(dirname, exist_ok=True)
    try:
        os.remove(os.path.join(dirname, _WARMUP_MANIFEST))
    except OSError:
        pass
    with open(os.path.join(dirname, "__model__.json"), "w") as f:
        json.dump({
            "program": program_to_dict(pruned),
            "feed_names": feeded_var_names,
            "fetch_names": fetch_names,
        }, f)
    save_vars(executor, os.path.join(dirname, "params"),
              main_program=pruned, predicate=_is_persistable,
              scope=save_scope)


def transpile_saved_model(dirname: str, out_dirname: str, pipeline=None):
    """Not ported: the deployment pipeline (fused ops lowered back to
    plain convs) comes with int8 quantization."""
    raise NotImplementedError(
        "transpile_saved_model (the deployment pipeline) is not ported to "
        "paddle_tpu_torch; see ROADMAP.md Queue 1 item 9")


def quantize_inference_model(dirname: str, out_dirname: str,
                             min_elems: int = 1024,
                             transpile: bool = True) -> List[str]:
    """Not ported: int8 weight quantization serves the native C machine,
    which the port does not have."""
    raise NotImplementedError(
        "quantize_inference_model is not ported to paddle_tpu_torch; see "
        "ROADMAP.md Queue 1 item 9")


def read_inference_model_meta(dirname: str) -> dict:
    """A saved model's ``{"program", "feed_names", "fetch_names"}``,
    without loading its parameters."""
    with open(os.path.join(dirname, "__model__.json")) as f:
        return json.load(f)


def load_inference_model(dirname: str, executor, scope=None):
    """Returns (program, feed_names, fetch_names); the persistable values
    are loaded into ``scope`` on the executor's device."""
    payload = read_inference_model_meta(dirname)
    program = program_from_dict(payload["program"])
    load_vars(executor, os.path.join(dirname, "params"),
              main_program=program, predicate=_is_persistable, scope=scope)
    return program, payload["feed_names"], payload["fetch_names"]
