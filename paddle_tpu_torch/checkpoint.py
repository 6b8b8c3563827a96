"""Checkpoint/resume: atomic, self-describing training snapshots.

Counterpart of ``paddle_tpu/checkpoint.py``, in its file format, so a
checkpoint moves between the two packages in both directions:

- ``ckpt-<step>.npz`` holds every scope value under its name, written to
  a temporary file and atomically renamed. A ``__dtypes__`` record (JSON
  bytes) names each value's dtype; bf16 values are stored as their
  uint16 bits. The RNG key (``RNG_VAR``) is a uint32 [2] array, as the
  JAX package keeps it; the port carries it as a pair of int64 tensors
  holding uint32 values (``core/prng.py``) and restores that form bit
  for bit.
- ``ckpt-<step>.json`` (md5, timestamp, ``extra`` position) beside each
  payload, and ``checkpoint.meta`` naming the latest, so a torn latest
  falls back to the newest older intact checkpoint (``_candidates``,
  ``_looks_intact``).
- ``max_keep`` retention, which always keeps the newest checkpoint and a
  generation pinned with ``pin_generation``.

A checkpoint captures everything in the scope (parameters, optimizer
slots, the RNG key), so resume is bit-exact. One process only: sharded
per-process sidecars (``ckpt-<step>.shard<i>.npz``) and the barrier
between processes raise, citing ROADMAP.md Queue 1 item 10. The JAX
package's ``save_manifest``/``load_manifest`` store XLA compile
signatures, which the eager port does not have (item 9).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from .core.program import RNG_VAR
from .core.scope import global_scope

META_NAME = "checkpoint.meta"
PIN_NAME = "publisher.pin"


def pin_generation(dirname: str, step: Optional[int]) -> None:
    """Pin generation ``step`` against retention GC. ``step=None``
    removes the pin. Atomic."""
    path = os.path.join(dirname, PIN_NAME)
    if step is None:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
        return
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"step": int(step)}, f)
    os.replace(tmp, path)


def pinned_step(dirname: str) -> Optional[int]:
    """The GC-pinned generation step, or None."""
    try:
        with open(os.path.join(dirname, PIN_NAME)) as f:
            return int(json.load(f)["step"])
    except (FileNotFoundError, ValueError, KeyError,
            json.JSONDecodeError):
        return None


def _one_process(what: str) -> None:
    """Raise inside a torch.distributed group of more than one process:
    per-process shards are not ported."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} across {dist.get_world_size()} processes is not "
            "ported to paddle_tpu_torch: per-process shard sidecars land "
            "with the parallel plane, ROADMAP.md Queue 1 item 10")


def _host_array(name: str, value) -> Tuple[np.ndarray, str]:
    """(the array the file holds, its dtype's name) for a scope value:
    the RNG key as uint32 [2]; bf16 as its uint16 bits (``io.py``'s
    saved-model convention, the JAX package's ``_store``)."""
    from .io import _to_numpy

    if name == RNG_VAR and isinstance(value, (tuple, list)):
        return np.asarray([int(k) for k in value], dtype=np.uint32), "uint32"
    arr, logical = _to_numpy(value)
    return arr, logical or str(arr.dtype)


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_checkpoint(dirname: str, scope=None, step: int = 0,
                    max_keep: int = 3, extra: Optional[dict] = None) -> str:
    """Snapshot the whole scope (any object with ``keys()``/``get()``)
    into ``dirname``; returns the payload path."""
    _one_process("save_checkpoint")
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrays, dtypes = {}, {}
    for name in scope.keys():
        arrays[name], dtypes[name] = _host_array(name, scope.get(name))
    payload = os.path.join(dirname, f"ckpt-{step}.npz")
    arrays["__dtypes__"] = np.frombuffer(
        json.dumps(dtypes).encode(), dtype=np.uint8)
    tmp = payload + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, payload)  # atomic

    step_meta = {
        "step": step,
        "md5": _md5(payload),
        "timestamp": time.time(),
        "shard_files": 0,
        "shard_values": [],
        "extra": extra or {},
    }
    # per-step meta sidecar (ckpt-N.json): the torn-latest fallback needs
    # integrity and resume position for older steps too
    sj_tmp = payload[:-4] + f".json.tmp{os.getpid()}"
    with open(sj_tmp, "w") as f:
        json.dump(step_meta, f)
    os.replace(sj_tmp, payload[:-4] + ".json")
    meta = {"latest": os.path.basename(payload), **step_meta}
    meta_tmp = os.path.join(dirname, META_NAME + f".tmp{os.getpid()}")
    with open(meta_tmp, "w") as f:
        json.dump(meta, f)
    os.replace(meta_tmp, os.path.join(dirname, META_NAME))

    # prune: keep the newest max_keep by step, the one just written (what
    # meta['latest'] points to) and the pinned generation
    cks = sorted(
        (p for p in os.listdir(dirname)
         if p.startswith("ckpt-") and p.endswith(".npz")
         and ".shard" not in p),
        key=lambda p: int(p[5:-4]))
    keep = max(int(max_keep), 1)
    keep_set = set(cks[max(len(cks) - keep, 0):]) | {os.path.basename(payload)}
    pin = pinned_step(dirname)
    if pin is not None:
        keep_set.add(f"ckpt-{pin}.npz")
    for old in cks:
        if old not in keep_set:
            os.remove(os.path.join(dirname, old))
            sidecar = os.path.join(dirname, old[:-4] + ".json")
            if os.path.exists(sidecar):
                os.remove(sidecar)
    return payload


def _step_of(payload_name: str) -> int:
    return int(payload_name[5:-4])  # "ckpt-<step>.npz"


def _step_info(dirname: str, payload_name: str) -> Optional[dict]:
    """The per-step meta sidecar, or None for checkpoints without one."""
    try:
        with open(os.path.join(dirname, payload_name[:-4] + ".json")) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def generation_info(dirname: str, step: int) -> Optional[dict]:
    """Public view of one generation's per-step meta (md5, timestamp,
    ``extra``), or None when the step has no sidecar."""
    return _step_info(dirname, f"ckpt-{int(step)}.npz")


def _candidates(dirname: str, meta: dict) -> List[str]:
    """Payload names to try, newest-first: the meta's latest, then every
    OLDER step (a leftover higher-step file from an abandoned longer run
    is not a fallback target)."""
    latest = meta["latest"]
    latest_step_no = _step_of(latest)
    older = sorted(
        (p for p in os.listdir(dirname)
         if p.startswith("ckpt-") and p.endswith(".npz")
         and ".shard" not in p and p != latest
         and _step_of(p) < latest_step_no),
        key=_step_of, reverse=True)
    return [latest] + older


def _from_file(name: str, arr: np.ndarray, want: Optional[str], device):
    """A stored array as the port's scope value on ``device``: the RNG
    key as a pair of int64 tensors, the rest as ``io.py`` loads it."""
    from .io import _from_numpy

    if name == RNG_VAR:
        return tuple(torch.tensor(int(k), dtype=torch.int64, device=device)
                     for k in np.asarray(arr).astype(np.uint32).reshape(-1))
    return _from_numpy(arr, want if want and want != str(arr.dtype)
                       else None, device)


def _restore_payload(dirname: str, payload_name: str, stage: dict,
                     verify: bool, expect_md5: Optional[str],
                     expect_files, device) -> None:
    """Verify and load one payload into ``stage`` (name -> value).
    Raises on any integrity problem."""
    import glob

    payload = os.path.join(dirname, payload_name)
    if expect_files or glob.glob(os.path.join(
            dirname, payload_name[:-4] + ".shard*.npz")):
        raise NotImplementedError(
            f"checkpoint {payload} has per-process shard sidecars, which "
            "paddle_tpu_torch does not read yet: they land with the "
            "parallel plane, ROADMAP.md Queue 1 item 10")
    if verify and expect_md5 is not None and _md5(payload) != expect_md5:
        raise ValueError(f"checkpoint {payload} md5 mismatch (corrupt)")
    with np.load(payload) as data:
        dtypes = {}
        if "__dtypes__" in data.files:
            dtypes = json.loads(bytes(data["__dtypes__"]).decode())
        for key in data.files:
            if key != "__dtypes__":
                stage[key] = _from_file(key, data[key], dtypes.get(key),
                                        device)


def load_checkpoint(dirname: str, scope=None, verify: bool = True,
                    strict: bool = False, plan=None,
                    device=None) -> dict:
    """Restore the latest *intact* checkpoint into the scope, its tensors
    on ``device`` (``cuda`` by default, raising without it); returns its
    meta dict. Raises FileNotFoundError if none exists.

    When the latest checkpoint is torn (md5 mismatch, unreadable npz),
    the default walks BACK to the newest older intact ``ckpt-*.npz``,
    warning and recording ``fallback``/``fallback_from``/
    ``fallback_errors`` in the returned meta. ``strict=True`` raises
    instead. If no intact checkpoint remains, the latest's error is
    raised either way. A restore stages every value first, so the scope
    is never left half-written. ``plan`` (resharding on restore) is the
    parallel plane's and raises."""
    from . import resolve_device

    if plan is not None:
        raise NotImplementedError(
            "load_checkpoint(plan=...) reshards onto a mesh, which is not "
            "ported to paddle_tpu_torch: ROADMAP.md Queue 1 item 10")
    _one_process("load_checkpoint")
    device = resolve_device(device)
    scope = scope or global_scope()
    meta_path = os.path.join(dirname, META_NAME)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no checkpoint meta in {dirname}")
    with open(meta_path) as f:
        meta = json.load(f)
    errors: List[Tuple[str, BaseException]] = []
    for payload_name in _candidates(dirname, meta):
        is_latest = payload_name == meta["latest"]
        info = meta if is_latest else _step_info(dirname, payload_name)
        stage: dict = {}
        try:
            _restore_payload(
                dirname, payload_name, stage, verify,
                expect_md5=(info or {}).get("md5"),
                expect_files=(info or {}).get("shard_files"),
                device=device)
        except NotImplementedError:
            raise
        except Exception as exc:  # noqa: BLE001 - walk back per candidate
            errors.append((payload_name, exc))
            if strict:
                raise
            continue
        for name, value in stage.items():
            scope.set(name, value)
        if is_latest:
            return meta
        out = dict(info or {})
        out.setdefault("step", _step_of(payload_name))
        out.setdefault("extra", {})
        out["latest"] = payload_name
        out["fallback"] = True
        out["fallback_from"] = meta["latest"]
        out["fallback_errors"] = [f"{n}: {e}" for n, e in errors]
        warnings.warn(
            f"checkpoint {meta['latest']} in {dirname} is not usable "
            f"({errors[0][1]}); fell back to intact {payload_name} "
            f"(step {out['step']})", RuntimeWarning, stacklevel=2)
        return out
    raise errors[0][1]


def _looks_intact(dirname: str, payload_name: str,
                  expect_md5: Optional[str]) -> bool:
    """Cheap integrity probe: md5 when the per-step sidecar recorded one,
    else an npz directory read (a truncated zip fails to open)."""
    payload = os.path.join(dirname, payload_name)
    try:
        if expect_md5 is not None:
            return _md5(payload) == expect_md5
        with np.load(payload) as data:
            list(data.files)
        return True
    except Exception:  # noqa: BLE001 - any failure means not intact
        return False


def latest_step(dirname: str, verify: bool = True) -> Optional[int]:
    """The step of the latest INTACT checkpoint, or None. A torn latest
    is skipped the same way ``load_checkpoint`` falls back; pass
    ``verify=False`` for the raw meta value."""
    try:
        with open(os.path.join(dirname, META_NAME)) as f:
            meta = json.load(f)
        if not verify:
            return meta["step"]
        for payload_name in _candidates(dirname, meta):
            is_latest = payload_name == meta["latest"]
            info = meta if is_latest else _step_info(dirname, payload_name)
            if not verify or _looks_intact(dirname, payload_name,
                                           (info or {}).get("md5")):
                return meta["step"] if is_latest else _step_of(payload_name)
        return None
    except (FileNotFoundError, KeyError, json.JSONDecodeError, ValueError):
        return None
