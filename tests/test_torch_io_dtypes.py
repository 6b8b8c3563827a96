"""Saved parameters of the dtypes numpy has no name for (bf16 and the
four fp8 types) between the JAX package and the port, both ways, bit for
bit: the JAX package writes their integer bit view with the ml_dtypes
name in ``MANIFEST.json`` (``paddle_tpu/io.py``), and the port reads and
writes the same without ml_dtypes (``paddle_tpu_torch/io.py``). Every
bit pattern of a 1-byte type goes through, NaNs included.

One exception, the JAX package's: ml_dtypes gives ``float8_e5m2`` the
dtype kind "f", so ``paddle_tpu/io.py`` saves it as a plain ``<f1``
array with no manifest dtype, which numpy (the JAX package's own
``load_params`` too) cannot read back. The port writes it as its bit
view, which both packages load."""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt

torch.set_num_threads(1)
DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
          "float8_e5m2fnuz")


def _program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[16])
        pkg.layers.fc(x, size=16, param_attr=pkg.ParamAttr(name="w"),
                      bias_attr=pkg.ParamAttr(name="b"))
    return main


def _bits(name, seed):
    """Every bit pattern of a 1-byte type (and more), or random bf16 bits,
    as the type's integer view, shaped [16, 16] and [16]."""
    rng = np.random.RandomState(seed)
    if name == "bfloat16":
        w = rng.randint(0, 2**16, size=256, dtype=np.uint16)
        b = rng.randint(0, 2**16, size=16, dtype=np.uint16)
    else:
        w = np.arange(256, dtype=np.uint8)
        b = rng.randint(0, 256, size=16).astype(np.uint8)
    return w.reshape(16, 16), b


def _torch_dtype(name):
    return getattr(torch, name)


def _torch_bits(t):
    view = torch.int16 if t.dtype == torch.bfloat16 else torch.uint8
    out = t.view(view).numpy()
    return out.view(np.uint16) if view == torch.int16 else out


@pytest.mark.parametrize("name", [n for n in DTYPES if n != "float8_e5m2"])
def test_saved_by_jax_loads_in_the_port(name, tmp_path):
    w, b = _bits(name, 0)
    dt = np.dtype(getattr(ml_dtypes, name))
    jmain = _program(jpt)
    jscope = jpt.Scope()
    jscope.set("w", jnp.asarray(w.view(dt)))
    jscope.set("b", jnp.asarray(b.view(dt)))
    jpt.io.save_params(None, str(tmp_path), main_program=jmain, scope=jscope)
    manifest = json.load(open(os.path.join(tmp_path, "MANIFEST.json")))
    assert {e["dtype"] for e in manifest} == {name}
    tscope = tpt.Scope()
    tpt.io.load_params(tpt.Executor(tpt.CPUPlace()), str(tmp_path),
                       main_program=_program(tpt), scope=tscope)
    for key, want in (("w", w), ("b", b)):
        got = tscope.get(key)
        assert got.dtype == _torch_dtype(name)
        np.testing.assert_array_equal(_torch_bits(got), want)


@pytest.mark.parametrize("name", DTYPES)
def test_saved_by_the_port_loads_in_jax(name, tmp_path):
    w, b = _bits(name, 1)
    tscope = tpt.Scope()
    view = torch.int16 if name == "bfloat16" else torch.uint8
    for key, bits in (("w", w), ("b", b)):
        src = bits.view(np.int16) if view == torch.int16 else bits
        tscope.set(key, torch.from_numpy(src.copy()).view(
            _torch_dtype(name)))
    tpt.io.save_params(None, str(tmp_path), main_program=_program(tpt),
                       scope=tscope)
    jscope = jpt.Scope()
    jpt.io.load_params(None, str(tmp_path), main_program=_program(jpt),
                       scope=jscope)
    for key, want in (("w", w), ("b", b)):
        got = np.asarray(jscope.get(key))
        assert got.dtype == np.dtype(getattr(ml_dtypes, name))
        np.testing.assert_array_equal(got.view(want.dtype), want)
    # and back into the port, unchanged
    again = tpt.Scope()
    tpt.io.load_params(None, str(tmp_path), main_program=_program(tpt),
                       scope=again)
    assert torch.equal(again.get("w").view(view), tscope.get("w").view(view))


def test_jax_saves_float8_e5m2_as_an_unreadable_array(tmp_path):
    w, b = _bits("float8_e5m2", 0)
    dt = np.dtype(ml_dtypes.float8_e5m2)
    jscope = jpt.Scope()
    jscope.set("w", jnp.asarray(w.view(dt)))
    jscope.set("b", jnp.asarray(b.view(dt)))
    jpt.io.save_params(None, str(tmp_path), main_program=_program(jpt),
                       scope=jscope)
    manifest = json.load(open(os.path.join(tmp_path, "MANIFEST.json")))
    assert all("dtype" not in e for e in manifest)
    for pkg in (jpt, tpt):
        with pytest.raises(ValueError, match="<f1"):
            pkg.io.load_params(None, str(tmp_path),
                               main_program=_program(pkg), scope=pkg.Scope())


def test_other_saved_dtypes_raise_naming_them(tmp_path):
    np.save(os.path.join(tmp_path, "w.npy"), np.zeros(4, np.uint8))
    with open(os.path.join(tmp_path, "MANIFEST.json"), "w") as f:
        json.dump([{"name": "w", "file": "w.npy", "dtype": "int4"}], f)
    with pytest.raises(NotImplementedError, match="'int4'"):
        tpt.io.load_params(None, str(tmp_path), main_program=_program(tpt),
                           scope=tpt.Scope())
