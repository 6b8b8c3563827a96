"""The port's saved-model format against the JAX package's.

The same builder yields an identical ``program_to_dict`` in both
packages (main and startup programs and the ``for_test`` clone; the
JAX ops' ``_callsite`` attrs dropped, int64 vars read as the int32 JAX
holds them as without x64). A model saved by JAX and loaded by the port,
and one saved by the port and loaded by JAX, give identical program
dicts (the port keeps every attr, ``_callsite`` included; the JAX loader
stamps its own ``_callsite`` where an op has none), bitwise-equal params
and logits within rtol 1e-4 / atol 1e-5, with and without the inference
transpiler. ``save_vars``/``load_vars`` and their variants round-trip
f32, int and bf16 values; the later pieces raise naming ``ROADMAP.md``.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_transpiler import (Pair, attention_net, fc_bn_dropout_net,
                                   program_dict, resnet_net)

torch.set_num_threads(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _lm(pt):
    ids = pt.layers.data("ids", shape=[16], dtype="int64")
    logits = pt.models.transformer_lm(ids, vocab_size=97, d_model=32,
                                      n_layers=2, num_heads=4, max_len=32,
                                      pipeline_stack=True)
    return {}, logits


@pytest.mark.parametrize("builder", [resnet_net, fc_bn_dropout_net,
                                     attention_net, _lm])
def test_same_builder_same_program_dict(builder):
    start = jprog.Program._uid_counter
    dicts = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            builder(pt)
        dicts.append([program_dict(pt, p) for p in
                      (main, startup, main.clone(for_test=True))])
    assert dicts[1] == dicts[0]


def _saved_dict(dirname):
    with open(os.path.join(dirname, "__model__.json")) as f:
        return json.load(f)


def _params(dirname):
    with open(os.path.join(dirname, "params", "MANIFEST.json")) as f:
        manifest = json.load(f)
    return {e["name"]: np.load(os.path.join(dirname, "params", e["file"]))
            for e in manifest}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The fused narrow ResNet saved by both packages from the same
    values, transpiled and plain."""
    pair = Pair(resnet_net, fused=True, test_clone=True)
    out = {"pair": pair}
    for transpile in (True, False):
        for pt, main, scope in ((jpt, pair.jmain, pair.jscope),
                                (tpt, pair.tmain, pair.tscope)):
            d = str(tmp_path_factory.mktemp(f"{pt.__name__}-{transpile}"))
            old = pt.flags.FLAGS.fused_conv_epilogue
            pt.flags.FLAGS.fused_conv_epilogue = True
            try:
                pt.io.save_inference_model(
                    d, pair.feed_names, [pair.fetch],
                    pt.Executor(pt.CPUPlace()), main_program=main,
                    scope=scope, transpile=transpile)
            finally:
                pt.flags.FLAGS.fused_conv_epilogue = old
            out[pt.__name__, transpile] = d
    return out


@pytest.mark.parametrize("transpile", [True, False])
def test_both_packages_save_the_same_artefact(saved, transpile):
    jdir = saved["paddle_tpu", transpile]
    tdir = saved["paddle_tpu_torch", transpile]
    jd, td = _saved_dict(jdir), _saved_dict(tdir)
    assert td["feed_names"] == jd["feed_names"]
    assert td["fetch_names"] == jd["fetch_names"]
    assert program_dict(tpt, tpt.io.program_from_dict(td["program"])) == \
        program_dict(jpt, jpt.io.program_from_dict(jd["program"]))
    jp, tp = _params(jdir), _params(tdir)
    assert sorted(tp) == sorted(jp)
    for name in jp:
        assert tp[name].dtype == jp[name].dtype, name
        np.testing.assert_array_equal(tp[name], jp[name], err_msg=name)
    types = [op["type"] for op in td["program"]["blocks"][0]["ops"]]
    assert ("batch_norm" in types) != transpile


@pytest.mark.parametrize("transpile", [True, False])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_saved_model_round_trips(saved, tmp_path, transpile, direction):
    pair = saved["pair"]
    src_pkg, dst = ((jpt, tpt) if direction == "jax_to_port"
                    else (tpt, jpt))
    src = saved[src_pkg.__name__, transpile]
    scope = dst.Scope()
    exe = dst.Executor(dst.CPUPlace())
    program, feeds, fetches = dst.io.load_inference_model(src, exe,
                                                          scope=scope)
    meta = dst.io.read_inference_model_meta(src)
    assert (feeds, fetches) == (meta["feed_names"], meta["fetch_names"])
    # the loaded program writes back the dict it was read from, every
    # attr included (JAX's _callsite too; the JAX loader stamps its own
    # where the port's artefact has none)
    loaded = json.loads(json.dumps(dst.io.program_to_dict(program)))
    if dst is tpt:
        assert loaded == _saved_dict(src)["program"]
    assert program_dict(dst, program) == program_dict(
        src_pkg, src_pkg.io.program_from_dict(_saved_dict(src)["program"]))
    for name, want in _params(src).items():
        got = (scope.get_numpy(name) if dst is tpt
               else np.asarray(scope.get(name)))
        np.testing.assert_array_equal(got, want, err_msg=name)
    got = np.asarray(exe.run(program, feed=pair.feeds, fetch_list=fetches,
                             scope=scope)[0])
    want_scope = pair.jscope if src_pkg is jpt else pair.tscope
    src_main = pair.jmain if src_pkg is jpt else pair.tmain
    want = np.asarray(src_pkg.Executor(src_pkg.CPUPlace()).run(
        src_main, feed=pair.feeds, fetch_list=[pair.fetch],
        scope=want_scope)[0])
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    # saved again by the destination: the same files
    again = str(tmp_path / "again")
    dst.io.save_inference_model(again, feeds, fetches, exe,
                                main_program=program, scope=scope,
                                transpile=False)
    if dst is tpt:
        assert _saved_dict(again)["program"] == _saved_dict(src)["program"]
    assert program_dict(dst, dst.io.program_from_dict(
        _saved_dict(again)["program"])) == program_dict(dst, program)
    for name, arr in _params(again).items():
        np.testing.assert_array_equal(arr, _params(src)[name])


def test_save_and_load_vars_round_trip(tmp_path):
    prog = tpt.Program()
    block = prog.global_block
    values = {
        "w": torch.randn(3, 4),
        "steps": torch.arange(5, dtype=torch.int64),
        "h": torch.randn(2, 3).to(torch.bfloat16),
        "a/b": torch.randn(2),
    }
    for name, t in values.items():
        block.create_parameter(name=name, shape=list(t.shape),
                               dtype=t.dtype)
    block.create_var(name="tmp", shape=[2], persistable=False)
    scope = tpt.Scope()
    for name, t in values.items():
        scope.set(name, t)
    scope.set("tmp", torch.zeros(2))
    exe = tpt.Executor(tpt.CPUPlace())
    tpt.io.save_persistables(exe, str(tmp_path / "p"), prog, scope)
    files = sorted(os.listdir(tmp_path / "p"))
    assert files == ["MANIFEST.json", "a__b.npy", "h.npy", "steps.npy",
                     "w.npy"]
    back = tpt.Scope()
    tpt.io.load_params(exe, str(tmp_path / "p"), prog, back)
    assert not back.has("tmp")
    for name, t in values.items():
        got = back.get(name)
        assert got.dtype == t.dtype and torch.equal(got, t), name
    # bf16 goes to disk as JAX writes it: readable by the JAX package
    jscope = jpt.Scope()
    jprog_ = jpt.io.program_from_dict(tpt.io.program_to_dict(prog))
    jpt.io.load_vars(None, str(tmp_path / "p"), jprog_,
                     predicate=lambda v: v.persistable, scope=jscope)
    np.testing.assert_array_equal(
        np.asarray(jscope.get("h")).astype(np.float32),
        values["h"].float().numpy())


def test_later_pieces_raise_naming_the_roadmap(saved, tmp_path):
    src = saved["paddle_tpu_torch", True]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpt.io.quantize_inference_model(src, str(tmp_path / "q"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpt.io.transpile_saved_model(src, str(tmp_path / "t"))
    tpt.flags.FLAGS.verify_program = True
    try:
        pair = saved["pair"]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpt.io.save_inference_model(
                str(tmp_path / "v"), pair.feed_names, [pair.fetch],
                tpt.Executor(tpt.CPUPlace()), main_program=pair.tmain,
                scope=pair.tscope)
    finally:
        tpt.flags.reset_flags()
