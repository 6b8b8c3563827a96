"""``check_gradients`` (the ``--job=checkgrad`` job) against the JAX
package's.

On a smooth program both packages pass from the same startup values
(errors under rtol 1e-2, no kink found by the port, whose probes read
the mean loss from its rows in float64); a gradient made wrong by 2x
through a custom ``grad_fn`` fails in both. Across a kink (a max whose
choice changes within +-delta) the JAX package's central difference
measures the mean of two slopes and fails a correct gradient; the port
takes the loss at the unperturbed point, finds the two one-sided
differences apart, holds the analytic gradient to the one that matches,
and lists the probe in ``kinks``. A wrong gradient at that kink still
fails in the port. The ``--job=checkgrad`` CLI passes on the v1 demo's
CNN text classifier (ReLU, max pool over time) over the first data draws
of its provider, seeded by the draw's number instead of by ``hash()``
of the file name, which changes from process to process.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
import paddle_tpu_torch.v1.trainer as v1t
from paddle_tpu.checkgrad import check_gradients as jax_check
from paddle_tpu.core import registry as jax_registry
from paddle_tpu_torch.core import registry as torch_registry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# y = x . W with x = [1, 0] is W's first row; its two entries lie 4e-4
# apart, inside delta = 1e-3, so max(y) has a kink within both probes
KINK_W = np.array([[0.5, 0.5004], [0.3, 0.2]], np.float32)


def _smooth(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=8, act="tanh")
        logits = pkg.layers.fc(h, size=3)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(6, 4).astype(np.float32),
            "label": rng.randint(0, 3, size=(6, 1)).astype(np.int64)}
    return main, startup, loss, feed


def _kink(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[2])
        y = pkg.layers.fc(x, size=2, bias_attr=False)
        loss = pkg.layers.mean(pkg.layers.reduce_max(y, dim=1))
    return main, startup, loss, {"x": np.array([[1.0, 0.0]], np.float32)}


def _run_jax(build, weight=None, **kw):
    main, startup, loss, feed = build(jpt)
    scope = jpt.Scope()
    jpt.Executor(jpt.CPUPlace()).run(startup, scope=scope)
    if weight is not None:
        scope.set(main.global_block.all_parameters()[0].name, weight)
    return jax_check(main, feed, loss, scope=scope,
                     executor=jpt.Executor(jpt.CPUPlace()), **kw)


def _run_port(build, weight=None, startup_from=None, **kw):
    main, startup, loss, feed = build(tpt)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block.all_parameters()]
    for name, value in zip(params, startup_from or []):
        scope.set(name, torch.from_numpy(value.copy()))
    if weight is not None:
        scope.set(params[0], torch.from_numpy(weight.copy()))
    return tpt.check_gradients(main, feed, loss, scope=scope,
                               executor=exe, **kw)


def _startup_values(pkg_build):
    main, startup, _, _ = pkg_build(jpt)
    scope = jpt.Scope()
    jpt.Executor(jpt.CPUPlace()).run(startup, scope=scope)
    return [np.asarray(scope.get(p.name))
            for p in main.global_block.all_parameters()]


def test_smooth_program_passes_in_both():
    jres = _run_jax(_smooth, max_elements=8)
    kinks = []
    tres = _run_port(_smooth, startup_from=_startup_values(_smooth),
                     max_elements=8, kinks=kinks)
    assert len(tres) == len(jres) == 4  # two weights, two biases
    for (_, jerr), (_, terr) in zip(jres, tres):
        assert jerr < 1e-2 and terr < 1e-2, (jerr, terr)
    assert kinks == []


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_wrong_gradient_fails(pkg):
    """tanh's gradient doubled by a custom grad_fn is caught."""
    registry = jax_registry if pkg == "jax" else torch_registry
    opdef = registry.get_op("tanh")
    orig = opdef.grad_fn
    opdef.grad_fn = lambda attrs, ins, outs, ogs: {
        "X": [2.0 * ogs["Out"][0] * (1 - outs["Out"][0] ** 2)]}
    try:
        with pytest.raises(AssertionError, match="gradient check FAILED"):
            (_run_jax if pkg == "jax" else _run_port)(_smooth,
                                                      max_elements=4)
    finally:
        opdef.grad_fn = orig


def test_probe_across_a_kink_is_held_to_one_side():
    """The JAX package fails max(w00, w01)'s correct gradient (0, 1) at
    w00 = 0.5, w01 = 0.5004: its central differences read 0.3 and 0.7.
    The port passes it, each probe listed as reaching across the kink,
    its error that of the matching one-sided slope."""
    with pytest.raises(AssertionError, match="gradient check FAILED"):
        _run_jax(_kink, weight=KINK_W)
    kinks = []
    (name, err), = _run_port(_kink, weight=KINK_W, kinks=kinks)
    assert kinks == [(name, 0), (name, 1)]
    assert err < 1e-3, err


def test_wrong_gradient_across_a_kink_fails():
    """reduce_max's gradient doubled: at the kink the analytic 2 matches
    neither one-sided slope (1 ahead, 0.4 behind), so the port fails."""
    opdef = torch_registry.get_op("reduce_max")
    orig = opdef.grad_fn

    def doubled(attrs, ins, outs, ogs):
        x, = ins["X"]
        g = (x == outs["Out"][0].unsqueeze(1)).to(x.dtype)
        return {"X": [2.0 * g * ogs["Out"][0].unsqueeze(1)]}

    opdef.grad_fn = doubled
    try:
        with pytest.raises(AssertionError,
                           match=r"gradient check FAILED for .*\[1\]"):
            _run_port(_kink, weight=KINK_W)
    finally:
        opdef.grad_fn = orig


def _demo():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "v1_config_compat_demo", os.path.join(REPO, "demos",
                                              "v1_config_compat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("draw", range(12))
def test_cli_checkgrad_on_the_cnn_demo(draw, tmp_path, monkeypatch,
                                       capsys):
    demo = _demo()
    provider = demo.PROVIDER.replace("hash(filename) % 1000",
                                     "int(filename.rsplit('-', 1)[1])")
    assert provider != demo.PROVIDER
    conf = demo.CNN_CONF.replace("module='provider_demo'",
                                 "module='provider_draws'")
    (tmp_path / "data").mkdir()
    (tmp_path / "provider_draws.py").write_text(provider)
    (tmp_path / "data" / "train.list").write_text(f"data/part-{draw}\n")
    (tmp_path / "cnn_conf.py").write_text(conf)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delitem(sys.modules, "provider_draws", raising=False)
    try:
        assert v1t.main(["--config", "cnn_conf.py", "--job", "checkgrad",
                         "--use_gpu=0"]) == 0
    finally:
        sys.modules.pop("provider_draws", None)
    assert capsys.readouterr().out.count("max rel err") == 5
