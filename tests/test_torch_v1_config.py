"""The v1 config plane (parse_config, PyDataProvider2,
trainer_config_helpers, the paddle_trainer CLI) against the JAX
package's.

The configs are self-contained: ``tests/test_v1_config.py``'s fixture
config and provider, and ``demos/v1_config_compat.py``'s CNN text
classifier and ``recurrent_group`` tagger over its provider, written out
as the demo writes them. Each parses in both packages, with the name
counters synced, to the same program (as ``program_to_dict`` writes it,
without the JAX package's ``_callsite`` attrs), the same inputs and
settings; ``train_from_config`` (the port's on ``CPUPlace()``) trains
each from its own startup (the port's draws JAX's values) to the same
first 5 batch losses within ``LOSS_RTOL``. The ``paddle`` module names
are bound only while a package evaluates a config or imports a provider:
parsing with the port and then the JAX package in one process, and the
other way round, gives each package's own program and provider, and the
port leaves no ``paddle`` module behind. ``main(argv)`` runs every job.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import v1 as jv1
from paddle_tpu.core import program as jprog
from paddle_tpu_torch import v1 as tv1
from paddle_tpu_torch.core import program as tprog
from test_torch_control_flow import _strip_callsites
from test_torch_transpiler import program_dict
from test_v1_config import FIXTURE_CONF, FIXTURE_PROVIDER

torch.set_num_threads(1)
LOSS_RTOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demo():
    """demos/v1_config_compat.py as a module (its configs, provider)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "v1_config_compat_demo", os.path.join(REPO, "demos",
                                              "v1_config_compat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DEMO = _demo()
CONFIGS = {"fixture": (FIXTURE_CONF, "fixture_provider", FIXTURE_PROVIDER,
                       "data/part-0\ndata/part-1\n", "dim=16"),
           "cnn": (DEMO.CNN_CONF, "provider_demo", DEMO.PROVIDER,
                   "data/part-0\n", ""),
           "rnn": (DEMO.RNN_CONF, "provider_demo", DEMO.PROVIDER,
                   "data/part-0\n", "")}


def _paddle_modules():
    return {n: m for n, m in sys.modules.items()
            if n == "paddle" or n.startswith("paddle.")}


PROVIDERS = ("provider_demo", "fixture_provider")


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A config directory as the demo lays it out, as the CWD, with no
    ``paddle`` shim and no provider module cached (a fresh process); the
    provider modules the JAX package caches from it go after the test."""
    for name in list(_paddle_modules()) + list(PROVIDERS):
        monkeypatch.delitem(sys.modules, name, raising=False)
    (tmp_path / "data").mkdir()
    for part in ("part-0", "part-1"):
        (tmp_path / "data" / part).write_text("")
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    for name in PROVIDERS:
        sys.modules.pop(name, None)


def _write(workdir, case):
    conf, module, provider, train_list, args = CONFIGS[case]
    (workdir / f"{module}.py").write_text(provider)
    (workdir / "data" / "train.list").write_text(train_list)
    (workdir / f"{case}_conf.py").write_text(conf)
    return f"{case}_conf.py", args


def _parse_both(name, args):
    start = jprog.Program._uid_counter
    out = []
    for v1, counter in ((jv1, jprog), (tv1, tprog)):
        counter.Program._uid_counter = start
        out.append(v1.parse_config(name, args))
    return out


def _plain(v):
    """Settings values as data: objects by class name and attributes."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    return (type(v).__name__, _plain(vars(v)))


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_config_parses_to_the_jax_program(workdir, case):
    name, args = _write(workdir, case)
    jp, tp = _parse_both(name, args)
    jd, td = (_strip_callsites(program_dict(pt, p.main_program))
              for pt, p in ((jpt, jp), (tpt, tp)))
    assert td == jd
    types = [op.type for op in tp.main_program.global_block.ops]
    assert types == [op.type for op in jp.main_program.global_block.ops]
    assert ("static_rnn" in types) == (case == "rnn")
    shapes = lambda p: {v.name: tuple(v.shape)  # noqa: E731
                        for v in p.main_program.all_parameters()}
    assert shapes(tp) == shapes(jp)
    assert [v.name for v in tp.input_vars] == [v.name for v in jp.input_vars]
    assert _plain(tp.settings) == _plain(jp.settings)
    assert [v.input_type.dim for v in tp.input_vars] == \
        [v.input_type.dim for v in jp.input_vars]


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_config_trains_to_the_jax_losses(workdir, case):
    """The first 5 batch losses of ``train_from_config``, 2 passes."""
    name, args = _write(workdir, case)
    start = jprog.Program._uid_counter
    losses = []
    for v1, counter, kw in ((jv1, jprog, {}),
                            (tv1, tprog, {"place": tpt.CPUPlace()})):
        counter.Program._uid_counter = start
        seen = []
        _, scope, passes = v1.train_from_config(
            name, args, num_passes=2,
            event_handler=lambda e: seen.append(e["cost"]), **kw)
        assert np.isfinite(passes).all()
        losses.append(seen[:5])
    assert len(losses[1]) == 5
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL)


def _built_by(parsed, pkg):
    """Every piece of ``parsed`` is ``pkg``'s: the program, the feeds,
    the provider and its declared input types."""
    provider = parsed.data_sources["provider"]
    types = parsed.data_sources["provider_settings"].input_types
    return (isinstance(parsed.main_program, pkg.Program)
            and type(provider) is pkg.v1.data_provider.DataProvider
            and all(type(t) is pkg.v2.data_type.InputType
                    for t in types.values())
            and all(isinstance(v, pkg.core.program.Variable)
                    for v in parsed.input_vars))


@pytest.mark.parametrize("order", ["port_first", "jax_first"])
def test_each_package_parses_with_its_own_modules(workdir, order):
    import paddle_tpu.v2  # noqa: F401
    import paddle_tpu_torch.v2  # noqa: F401

    name, args = _write(workdir, "rnn")
    seq = [(tv1, tpt), (jv1, jpt)]
    if order == "jax_first":
        seq.reverse()
    for v1, pkg in seq + seq:
        before = _paddle_modules()
        provider_before = sys.modules.get("provider_demo")
        parsed = v1.parse_config(name, args)
        assert _built_by(parsed, pkg), (order, pkg.__name__)
        if pkg is tpt:  # the port puts back what it found
            assert _paddle_modules() == before
            assert sys.modules.get("provider_demo") is provider_before


def test_port_leaves_no_paddle_module(workdir):
    name, args = _write(workdir, "cnn")
    assert not _paddle_modules()
    parsed = tv1.parse_config(name, args)
    assert parsed.data_sources["provider"] is not None
    assert not _paddle_modules()
    assert "provider_demo" not in sys.modules


def test_config_args_and_lazy_settings(workdir):
    name, _ = _write(workdir, "fixture")
    parsed = tv1.parse_config(name, "dim=24")
    assert parsed.input_vars[0].input_type.dim == 24
    assert parsed.cost is parsed.output_vars[0]
    conf = workdir / "c.py"
    conf.write_text(textwrap.dedent("""
        from paddle.trainer_config_helpers import *
        Settings(algorithm='sgd', batch_size=4, learning_rate=0.1,
                 learning_method='momentum')
        default_momentum(0.7)
        default_decay_rate(2e-4)
        x = data_layer(name='x', size=4)
        y = data_layer(name='y', size=2)
        out = fc_layer(input=x, size=2, name='pred')
        outputs(regression_cost(input=out, label=y))
    """))
    parsed = tv1.parse_config(conf)
    opt = parsed.build_optimizer()
    assert opt.momentum == 0.7
    assert parsed.default_decay_rate == 2e-4
    from paddle_tpu_torch.v1 import helpers as H

    with pytest.raises(ValueError, match="not a supported"):
        H.resolve_learning_method("nesterov_lookahead")


def test_unported_layers_raise_naming_their_item(workdir):
    from paddle_tpu_torch.v1 import helpers as H

    for fn, item in ((H.warp_ctc_layer, 3), (H.priorbox_layer, 2),
                     (H.row_conv_layer, 3), (H.conv_shift_layer, 8)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fn(None, None)
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[4, 4, 3])
        for call, item in ((lambda: H.spp_layer(x), 2),
                           (lambda: H.roi_pool_layer(x, x), 2),
                           (lambda: H.tensor_layer(x, x, 3), 8)):
            with pytest.raises(NotImplementedError, match=f"item {item}"):
                call()


def test_cli_runs_every_job(workdir, capsys):
    from paddle_tpu_torch.v1 import trainer as v1t

    name, _ = _write(workdir, "fixture")
    base = ["--config", name, "--config_args", "dim=12", "--use_gpu=0"]
    assert v1t.main(base + ["--job", "train", "--num_passes", "1"]) == 0
    assert "pass 0: mean cost" in capsys.readouterr().out
    assert v1t.main(base + ["--job", "time"]) == 0
    out = capsys.readouterr().out
    assert "ms/batch" in out and "train_step" in out
    assert v1t.main(base + ["--job", "test"]) == 0
    assert "mean cost" in capsys.readouterr().out
    assert v1t.main(base + ["--job", "checkgrad"]) == 0
    out = capsys.readouterr().out
    assert out.count("max rel err") == 4  # two weights, two biases
    assert not _paddle_modules()


def test_cli_defaults_to_the_card(workdir, monkeypatch):
    """Without ``--use_gpu=0`` the jobs run on ``CUDAPlace(0)``, which
    raises where there is no card rather than fall back."""
    from paddle_tpu_torch.v1 import trainer as v1t

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name, _ = _write(workdir, "fixture")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        v1t.main(["--config", name, "--job", "test"])


def test_cli_as_a_module(workdir):
    """``python -m paddle_tpu_torch.v1.trainer``, as a user runs it."""
    name, _ = _write(workdir, "rnn")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.v1.trainer", "--config",
         name, "--job", "time", "--use_gpu", "false"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ms/batch" in proc.stdout
