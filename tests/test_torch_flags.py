"""The port's flag plane (paddle_tpu_torch/flags.py) against the JAX
package's (paddle_tpu/flags.py): the same registry, defaults and types,
and the same parsing of set_flags / parse_flags / get_flag /
print_flags, as tests/test_flags_enforce.py checks the JAX package's."""
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import flags as jflags
from paddle_tpu_torch import flags as tflags

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    tflags.reset_flags()
    jflags.reset_flags()


def test_registry_defaults_and_types_equal_the_reference():
    names = jflags.flags_registered()
    assert tflags.flags_registered() == names
    assert len(names) == 16
    for name in names:
        ref = jflags._registry[name]
        assert tflags._DEFAULTS[name] == ref.default, name
        assert tflags._registry[name].type_name == ref.type_name, name
        assert tflags.get_flag(name) == jflags.get_flag(name), name
    assert tflags._registry["trace_sample_rate"].type_name == "float"


def test_defaults_and_set():
    assert tpt.FLAGS.check_nan_inf is False
    tpt.FLAGS.check_nan_inf = True
    assert tpt.FLAGS.check_nan_inf is True
    assert tflags.get_flag("check_nan_inf") is True


def test_unknown_flag_rejected():
    with pytest.raises(AttributeError):
        tpt.FLAGS.no_such_flag
    with pytest.raises(tflags.FlagError):
        tpt.FLAGS.another_missing = 1
    with pytest.raises(tflags.FlagError):
        tpt.set_flags({"no_such_flag": 1})


@pytest.mark.parametrize("values", [
    {"log_period": "25", "check_nan_inf": "true",
     "mxu_precision": "highest"},
    {"trace_sample_rate": "0.25", "trace_buffer": "0x100",
     "warmup_concurrency": 8, "op_callsite": "off"},
    {"compilation_cache_dir": "cc_dir", "verify_restored_donation": "0",
     "reduce_peak_memory": "yes", "trace_level": 2, "seed": "7"},
], ids=["core", "numbers", "unported"])
def test_type_parsing_as_the_reference(values):
    tpt.set_flags(values)
    jpt.set_flags(values)
    for name in values:
        got, want = tflags.get_flag(name), jflags.get_flag(name)
        assert got == want and type(got) is type(want), (name, got, want)


def test_bad_values_raise():
    for flags in (tflags, jflags):
        with pytest.raises(flags.FlagError):
            flags.set_flags({"check_nan_inf": "maybe"})
    with pytest.raises(tflags.FlagError):
        tflags.set_flags({"trace_sample_rate": "half"})
    with pytest.raises(tflags.FlagError):
        tflags.parse_flags(["--seed"])  # a value is missing


def test_parse_argv_as_the_reference():
    argv = ["prog.py", "--check_nan_inf", "--log_period=7", "--seed", "3",
            "--trace_sample_rate=0.5", "--unrelated=x", "--noseed", "pos"]
    rest = tpt.parse_flags(list(argv))
    assert rest == jpt.parse_flags(list(argv))
    assert rest == ["prog.py", "--unrelated=x", "--noseed", "pos"]
    for name in ("check_nan_inf", "log_period", "seed", "trace_sample_rate"):
        assert tflags.get_flag(name) == jflags.get_flag(name), name
    assert (tpt.FLAGS.check_nan_inf, tpt.FLAGS.log_period,
            tpt.FLAGS.seed) == (True, 7, 3)
    tpt.parse_flags(["--nocheck_nan_inf"])
    assert tpt.FLAGS.check_nan_inf is False


def test_reset_restores_every_default():
    tpt.set_flags({"log_period": 3, "mxu_precision": "high",
                   "fault_plan": "preempt@5"})
    tflags.reset_flags()
    for name in tflags.flags_registered():
        assert tflags.get_flag(name) == jflags._registry[name].default


def test_print_flags_lists_everything_and_marks_what_is_set():
    tpt.FLAGS.log_period = 5
    text = tflags.print_flags()
    for name in tflags.flags_registered():
        assert f"--{name}=" in text
    line, = [ln for ln in text.splitlines() if ln.startswith("--log_period")]
    assert line.endswith("(set)") and "[int32]" in line
    # the flags whose plane is not ported say so in their help
    for name in ("compilation_cache_dir", "verify_restored_donation",
                 "warmup_concurrency"):
        assert "XLA-only" in tflags._registry[name].help, name
    for name in ("op_callsite", "trace_level", "trace_sample_rate",
                 "trace_buffer", "reduce_peak_memory"):
        assert "ROADMAP item 9" in tflags._registry[name].help, name


def test_env_override():
    """PADDLE_TPU_<NAME> env vars set flag values at import, as in the
    JAX package."""
    code = ("import paddle_tpu_torch as pt; "
            "assert pt.FLAGS.log_period == 42, pt.FLAGS.log_period; "
            "assert pt.FLAGS.check_nan_inf is True; "
            "assert pt.FLAGS.trace_sample_rate == 0.5; "
            "assert pt.mxu_precision() == 'highest'; "
            "from paddle_tpu_torch.ops import common; "
            "assert common.amp_enabled(); print('ok')")
    env = dict(os.environ, PADDLE_TPU_LOG_PERIOD="42",
               PADDLE_TPU_CHECK_NAN_INF="1", PADDLE_TPU_USE_AMP="true",
               PADDLE_TPU_TRACE_SAMPLE_RATE="0.5",
               PADDLE_TPU_MXU_PRECISION="highest")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-800:]


def test_executor_reads_check_nan_inf_flag():
    tpt.FLAGS.check_nan_inf = True
    exe = tpt.Executor(tpt.CPUPlace())
    assert exe.check_nan_inf is True
    assert tpt.Executor(tpt.CPUPlace(),
                        check_nan_inf=False).check_nan_inf is False
