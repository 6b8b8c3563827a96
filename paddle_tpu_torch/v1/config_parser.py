"""parse_config: evaluate a v1 trainer config file into Programs.

Counterpart of ``paddle_tpu/v1/config_parser.py``. The reference's first
user API is a Python config file evaluated by ``parse_config``
(reference python/paddle/trainer/config_parser.py:4345) under the
trainer_config_helpers DSL. Here the same evaluation gives the port's
Program pair plus the config-level records (settings, data sources,
inputs/outputs, evaluators) that :mod:`paddle_tpu_torch.v1.trainer`
consumes.

Reference config files open with ``from paddle.trainer_config_helpers
import *`` and provider modules with ``from paddle.trainer.PyDataProvider2
import *``. :func:`shims` binds those module names to this package's
modules for the duration of a config's evaluation or a provider's import
and then puts back whatever ``sys.modules`` held under them (another
package's shims, a real ``paddle``, or nothing). So no ``paddle`` module
of this package outlives a parse, and a config or provider evaluated by
another package in the same process keeps seeing that package's modules.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import sys
import types

from ..core.program import Program, program_guard
from . import data_provider as _dp
from . import helpers as _h

_SHIM_NAMES = ("paddle", "paddle.trainer_config_helpers", "paddle.trainer",
               "paddle.trainer.PyDataProvider2")
_ABSENT = object()
_SHIM_MODULES = None


def _shim_modules():
    """The four module objects this package binds the ``paddle`` names
    to, built on first use and kept here, never in ``sys.modules``."""
    global _SHIM_MODULES
    if _SHIM_MODULES is None:
        paddle = types.ModuleType("paddle")
        paddle.__paddle_tpu_torch_v1_shim__ = True
        tch = types.ModuleType("paddle.trainer_config_helpers")
        for name in _h._EXPORTS:
            setattr(tch, name, getattr(_h, name))
        tch.__all__ = list(_h._EXPORTS)
        trainer = types.ModuleType("paddle.trainer")
        pdp2 = types.ModuleType("paddle.trainer.PyDataProvider2")
        for name in _dp.__all__:
            setattr(pdp2, name, getattr(_dp, name))
        pdp2.__all__ = list(_dp.__all__)
        paddle.trainer_config_helpers = tch
        paddle.trainer = trainer
        trainer.PyDataProvider2 = pdp2
        _SHIM_MODULES = dict(zip(_SHIM_NAMES, (paddle, tch, trainer, pdp2)))
    return _SHIM_MODULES


@contextlib.contextmanager
def shims(*private):
    """Bind the ``paddle`` module names to this package's v1 modules
    inside the block; also hide the modules named in ``private`` (a
    provider module to import afresh). On exit every one of those names
    holds what it held before the block, or nothing."""
    names = _SHIM_NAMES + tuple(private)
    saved = {n: sys.modules.get(n, _ABSENT) for n in names}
    for n in private:
        sys.modules.pop(n, None)
    sys.modules.update(_shim_modules())
    try:
        yield
    finally:
        for n, mod in saved.items():
            if mod is _ABSENT:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod


def import_provider(module, config_dir):
    """This package's own copy of the provider module ``module`` from
    ``config_dir``: imported afresh under the shims, so its ``@provider``
    is this package's even where another package imported the module
    first, and left out of ``sys.modules`` after."""
    added = config_dir not in sys.path
    if added:
        sys.path.insert(0, config_dir)
    try:
        with shims(module):
            return importlib.import_module(module)
    finally:
        if added and config_dir in sys.path:
            sys.path.remove(config_dir)


def _parse_config_args(config_arg_str):
    """'a=1,b=x' -> dict (reference config_parser.py parse_config)."""
    out = {}
    for part in (config_arg_str or "").split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


class ParsedConfig:
    """What parse_config returns: the built Program pair + config records.

    ``input_vars`` are the feed variables in the config's ``inputs()``
    order (creation order when inputs() was not called), the order
    provider row tuples follow. ``output_vars`` are the ``outputs()``
    targets (training configs: the cost)."""

    def __init__(self, ctx, main_program, startup_program):
        self.main_program = main_program
        self.startup_program = startup_program
        self.settings = ctx.settings
        self.data_sources = ctx.data_sources
        self.evaluators = ctx.evaluators
        # Outputs("name") entries resolve against the v1 name registry
        self.output_vars = []
        for o in (ctx.outputs or []):
            if isinstance(o, str):
                if o not in ctx.named_layers:
                    raise ValueError(
                        f"Outputs({o!r}): no layer was created with "
                        f"name={o!r}; known names: "
                        f"{sorted(ctx.named_layers)[:20]}")
                o = ctx.named_layers[o]
            self.output_vars.append(o)
        by_name = {v.name: v for v in ctx.data_layers}
        order = ctx.inputs_order or [v.name for v in ctx.data_layers]
        self.input_vars = [by_name[n] for n in order if n in by_name]
        self.config_dir = ctx.config_dir
        # config-wide defaults, applied when the optimizer is built (the
        # reference reads them then, so their order against Settings is
        # free)
        self.default_momentum = ctx.default_momentum
        self.default_decay_rate = ctx.default_decay_rate

    @property
    def cost(self):
        if not self.output_vars:
            raise ValueError("config declared no outputs()")
        return self.output_vars[0]

    def build_optimizer(self):
        """The settings record as a concrete optimizer, with the legacy
        gradient_clipping_threshold installed on the main program.
        String learning_methods (the Settings() form) and the
        default_momentum/default_decay_rate defaults resolve here, after
        the whole config has been evaluated (the reference's timing)."""
        method = _h.resolve_learning_method(
            self.settings.get("learning_method"),
            default_momentum=self.default_momentum)
        reg = self.settings.get("regularization")
        if reg is None and self.default_decay_rate:
            reg = _h.L2Regularization(self.default_decay_rate)
        opt = (method or _h.MomentumOptimizer(momentum=0.0)).build(
            self.settings.get("learning_rate", 0.01),
            regularization=reg)
        thr = self.settings.get("gradient_clipping_threshold")
        if thr:
            from ..clip import GradientClipByGlobalNorm, set_gradient_clip

            set_gradient_clip(GradientClipByGlobalNorm(thr),
                              program=self.main_program)
        return opt


def parse_config(config_file, config_arg_str=""):
    """Evaluate ``config_file`` (a v1 trainer config) and return a
    :class:`ParsedConfig`. ``config_arg_str`` is the reference's
    ``--config_args`` comma list, read inside the config via
    get_config_arg()."""
    config_file = os.fspath(config_file)
    with open(config_file) as fh:
        source = fh.read()
    ctx = _h.ParseContext(_parse_config_args(config_arg_str),
                          config_dir=os.path.dirname(
                              os.path.abspath(config_file)))
    main_program, startup_program = Program(), Program()
    ns = {name: getattr(_h, name) for name in _h._EXPORTS}
    ns["__file__"] = config_file
    ns["__name__"] = "__paddle_v1_config__"
    prev_ctx = _h._CTX
    _h._CTX = ctx
    added_path = ctx.config_dir not in sys.path
    if added_path:
        sys.path.insert(0, ctx.config_dir)
    had_maxint = hasattr(sys, "maxint")
    if not had_maxint:
        sys.maxint = sys.maxsize  # py2-era configs read sys.maxint
    try:
        with shims(), program_guard(main_program, startup_program):
            exec(compile(source, config_file, "exec"), ns)  # noqa: S102
    finally:
        _h._CTX = prev_ctx
        if not had_maxint:
            del sys.maxint
        if added_path and ctx.config_dir in sys.path:
            sys.path.remove(ctx.config_dir)
    if ctx.outputs is None and ctx.data_layers:
        raise ValueError(f"{config_file}: config declared no outputs()")
    return ParsedConfig(ctx, main_program, startup_program)
