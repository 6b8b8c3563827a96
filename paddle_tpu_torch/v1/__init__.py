"""v1 compatibility layer: the reference's first-generation user API.

Counterpart of ``paddle_tpu/v1``. Three pieces, as a reference v1 user
worked:

- :func:`parse_config` evaluates a trainer-config python file (the
  ``from paddle.trainer_config_helpers import *`` DSL) into Programs
  (``config_parser.py``; reference trainer/config_parser.py:4345).
- :mod:`~paddle_tpu_torch.v1.data_provider`: the PyDataProvider2
  ``@provider`` decorator and the input-type declarations that provider
  modules import.
- :func:`train_from_config` is ``paddle_trainer --config=...``:
  provider-fed batched training of the parsed config, on the card unless
  the caller passes ``place=CPUPlace()``; ``python -m
  paddle_tpu_torch.v1.trainer`` is its CLI (``--use_gpu=0`` for the CPU).

The module names ``paddle``, ``paddle.trainer_config_helpers``,
``paddle.trainer`` and ``paddle.trainer.PyDataProvider2`` are bound to
this package only while a config is evaluated or a provider module is
imported, and whatever held them before is put back after
(``config_parser.shims``), so unmodified reference config and provider
files run as they are, and this package and the JAX package can parse in
one process.
"""
from . import data_provider
from .config_parser import ParsedConfig, parse_config
from .helpers import ParseContext
from .trainer import V1DataFeeder, make_reader, train_from_config

__all__ = ["parse_config", "ParsedConfig", "ParseContext", "data_provider",
           "train_from_config", "make_reader", "V1DataFeeder"]
