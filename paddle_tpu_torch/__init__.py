"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for NVIDIA Hopper.

Module paths and public names mirror ``paddle_tpu``; the kernels the JAX
package wrote in Pallas are hand-written sm_90a CUDA here, built with
nvcc on first use (``kernels/build.py``). The port serves the stacked
transformer LM through the dense-KV continuous-batching engine, and
trains it and ResNet through the Program IR: ``layers`` and ``models``
build a program, ``optimizer.*Optimizer(...).minimize`` appends the
backward pass and the updates, and ``Executor`` runs it (ResNet's fused
conv epilogue under ``flags.FLAGS.fused_conv_epilogue``), in f32 or under
mixed precision (``set_amp(True)`` or ``flags.FLAGS.use_amp``: bf16
products on f32 master weights). The trainer plane drives that loop:
``trainer.SGD(cost, optimizer, feed_list).train(reader, ...)`` over
``reader`` decorators and a ``data_feeder.DataFeeder``, with ``event``
callbacks, an ``async_depth`` pipeline (``Executor.run_async``),
``checkpoint`` save/resume in the JAX package's file format,
``resilience`` (periodic checkpoints, graceful shutdown, fault plans) and
``profiler`` timers. Training trades step time for memory through
recompute segments (``recompute_guard``, ``transformer_lm(remat=...)``,
``resnet(recompute=True)``) and batch for steps through
``minimize(accumulate_steps=k)``. The op plane holds the reference's
activation, tensor, loss and math ops, their ``layers`` and Variable
arithmetic (``a - b``), with the synthetic ``dataset.mnist`` the GAN and
VAE demos train on. The book plane holds the six book datasets,
``sequence_conv``, the linear-chain CRF ops, the fused
``beam_search_decoder`` and the ``evaluator`` module's ``Accuracy`` and
``ChunkEvaluator``. The optimizer plane adds ``learning_rate_decay``
schedules, ``Optimizer(global_step=)``, gradient ``clip`` attrs,
``regularizer`` decay, ``ModelAverage`` and the pruning hook
(``ParamAttr(update_hooks=)``), and ``layers.fused_head_cross_entropy``
is the chunked LM head over ``transformer_lm(include_head=False)``.
``set_mxu_precision`` / ``--mxu_precision`` choose the products' math on
the card (``default``: TF32; ``high``, ``highest``: f32-accurate; the
CPU computes all three in f32), the ``flags`` module holds the JAX
package's flag plane, and ``v2`` its v2 facade (``init``, ``layer``,
``parameters.create``, ``trainer.SGD``, ``infer``). The sparse plane
gives an ``embedding(is_sparse=True)`` a row-sparse ``SelectedRows``
gradient that the optimizers apply to the looked-up rows only
(``models.wide_deep`` over ``dataset.ctr``, with the ``Auc``,
``PrecisionRecall``, ``RankAuc`` and ``Pnpair`` evaluators). The
control-flow plane runs user-defined recurrences and loops
(``layers.StaticRNN``, ``While``, ``DynamicRNN``, the tensor arrays),
and ``v1`` the first-generation config API over it: ``parse_config``,
``PyDataProvider2``, ``trainer_config_helpers`` with ``recurrent_group``,
and the ``paddle_trainer`` CLI (``python -m paddle_tpu_torch.v1.trainer``),
with ``check_gradients`` for its ``--job=checkgrad``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
or ``CPUPlace()`` (where every kernel runs its plain PyTorch version);
without CUDA they raise rather than fall back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, raising
    when CUDA is absent; any explicit device as given. A CUDA device
    comes back with its index (``cuda:0``), as tensors report it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "versions of the kernels")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


from . import core, ops  # noqa: E402,F401  (ops register on import)
from .core import backward  # noqa: E402,F401  (registers grad ops)
from .core.backward import append_backward  # noqa: E402
from .core.executor import (CPUPlace, CUDAPlace, Executor,  # noqa: E402
                            RunHandle)
from .ops.common import (amp_enabled, mxu_precision,  # noqa: E402
                         set_amp, set_mxu_precision)
from .core.program import (Program, default_main_program,  # noqa: E402
                           default_startup_program, maybe_recompute,
                           program_guard, recompute_guard)
from .core.scope import Scope, global_scope, scope_from_numpy  # noqa: E402
from . import flags, io, layers, models, nets, optimizer  # noqa: E402
from .flags import FLAGS, parse_flags, set_flags  # noqa: E402
from . import clip, initializer, learning_rate_decay  # noqa: E402
from . import regularizer, transpiler  # noqa: E402
from . import (checkpoint, data_feeder, dataset, evaluator,  # noqa: E402
               event, profiler, reader, resilience, trainer)
from .param_attr import ParamAttr  # noqa: E402
from .checkgrad import check_gradients  # noqa: E402
from .serving import (BadRequestError, CacheExhaustedError,  # noqa: E402
                      DynamicBatcher, EngineClosedError, Future,
                      GenerationEngine, InferenceEngine, LMSpec,
                      MetricsRegistry, PagedGenerationEngine,
                      PendingInference, QueueFullError, Request,
                      RequestTimeoutError, Server, ServingError)
from .decoding import SamplingParams  # noqa: E402
from .models.transformer import TransformerLM, init_params  # noqa: E402

__all__ = [
    "CPUPlace", "CUDAPlace", "Executor", "ParamAttr", "Program",
    "RunHandle", "Scope", "amp_enabled", "append_backward",
    "check_gradients", "set_amp", "checkpoint", "clip",
    "data_feeder", "dataset", "evaluator",
    "default_main_program", "default_startup_program", "event", "flags",
    "global_scope", "initializer", "io",
    "layers", "learning_rate_decay", "maybe_recompute", "models", "nets",
    "optimizer", "profiler",
    "program_guard", "recompute_guard",
    "reader", "regularizer", "resilience", "scope_from_numpy", "trainer",
    "transpiler",
    "BadRequestError", "CacheExhaustedError", "DynamicBatcher",
    "EngineClosedError", "Future", "GenerationEngine", "InferenceEngine",
    "LMSpec", "MetricsRegistry", "PagedGenerationEngine",
    "PendingInference", "QueueFullError",
    "Request", "RequestTimeoutError", "SamplingParams", "Server",
    "ServingError",
    "TransformerLM", "init_params", "resolve_device",
]
