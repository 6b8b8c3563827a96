"""The v2 user API on the port. Counterpart of ``paddle_tpu/v2``.

The reference's paddle.v2 surface (python/paddle/v2: layer.py,
activation.py, pooling.py, attr.py, parameters.py, trainer.py, event.py,
reader/, dataset/, minibatch.py) drove the legacy gserver engine; here
the same user-facing shapes build Program IR and run through the port's
executor, on the card by default::

    import paddle_tpu_torch.v2 as paddle
    paddle.init(trainer_count=1)       # use_gpu=False runs on the CPU
    images = paddle.layer.data("pixel",
                               paddle.data_type.dense_vector(784))
    label = paddle.layer.data("label", paddle.data_type.integer_value(10))
    h = paddle.layer.fc(input=images, size=128,
                        act=paddle.activation.Relu())
    cost = paddle.layer.classification_cost(
        input=paddle.layer.fc(input=h, size=10,
                              act=paddle.activation.Softmax()),
        label=label)
    parameters = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=parameters,
        update_equation=paddle.optimizer.Momentum(learning_rate=0.01))
    trainer.train(paddle.batch(reader, 64), num_passes=2,
                  event_handler=handler)

``image``, ``master`` and ``plot``, which the JAX package's v2
re-exports, are not ported: reaching them raises, naming ROADMAP item 9.
"""
from __future__ import annotations

from .. import dataset, evaluator, event  # noqa: F401  (reference re-exports)
from ..core.program import (default_main_program,  # noqa: F401
                            default_startup_program)
from ..reader import decorator as reader  # noqa: F401
from ..reader.minibatch import batch  # noqa: F401
from . import activation, attr, data_type, layer, networks, optimizer, \
    parameters, pooling, trainer  # noqa: F401

__all__ = ["init", "infer", "batch", "reader", "dataset", "event", "layer",
           "activation", "pooling", "attr", "data_type", "optimizer",
           "parameters", "trainer", "networks", "evaluator",
           "default_main_program", "default_startup_program"]

_NOT_PORTED = ("image", "master", "plot")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle_tpu_torch.v2.{name} is not ported (the JAX package's "
            f"v2 re-exports paddle_tpu.{name}); see ROADMAP.md Queue 1 "
            "item 9")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def init(use_gpu: bool = None, trainer_count: int = 1, seed: int = None,
         **kwargs) -> None:
    """paddle.init analogue: ``seed`` sets ``--seed``; ``use_gpu=False``
    runs what is created afterwards on the CPU, None or True on the card
    (the default). The topology knobs are accepted and ignored."""
    from ..flags import FLAGS

    if seed is not None:
        FLAGS.seed = int(seed)
    parameters._USE_GPU = use_gpu is None or bool(use_gpu)
    del trainer_count, kwargs


def infer(output_layer, parameters, input, feeding=None):
    """paddle.infer analogue: run the inference clone of output_layer's
    program over ``input`` rows; returns the stacked outputs. Accepts a
    single layer or (like the reference's ``outputs([...])`` configs) a
    list, returning one array per requested layer."""
    import numpy as np

    from ..data_feeder import DataFeeder

    multi = isinstance(output_layer, (list, tuple))
    outputs = list(output_layer) if multi else [output_layer]
    parameters.init()
    prog = parameters.test_program_for(outputs)
    consumed = {n for op in prog.global_block.ops
                for names in op.inputs.values() for n in names}
    feed_vars = [v for v in parameters.data_vars(feeding, program=prog)
                 if v.name in consumed]
    feeder = DataFeeder(feed_vars)
    out = parameters.executor.run(
        prog, feed=feeder.feed(input), fetch_list=outputs,
        scope=parameters.scope)
    arrays = [np.asarray(o) for o in out]
    return arrays if multi else arrays[0]
