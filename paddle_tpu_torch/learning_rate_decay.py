"""Learning-rate decay schedules, computed in the program from a step
counter.

Counterpart of ``paddle_tpu/learning_rate_decay.py``, whole: the shared
``step_counter``, seven decay functions and ``linear_lr_warmup``. Each
returns a [1] float32 Variable that the training program recomputes
every run from a persistable int32 step counter (ops ``lr_schedule`` and
``lr_warmup``, ``ops/optimizer_ops.py``), so the learning rate stays a
device tensor with no host round trip a step. Pass the result as
``Optimizer(learning_rate=...)``.
"""
from __future__ import annotations

from .layers import tensor as tensor_layers
from .layers.layer_helper import LayerHelper

__all__ = [
    "step_counter", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "noam_decay", "linear_lr_warmup",
]  # the reference's list: ``cosine_decay`` is public but not in it


def step_counter(main_program=None, startup_program=None, begin=0):
    """A persistable int32 [1] counter incremented once a program run
    (fluid's autoincreased global step; int32 is exact to 2^31, where an
    f32 counter freezes at 2^24).

    One shared counter a main program: schedules created without an
    explicit ``global_step`` reuse it and its one increment op, so a
    warmup stacked over a decay adds no second counter."""
    helper = LayerHelper("lr_global_step", main_program=main_program,
                         startup_program=startup_program)
    main = helper.main_program
    cached = getattr(main, "_lr_step_counter", None)
    if cached is not None:
        if int(begin) != cached._begin:
            raise ValueError(
                f"this program's shared LR step counter already starts at "
                f"{cached._begin}; cannot re-create it with begin="
                f"{int(begin)}. Pass the counter explicitly as global_step "
                f"to use a different origin.")
        return cached
    counter = tensor_layers.create_global_var(
        shape=[1], value=int(begin), dtype="int32",
        name=main.unique_name("lr_global_step"),
        main_program=main, startup_program=helper.startup_program)
    counter._begin = int(begin)
    helper.block.append_op("increment", inputs={"X": [counter.name]},
                           outputs={"Out": [counter.name]},
                           attrs={"step": 1})
    main._lr_step_counter = counter
    return counter


def _schedule(policy, attrs, global_step, main_program, startup_program):
    helper = LayerHelper("lr_schedule", main_program=main_program,
                         startup_program=startup_program)
    if global_step is None:
        global_step = step_counter(main_program=helper.main_program,
                                   startup_program=helper.startup_program)
    return helper.simple_op("lr_schedule", {"GlobalStep": [global_step]},
                            dict(attrs, policy=policy))


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False, global_step=None,
                      main_program=None, startup_program=None):
    """lr * decay_rate^(step/decay_steps)."""
    return _schedule("exponential",
                     {"learning_rate": float(learning_rate),
                      "decay_steps": int(decay_steps),
                      "decay_rate": float(decay_rate),
                      "staircase": bool(staircase)},
                     global_step, main_program, startup_program)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False, global_step=None,
                      main_program=None, startup_program=None):
    """lr * exp(-decay_rate * step/decay_steps)."""
    return _schedule("natural_exp",
                     {"learning_rate": float(learning_rate),
                      "decay_steps": int(decay_steps),
                      "decay_rate": float(decay_rate),
                      "staircase": bool(staircase)},
                     global_step, main_program, startup_program)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False, global_step=None,
                       main_program=None, startup_program=None):
    """lr / (1 + decay_rate * step/decay_steps)."""
    return _schedule("inverse_time",
                     {"learning_rate": float(learning_rate),
                      "decay_steps": int(decay_steps),
                      "decay_rate": float(decay_rate),
                      "staircase": bool(staircase)},
                     global_step, main_program, startup_program)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False, global_step=None,
                     main_program=None, startup_program=None):
    """(lr - end) * (1 - step/decay_steps)^power + end."""
    return _schedule("polynomial",
                     {"learning_rate": float(learning_rate),
                      "decay_steps": int(decay_steps),
                      "end_learning_rate": float(end_learning_rate),
                      "power": float(power), "cycle": bool(cycle)},
                     global_step, main_program, startup_program)


def piecewise_decay(boundaries, values, global_step=None,
                    main_program=None, startup_program=None):
    """A step-wise constant LR: values[i] while step < boundaries[i]."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("piecewise_decay needs len(values) == "
                         "len(boundaries) + 1")
    return _schedule("piecewise",
                     {"boundaries": [float(b) for b in boundaries],
                      "values": [float(v) for v in values]},
                     global_step, main_program, startup_program)


def cosine_decay(learning_rate, decay_steps, alpha=0.0, global_step=None,
                 main_program=None, startup_program=None):
    """Cosine annealing, lr * ((1-alpha) * 0.5*(1+cos(pi*step/decay_steps))
    + alpha), held at ``alpha*lr`` past ``decay_steps``. Compose with
    ``linear_lr_warmup`` for the warmup + cosine recipe."""
    return _schedule("cosine",
                     {"learning_rate": float(learning_rate),
                      "decay_steps": int(decay_steps),
                      "alpha": float(alpha)},
                     global_step, main_program, startup_program)


def noam_decay(d_model, warmup_steps, global_step=None,
               main_program=None, startup_program=None):
    """The transformer schedule: d_model^-0.5 * min(s^-0.5, s*warmup^-1.5)."""
    return _schedule("noam",
                     {"d_model": float(d_model),
                      "warmup_steps": int(warmup_steps)},
                     global_step, main_program, startup_program)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr,
                     global_step=None, main_program=None,
                     startup_program=None):
    """Ramp start_lr -> end_lr over warmup_steps, then follow
    ``learning_rate`` (a Variable from a decay above, or a float)."""
    helper = LayerHelper("lr_warmup", main_program=main_program,
                         startup_program=startup_program)
    if global_step is None:
        global_step = step_counter(main_program=helper.main_program,
                                   startup_program=helper.startup_program)
    if not hasattr(learning_rate, "name"):  # a plain float
        learning_rate = tensor_layers.fill_constant(
            shape=[1], dtype="float32", value=float(learning_rate),
            main_program=helper.main_program,
            startup_program=helper.startup_program)
    return helper.simple_op(
        "lr_warmup",
        {"LearningRate": [learning_rate], "GlobalStep": [global_step]},
        {"warmup_steps": int(warmup_steps), "start_lr": float(start_lr),
         "end_lr": float(end_lr)})
