"""Optimizer classes: build backward + update ops into the program.

Counterpart of ``paddle_tpu/optimizer.py``: the ``Optimizer`` base
(``minimize``, accumulators, the learning-rate variable, in-graph
gradient accumulation) and the eleven optimizers SGD, Momentum, Adam,
AdamW, Adamax, Adagrad, DecayedAdagrad, Adadelta, RMSProp and Ftrl.
``minimize`` appends the backward pass, then one update op per
parameter, creating accumulator state as persistable vars initialised in
the startup program, under the JAX package's names (``checkpoint``
saves them in its file format). ``Optimizer(global_step=)`` advances a
user's counter once an applied step, a learning rate may be a schedule
of ``learning_rate_decay``, ``ParamAttr(update_hooks=)`` prunes through
``StaticPruningHook``, and ``ModelAverage`` keeps a windowed average of
the parameters for evaluation. The weight of an ``is_sparse``
embedding gets a SelectedRows gradient: SGD and Adagrad update it
through their ``sparse_sgd``/``sparse_adagrad`` ops, and Momentum and
Adam through their ops' row rules, touching only the looked-up rows.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

from .clip import append_gradient_clip_ops
from .core.backward import append_backward
from .core.program import Program, Variable, default_startup_program
from .core.types import dtype_name


def _sparse_grad_params(block) -> set:
    """The parameters whose gradient arrives as a SelectedRows: the
    weights of ``is_sparse`` lookup_table ops. SGD and Adagrad emit
    their ``sparse_*`` op for them."""
    names = set()
    for op in block.ops:
        if op.type == "lookup_table" and op.attrs.get("is_sparse", False):
            names.update(op.inputs.get("W", ()))
    return names
from .regularizer import append_regularization_ops


class Optimizer:
    op_type: str = None

    def __init__(self, learning_rate: float = 0.001, global_step=None,
                 regularization=None):
        self.learning_rate = learning_rate
        self.global_step = global_step
        self.regularization = regularization
        self._lr_var: Optional[Variable] = None
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._sparse_params: set = set()

    # -- learning rate -----------------------------------------------------
    def _create_lr_var(self, program: Program, startup: Program) -> Variable:
        if self._lr_var is not None:
            return self._lr_var
        if hasattr(self.learning_rate, "name"):
            # a program-computed LR Variable (a learning_rate_decay
            # schedule)
            self._lr_var = self.learning_rate
            return self._lr_var
        name = program.unique_name("learning_rate")
        v = program.global_block.create_var(
            name=name, shape=[1], dtype="float32", persistable=True,
            stop_gradient=True)
        sb = startup.global_block
        sb.create_var(name=name, shape=[1], dtype="float32",
                      persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [name]},
                     attrs={"shape": [1], "dtype": "float32",
                            "value": float(self.learning_rate)})
        self._lr_var = v
        return v

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name: str, param: Variable, startup: Program,
                         fill_value: float = 0.0, shape=None,
                         dtype="float32") -> Variable:
        shape = list(shape if shape is not None else param.shape)
        var_name = f"{param.name}_{name}_acc"
        block = param.block.program.global_block
        v = block.create_var(name=var_name, shape=shape, dtype=dtype,
                             persistable=True, stop_gradient=True)
        sb = startup.global_block
        sb.create_var(name=var_name, shape=shape, dtype=dtype,
                      persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [var_name]},
                     attrs={"shape": shape, "dtype": dtype,
                            "value": float(fill_value)})
        self._accumulators.setdefault(name, {})[param.name] = v
        return v

    def _get_accumulator(self, name, param) -> Variable:
        return self._accumulators[name][param.name]

    # -- per-algorithm hooks ----------------------------------------------
    def _create_accumulators(self, startup, params: List[Variable]):
        pass

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def minimize(self, loss: Variable,
                 startup_program: Optional[Program] = None,
                 parameter_list=None, no_grad_set=None,
                 accumulate_steps: int = 1
                 ) -> List[Tuple[Variable, Variable]]:
        """Append backward + update ops for ``loss``; returns the
        [(param, grad)] pairs.

        ``accumulate_steps`` > 1 turns on in-graph gradient accumulation:
        each run adds the micro-batch gradient into a persistent
        ``*_gradsum_acc`` buffer, and every k-th run the optimizer
        (with its moments and beta powers) applies on the MEAN of the k
        gradients, so k micro-batches make one large-batch step. Every
        state write goes through a gate: the other runs leave all state
        bit-identical."""
        startup = startup_program or default_startup_program()
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        self._sparse_params = _sparse_grad_params(loss.block)
        block = loss.block
        lr_var = self._create_lr_var(block.program, startup)
        if accumulate_steps and int(accumulate_steps) > 1:
            # clip and regularization must see the accumulated mean, so
            # they are appended inside the accumulation plumbing
            self._create_accumulators(startup, [p for p, _ in params_grads])
            self._minimize_accumulated(block, startup, params_grads, lr_var,
                                       int(accumulate_steps))
            self._append_updater_hooks(block, startup,
                                       [p for p, _ in params_grads])
            return params_grads
        # clip before regularization, fluid's order
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_accumulators(startup, [p for p, _ in params_grads])
        for pg in params_grads:
            self._append_optimize_op(block, pg, lr_var)
        if self.global_step is not None:
            block.append_op("increment",
                            inputs={"X": [self.global_step.name]},
                            outputs={"Out": [self.global_step.name]},
                            attrs={"step": 1.0})
        self._append_updater_hooks(block, startup,
                                   [p for p, _ in params_grads])
        return params_grads

    def _minimize_accumulated(self, block, startup, params_grads, lr_var,
                              k: int):
        """Gradient accumulation: buffer += grad each run; every k-th run
        clip, regularization and the optimizer op apply on the mean of
        the k gradients, and every state write (param, moments, beta
        powers, step counters) lands through a gate, s = old + gate * (s
        - old), so the other runs keep all state bit-identical. The
        counter resets on the applying run (no mod op needed).

        Counters keep their dtypes (a schedule's ``lr_global_step`` is
        int32). Schedules on the shared ``lr_global_step`` counter, and
        the optimizer's own ``global_step``, advance once an applied
        step; a ``global_step`` passed straight to a decay function
        cannot be found here and would tick every run, so pass it to the
        optimizer as well."""
        from . import layers as L

        kw = dict(main_program=block.program, startup_program=startup)
        counter = L.create_global_var(
            shape=[1], value=0.0, dtype="float32",
            name=block.program.unique_name("grad_acc_step"), **kw)
        block.append_op("increment", inputs={"X": [counter.name]},
                        outputs={"Out": [counter.name]},
                        attrs={"step": 1.0})
        k_c = L.fill_constant(shape=[1], value=float(k), dtype="float32",
                              **kw)
        gate = L.cast(L.equal(counter, k_c, **kw), "float32", **kw)
        inv_gate = L.scale(gate, scale=-1.0, bias=1.0, **kw)
        block.append_op("elementwise_mul",
                        inputs={"X": [counter.name], "Y": [inv_gate.name]},
                        outputs={"Out": [counter.name]}, attrs={})
        # LR schedules carry per-run counters (learning_rate_decay's
        # lr_global_step, incremented where the schedule was built);
        # subtracting the increment back on the other runs makes a
        # schedule advance once per applied step
        lr_counters = {n for op in block.ops if op.type == "increment"
                       for n in op.inputs.get("X", [])
                       if "lr_global_step" in n}
        shared = getattr(block.program, "_lr_step_counter", None)
        if shared is not None:
            lr_counters.add(shared.name)
        for name in sorted(lr_counters):
            dt = dtype_name(block.vars[name].dtype)
            ig = inv_gate if dt == "float32" else L.cast(inv_gate, dt, **kw)
            block.append_op("elementwise_sub",
                            inputs={"X": [name], "Y": [ig.name]},
                            outputs={"Out": [name]}, attrs={})
        # pass 1: accumulate and form every mean
        means, accs = [], []
        for p, g in params_grads:
            acc = self._add_accumulator("gradsum", p, startup)
            accs.append(acc)
            block.append_op("elementwise_add",
                            inputs={"X": [acc.name], "Y": [g.name]},
                            outputs={"Out": [acc.name]}, attrs={})
            means.append(L.scale(acc, scale=1.0 / k, **kw))
        pg_mean = append_gradient_clip_ops(
            [(p, m) for (p, _), m in zip(params_grads, means)])
        pg_mean = append_regularization_ops(pg_mean, self.regularization)
        # pass 2: the gated update of each parameter and its state
        for (p, mean), acc in zip(pg_mean, accs):
            states = [p] + [vars_[p.name]
                            for name, vars_ in self._accumulators.items()
                            if name != "gradsum" and p.name in vars_]
            olds = [L.assign(st, **kw) for st in states]
            self._append_optimize_op(block, (p, mean), lr_var)
            for st, old in zip(states, olds):
                gated = L.elementwise_mul(L.elementwise_sub(st, old, **kw),
                                          gate, **kw)
                block.append_op("elementwise_add",
                                inputs={"X": [old.name], "Y": [gated.name]},
                                outputs={"Out": [st.name]}, attrs={})
            block.append_op("elementwise_mul",
                            inputs={"X": [acc.name], "Y": [inv_gate.name]},
                            outputs={"Out": [acc.name]}, attrs={})
        if self.global_step is not None:
            # counter += gate, in the counter's own dtype
            name = self.global_step.name
            dt = dtype_name(self.global_step.dtype)
            g = gate if dt == "float32" else L.cast(gate, dt, **kw)
            block.append_op("elementwise_add",
                            inputs={"X": [name], "Y": [g.name]},
                            outputs={"Out": [name]}, attrs={})

    def _append_updater_hooks(self, block, startup, params):
        """Updater hooks: for a parameter with a ``StaticPruningHook``,
        the startup program builds the fixed mask from the initialised
        weights and prunes them, and the main program applies the mask
        again after every update."""
        from .param_attr import StaticPruningHook

        for p in params:
            for hook in getattr(p, "update_hooks", ()) or ():
                if not isinstance(hook, StaticPruningHook):
                    raise TypeError(f"unsupported updater hook {hook!r}")
                mask_name = p.name + "@PRUNE_MASK"
                sb = startup.global_block
                sb.create_var(name=mask_name, shape=p.shape, dtype=p.dtype,
                              persistable=True)
                sb.append_op(
                    "static_prune_mask", inputs={"Param": [p.name]},
                    outputs={"Mask": [mask_name]},
                    attrs={"sparsity_ratio": hook.sparsity_ratio})
                sb.append_op("elementwise_mul",
                             inputs={"X": [p.name], "Y": [mask_name]},
                             outputs={"Out": [p.name]}, attrs={})
                block.create_var(name=mask_name, shape=p.shape,
                                 dtype=p.dtype, persistable=True,
                                 stop_gradient=True)
                block.append_op("elementwise_mul",
                                inputs={"X": [p.name], "Y": [mask_name]},
                                outputs={"Out": [p.name]}, attrs={})


def _update_op(block, op_type, p, g, lr_var, states, attrs):
    """Append one update op: Param, Grad, LearningRate (when given) and
    each (input slot, output slot, accumulator) of ``states``, written
    back in place."""
    inputs = {"Param": [p.name], "Grad": [g.name]}
    if lr_var is not None:
        inputs["LearningRate"] = [lr_var.name]
    outputs = {"ParamOut": [p.name]}
    for slot_in, slot_out, acc in states:
        inputs[slot_in] = [acc.name]
        outputs[slot_out] = [acc.name]
    block.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)


class SGDOptimizer(Optimizer):
    op_type = "sgd"

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        op_type = "sparse_sgd" if p.name in self._sparse_params else "sgd"
        _update_op(block, op_type, p, g, lr_var, [], {})


class MomentumOptimizer(Optimizer):
    op_type = "momentum"

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _create_accumulators(self, startup, params):
        for p in params:
            self._add_accumulator("velocity", p, startup)

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        _update_op(block, "momentum", p, g, lr_var,
                   [("Velocity", "VelocityOut",
                     self._get_accumulator("velocity", p))],
                   {"mu": self.momentum, "use_nesterov": self.use_nesterov})


class AdamOptimizer(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = 0.0  # AdamWOptimizer sets it

    def _create_accumulators(self, startup, params):
        for p in params:
            self._add_accumulator("moment1", p, startup)
            self._add_accumulator("moment2", p, startup)
            self._add_accumulator("beta1_pow", p, startup, self.beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow", p, startup, self.beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        acc = self._get_accumulator
        _update_op(block, "adam", p, g, lr_var,
                   [("Moment1", "Moment1Out", acc("moment1", p)),
                    ("Moment2", "Moment2Out", acc("moment2", p)),
                    ("Beta1Pow", "Beta1PowOut", acc("beta1_pow", p)),
                    ("Beta2Pow", "Beta2PowOut", acc("beta2_pow", p))],
                   {"beta1": self.beta1, "beta2": self.beta2,
                    "epsilon": self.epsilon,
                    "weight_decay": self.weight_decay})


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay: p -= lr * wd * p outside the
    moment estimates (``regularization=L2Decay`` would add wd * p into
    the gradient, and so into the moments)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self.weight_decay = weight_decay


class AdamaxOptimizer(Optimizer):
    op_type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, startup, params):
        for p in params:
            self._add_accumulator("moment", p, startup)
            self._add_accumulator("inf_norm", p, startup)
            self._add_accumulator("beta1_pow", p, startup, self.beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        acc = self._get_accumulator
        _update_op(block, "adamax", p, g, lr_var,
                   [("Moment", "MomentOut", acc("moment", p)),
                    ("InfNorm", "InfNormOut", acc("inf_norm", p)),
                    ("Beta1Pow", "Beta1PowOut", acc("beta1_pow", p))],
                   {"beta1": self.beta1, "beta2": self.beta2,
                    "epsilon": self.epsilon})


class AdagradOptimizer(Optimizer):
    op_type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon

    def _create_accumulators(self, startup, params):
        for p in params:
            self._add_accumulator("moment", p, startup)

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        op_type = ("sparse_adagrad" if p.name in self._sparse_params
                   else "adagrad")
        _update_op(block, op_type, p, g, lr_var,
                   [("Moment", "MomentOut",
                     self._get_accumulator("moment", p))],
                   {"epsilon": self.epsilon})


class DecayedAdagradOptimizer(Optimizer):
    op_type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def _create_accumulators(self, startup, params):
        for p in params:
            self._add_accumulator("moment", p, startup)

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        _update_op(block, "decayed_adagrad", p, g, lr_var,
                   [("Moment", "MomentOut",
                     self._get_accumulator("moment", p))],
                   {"decay": self.decay, "epsilon": self.epsilon})


class AdadeltaOptimizer(Optimizer):
    """Adadelta takes no learning rate in its update (the reference's
    adadelta_op)."""

    op_type = "adadelta"

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def _create_accumulators(self, startup, params):
        for p in params:
            self._add_accumulator("avg_sq_grad", p, startup)
            self._add_accumulator("avg_sq_update", p, startup)

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        acc = self._get_accumulator
        _update_op(block, "adadelta", p, g, None,
                   [("AvgSquaredGrad", "AvgSquaredGradOut",
                     acc("avg_sq_grad", p)),
                    ("AvgSquaredUpdate", "AvgSquaredUpdateOut",
                     acc("avg_sq_update", p))],
                   {"rho": self.rho, "epsilon": self.epsilon})


class RMSPropOptimizer(Optimizer):
    op_type = "rmsprop"

    def __init__(self, learning_rate, decay=0.9, momentum=0.0,
                 epsilon=1e-10, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.momentum, self.epsilon = decay, momentum, epsilon

    def _create_accumulators(self, startup, params):
        for p in params:
            self._add_accumulator("mean_square", p, startup)
            self._add_accumulator("moment", p, startup)

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        acc = self._get_accumulator
        _update_op(block, "rmsprop", p, g, lr_var,
                   [("MeanSquare", "MeanSquareOut", acc("mean_square", p)),
                    ("Moment", "MomentOut", acc("moment", p))],
                   {"decay": self.decay, "momentum": self.momentum,
                    "epsilon": self.epsilon})


class FtrlOptimizer(Optimizer):
    op_type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _create_accumulators(self, startup, params):
        for p in params:
            self._add_accumulator("squared_acc", p, startup)
            self._add_accumulator("linear_acc", p, startup)

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        acc = self._get_accumulator
        _update_op(block, "ftrl", p, g, lr_var,
                   [("SquaredAccumulator", "SquaredAccumOut",
                     acc("squared_acc", p)),
                    ("LinearAccumulator", "LinearAccumOut",
                     acc("linear_acc", p))],
                   {"l1": self.l1, "l2": self.l2,
                    "lr_power": self.lr_power})


# fluid aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer


class ModelAverage:
    """A windowed average of the parameters, for evaluation.

    Build it after ``Optimizer.minimize``: it appends one
    ``model_average_update`` op a trainable parameter, so the window
    accumulates inside the training step. ``apply(scope)`` is a context
    manager that puts the averaged values into the scope and restores the
    live parameters on exit. Two buffers rotate (Sum1 live, Sum2 the last
    full window), so the average spans one to two windows;
    ``min_average_window`` gates ``apply``: with fewer accumulated steps
    the live parameters stay.
    """

    def __init__(self, average_window_rate: float = 0.15,
                 min_average_window: int = 100,
                 max_average_window: int = 10000,
                 main_program: Optional[Program] = None,
                 startup_program: Optional[Program] = None):
        from .core.program import default_main_program
        from .initializer import ConstantInitializer

        del average_window_rate  # the window is bounded explicitly
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        main = main_program or default_main_program()
        startup = startup_program or default_startup_program()
        block = main.global_block
        self._slots: List[Tuple[str, Dict[str, str]]] = []
        for p in block.all_parameters():
            if not p.trainable:
                continue
            names = {}
            for suffix, shape in (("sum_1", p.shape), ("sum_2", p.shape),
                                  ("num_1", [1]), ("num_2", [1])):
                name = f"{p.name}@MA_{suffix}"
                names[suffix] = name
                block.create_var(name=name, shape=shape, dtype="float32",
                                 persistable=True, stop_gradient=True)
                sv = startup.global_block.create_var(
                    name=name, shape=shape, dtype="float32",
                    persistable=True)
                ConstantInitializer(0.0)(sv, startup.global_block)
            block.append_op(
                "model_average_update",
                inputs={"Param": [p.name], "Sum1": [names["sum_1"]],
                        "Sum2": [names["sum_2"]], "Num1": [names["num_1"]],
                        "Num2": [names["num_2"]]},
                outputs={"Sum1Out": [names["sum_1"]],
                         "Sum2Out": [names["sum_2"]],
                         "Num1Out": [names["num_1"]],
                         "Num2Out": [names["num_2"]]},
                attrs={"max_average_window": self.max_average_window})
            self._slots.append((p.name, names))

    def apply(self, scope=None):
        """A context manager: inside it the scope holds the averaged
        parameters, (Sum1 + Sum2) / (Num1 + Num2) computed where the
        sums live, in the parameter's dtype; on exit the live tensors
        themselves go back (no host copy is left in the scope)."""
        from .core.scope import global_scope

        scope = scope or global_scope()

        @contextlib.contextmanager
        def _ctx():
            backup = {}
            for pname, names in self._slots:
                n = (float(scope.get(names["num_1"]).reshape(-1)[0])
                     + float(scope.get(names["num_2"]).reshape(-1)[0]))
                if n <= 0 or n < self.min_average_window:
                    continue
                live = scope.get(pname)
                total = scope.get(names["sum_1"]) + scope.get(names["sum_2"])
                # a tensor divisor: a scalar one is a reciprocal product
                # on the card
                avg = total / total.new_full((), n)
                backup[pname] = live
                scope.set(pname, avg.to(live.dtype))
            try:
                yield self
            finally:
                for pname, val in backup.items():
                    scope.set(pname, val)

        return _ctx()
