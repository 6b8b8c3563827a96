"""Optimizer classes: build backward + update ops into the program.

Counterpart of ``paddle_tpu/optimizer.py``, cut to the ``Optimizer`` base
(``minimize``, accumulators, the learning-rate variable), ``SGDOptimizer``,
``MomentumOptimizer`` and ``AdamOptimizer``. ``minimize`` appends the backward pass, then one
update op per parameter, creating accumulator state as persistable vars
initialised in the startup program. Gradient accumulation
(``accumulate_steps`` > 1), global steps, updater hooks and the other
optimizers are later slices of the port.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .clip import append_gradient_clip_ops
from .core.backward import append_backward
from .core.program import Program, Variable, default_startup_program
from .regularizer import append_regularization_ops


class Optimizer:
    op_type: str = None

    def __init__(self, learning_rate: float = 0.001, global_step=None,
                 regularization=None):
        if global_step is not None:
            raise NotImplementedError(
                "Optimizer(global_step=...) is not ported to "
                "paddle_tpu_torch yet: it lands with the LR-schedule slice")
        self.learning_rate = learning_rate
        self.global_step = global_step
        self.regularization = regularization
        self._lr_var: Optional[Variable] = None
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    # -- learning rate -----------------------------------------------------
    def _create_lr_var(self, program: Program, startup: Program) -> Variable:
        if self._lr_var is not None:
            return self._lr_var
        if hasattr(self.learning_rate, "name"):
            # a program-computed LR Variable
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
        [(param, grad)] pairs."""
        if accumulate_steps and int(accumulate_steps) > 1:
            raise NotImplementedError(
                "minimize(accumulate_steps > 1) is not ported to "
                "paddle_tpu_torch yet: in-graph gradient accumulation lands "
                "with the optimizer-plane slice")
        startup = startup_program or default_startup_program()
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        block = loss.block
        lr_var = self._create_lr_var(block.program, startup)
        # clip before regularization, fluid's order
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_accumulators(startup, [p for p, _ in params_grads])
        for pg in params_grads:
            self._append_optimize_op(block, pg, lr_var)
        return params_grads


class SGDOptimizer(Optimizer):
    op_type = "sgd"

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        block.append_op(
            "sgd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "LearningRate": [lr_var.name]},
            outputs={"ParamOut": [p.name]})


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
        v = self._get_accumulator("velocity", p)
        block.append_op(
            "momentum",
            inputs={"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
                    "LearningRate": [lr_var.name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self.momentum, "use_nesterov": self.use_nesterov})


class AdamOptimizer(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = 0.0

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
        acc = {name: self._get_accumulator(name, p).name
               for name in ("moment1", "moment2", "beta1_pow", "beta2_pow")}
        block.append_op(
            "adam",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "LearningRate": [lr_var.name],
                    "Moment1": [acc["moment1"]], "Moment2": [acc["moment2"]],
                    "Beta1Pow": [acc["beta1_pow"]],
                    "Beta2Pow": [acc["beta2_pow"]]},
            outputs={"ParamOut": [p.name],
                     "Moment1Out": [acc["moment1"]],
                     "Moment2Out": [acc["moment2"]],
                     "Beta1PowOut": [acc["beta1_pow"]],
                     "Beta2PowOut": [acc["beta2_pow"]]},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon,
                   "weight_decay": self.weight_decay})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
