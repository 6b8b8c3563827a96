"""Weight-decay regularizers. Counterpart of ``paddle_tpu/regularizer.py``,
whole: each appends its decay term onto a parameter's gradient before
the optimizer op (L2: ``scale`` of the parameter; L1: ``l1_decay_sign``)
and a ``sum`` into a new gradient. A parameter's own
``ParamAttr(regularizer=)`` wins over the optimizer's global one."""
from __future__ import annotations


class WeightDecayRegularizer:
    def append_decay(self, param, grad, block):
        raise NotImplementedError


def _add_decay(block, param, grad, op_type, tag, attrs):
    """grad + op_type(param) as a new gradient variable."""
    program = block.program
    decay = program.unique_name(param.name + tag)
    block.create_var(name=decay, shape=param.shape, dtype=param.dtype,
                     stop_gradient=True)
    block.append_op(op_type, inputs={"X": [param.name]},
                    outputs={"Out": [decay]}, attrs=attrs)
    out = program.unique_name(grad.name + "@REG")
    block.create_var(name=out, shape=param.shape, dtype=param.dtype,
                     stop_gradient=True)
    block.append_op("sum", inputs={"X": [grad.name, decay]},
                    outputs={"Out": [out]})
    return block.var(out)


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_decay(self, param, grad, block):
        return _add_decay(block, param, grad, "scale", "@L2DECAY",
                          {"scale": self.coeff})


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_decay(self, param, grad, block):
        return _add_decay(block, param, grad, "l1_decay_sign", "@L1DECAY",
                          {"coeff": self.coeff})


def append_regularization_ops(params_grads, regularization=None):
    """Apply each parameter's regularizer (or the global one) to its
    gradient; returns the new [(param, grad)] list."""
    result = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if reg is None:
            result.append((param, grad))
            continue
        result.append((param, reg.append_decay(
            param, grad, param.block.program.global_block)))
    return result


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
