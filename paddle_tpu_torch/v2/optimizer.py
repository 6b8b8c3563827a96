"""v2 optimizer objects. Counterpart of ``paddle_tpu/v2/optimizer.py``
(reference python/paddle/v2/optimizer.py): names over the optimizers."""
from .. import optimizer as _opt


def Momentum(learning_rate=0.01, momentum=0.9, **kw):
    return _opt.MomentumOptimizer(learning_rate=learning_rate,
                                  momentum=momentum)


def Adam(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
    return _opt.AdamOptimizer(learning_rate=learning_rate, beta1=beta1,
                              beta2=beta2, epsilon=epsilon)


def AdaGrad(learning_rate=1e-2, **kw):
    return _opt.AdagradOptimizer(learning_rate=learning_rate)


def RMSProp(learning_rate=1e-3, **kw):
    return _opt.RMSPropOptimizer(learning_rate=learning_rate)


def SGD(learning_rate=1e-2, **kw):
    return _opt.SGDOptimizer(learning_rate=learning_rate)
