"""v2 attribute objects. Counterpart of ``paddle_tpu/v2/attr.py``
(reference v2/attr.py): Param/Extra attrs map onto ParamAttr."""
from ..param_attr import ParamAttr as _ParamAttr


def Param(name=None, initial_std=None, initial_mean=None, l2_rate=None,
          learning_rate=1.0, is_static=False, **kw):
    from ..initializer import NormalInitializer
    from ..regularizer import L2Decay

    init = None
    if initial_std is not None or initial_mean is not None:
        init = NormalInitializer(initial_mean or 0.0, initial_std or 0.01)
    reg = L2Decay(l2_rate) if l2_rate else None
    return _ParamAttr(name=name, initializer=init, regularizer=reg,
                      learning_rate=learning_rate,
                      trainable=not is_static)


def Extra(drop_rate=None, **kw):
    """ExtraAttr subset: only drop_rate is read."""
    return {"drop_rate": drop_rate}


ParamAttr = Param
ExtraAttr = Extra
