"""Composite network helpers. Counterpart of ``paddle_tpu/nets.py``:
``simple_img_conv_pool``, ``img_conv_group`` (VGG's conv blocks) and
``glu``."""
from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, pool_type="max", data_format="NCHW",
                         param_attr=None, main_program=None,
                         startup_program=None):
    """One conv2d with its activation, then one pool2d."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act, data_format=data_format,
        main_program=main_program, startup_program=startup_program)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, data_format=data_format,
        main_program=main_program, startup_program=startup_program)


def img_conv_group(input, conv_num_filter, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_size=2, pool_stride=2, pool_type="max",
                   data_format="NCHW", main_program=None,
                   startup_program=None):
    """A VGG block: one 'same'-padded conv2d per entry of
    ``conv_num_filter`` (each optionally followed by batch_norm, which
    then takes the activation, and dropout), then one pool2d. The filter
    size, batch-norm and drop-rate options take one value or one per
    conv."""
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]
    n = len(conv_num_filter)

    def per_conv(x):
        return x if isinstance(x, (list, tuple)) else [x] * n

    sizes = per_conv(conv_filter_size)
    with_bn = per_conv(conv_with_batchnorm)
    drop = per_conv(conv_batchnorm_drop_rate)
    tmp = input
    for i in range(n):
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i], filter_size=sizes[i],
            padding=(sizes[i] - 1) // 2,
            act=None if with_bn[i] else conv_act, data_format=data_format,
            main_program=main_program, startup_program=startup_program)
        if with_bn[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act,
                                    data_layout=data_format,
                                    main_program=main_program,
                                    startup_program=startup_program)
            if drop[i] > 0:
                tmp = layers.dropout(x=tmp, dropout_prob=drop[i],
                                     main_program=main_program,
                                     startup_program=startup_program)
    return layers.pool2d(input=tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, data_format=data_format,
                         main_program=main_program,
                         startup_program=startup_program)


def glu(input, dim=-1, main_program=None, startup_program=None):
    """Gated linear unit: ``input`` split in two halves a, b along
    ``dim``, a * sigmoid(b)."""
    a, b = layers.split(input, 2, dim=dim, main_program=main_program,
                        startup_program=startup_program)
    gate = layers.sigmoid(b, main_program=main_program,
                          startup_program=startup_program)
    return layers.elementwise_mul(a, gate, main_program=main_program,
                                  startup_program=startup_program)
