"""MobileNet v1. Counterpart of ``paddle_tpu/models/mobilenet.py``: a
3x3/s2 conv, then 13 depthwise-separable blocks (a depthwise 3x3 conv,
``groups`` = channels, and a pointwise 1x1 conv, each with batch_norm and
relu), global average pooling and the classifier.

Trained, the pointwise convs are conv2d + batch_norm. Saved for serving
under ``--fused_conv_epilogue``, the inference transpiler folds every BN
into its conv and rewrites each 1x1 conv + BN + relu chain into one
``conv1x1_bn_act`` op (13 of them), which ``conv1x1_epilogue`` runs.
"""
from __future__ import annotations

from .. import layers


def _conv_bn(x, num_filters, filter_size, stride, padding, data_format,
             is_test, groups=1):
    conv = layers.conv2d(x, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=padding, groups=groups, bias_attr=False,
                         data_format=data_format)
    return layers.batch_norm(conv, act="relu", is_test=is_test,
                             data_layout=data_format)


def _separable(x, ch_out, stride, data_format, is_test):
    ch_in = x.shape[3 if data_format == "NHWC" else 1]
    x = _conv_bn(x, ch_in, 3, stride, 1, data_format, is_test,
                 groups=ch_in)  # depthwise
    return _conv_bn(x, ch_out, 1, 1, 0, data_format, is_test)  # pointwise


def mobilenet(images, num_classes=1000, scale=1.0, data_format="NHWC",
              is_test=False):
    """MobileNet v1 for 224x224 inputs; ``scale`` is the width
    multiplier."""
    def c(ch):
        return max(8, int(ch * scale))

    x = _conv_bn(images, c(32), 3, 2, 1, data_format, is_test)
    for ch, stride in [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                       (512, 2)] + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]:
        x = _separable(x, c(ch), stride, data_format, is_test)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True,
                      data_format=data_format)
    return layers.fc(x, size=num_classes)
