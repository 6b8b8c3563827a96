"""ResNet, the image-classification model family. Counterpart of
``paddle_tpu/models/resnet.py``: ImageNet ResNet-50/101/152 with
bottleneck blocks and the CIFAR variant with basic blocks, NHWC by
default, projection shortcuts only where the shape changes.

Under ``--fused_conv_epilogue`` every NHWC 1x1/stride-1 conv + BN
(+ residual) (+ relu) chain is built as one ``conv1x1_bn_act`` op; for
ResNet-50 that is conv a and conv c of each of the 16 bottlenecks and
stage 1's stride-1 projection, 33 ops. Recompute segments
(``recompute=True``) are a later slice of the port.
"""
from __future__ import annotations

from .. import layers


def _no_recompute(recompute):
    if recompute:
        raise NotImplementedError(
            "resnet(recompute=True) builds recompute segments "
            "(recompute_guard), which are not ported to paddle_tpu_torch "
            "yet: they land with the per-layer transformer training slice")


def _fuse_epilogue(filter_size, stride, padding, data_format):
    from ..flags import FLAGS

    return (FLAGS.fused_conv_epilogue and filter_size == 1 and stride == 1
            and padding == 0 and data_format == "NHWC")


def _conv_bn(x, num_filters, filter_size, stride=1, padding=0, act="relu",
             data_format="NHWC", is_test=False):
    if _fuse_epilogue(filter_size, stride, padding, data_format):
        return layers.conv1x1_bn_act(x, num_filters, act=act,
                                     is_test=is_test)
    conv = layers.conv2d(x, num_filters=num_filters, filter_size=filter_size,
                         stride=stride, padding=padding, bias_attr=False,
                         data_format=data_format)
    return layers.batch_norm(conv, act=act, is_test=is_test,
                             data_layout=data_format)


def _shortcut(x, ch_out, stride, data_format, is_test):
    ch_axis = 3 if data_format == "NHWC" else 1
    if x.shape[ch_axis] != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride, act=None,
                        data_format=data_format, is_test=is_test)
    return x


def _bottleneck(x, ch_mid, stride, data_format, is_test, recompute=False):
    """1x1 -> 3x3 -> 1x1 (x4) bottleneck."""
    _no_recompute(recompute)
    ch_out = ch_mid * 4
    short = _shortcut(x, ch_out, stride, data_format, is_test)
    y = _conv_bn(x, ch_mid, 1, 1, 0, data_format=data_format,
                 is_test=is_test)
    y = _conv_bn(y, ch_mid, 3, stride, 1, data_format=data_format,
                 is_test=is_test)
    if _fuse_epilogue(1, 1, 0, data_format):
        # residual add + relu ride the final 1x1 conv's output tile
        return layers.conv1x1_bn_act(y, ch_out, residual=short,
                                     act="relu", is_test=is_test)
    y = _conv_bn(y, ch_out, 1, 1, 0, act=None, data_format=data_format,
                 is_test=is_test)
    added = layers.elementwise_add(y, short)
    return layers.relu(added)


def _basicblock(x, ch_out, stride, data_format, is_test, recompute=False):
    _no_recompute(recompute)
    short = _shortcut(x, ch_out, stride, data_format, is_test)
    y = _conv_bn(x, ch_out, 3, stride, 1, data_format=data_format,
                 is_test=is_test)
    y = _conv_bn(y, ch_out, 3, 1, 1, act=None, data_format=data_format,
                 is_test=is_test)
    added = layers.elementwise_add(y, short)
    return layers.relu(added)


def resnet_imagenet(images, num_classes=1000, depth=50, data_format="NHWC",
                    is_test=False, recompute=False):
    """ResNet-50/101/152 for 224x224 ImageNet."""
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
    assert depth in cfg, (f"resnet_imagenet depth must be one of "
                          f"{sorted(cfg)}, got {depth}")
    counts = cfg[depth]
    x = _conv_bn(images, 64, 7, stride=2, padding=3, data_format=data_format,
                 is_test=is_test)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      data_format=data_format)
    for stage, (ch_mid, n) in enumerate(zip([64, 128, 256, 512], counts)):
        for block in range(n):
            stride = 2 if block == 0 and stage > 0 else 1
            x = _bottleneck(x, ch_mid, stride, data_format, is_test,
                            recompute=recompute)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True,
                      data_format=data_format)
    return layers.fc(x, size=num_classes)


def resnet_cifar10(images, num_classes=10, depth=32, data_format="NHWC",
                   is_test=False, recompute=False):
    """CIFAR ResNet with basic blocks, depth = 6n+2."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    x = _conv_bn(images, 16, 3, 1, 1, data_format=data_format,
                 is_test=is_test)
    for stage, ch in enumerate([16, 32, 64]):
        for block in range(n):
            stride = 2 if block == 0 and stage > 0 else 1
            x = _basicblock(x, ch, stride, data_format, is_test,
                            recompute=recompute)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True,
                      data_format=data_format)
    return layers.fc(x, size=num_classes)
