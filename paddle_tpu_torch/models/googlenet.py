"""GoogLeNet (Inception v1). Counterpart of
``paddle_tpu/models/googlenet.py``, the reference benchmark's
``benchmark/paddle/image/googlenet.py`` without its two auxiliary heads:
nine inception blocks, each four branches (1x1; 1x1 → 3x3; 1x1 → 5x5;
3x3 max pool → 1x1) joined on the channel axis by ``concat``."""
from __future__ import annotations

from .. import layers


def _inception(x, c1, c3r, c3, c5r, c5, proj, data_format):
    ch_axis = 3 if data_format == "NHWC" else 1
    b1 = layers.conv2d(x, num_filters=c1, filter_size=1, act="relu",
                       data_format=data_format)
    b3 = layers.conv2d(x, num_filters=c3r, filter_size=1, act="relu",
                       data_format=data_format)
    b3 = layers.conv2d(b3, num_filters=c3, filter_size=3, padding=1,
                       act="relu", data_format=data_format)
    b5 = layers.conv2d(x, num_filters=c5r, filter_size=1, act="relu",
                       data_format=data_format)
    b5 = layers.conv2d(b5, num_filters=c5, filter_size=5, padding=2,
                       act="relu", data_format=data_format)
    bp = layers.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1,
                       data_format=data_format)
    bp = layers.conv2d(bp, num_filters=proj, filter_size=1, act="relu",
                       data_format=data_format)
    return layers.concat([b1, b3, b5, bp], axis=ch_axis)


def googlenet(images, num_classes=1000, data_format="NHWC", is_test=False):
    """images: [N, 224, 224, 3] → logits (the main head)."""
    x = layers.conv2d(images, num_filters=64, filter_size=7, stride=2,
                      padding=3, act="relu", data_format=data_format)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, data_format=data_format)
    x = layers.conv2d(x, num_filters=64, filter_size=1, act="relu",
                      data_format=data_format)
    x = layers.conv2d(x, num_filters=192, filter_size=3, padding=1,
                      act="relu", data_format=data_format)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, data_format=data_format)
    x = _inception(x, 64, 96, 128, 16, 32, 32, data_format)
    x = _inception(x, 128, 128, 192, 32, 96, 64, data_format)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, data_format=data_format)
    x = _inception(x, 192, 96, 208, 16, 48, 64, data_format)
    x = _inception(x, 160, 112, 224, 24, 64, 64, data_format)
    x = _inception(x, 128, 128, 256, 24, 64, 64, data_format)
    x = _inception(x, 112, 144, 288, 32, 64, 64, data_format)
    x = _inception(x, 256, 160, 320, 32, 128, 128, data_format)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, data_format=data_format)
    x = _inception(x, 256, 160, 320, 32, 128, 128, data_format)
    x = _inception(x, 384, 192, 384, 48, 128, 128, data_format)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True,
                      data_format=data_format)
    x = layers.dropout(x, 0.4, is_test=is_test)
    return layers.fc(x, size=num_classes)
