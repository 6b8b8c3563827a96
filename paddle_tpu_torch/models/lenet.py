"""LeNet-5 for MNIST. Counterpart of ``paddle_tpu/models/lenet.py``: two
conv-pool stages, then two fc layers."""
from __future__ import annotations

from .. import layers


def lenet5(images, data_format="NHWC", num_classes=10):
    """images: [N, 28, 28, 1] (NHWC) or [N, 1, 28, 28] (NCHW) → logits."""
    conv1 = layers.conv2d(images, num_filters=20, filter_size=5, act="relu",
                          data_format=data_format)
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2,
                          data_format=data_format)
    conv2 = layers.conv2d(pool1, num_filters=50, filter_size=5, act="relu",
                          data_format=data_format)
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2,
                          data_format=data_format)
    fc1 = layers.fc(pool2, size=500, act="relu")
    return layers.fc(fc1, size=num_classes)
