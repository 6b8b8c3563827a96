"""SmallNet for MNIST/CIFAR. Counterpart of
``paddle_tpu/models/smallnet.py``, the reference benchmark's
``benchmark/paddle/image/smallnet_mnist_cifar.py``: conv5x32 → pool →
conv5x64 → pool → fc."""
from __future__ import annotations

from .. import layers


def smallnet_mnist_cifar(images, num_classes=10, data_format="NHWC"):
    x = layers.conv2d(images, num_filters=32, filter_size=5, padding=2,
                      act="relu", data_format=data_format)
    x = layers.pool2d(x, pool_size=2, pool_stride=2, data_format=data_format)
    x = layers.conv2d(x, num_filters=64, filter_size=5, padding=2,
                      act="relu", data_format=data_format)
    x = layers.pool2d(x, pool_size=2, pool_stride=2, data_format=data_format)
    return layers.fc(x, size=num_classes)
