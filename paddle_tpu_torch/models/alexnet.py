"""AlexNet. Counterpart of ``paddle_tpu/models/alexnet.py``, the
reference benchmark's ``benchmark/paddle/image/alexnet.py``: conv11/s4 →
lrn → pool → conv5 → lrn → pool → conv3 ×3 → pool → fc4096 ×2 (dropout
0.5) → fc, parameters created in the JAX builder's order."""
from __future__ import annotations

from .. import layers


def alexnet(images, num_classes=1000, data_format="NHWC", is_test=False):
    """images: [N, 224, 224, 3] NHWC (or NCHW) → logits."""
    conv1 = layers.conv2d(images, num_filters=96, filter_size=11, stride=4,
                          padding=1, act="relu", data_format=data_format)
    norm1 = layers.lrn(conv1, n=5, alpha=1e-4, beta=0.75,
                       data_format=data_format)
    pool1 = layers.pool2d(norm1, pool_size=3, pool_stride=2,
                          data_format=data_format)
    conv2 = layers.conv2d(pool1, num_filters=256, filter_size=5, padding=2,
                          act="relu", data_format=data_format)
    norm2 = layers.lrn(conv2, n=5, alpha=1e-4, beta=0.75,
                       data_format=data_format)
    pool2 = layers.pool2d(norm2, pool_size=3, pool_stride=2,
                          data_format=data_format)
    conv3 = layers.conv2d(pool2, num_filters=384, filter_size=3, padding=1,
                          act="relu", data_format=data_format)
    conv4 = layers.conv2d(conv3, num_filters=384, filter_size=3, padding=1,
                          act="relu", data_format=data_format)
    conv5 = layers.conv2d(conv4, num_filters=256, filter_size=3, padding=1,
                          act="relu", data_format=data_format)
    pool5 = layers.pool2d(conv5, pool_size=3, pool_stride=2,
                          data_format=data_format)
    fc6 = layers.fc(pool5, size=4096, act="relu")
    fc6 = layers.dropout(fc6, 0.5, is_test=is_test)
    fc7 = layers.fc(fc6, size=4096, act="relu")
    fc7 = layers.dropout(fc7, 0.5, is_test=is_test)
    return layers.fc(fc7, size=num_classes)
