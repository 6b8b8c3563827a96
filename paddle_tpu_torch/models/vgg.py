"""VGG-16 and VGG-19. Counterpart of ``paddle_tpu/models/vgg.py``, the
reference benchmark's ``benchmark/paddle/image/vgg.py``: five
``img_conv_group`` blocks of 3x3 convs (2, 2, 3, 3, 3 at depth 16; 2, 2,
4, 4, 4 at 19), then fc4096 ×2 (dropout 0.5) and the classifier."""
from __future__ import annotations

from .. import layers
from ..nets import img_conv_group


def vgg(images, num_classes=1000, depth=19, data_format="NHWC",
        is_test=False):
    if depth not in (16, 19):
        raise ValueError(f"vgg depth must be 16 or 19, got {depth}")
    nums = [2, 2, 3, 3, 3] if depth == 16 else [2, 2, 4, 4, 4]
    x = images
    for filters, n in zip([64, 128, 256, 512, 512], nums):
        x = img_conv_group(x, [filters] * n, conv_filter_size=3,
                           conv_act="relu", data_format=data_format)
    fc1 = layers.fc(x, size=4096, act="relu")
    fc1 = layers.dropout(fc1, 0.5, is_test=is_test)
    fc2 = layers.fc(fc1, size=4096, act="relu")
    fc2 = layers.dropout(fc2, 0.5, is_test=is_test)
    return layers.fc(fc2, size=num_classes)
