"""The port's synthetic MNIST yields the JAX package's samples bit for
bit: ``train()`` (8192 samples) and ``test()`` (1024), each an image of
784 float32 values in [-1, 1] and an int label, from the same per-name
RandomState (``dataset.common.synthetic_rng``). The reference's readers
are taken through their synthetic path (``_synthetic_reader``), which
they serve when no IDX file sits in the data cache; the port's never
read files, and ``common.download`` raises."""
import numpy as np
import pytest

from paddle_tpu.dataset import common as jcommon
from paddle_tpu.dataset import mnist as jmnist
from paddle_tpu_torch.dataset import common, mnist


@pytest.mark.parametrize("split,n,name", [
    ("train", 8192, "mnist-train"), ("test", 1024, "mnist-t10k")])
def test_mnist_readers_yield_the_reference_samples(split, n, name):
    ours = list(getattr(mnist, split)()())
    ref = list(jmnist._synthetic_reader(n, name)())
    assert len(ours) == len(ref) == n
    for (img, label), (rimg, rlabel) in zip(ours, ref):
        assert img.dtype == np.float32 and img.shape == (784,)
        assert type(label) is int and label == rlabel
        np.testing.assert_array_equal(img, rimg)
    imgs = np.stack([img for img, _ in ours])
    assert imgs.min() >= -1.0 and imgs.max() <= 1.0
    assert sorted({label for _, label in ours}) == list(range(10))


def test_synthetic_rng_and_prototypes_equal_the_reference():
    for name in ("mnist-protos", "mnist-train", "x"):
        np.testing.assert_array_equal(common.synthetic_rng(name).rand(5),
                                      jcommon.synthetic_rng(name).rand(5))
    for p, q in zip(mnist._prototypes(), jmnist._prototypes()):
        np.testing.assert_array_equal(p, q)


def test_downloads_stay_disabled():
    with pytest.raises(FileNotFoundError, match="downloads are disabled"):
        common.download("http://example.invalid/x.gz", "mnist")
