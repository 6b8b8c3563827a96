"""Datasets, cut to the synthetic MNIST the GAN and VAE demos read.
Counterpart of ``paddle_tpu/dataset``: its readers serve deterministic
synthetic data (downloads are disabled there too), and the port's yield
the same samples bit for bit."""
from . import common, mnist

__all__ = ["common", "mnist"]
