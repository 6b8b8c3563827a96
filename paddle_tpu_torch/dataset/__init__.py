"""Datasets: the synthetic MNIST the GAN and VAE demos read, the six
the Paddle book chapters read (``uci_housing``, ``imikolov``,
``movielens``, ``imdb``, ``conll05``, ``wmt14``) and the CTR
click-stream Wide&Deep trains on (``ctr``). Counterpart of
``paddle_tpu/dataset``: its readers serve deterministic synthetic data
(downloads are disabled there too), and the port's yield the same
samples bit for bit; a real corpus already under ``common.DATA_HOME`` is
parsed by the same rules."""
from . import (common, conll05, ctr, imdb, imikolov, mnist, movielens,
               uci_housing, wmt14)

__all__ = ["common", "conll05", "ctr", "imdb", "imikolov", "mnist",
           "movielens", "uci_housing", "wmt14"]
