"""Models of the port."""
from .alexnet import alexnet
from .googlenet import googlenet
from .lenet import lenet5
from .mobilenet import mobilenet
from .resnet import resnet_cifar10, resnet_imagenet
from .smallnet import smallnet_mnist_cifar
from .seq2seq import shared_nmt_params, transformer_nmt_teacher
from .transformer import (TransformerLM, init_params, transformer_lm,
                          transformer_lm_beam_search, transformer_lm_generate,
                          transformer_lm_speculative_generate)
from .vgg import vgg
from .wide_deep import wide_deep, wide_deep_loss

__all__ = ["TransformerLM", "alexnet", "googlenet", "init_params", "lenet5",
           "mobilenet", "resnet_cifar10", "resnet_imagenet",
           "shared_nmt_params", "smallnet_mnist_cifar", "transformer_lm",
           "transformer_lm_beam_search", "transformer_lm_generate",
           "transformer_lm_speculative_generate", "transformer_nmt_teacher",
           "vgg", "wide_deep", "wide_deep_loss"]
