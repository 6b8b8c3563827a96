"""Models of the port."""
from .alexnet import alexnet
from .googlenet import googlenet
from .lenet import lenet5
from .mobilenet import mobilenet
from .resnet import resnet_cifar10, resnet_imagenet
from .smallnet import smallnet_mnist_cifar
from .transformer import (TransformerLM, init_params, transformer_lm,
                          transformer_lm_generate)
from .vgg import vgg

__all__ = ["TransformerLM", "alexnet", "googlenet", "init_params", "lenet5",
           "mobilenet", "resnet_cifar10", "resnet_imagenet",
           "smallnet_mnist_cifar", "transformer_lm",
           "transformer_lm_generate", "vgg"]
