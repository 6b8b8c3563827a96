"""Models of the port."""
from .resnet import resnet_cifar10, resnet_imagenet
from .transformer import (TransformerLM, init_params, transformer_lm,
                          transformer_lm_generate)

__all__ = ["TransformerLM", "init_params", "resnet_cifar10",
           "resnet_imagenet", "transformer_lm", "transformer_lm_generate"]
