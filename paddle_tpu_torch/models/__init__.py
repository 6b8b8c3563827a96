"""Models of the port."""
from .transformer import TransformerLM, init_params, transformer_lm

__all__ = ["TransformerLM", "init_params", "transformer_lm"]
