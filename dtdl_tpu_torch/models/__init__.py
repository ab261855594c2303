"""The port's models."""

from dtdl_tpu_torch.models.transformer import (CacheOverflowError,
                                               TransformerLM, generate,
                                               transformer_lm)

__all__ = ["CacheOverflowError", "TransformerLM", "generate",
           "transformer_lm"]
