"""The port's models: the causal LM and the four classifiers, with the JAX
package's registry (``get_model``, ``input_spec``)."""

from dtdl_tpu_torch.models.cnn import MnistCNN
from dtdl_tpu_torch.models.mlp import MLP
from dtdl_tpu_torch.models.pyramidnet import PyramidNet, pyramidnet
from dtdl_tpu_torch.models.resnet import ResNet, ResNet50, resnet50
from dtdl_tpu_torch.models.transformer import (CacheOverflowError,
                                               TransformerLM, generate,
                                               transformer_lm)

__all__ = ["CacheOverflowError", "MLP", "MnistCNN", "PyramidNet", "ResNet",
           "ResNet50", "TransformerLM", "generate", "get_model",
           "input_spec", "pyramidnet", "resnet50", "transformer_lm"]

_REGISTRY = {
    "mlp": MLP,
    "mnist_cnn": MnistCNN,
    "pyramidnet": pyramidnet,
    "resnet50": resnet50,
    "transformer_lm": transformer_lm,
}

_SPECS = {
    "mlp": ((784,), "mnist"),
    "mnist_cnn": ((28, 28, 1), "mnist"),
    "pyramidnet": ((32, 32, 3), "cifar10"),
    "resnet50": ((224, 224, 3), "imagenet"),
    "transformer_lm": ((128,), "synthetic_lm"),
}


def get_model(name: str, **kwargs):
    """The registered model ``name`` built with ``kwargs`` (``device=``
    among them; the card unless ``device="cpu"``)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def input_spec(name: str) -> tuple[tuple[int, ...], str]:
    """(example input shape without batch dim, dataset name) per model."""
    if name not in _SPECS:
        raise ValueError(f"unknown model {name!r}; have {sorted(_SPECS)}")
    return _SPECS[name]
