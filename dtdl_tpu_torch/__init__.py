"""dtdl_tpu_torch: the PyTorch/CUDA port of dtdl_tpu for one NVIDIA H100.

The JAX package ``dtdl_tpu`` stays the reference; this package mirrors
its module names (``ops/``, ``models/``, ``train/``, ``data/``,
``serve/``, ``metrics/``, ``obs/``) and imports only torch, numpy and the
standard library.  Every
Pallas kernel on a ported path is a hand-written Hopper kernel under
``csrc/``, built by :mod:`dtdl_tpu_torch.kernels`; each has a plain
PyTorch version beside it that CPU tensors take.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no CUDA device they raise :class:`NoCudaDeviceError`.  The ported
slices train the image classifiers (:func:`pyramidnet`, :func:`resnet50`,
``MLP``, ``MnistCNN`` in :mod:`dtdl_tpu_torch.models`, with flax's
BatchNorm, through ``train.step.make_train_step``/``make_eval_step`` and
``train.loop.train_epoch``/``evaluate`` over ``data.loader.DataLoader``
and ``data.datasets``), and train and serve the LM: :func:`transformer_lm`,
:mod:`dtdl_tpu_torch.bridge`, ``train.state.init_state`` and
``train.step.make_lm_train_step`` over ``data.loader.DataLoader``, and
:class:`InferenceEngine` (paged or dense arena, int8/fp8 weights and KV
through :mod:`dtdl_tpu_torch.quant`) with :class:`Scheduler` (speculative
decoding, :mod:`dtdl_tpu_torch.serve.draft`; chunked prefill; cancel,
shutdown and containment of engine failures).
"""

from dtdl_tpu_torch.device import NoCudaDeviceError, resolve_device
from dtdl_tpu_torch.models import pyramidnet, resnet50
from dtdl_tpu_torch.models.transformer import TransformerLM, transformer_lm
from dtdl_tpu_torch.serve.engine import InferenceEngine
from dtdl_tpu_torch.serve.sampling import GREEDY, SampleParams
from dtdl_tpu_torch.serve.scheduler import Request, Scheduler

__all__ = ["GREEDY", "InferenceEngine", "NoCudaDeviceError", "Request",
           "SampleParams", "Scheduler", "TransformerLM", "pyramidnet",
           "resnet50", "resolve_device", "transformer_lm"]
