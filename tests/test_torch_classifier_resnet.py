"""The port's ResNet train step against the JAX package's, on the CPU:
one SGD step and three steps of ``sgd_steplr``'s chain, as
``tests/test_torch_classifier_train.py`` holds the other classifiers
(its helpers, oracle and tolerances; the ResNet's bound widens by twice
the JAX package's own f32 error, as that file's docstring explains).
"""

import torch

from test_torch_classifier_train import (one_sgd_step,  # noqa: F401
                                         three_steps_of_sgd_steplr, x64)

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)


def test_one_sgd_step_matches_jax():
    one_sgd_step("resnet")


def test_three_steps_of_sgd_steplr_match_jax():
    three_steps_of_sgd_steplr("resnet")
