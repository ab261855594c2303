"""The train, eval and predict steps, the port of dtdl_tpu/train/step.py:
the classifier steps (``make_train_step``, ``make_eval_step``,
``make_predict_step``) and the LM step (``make_lm_train_step``), each
under a strategy (:mod:`dtdl_tpu_torch.parallel.strategy`; ``None`` is
:class:`SingleDevice`).

One train call is forward, loss, backward (flash attention's backward
runs kernels K2 and K3 on the card) and the optimizer update, eagerly.
The metrics come back as device tensors and the step never reads them on
the host, so the card runs ahead of the Python loop as the JAX step's
asynchronous metrics let it; the caller settles a window with
``float(metrics["loss"])``.

Train or eval mode follows the JAX ``train=`` flag: the classifier train
step puts the model in train mode (BatchNorm normalizes by the batch and
updates its statistics); the eval and predict steps put it in eval mode
(the stored statistics) and restore its mode after.

Under :class:`AutoSharded` the steps bind its placement to the state on
their first call and run as under ``DataParallel``, BatchNorm normalizing
by the global batch's statistics (``models/norm.py``), which then need no
sync.

Under :class:`DataParallel` each process runs the step on its own rows,
with the JAX step's semantics: the gradients are the mean of the
per-replica gradients (``grad_sync``, before the update); BatchNorm
normalizes by the replica's own rows and its new running statistics are
mean-synced (``stats_sync``); train metrics are mean-synced, eval sums
sum-synced.  ``guard`` is ROADMAP queue A13b (resilience).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable

import torch

from dtdl_tpu_torch.bridge import batch_stats_view, flatten
from dtdl_tpu_torch.device import upload
from dtdl_tpu_torch.ops.cross_entropy import (accuracy, chunked_lm_loss,
                                              softmax_cross_entropy)
from dtdl_tpu_torch.parallel.strategy import Strategy, check_strategy
from dtdl_tpu_torch.train.state import TrainState


def _on(x, device, dtype=None):
    """A batch entry (numpy or tensor) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype, non_blocking=True)
    return upload(x, device, dtype)


def _strategy(strategy, guard=None) -> Strategy:
    if guard is not None:
        raise NotImplementedError(
            "the step guard (resil StepGuard) is ROADMAP queue A13b "
            "(resilience)")
    return check_strategy(strategy)


def _grads(model) -> list:
    """The gradients of every trainable parameter, which every replica
    must hold for the bucketed allreduce to line up."""
    grads = [p.grad for p in model.parameters() if p.requires_grad]
    if any(g is None for g in grads):
        raise RuntimeError("a trainable parameter got no gradient; every "
                           "replica must hold one for each to sync them")
    return grads


def _stats(model) -> list:
    """A classifier's BatchNorm running statistics (its live buffers)."""
    view = batch_stats_view(model)
    return list(flatten(view).values()) if view else []


@contextmanager
def _eval_mode(model):
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was)


def make_train_step(strategy=None,
                    loss_fn: Callable = softmax_cross_entropy,
                    seed: int = 0, guard=None):
    """Classifier step ``(state, batch) -> (state, metrics)``.

    ``batch``: {'image': NHWC images, 'label': int labels} (numpy arrays
    or tensors; they are put on the model's device).  Train-mode forward
    (BatchNorm statistics updated), ``loss_fn`` (softmax cross entropy),
    backward, optimizer update; metrics {'loss', 'accuracy'} as 0-d
    device tensors.  ``seed`` feeds dropout in the JAX step, and no
    classifier has dropout."""
    del seed
    strategy = _strategy(strategy, guard)

    def step(state: TrainState, batch):
        strategy.bind(state)
        model = state.model
        dev = model.device
        images = _on(batch["image"], dev)
        labels = _on(batch["label"], dev, torch.long)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(images)
        loss = loss_fn(logits, labels)
        loss.backward()
        if strategy.mesh is not None:        # SingleDevice: nothing to sync
            strategy.grad_sync(_grads(model))
            with torch.no_grad():
                strategy.stats_sync(_stats(model))
        state.apply_gradients()
        with torch.no_grad():
            acc = accuracy(logits, labels)
            metrics = strategy.metric_sync({"loss": loss.detach(),
                                            "accuracy": acc})
        return state, metrics

    return step


def make_eval_step(strategy=None,
                   loss_fn: Callable = softmax_cross_entropy):
    """Eval step ``(state, batch) -> summed metrics``: eval mode (the
    stored BatchNorm statistics), and **sums** {'loss_sum',
    'correct_sum', 'count'} as 0-d device tensors over the rows with
    ``batch["mask"]`` 1 (all rows without a mask), so a padded ragged
    tail counts each real example once.  Under :class:`DataParallel` the
    sums are sum-synced over the replicas."""
    strategy = _strategy(strategy)

    def evaluate(state: TrainState, batch):
        strategy.bind(state)
        model = state.model
        dev = model.device
        labels = _on(batch["label"], dev, torch.long)
        mask = batch.get("mask")
        mask = (torch.ones(labels.shape, dtype=torch.float32, device=dev)
                if mask is None else _on(mask, dev, torch.float32))
        with _eval_mode(model):
            logits = model(_on(batch["image"], dev))
            losses = loss_fn(logits, labels, reduction="none")
            correct = (logits.argmax(-1) == labels).float()
            return strategy.sum_sync({"loss_sum": (losses * mask).sum(),
                                      "correct_sum": (correct * mask).sum(),
                                      "count": mask.sum()})

    return evaluate


def make_predict_step(strategy=None, probabilities: bool = False):
    """Predict step ``(state, batch) -> logits`` (f32, on the device), or
    their softmax with ``probabilities=True``; eval mode.  Under
    :class:`DataParallel` each process predicts its own rows (the JAX
    outputs stay sharded on the data axis, aligned with the batch)."""
    strategy = _strategy(strategy)

    def predict(state: TrainState, batch):
        strategy.bind(state)
        model = state.model
        with _eval_mode(model):
            logits = model(_on(batch["image"], model.device))
            return logits.softmax(-1) if probabilities else logits

    return predict


def make_lm_train_step(strategy=None, seed: int = 0,
                       vocab_chunk_size: int = 0,
                       moe_aux_weight: float = 0.01, guard=None):
    """Causal-LM step ``(state, batch) -> (state, metrics)``.

    ``batch``: {'tokens': int [B, S]} and optionally 'mask' f32 [B, S-1]
    over the *target* positions (numpy arrays or tensors; they are put on
    the model's device).  Next-token cross entropy with shift over f32
    logits, scaled by ``num_replicas / max(sum_sync(mask.sum()), 1)``:
    the global token count, so the mean of the per-replica gradients is
    the global token mean under a ragged mask (one replica:
    1 / max(mask.sum(), 1)); metrics {'loss', 'accuracy'} as 0-d device
    tensors, mean-synced.  ``vocab_chunk_size > 0`` takes
    the head through :func:`chunked_lm_loss` on the final hidden states
    and the tied embedding, so the [B, S, V] logits never exist.

    An MoE model's blocks return their Switch load-balance values (the
    forward's ``return_aux``); the loss gains ``moe_aux_weight`` times
    their mean over the MoE layers, reported as the ``moe_aux_loss``
    metric (a weight of 0 adds nothing and still reports it).

    ``seed`` feeds dropout in the JAX step, and the LM has no dropout.
    """
    del seed
    strategy = _strategy(strategy, guard)

    def step(state: TrainState, batch):
        strategy.bind(state)
        model = state.model
        dev = model.device
        tokens = _on(batch["tokens"], dev, torch.long)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        mask = batch.get("mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32, device=dev)
                if mask is None else _on(mask, dev, torch.float32))
        total = strategy.sum_sync(mask.sum())
        scale = strategy.num_replicas / total.clamp(min=1.0)

        state.optimizer.zero_grad(set_to_none=True)
        if vocab_chunk_size:
            h, aux = model(inputs, return_hidden=True, return_aux=True)
            b, s, d = h.shape
            loss_sum, correct = chunked_lm_loss(
                h.reshape(b * s, d), model.embed, targets.reshape(b * s),
                mask.reshape(b * s), vocab_chunk_size)
            loss = loss_sum * scale
            acc = correct.detach() * scale
        else:
            logits, aux = model(inputs, return_aux=True)     # f32
            lse = torch.logsumexp(logits, dim=-1)
            true = logits.gather(-1, targets[..., None])[..., 0]
            loss = ((lse - true) * mask).sum() * scale
            with torch.no_grad():
                correct = (logits.argmax(-1) == targets).float()
                acc = (correct * mask).sum() * scale
        metrics = {}
        if aux:
            aux = sum(aux) / len(aux)
            loss = loss + moe_aux_weight * aux
            metrics["moe_aux_loss"] = aux.detach()
        loss.backward()
        if strategy.mesh is not None:
            strategy.grad_sync(_grads(model))
        state.apply_gradients()
        with torch.no_grad():
            metrics = strategy.metric_sync(
                {"loss": loss.detach(), "accuracy": acc, **metrics})
        return state, metrics

    return step
