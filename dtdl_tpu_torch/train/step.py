"""The LM train step, the port of dtdl_tpu/train/step.py:make_lm_train_step
for one device.

One call is forward, next-token loss, backward (flash attention's
backward runs kernels K2 and K3 on the card) and the optimizer update,
eagerly.  The metrics come back as device tensors and the step never
reads them on the host, so the card runs ahead of the Python loop as the
JAX step's asynchronous metrics let it; the caller settles a window with
``float(metrics["loss"])``.
"""

from __future__ import annotations

import torch

from dtdl_tpu_torch.device import upload
from dtdl_tpu_torch.ops.cross_entropy import chunked_lm_loss
from dtdl_tpu_torch.train.state import TrainState


def _on(x, device, dtype=None):
    """A batch entry (numpy or tensor) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype, non_blocking=True)
    return upload(x, device, dtype)


def make_lm_train_step(strategy=None, seed: int = 0,
                       vocab_chunk_size: int = 0,
                       moe_aux_weight: float = 0.01, guard=None):
    """Causal-LM step ``(state, batch) -> (state, metrics)``.

    ``batch``: {'tokens': int [B, S]} and optionally 'mask' f32 [B, S-1]
    over the *target* positions (numpy arrays or tensors; they are put on
    the model's device).  Next-token cross entropy with shift over f32
    logits, scaled by 1 / max(mask.sum(), 1); metrics {'loss',
    'accuracy'} as 0-d device tensors.  ``vocab_chunk_size > 0`` takes
    the head through :func:`chunked_lm_loss` on the final hidden states
    and the tied embedding, so the [B, S, V] logits never exist.

    Only the single-device step is ported: another ``strategy`` is
    ROADMAP queue A9 (distributed), ``guard`` is A13 (operations), an MoE
    model A3.  ``seed`` feeds dropout in the JAX step, and the LM has no
    dropout; ``moe_aux_weight`` waits for MoE.
    """
    del seed, moe_aux_weight
    if strategy is not None:
        raise NotImplementedError(
            f"strategy {strategy!r}: data/tensor-parallel training steps are "
            f"ROADMAP queue A9 (distributed); only the single-device step "
            f"is ported")
    if guard is not None:
        raise NotImplementedError(
            "the step guard (resil StepGuard) is ROADMAP queue A13 "
            "(operations)")

    def step(state: TrainState, batch):
        model = state.model
        if getattr(model.cfg, "n_experts", 0) > 0:
            raise NotImplementedError(
                "MoE training (the Switch aux loss) is ROADMAP queue A3")
        dev = model.device
        tokens = _on(batch["tokens"], dev, torch.long)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        mask = batch.get("mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32, device=dev)
                if mask is None else _on(mask, dev, torch.float32))
        scale = 1.0 / mask.sum().clamp(min=1.0)

        state.optimizer.zero_grad(set_to_none=True)
        if vocab_chunk_size:
            h = model(inputs, return_hidden=True)
            b, s, d = h.shape
            loss_sum, correct = chunked_lm_loss(
                h.reshape(b * s, d), model.embed, targets.reshape(b * s),
                mask.reshape(b * s), vocab_chunk_size)
            loss = loss_sum * scale
            acc = correct.detach() * scale
        else:
            logits = model(inputs)                       # f32
            lse = torch.logsumexp(logits, dim=-1)
            true = logits.gather(-1, targets[..., None])[..., 0]
            loss = ((lse - true) * mask).sum() * scale
            with torch.no_grad():
                correct = (logits.argmax(-1) == targets).float()
                acc = (correct * mask).sum() * scale
        loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step
