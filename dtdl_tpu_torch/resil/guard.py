"""Step anomaly guard, the port of dtdl_tpu/resil/guard.py: a finite
check on the device, and the policies applied on the host from the
drained metrics.

A NaN/Inf loss or gradient burst is the most common way a long training
run dies, and the naive defense (``if not math.isfinite(float(loss))``
in the step loop) is a wait for the card every step.  The guard splits
the job as the JAX one does:

* **on the device** (folded into the step by ``make_train_step(...,
  guard=)`` / ``make_lm_train_step(..., guard=)``): the global gradient
  norm, ``isfinite(loss) & isfinite(grad_norm)`` (plus an optional
  ``grad_norm_limit``), and **the old state when the step is bad**.  The
  JAX step picks the old pytree with one ``lax.cond``; here the update
  runs in place (``optimizer.step()``), so :meth:`StepGuard.begin` copies
  every tensor the step may change before the forward (the parameters
  the optimizer updates, every optimizer state tensor, BatchNorm
  statistics; one multi-tensor copy into buffers kept across steps) and
  :meth:`StepGuard.select` writes ``where(bad, copy, live)`` back into
  each live tensor, and adds the flag to the state's
  device count of suppressed updates (:attr:`TrainState.skipped`).  No
  value is read on the host, so the guard adds no wait; when no fault
  fires ``where(False, copy, live)`` is ``live`` elementwise, so guarded
  training is bitwise unguarded training, and a skipped step leaves the
  state exactly as if its batch had been dropped (the optimizer's step
  counts and BatchNorm's statistics included).  The ``bad_step`` flag
  and the norm ride the step's metric dict.

  That needs every such tensor on the device: an optimizer whose state
  lives on the host (a schedule's count in the param group, torch's
  Adam step counter on the CPU for card parameters, ``MultiSteps``'s
  mini-step) cannot be selected without a wait, and :meth:`begin` refuses
  it by name.  The port's ``adam``/``adamw`` build ``capturable``
  optimizers on the card (their step counters on the device) for that
  reason, guarded or not, so the two paths stay one function.

* **on the host** (:meth:`StepGuard.observe`, fed each drained per-step
  metric dict by ``train_epoch`` / ``Trainer``): count bad steps and
  apply the policy, up to the queue's lag after the fact:

  - ``skip``     — count; after ``max_consecutive`` bad steps in a row
    escalate to :class:`GuardEscalationError`;
  - ``raise``    — :class:`AnomalousStepError` on the first bad step;
  - ``rollback`` — after ``max_consecutive`` consecutive bad steps raise
    :class:`GuardRollback`; the Trainer restores the last good snapshot
    and resumes mid-epoch; after ``max_rollbacks`` it escalates.

The replica-consistency rule: the flag is computed from the
metric-synced loss and the post-``grad_sync`` gradients only, so every
replica takes the same branch and the replicated state stays bitwise
identical.
"""

from __future__ import annotations

from typing import Optional

import torch

from dtdl_tpu_torch.obs.observer import NULL_OBSERVER


class AnomalousStepError(RuntimeError):
    """policy='raise': a non-finite (or over-limit) step was observed."""


class GuardEscalationError(RuntimeError):
    """The consecutive-bad-step (or rollback-budget) threshold tripped."""


class GuardRollback(Exception):
    """Control-flow signal: restore the last good snapshot and continue.

    Raised by :meth:`StepGuard.observe` under policy='rollback'; caught
    by the Trainer.  Deliberately not a RuntimeError, so generic ``except
    RuntimeError`` recovery code cannot swallow it."""


class GuardDeviceError(TypeError):
    """The state holds a tensor or counter the guard cannot select on the
    device (it lives on the host), so guarding it would need a wait for
    the card every step."""


def global_norm(grads) -> torch.Tensor:
    """optax's ``global_norm``: the L2 norm of all gradients together, as
    an f32 0-d tensor on their device."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class _Saved:
    """The copies :meth:`StepGuard.begin` took, beside their live
    tensors."""

    __slots__ = ("live", "saved")

    def __init__(self, live: list, saved: list):
        self.live = live
        self.saved = saved


class StepGuard:
    """Anomaly guard folded into a train step (module docstring).

    One instance guards one logical training run: the step factory calls
    :meth:`begin`, :meth:`check` and :meth:`select` around the update,
    the loop feeds drained metrics to :meth:`observe`.  Counters —
    ``n_bad``, ``n_rollbacks``, ``consecutive`` — are host state,
    lag-harvested."""

    POLICIES = ("skip", "raise", "rollback")

    def __init__(self, policy: str = "skip", max_consecutive: int = 3,
                 grad_norm_limit: Optional[float] = None,
                 max_rollbacks: int = 3, observer=None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown guard policy {policy!r} "
                             f"(one of {self.POLICIES})")
        if max_consecutive < 1:
            raise ValueError(f"max_consecutive must be >= 1, got "
                             f"{max_consecutive}")
        self.policy = policy
        self.max_consecutive = max_consecutive
        self.grad_norm_limit = grad_norm_limit
        self.max_rollbacks = max_rollbacks
        self.observer = observer or NULL_OBSERVER
        # host-side counters (updated at harvest, not dispatch)
        self.n_steps = 0
        self.n_bad = 0
        self.consecutive = 0
        self.n_rollbacks = 0
        self.last_bad: Optional[dict] = None
        self._win_prev = {"steps": 0, "bad_steps": 0, "rollbacks": 0}
        # the copy buffers, kept across steps for one set of live tensors
        self._key: Optional[tuple] = None
        self._buffers: list = []

    # ---- the device piece --------------------------------------------

    @staticmethod
    def _mutable(state, stats) -> list:
        """Every tensor one step may change: the optimizer's parameters,
        its per-parameter state (fresh slots installed first, so a
        suppressed first update leaves them as fresh) and ``stats``."""
        from dtdl_tpu_torch.train.optim import MultiSteps
        from dtdl_tpu_torch.train.state import _fresh_slots
        opt = state.optimizer
        if isinstance(opt, MultiSteps):
            raise GuardDeviceError(
                "the guard cannot select MultiSteps' mini-step count, a "
                "host int: guard the inner optimizer's steps instead")
        if any("count" in g for g in opt.param_groups):
            raise GuardDeviceError(
                "the guard cannot select a scheduled optimizer's update "
                "count (a host int in the param group): a suppressed step "
                "would advance the schedule; use a constant learning rate")
        live = []
        for group in opt.param_groups:
            for p in group["params"]:
                live.append(p)
                if not opt.state.get(p):
                    opt.state[p] = _fresh_slots(opt, group, p)
                for slot, v in opt.state.get(p, {}).items():
                    if not isinstance(v, torch.Tensor) or \
                            v.device != p.device:
                        where = v.device if isinstance(v, torch.Tensor) \
                            else type(v).__name__
                        raise GuardDeviceError(
                            f"the guard cannot select optimizer slot "
                            f"{slot!r} ({where}) beside a parameter on "
                            f"{p.device} without a wait; build Adam/AdamW "
                            f"with capturable=True on the card (the "
                            f"port's adam/adamw do)")
                    live.append(v)
        return live + list(stats)

    def begin(self, state, stats=()) -> _Saved:
        """Copy every tensor the coming step may change (call before the
        forward: BatchNorm updates ``stats`` there), into buffers kept
        from step to step, in one multi-tensor copy."""
        live = self._mutable(state, stats)
        key = tuple((id(t), t.shape, t.dtype, t.device) for t in live)
        if key != self._key:
            self._buffers = [torch.empty_like(t) for t in live]
            self._key = key
        with torch.no_grad():
            torch._foreach_copy_(self._buffers, live)
        return _Saved(live, self._buffers)

    def check(self, loss, grads):
        """(bad, grad_norm) as 0-d device tensors: ``loss`` already
        metric-synced, ``grads`` post-``grad_sync``."""
        gnorm = global_norm(grads)
        bad = torch.logical_not(torch.isfinite(loss) & torch.isfinite(gnorm))
        if self.grad_norm_limit is not None:
            bad = torch.logical_or(bad, gnorm > self.grad_norm_limit)
        return bad, gnorm

    def select(self, state, saved: _Saved, bad) -> None:
        """Keep the old state where the step is bad: each live tensor
        becomes ``where(bad, copy, live)`` in place, and ``bad`` adds to
        the state's count of suppressed updates."""
        with torch.no_grad():
            for live, old in zip(saved.live, saved.saved):
                torch.where(bad, old, live, out=live)
        state.count_skipped(bad)

    # ---- the host-side piece (lag-harvested) -------------------------

    def observe(self, vals: dict) -> None:
        """Apply the policy to one drained per-step metric dict.

        Called once per step at the drain boundary, up to ``lag`` steps
        after dispatch, which is safe because the device select already
        kept the bad update out of the state."""
        self.n_steps += 1
        if not vals.get("bad_step", 0.0):
            self.consecutive = 0
            return
        self.n_bad += 1
        self.consecutive += 1
        self.last_bad = {"loss": vals.get("loss"),
                         "grad_norm": vals.get("grad_norm")}
        self.observer.event("guard_bad_step", **self.last_bad)
        detail = (f"anomalous step (loss={vals.get('loss')}, "
                  f"grad_norm={vals.get('grad_norm')}): update suppressed "
                  f"on device")
        if self.policy == "raise":
            raise AnomalousStepError(detail)
        if self.consecutive >= self.max_consecutive:
            if self.policy == "rollback":
                self.consecutive = 0
                self.n_rollbacks += 1
                if self.n_rollbacks > self.max_rollbacks:
                    raise GuardEscalationError(
                        f"{self.n_rollbacks} rollbacks exceeded the budget "
                        f"of {self.max_rollbacks} — the run is not making "
                        f"progress; last bad step: {self.last_bad}")
                self.observer.event("guard_rollback",
                                    n_rollbacks=self.n_rollbacks)
                raise GuardRollback(detail)
            raise GuardEscalationError(
                f"{self.max_consecutive} consecutive anomalous steps under "
                f"policy='skip' — this is divergence or broken data, not a "
                f"transient; last bad step: {self.last_bad}")

    def summary(self) -> dict:
        """Run-level counters for reports."""
        return {"guard_steps": self.n_steps, "guard_bad_steps": self.n_bad,
                "guard_rollbacks": self.n_rollbacks}

    def window(self) -> dict:
        """Counter increments since the last call: the no-argument delta
        source a :class:`~dtdl_tpu_torch.obs.export.MetricsExporter`
        samples at drain boundaries (``exporter.add_source("guard",
        guard.window)``; the source name gives the ``guard_`` prefix).
        ``bad_step_ratio`` and the good/bad pair are the fields
        ``default_train_slos()`` judges."""
        cur = {"steps": self.n_steps, "bad_steps": self.n_bad,
               "rollbacks": self.n_rollbacks}
        out = {k: cur[k] - self._win_prev[k] for k in cur}
        self._win_prev = cur
        out["good_steps"] = out["steps"] - out["bad_steps"]
        out["bad_step_ratio"] = (out["bad_steps"] / out["steps"]
                                 if out["steps"] else 0.0)
        return out
