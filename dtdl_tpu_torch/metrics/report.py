"""Metrics bus, the port of dtdl_tpu/metrics/report.py: one reporter,
pluggable sinks.

:class:`Accumulator` keeps running means over an epoch; sinks write each
payload as the reference's fixed-format line (:class:`StdoutSink`) or as
JSON lines (:class:`JsonlSink`); :class:`Reporter` fans a payload out to
its sinks and closes them on exit.  The JAX reporter is silent on every
process but the leader, and so is this one.  :class:`TensorBoardSink`
writes TensorBoard event files when a writer imports
(``torch.utils.tensorboard`` or ``tensorboardX``) and is otherwise a
no-op with one warning per process, as the JAX sink.
"""

from __future__ import annotations

import json
import logging
import os
import time

from dtdl_tpu_torch.runtime.bootstrap import is_leader


class Accumulator:
    """Running means of scalar metrics over an epoch (Chainer-report style)."""

    def __init__(self):
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def add(self, metrics: dict, weight: int = 1) -> None:
        for k, v in metrics.items():
            v = float(v)
            self._sums[k] = self._sums.get(k, 0.0) + v * weight
            self._counts[k] = self._counts.get(k, 0) + weight

    def means(self) -> dict:
        return {k: self._sums[k] / self._counts[k] for k in self._sums}

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()


class _SinkContext:
    """``with JsonlSink(...) as s:`` closes (and so flushes) on any exit,
    exceptions included."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class StdoutSink(_SinkContext):
    """The reference's per-batch log line: ``Epoch [e] [step/steps] |
    loss: ... | accuracy: ... | batch_time: ...``."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def write(self, payload: dict) -> None:
        parts = []
        if "epoch" in payload:
            parts.append(f"Epoch [{payload['epoch']}]")
        if "step" in payload and "steps_per_epoch" in payload:
            parts.append(f"[{payload['step']}/{payload['steps_per_epoch']}]")
        elif "step" in payload:
            parts.append(f"step {payload['step']}")
        for k, v in payload.items():
            if k in ("epoch", "step", "steps_per_epoch", "split"):
                continue
            if isinstance(v, float):
                parts.append(f"{k}: {v:.4f}" if abs(v) < 100 else f"{k}: {v:.2f}")
            else:
                parts.append(f"{k}: {v}")
        line = (self.prefix + " " if self.prefix else "") + " | ".join(parts)
        print(line, flush=True)

    def close(self) -> None:
        pass


class JsonlSink(_SinkContext):
    """JSON-lines log file, one payload a line with its ``elapsed_time``
    (Chainer ``LogReport`` parity)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def write(self, payload: dict) -> None:
        rec = dict(payload)
        rec.setdefault("elapsed_time", round(time.time() - self._t0, 3))
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


# module-level so the no-writer warning fires once per process, not once
# per TensorBoardSink (fit() creates one per TensorBoard callback)
_TB_WARNED = False


class TensorBoardSink(_SinkContext):
    """TensorBoard event files when a writer implementation imports
    (TF2-track parity); without one, a no-op with a one-time warning —
    the metrics bus does not hard-depend on a tensorboard package."""

    def __init__(self, logdir: str):
        global _TB_WARNED
        self.logdir = logdir
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(logdir)
        except Exception:
            try:
                from tensorboardX import SummaryWriter
                self._writer = SummaryWriter(logdir)
            except Exception:
                if not _TB_WARNED:
                    _TB_WARNED = True
                    logging.getLogger("dtdl_tpu_torch").warning(
                        "no tensorboard writer available; TensorBoardSink "
                        "is a no-op (metrics still go to stdout/JSONL "
                        "sinks)")

    def write(self, payload: dict) -> None:
        if self._writer is None:
            return
        step = int(payload.get("step", 0))
        split = payload.get("split", "train")
        for k, v in payload.items():
            if isinstance(v, float):
                self._writer.add_scalar(f"{split}/{k}", v, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class Reporter:
    """Fan-out of metric payloads to sinks (a :class:`StdoutSink` by
    default); silent on processes other than the leader unless
    ``leader_only=False``.  A context manager: every sink is closed on
    exit, exceptions included."""

    def __init__(self, sinks=None, leader_only: bool = True):
        self.sinks = list(sinks) if sinks is not None else [StdoutSink()]
        self.leader_only = leader_only

    def __enter__(self) -> "Reporter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def active(self) -> bool:
        return not self.leader_only or is_leader()

    def report(self, payload: dict) -> None:
        if not self.active:
            return
        clean = {k: (float(v) if hasattr(v, "item") else v)
                 for k, v in payload.items()}
        for sink in self.sinks:
            sink.write(clean)

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()
