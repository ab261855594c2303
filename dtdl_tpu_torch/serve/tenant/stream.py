"""Per-request token streaming from the lag-harvest boundary, the port's
own copy of dtdl_tpu/serve/tenant/stream.py (framework-free: threading
only).

Tokens are delivered incrementally as the scheduler harvests its lagged
windows — the host was already going to touch those arrays, so
streaming adds no wait for the card.  The subtlety is fleet retries and
hedging: several *attempts* may be producing tokens for one user
request, and the stream must expose exactly one prefix-stable sequence
— the winning attempt's — with losers silently dropped.

The ownership protocol:

- ``offer(rid, tokens)`` — the first attempt to offer claims the
  stream; offers from any other rid return 0 and deliver nothing.
  Deliveries are prefix-guarded: only the extension beyond what was
  already delivered goes out, and a non-matching prefix marks the
  stream ``divergent`` instead of delivering.  A successor that has not
  caught up yet (its tokens a prefix of what was delivered) delivers
  nothing and is not divergent: the JAX package marks it so (ROADMAP
  C6), although its tokens agree.
- ``drop(rid)`` — called ONLY when an attempt terminates in error;
  releases ownership so the successor attempt can claim it and catch
  up via the prefix guard.  Successful attempts never drop — a hedge
  loser that is still running cannot claim a stream whose winner
  already finished.
- ``finish(tokens, error)`` — the router/scheduler reconciles the
  final sequence: any remaining suffix is delivered, the stream is
  closed, and every later offer returns 0.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Iterator, List, Optional, Sequence

__all__ = ["TokenStream"]

_END = object()


class TokenStream:
    """Incremental token delivery handle attached to a ``Request``.

    Consume via ``callback(list_of_new_tokens)`` (invoked inside the
    serving loop — keep it cheap) or by iterating the stream after /
    concurrently with the run (thread-safe, blocks until tokens or
    close).
    """

    def __init__(self,
                 callback: Optional[Callable[[List[int]], None]] = None
                 ) -> None:
        self._cb = callback
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._delivered: List[int] = []
        self._owner: Optional[int] = None
        self.closed = False
        self.divergent = False
        self.error: Optional[str] = None

    # -- producer side (scheduler / router) ----------------------------
    def offer(self, rid: int, tokens: Sequence[int]) -> int:
        """Offer the attempt ``rid``'s tokens-so-far; returns how many
        were newly delivered (0 for non-owners / closed streams)."""
        with self._cond:
            if self.closed:
                return 0
            if self._owner is None:
                self._owner = rid
            elif self._owner != rid:
                return 0
            return self._extend(tokens)

    def drop(self, rid: int) -> None:
        """Release ownership after ``rid`` terminated in error, so the
        retry/hedge successor can stream.  No-op for non-owners."""
        with self._cond:
            if not self.closed and self._owner == rid:
                self._owner = None

    def finish(self, tokens: Sequence[int],
               error: Optional[str] = None) -> int:
        """Reconcile against the final request tokens and close."""
        with self._cond:
            if self.closed:
                return 0
            n = self._extend(tokens) if error is None else 0
            self.error = error
            self.closed = True
            self._queue.append(_END)
            self._cond.notify_all()
            return n

    def _extend(self, tokens: Sequence[int]) -> int:
        have = len(self._delivered)
        toks = [int(t) for t in tokens]
        if toks[:have] != self._delivered[:len(toks)]:
            self.divergent = True
            return 0
        new = toks[have:]
        if not new:
            return 0
        self._delivered.extend(new)
        self._queue.append(new)
        self._cond.notify_all()
        if self._cb is not None:
            self._cb(new)
        return len(new)

    # -- consumer side --------------------------------------------------
    @property
    def tokens(self) -> List[int]:
        """Everything delivered so far (a copy)."""
        with self._cond:
            return list(self._delivered)

    def __iter__(self) -> Iterator[int]:
        """Yield tokens one at a time until the stream closes."""
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                item = self._queue.popleft()
            if item is _END:
                return
            for t in item:
                yield t
