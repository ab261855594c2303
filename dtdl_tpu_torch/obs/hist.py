"""Streaming log-bucketed histogram, the port's own copy of
dtdl_tpu/obs/hist.py: tail percentiles in fixed memory.

Geometric buckets (64 per decade by default, 3.7% wide), O(1) ``add``,
percentiles by cumulative walk, reported at the bucket's geometric
midpoint clamped to the observed min/max.  Plain host floats only.
"""

from __future__ import annotations

import math


class LogHistogram:
    """Fixed-memory log-bucketed histogram over (0, +inf); samples
    outside [lo, hi] clamp into the end buckets, min/max/mean stay exact."""

    __slots__ = ("lo", "hi", "bins_per_decade", "_ratio_log", "_n_bins",
                 "_counts", "n", "total", "_min", "_max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 bins_per_decade: int = 64):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if bins_per_decade < 1:
            raise ValueError(f"bins_per_decade must be >= 1, got "
                             f"{bins_per_decade}")
        self.lo = lo
        self.hi = hi
        self.bins_per_decade = bins_per_decade
        self._ratio_log = 1.0 / bins_per_decade
        self._n_bins = int(math.ceil(
            (math.log10(hi) - math.log10(lo)) * bins_per_decade)) + 1
        self._counts = [0] * self._n_bins
        self.n = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _index(self, x: float) -> int:
        if x <= self.lo:
            return 0
        i = int((math.log10(x) - math.log10(self.lo)) / self._ratio_log)
        return min(i, self._n_bins - 1)

    def add(self, x: float) -> None:
        x = float(x)
        self._counts[self._index(x)] += 1
        self.n += 1
        self.total += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    @property
    def max(self) -> float:
        return self._max if self.n else 0.0

    def percentile(self, p: float) -> float:
        """The p-th percentile (p in [0, 100])."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        if self.n == 0:
            return 0.0
        rank = p / 100.0 * self.n
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank and c:
                lo_edge = self.lo * 10 ** (i * self._ratio_log)
                mid = lo_edge * 10 ** (self._ratio_log / 2)
                return min(max(mid, self._min), self._max)
        return self._max

    def summary(self, prefix: str = "", unit: float = 1.0,
                digits: int = 6) -> dict:
        """Flat dict of count/mean/p50/p95/p99/max; empty with no samples."""
        if self.n == 0:
            return {}
        r = lambda v: round(v * unit, digits)  # noqa: E731
        return {f"{prefix}count": self.n,
                f"{prefix}mean": r(self.mean),
                f"{prefix}p50": r(self.percentile(50)),
                f"{prefix}p95": r(self.percentile(95)),
                f"{prefix}p99": r(self.percentile(99)),
                f"{prefix}max": r(self.max)}
