"""The arithmetic of the end-to-end metrics and of the comparisons."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank: the smallest
    value with at least q% of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return float(vals[k - 1])


def rate(units: float, seconds: float, scale: float = 1.0) -> float:
    """`units` of work over `seconds`, divided by `scale` (1e6 for M/s)."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds / scale


def rel_gap(got: float, want: float, floor: float = 0.0) -> float:
    """|got - want| over max(|want|, floor)."""
    return abs(got - want) / max(abs(want), floor)


def leaf_gaps(got: dict, want: dict) -> dict:
    """For each leaf, |got - want| over the larger of want and the median
    leaf's want: a gap of norms measured against the reference's norm of
    that leaf, or of the median leaf where that is larger."""
    med = statistics.median(want.values())
    return {k: rel_gap(got[k], want[k], med) for k in want}
