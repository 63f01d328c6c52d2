"""The numbers that decide `correct`, each with its limit.

A cell's traffic kind compares what its timed path produced with the plain
reference and returns `result(...)`: every number beside its limit (a
number passes when it is at most its limit), and whether any answer was
there to compare.
"""

from __future__ import annotations

import math

import torch


def mismatch_share(got, want, tol: float) -> float:
    """The share of rows (pixels) whose largest channel differs from the
    reference's by more than tol relative to max(1, |reference|)."""
    got, want = got.double(), want.double()
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    bad = ~(err.amax(dim=-1) <= tol)  # NaN counts as a mismatch
    return float(bad.double().mean())


def rel_l1(got, want) -> float:
    """sum |got - want| over sum |want|."""
    got, want = got.double(), want.double()
    num = float((got - want).abs().sum())
    den = float(want.abs().sum())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


NOT_A_NUMBER = 1e300  # what a NaN or an infinity is printed as: past every limit


def finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_A_NUMBER


def result(numbers, answered: bool = True, failed_answers=None) -> dict:
    """[(name, value, limit)] as the runner takes them."""
    out = {"numbers": [{"name": n, "value": finite(float(v)), "limit": float(lim)}
                       for n, v, lim in numbers],
           "answered": bool(answered)}
    if failed_answers is not None:
        out["failed_answers"] = int(failed_answers)
    return out


def tensor_norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))
