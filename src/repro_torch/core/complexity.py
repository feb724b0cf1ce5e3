"""Analytic complexity models from paper §3, used by benchmarks to compare
measured message counts / critical-path lengths against the claimed bounds.

Paper claims (n signalers, skip-list inter-level probability p):
  * signal aggregation:   expected critical path  O(log n)
  * eager insertion:      time & messages         O(log n)
  * lazy promotion:       per-node               O(p/(1-p) · log(C·p/(1-p)))
                          for a group of C concurrently promoting nodes
  * deletion:             messages & time         O(log n)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple


def expected_height(p: float) -> float:
    """E[height] of a skip-list node: geometric(1-p) => 1/(1-p)."""
    return 1.0 / (1.0 - p)


def expected_depth(n: int, p: float = 0.5) -> float:
    """Expected search/signal path length ~ log_{1/p}(n) · 1/(1-p)."""
    if n <= 1:
        return 1.0
    return math.log(n, 1.0 / p) / (1.0 - p)


def signal_bound(n: int, p: float = 0.5, c: float = 3.0) -> float:
    """O(log n) with explicit constant for assertions in benchmarks."""
    return c * max(1.0, expected_depth(n, p)) + c


def insertion_bound(n: int, p: float = 0.5, c: float = 4.0) -> float:
    """Eager insertion: search O(log n) + constant splice traffic."""
    return c * max(1.0, expected_depth(n, p)) + 8.0


def deletion_bound(n: int, p: float = 0.5, c: float = 6.0) -> float:
    """Deletion: O(log n) levels, constant messages per level."""
    exp_levels = min(expected_height(p) + math.log(max(n, 2), 1 / p),
                     64.0)
    return c * exp_levels + 8.0


def lazy_promotion_bound(C: int, p: float = 0.5, c: float = 8.0) -> float:
    """Paper: per-node lazy cost O(p/(1-p) · log(C·p/(1-p)))."""
    r = p / (1.0 - p)
    return c * max(1.0, r * math.log(max(C * r, 2.0))) + c


@dataclass
class Fit:
    """Least-squares fit of y ~ a·log2(x) + b — benchmarks use it to verify
    measured curves are logarithmic (R² close to 1, small residual slope in
    log-space)."""

    a: float
    b: float
    r2: float

    @classmethod
    def log_fit(cls, xs: Sequence[float], ys: Sequence[float]) -> "Fit":
        lx = [math.log2(x) for x in xs]
        n = len(lx)
        mx = sum(lx) / n
        my = sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in lx)
        sxy = sum((x - mx) * (y - my) for x, y in zip(lx, ys))
        a = sxy / sxx if sxx else 0.0
        b = my - a * mx
        ss_res = sum((y - (a * x + b)) ** 2 for x, y in zip(lx, ys))
        ss_tot = sum((y - my) ** 2 for y in ys)
        r2 = 1.0 - ss_res / ss_tot if ss_tot else 1.0
        return cls(a=a, b=b, r2=r2)

    def predict(self, x: float) -> float:
        return self.a * math.log2(x) + self.b


def is_logarithmic(xs: Sequence[float], ys: Sequence[float],
                   r2_min: float = 0.85) -> Tuple[bool, Fit]:
    """True if ys grows ~log(xs): good log-fit AND sublinear growth.

    The sublinearity check: doubling x from the median should grow y by a
    roughly additive (not multiplicative) amount — ratio of increments per
    doubling stays bounded.
    """
    fit = Fit.log_fit(xs, ys)
    # linear fit for comparison
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    a_lin = sxy / sxx if sxx else 0.0
    b_lin = my - a_lin * mx
    ss_res_lin = sum((y - (a_lin * x + b_lin)) ** 2
                     for x, y in zip(xs, ys))
    ss_res_log = sum((y - fit.predict(x)) ** 2 for x, y in zip(xs, ys))
    ok = fit.r2 >= r2_min and ss_res_log <= ss_res_lin * 1.5
    return ok, fit
