"""Statistical validation machinery.

Replaces the reference's host-side statistics (SURVEY C31/C32/C37):
20-independent-run confidence intervals with the t(19) critical value,
coefficient of variation, quartiles, CV-vs-raw variance reduction
(2_option_pricing.cu:210-468), and the pathwise-vs-FD z-score agreement
test (3_sensitivity_analysis.cu:656-695) — without the hard-coded
SE=0.000089 quirk (we use the measured standard error).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

# two-sided 97.5% Student-t quantiles for small n (reference hard-codes
# t=2.093 for n=20, 2_option_pricing.cu:320)
_T_CRIT = {2: 12.706, 3: 4.303, 4: 3.182, 5: 2.776, 6: 2.571, 7: 2.447,
           8: 2.365, 9: 2.306, 10: 2.262, 11: 2.228, 12: 2.201, 13: 2.179,
           14: 2.160, 15: 2.145, 16: 2.131, 17: 2.120, 18: 2.110, 19: 2.101,
           20: 2.093, 21: 2.086, 25: 2.064, 30: 2.045, 40: 2.023, 60: 2.001}


def t_critical(n_runs: int) -> float:
    if n_runs in _T_CRIT:
        return _T_CRIT[n_runs]
    # round DOWN to the previous tabulated n: t decreases with n, so the
    # smaller-n entry is the larger (conservative) critical value
    keys = sorted(_T_CRIT)
    below = [k for k in keys if k <= n_runs]
    if below:
        return _T_CRIT[below[-1]]
    return _T_CRIT[keys[0]]


@dataclass
class SampleStats:
    """Summary of n independent Monte Carlo runs (one estimator per run)."""

    samples: list = field(repr=False)
    mean: float
    std: float
    std_error: float
    ci_lower: float
    ci_upper: float
    margin_of_error: float
    cv_percent: float
    quartiles: tuple  # (min, q1, median, q3, max)
    n_runs: int


def summarize(samples: Sequence[float]) -> SampleStats:
    x = np.asarray(samples, np.float64)
    n = len(x)
    mean = float(x.mean())
    std = float(x.std(ddof=1)) if n > 1 else 0.0
    se = std / math.sqrt(n) if n > 0 else 0.0
    moe = t_critical(n) * se
    q = np.quantile(x, [0.0, 0.25, 0.5, 0.75, 1.0])
    return SampleStats(
        samples=list(map(float, x)),
        mean=mean, std=std, std_error=se,
        ci_lower=mean - moe, ci_upper=mean + moe, margin_of_error=moe,
        cv_percent=100.0 * std / abs(mean) if mean != 0 else float("inf"),
        quartiles=tuple(map(float, q)),
        n_runs=n,
    )


def variance_reduction_percent(adjusted: Sequence[float],
                               raw: Sequence[float]) -> float:
    """100 * (1 - Var(adjusted)/Var(raw)) (2_option_pricing.cu:340)."""
    va = float(np.var(adjusted, ddof=1))
    vr = float(np.var(raw, ddof=1))
    return 100.0 * (1.0 - va / vr)


@dataclass
class AgreementTest:
    diff: float
    rel_diff_percent: float
    z_score: float
    significant: bool  # True => methods disagree beyond sampling noise
    effect_size_se: float
    interpretation: str


def method_agreement(a: float, b: float, std_error: float) -> AgreementTest:
    """z-test of H0 "methods agree" (3_sensitivity_analysis.cu:656-695)."""
    diff = abs(a - b)
    z = diff / std_error if std_error > 0 else float("inf")
    if z < 0.5:
        interp = "negligible difference (< 0.5 SE)"
    elif z < 1.0:
        interp = "small difference (< 1 SE)"
    elif z < 2.0:
        interp = "moderate difference (< 2 SE)"
    else:
        interp = "large difference (>= 2 SE)"
    return AgreementTest(
        diff=diff,
        rel_diff_percent=100.0 * diff / abs(a) if a != 0 else float("inf"),
        z_score=z,
        significant=z > 1.96,
        effect_size_se=z,
        interpretation=interp,
    )
