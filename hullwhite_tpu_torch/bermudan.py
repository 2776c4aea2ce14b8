"""Bermudan swaptions / coupon-bond options: two-pass Longstaff-Schwartz
lower bound, Andersen-Broadie dual upper bound and a near-exact DP oracle
(PyTorch port of ``hullwhite_tpu.bermudan``).

The state the policy needs, (r(e_1), I(e_1), ..., r(e_k), I(e_k)) at the
exercise dates, is jointly Gaussian with a covariance built from the same
shock shapes as everything else, so Bermudan paths are sampled exactly
with 2k normals per path (no time stepping).

* LOWER bound: backward induction over the exercise dates, regressing the
  realized discounted continuation on [1, r~, r~^2, r~^3, V_bond(r)] over
  the in-the-money paths (weighted least squares by QR); the policy is
  estimated on one path set and evaluated out of sample on independent
  blocks, drawn one after the other from their global block index, or by
  randomized QMC (2k-dim digitally shifted Sobol points).
* UPPER bound: Andersen-Broadie duality with the martingale of a piecewise
  value proxy (exact intrinsic on the exercise side of the fitted boundary
  r*_j, a cubic continuation fit on the other side) whose one-step
  conditional expectations are closed form, so no nested simulation.
* Martingale control variate: cf - M_tau has the lower bound's expectation
  (optional stopping) and a far smaller variance.
* ORACLE: r(t) is 1-d Gauss-Markov, so the price is a 1-d dynamic program
  in host float64, its continuation sweep in the C++ library
  (``native/hw_native.cpp`` through ``utils.native``).

The estimator runs on the device in plain PyTorch (no hand-written
kernel); the sums, the 60-step bisections and the regressions stay tensors
there.  Every matrix product goes through ``engine_linear.dot`` at
``cfg.matmul_precision``, and the evaluation paths use ``exp32``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .config import HWConfig, resolve_device
from .instruments import CouponSchedule, _bond_value_terms
from .models import hull_white as hw
from .models.hull_white import MarketCurve, StepTables
from .ops.accurate import exp32 as _exp, nphi, npdf as _npdf
from .ops.engine_linear import _det_recursion, _shock_shapes, dot
from .ops.rng import Key, block_normals, normal
from .parallel import mesh as pmesh

BASIS_DEGREE = 3   # polynomial part of the basis: [1, r, r^2, r^3]
RIDGE = 1e-9


def _step_index(cfg: HWConfig, t: float) -> int:
    n = int(round(t / cfg.dt))
    if abs(n * cfg.dt - t) > 1e-9 or not (0 < n <= cfg.n_steps):
        raise ValueError(f"exercise date {t} must sit on the step grid")
    return n


@lru_cache(maxsize=None)
def _joint_chol(cfg: HWConfig, ex_dates: tuple):
    """fp64 Cholesky^T of the (2k, 2k) covariance of
    (r(e_1), I(e_1), ..., r(e_k), I(e_k)) / sig_st, rounded to float32."""
    k = len(ex_dates)
    U = np.zeros((cfg.n_steps, 2 * k))
    for j, t in enumerate(ex_dates):
        n = _step_index(cfg, t)
        u, w = _shock_shapes(cfg, n)
        U[:n, 2 * j] = np.asarray(u, np.float64)
        U[:n, 2 * j + 1] = np.asarray(w, np.float64)
    C = U.T @ U + RIDGE * np.eye(2 * k)
    L = np.linalg.cholesky(C)
    return np.asarray(L.T, np.float32)  # z = x @ L^T


@lru_cache(maxsize=None)
def _functional_chol(cfg: HWConfig, specs: tuple):
    """fp64 Cholesky^T of the covariance of an arbitrary tuple of
    functionals, specs = (("r"|"I", t), ...), per unit sig_st: the
    multi-date products draw only the quantities their payoff touches,
    in payoff order."""
    U = np.zeros((cfg.n_steps, len(specs)))
    for c, (kind, t) in enumerate(specs):
        n = _step_index(cfg, t)
        u, w = _shock_shapes(cfg, n)
        U[:n, c] = np.asarray(u if kind == "r" else w, np.float64)
    C = U.T @ U + RIDGE * np.eye(len(specs))
    L = np.linalg.cholesky(C)
    return np.asarray(L.T, np.float32)  # z = x @ L^T


@lru_cache(maxsize=None)
def _det_affine(cfg: HWConfig):
    """Host fp64 affine decomposition of the deterministic (G = 0) path:
    drift = base + c psi with c = 0.5 (sigma^2 - sigma0^2), and the
    recursion is linear in the drift, so r_n = rA_n + c rB_n and
    I_n = iA_n + c iB_n."""
    host = hw.host_tables(cfg)
    E, dt = host["E"], cfg.dt

    def roll(drift, r0):
        rs = np.empty(cfg.n_steps)
        Is = np.empty(cfg.n_steps)
        r, integral = r0, 0.0
        for nstep in range(cfg.n_steps):
            r_next = r * E + drift[nstep]
            integral += 0.5 * (r + r_next) * dt
            rs[nstep] = r_next
            Is[nstep] = integral
            r = r_next
        return rs, Is

    rA, iA = roll(np.asarray(host["base"], np.float64), cfg.r0)
    rB, iB = roll(np.asarray(host["psi"], np.float64), 0.0)
    return rA, rB, iA, iB


@lru_cache(maxsize=None)
def _functional_det_affine(cfg: HWConfig, specs: tuple):
    """(detA, detB) float32 arrays so the deterministic part of each spec
    functional is detA + 0.5 (sigma^2 - sigma0^2) detB."""
    rA, rB, iA, iB = _det_affine(cfg)
    A, B = [], []
    for kind, t in specs:
        nidx = _step_index(cfg, t) - 1
        A.append(rA[nidx] if kind == "r" else iA[nidx])
        B.append(rB[nidx] if kind == "r" else iB[nidx])
    return (np.asarray(A, np.float32), np.asarray(B, np.float32))


def _functional_det(cfg: HWConfig, sigma: torch.Tensor, specs: tuple,
                    sigma0=None):
    """(len(specs),) deterministic parts matching _functional_chol, on
    sigma's device (differentiable in sigma)."""
    if sigma0 is None:
        sigma0 = cfg.sigma
    A, B = _functional_det_affine(cfg, specs)
    dev = sigma.device
    s0 = float(np.float32(sigma0))
    return (torch.as_tensor(A, device=dev)
            + 0.5 * (sigma * sigma - s0 * s0) * torch.as_tensor(B, device=dev))


@lru_cache(maxsize=None)
def _interval_params(cfg: HWConfig, ex_dates: tuple):
    """fp64 conditional-Gaussian parameters of each exercise interval.

    For interval i (from s = e_{i-1}, with e_0 = 0, to t = e_i), writing
    centered variables per unit sig_st, conditional on r_s:

      r_t | r_s  ~  N( rdet_t + bt (r_s - rdet_s),  sig^2 vt )
      dI  | r_s  ~  N( didet  + bI (r_s - rdet_s),  sig^2 vI )
      Cov(r_t, dI | r_s) = sig^2 ctI

    Returns a tuple of dicts {bt, bI, vt, vI, ctI} (sigma-independent)."""
    out = []
    prev_n = 0
    u_prev = w_prev = None
    for t in ex_dates:
        n = _step_index(cfg, t)
        u_cur, w_cur = (np.asarray(a, np.float64)
                        for a in _shock_shapes(cfg, n))
        d = w_cur.copy()
        if prev_n:
            d[:prev_n] -= w_prev
            up = np.zeros(n)
            up[:prev_n] = u_prev
        else:
            up = np.zeros(n)
        v_ss = float(up @ up)
        c_st = float(up @ u_cur)
        v_tt = float(u_cur @ u_cur)
        c_sI = float(up @ d)
        c_tI = float(u_cur @ d)
        v_II = float(d @ d)
        if v_ss > 1e-14:
            bt, bI = c_st / v_ss, c_sI / v_ss
            vt = v_tt - c_st * c_st / v_ss
            vI = v_II - c_sI * c_sI / v_ss
            ctI = c_tI - c_st * c_sI / v_ss
        else:
            bt = bI = 0.0
            vt, vI, ctI = v_tt, v_II, c_tI
        out.append(dict(bt=bt, bI=bI, vt=vt, vI=vI, ctI=ctI))
        prev_n, u_prev, w_prev = n, u_cur, w_cur
    return tuple(out)


@lru_cache(maxsize=None)
def _date_shapes(cfg: HWConfig, dates: tuple):
    """(n_max, k) float32 shock shapes u, w of the dates' (r, I), zero
    beyond each date's step count: the weights of the drifts in the
    deterministic states."""
    steps = [_step_index(cfg, t) for t in dates]
    n_max = max(steps)
    U = np.zeros((n_max, len(dates)), np.float32)
    W = np.zeros((n_max, len(dates)), np.float32)
    for j, n in enumerate(steps):
        U[:n, j], W[:n, j] = _shock_shapes(cfg, n)
    return tuple(steps), U, W


def _det_host(cfg: HWConfig, exp_adt, dt, drift, dates: tuple):
    """(2, k) float32 numpy [r; I] of the G = 0 path at the dates: the host
    recursion, bit for bit the JAX package's ``det_trajectory`` scan."""
    steps, U, _ = _date_shapes(cfg, dates)
    rows = _det_recursion(cfg, exp_adt, dt, drift, drift, U.shape[0],
                          dual=False)
    idx = np.asarray(steps) - 1
    return np.stack([rows[0, idx], rows[1, idx]])


def _det_host64(cfg: HWConfig, sigma, dates: tuple):
    """(r_det, i_det) float64 numpy at the dates for the host oracles:
    the recursion on CPU tables at ``sigma`` (sigma0 = cfg.sigma)."""
    t = hw.step_tables(cfg, sigma, cfg.sigma, device="cpu")
    return (np.asarray(_det_host(cfg, t.exp_adt, t.dt, t.drift, dates),
                       np.float64), float(t.sig_st))


class _DetStates(torch.autograd.Function):
    """[r; I] of the G = 0 path at the dates, with the derivative of the
    scan they stand for.  The recursion is affine in the drifts with the
    shock shapes as weights (a drift enters a step as a unit shock does),
    so the tangent at date j is (u_j . d drift, w_j . d drift): under a
    sigma bump d drift = drift_sigma d sigma, what the JAX package's jvp
    through its scan carries.  A tangent in exp_adt or dt raises."""

    @staticmethod
    def forward(cfg, dates, exp_adt, dt, drift, U, W):
        return torch.as_tensor(_det_host(cfg, exp_adt, dt, drift, dates),
                               device=drift.device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[5], inputs[6])

    @staticmethod
    def jvp(ctx, _cfg, _dates, d_e, d_dt, d_drift, _du, _dw):
        for name, d in (("exp_adt", d_e), ("dt", d_dt)):
            if d is not None and bool(torch.any(d != 0)):
                raise NotImplementedError(
                    f"the deterministic states carry the derivative through "
                    f"the drifts only, not through {name}")
        U, W = ctx.saved_tensors
        if d_drift is None:
            return U.new_zeros((2, U.shape[1]))
        d = d_drift[:U.shape[0], None]
        return torch.stack([(d * U).sum(0), (d * W).sum(0)])


def _det_states(cfg: HWConfig, tables: StepTables, dates: tuple):
    """(k,) deterministic r and I at the dates (G = 0), on the tables'
    device, with their sigma tangent (``_DetStates``).  One host recursion
    per call: call it once and pass the result on."""
    _, U, W = _date_shapes(cfg, tuple(dates))
    dev = tables.drift.device
    out = _DetStates.apply(cfg, tuple(dates), tables.exp_adt, tables.dt,
                           tables.drift, torch.as_tensor(U, device=dev),
                           torch.as_tensor(W, device=dev))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Regression basis: [1, r~, r~^2, r~^3, V_bond(r)], a fixed function of r per
# date (model statistics, never batch statistics: the out-of-sample pass
# must apply the same policy or the lower-bound guarantee is lost)
# ---------------------------------------------------------------------------

def _powers(rt: torch.Tensor):
    """[1, rt, rt^2, rt^3] as products (integer powers, as XLA's)."""
    sq = rt * rt
    return [torch.ones_like(rt), rt, sq, sq * rt]


def _vb_norms(mu, sd, cA, B, v0):
    """Linear-detrend slope and curvature scale of the bond-value feature
    at the model mean: the raw V_bond(r)/v0 is ~0.999-correlated with the
    linear term, the detrended and rescaled residual is well conditioned."""
    e = cA * _exp(-B * mu)
    c1 = -sd * (e * B).sum() / v0
    c2 = 0.5 * sd * sd * (e * B * B).sum() / v0
    return c1, c2


def _poly_basis(r, mu, sd):
    """The polynomial columns only (the dual value proxy)."""
    return torch.stack(_powers((r - mu) / sd), dim=1)


def _basis(r, mu, sd, cA, B, v0):
    """Policy basis: [1, r~, r~^2, r~^3, clip(V-residual)], the bond feature
    clipped at +/-8 (the policy may be any fixed function of r)."""
    rt = (r - mu) / sd
    vb = (cA[None, :] * _exp(-B[None, :] * r[:, None])).sum(1)
    c1, c2 = _vb_norms(mu, sd, cA, B, v0)
    feat = torch.clamp((vb / v0 - 1.0 - c1 * rt) / c2, -8.0, 8.0)
    return torch.stack(_powers(rt) + [feat], dim=1)


def _wls(X, y, w, prec):
    """Weighted least squares by QR with ridge rows (the normal equations
    in float32 flip solutions on this basis; QR is backward-stable)."""
    sw = torch.sqrt(w)[:, None]
    p = X.shape[1]
    eye = math.sqrt(RIDGE) * torch.eye(p, dtype=X.dtype, device=X.device)
    Xw = torch.cat([X * sw, eye])
    yw = torch.cat([y * sw[:, 0], X.new_zeros(p)])
    Q, R = torch.linalg.qr(Xw, mode="reduced")
    rhs = dot(Q.T, yw, prec)
    return torch.linalg.solve_triangular(R, rhs[:, None], upper=True)[:, 0]


def _piecewise_value(r, gamma, mu, sd, cA, B, strike, rstar, sg, prec):
    """The dual value proxy V^(r): intrinsic sg (V_bond(r) - K) on the
    exercise side of r* (sg = +1 receiver exercises at low r, -1 payer at
    high r), cubic gamma . poly(r~) on the other side."""
    vb = (cA[None, :] * _exp(-B[None, :] * r[:, None])).sum(1)
    intr = sg * (vb - strike)
    poly = dot(_poly_basis(r, mu, sd), gamma, prec)
    return torch.where(sg * (rstar - r) > 0, intr, poly)


def _piecewise_cond(gamma, mu, sd, cA, B, strike, rstar, sg,
                    m_t, v_t, mI, vI, ctI):
    """E[ e^{-dI} V^(r_t) | r_s ] for the piecewise proxy, closed form.

    (r_t, dI) | r_s is bivariate normal with means (m_t, mI) (over paths)
    and scalar (v_t, vI, ctI).  Tilting by e^{-dI} multiplies by
    w0 = e^{-mI + vI/2} and shifts r_t's mean to m = m_t - ctI; then the
    exponential terms on the exercise side are truncated-lognormal means
    and the polynomial terms truncated Gaussian power moments.  The normal
    CDF is ``accurate.nphi``, the float32 ``ndtr`` formula of
    ``jax.scipy.stats.norm.cdf`` (PORT.md)."""
    w0 = _exp(-mI + 0.5 * vI)
    m = m_t - ctI
    s = torch.sqrt(v_t)
    # intrinsic side: sg * (sum_i cA_i e^{-B_i r} - K)
    eterm = _exp(-B[None, :] * m[:, None] + 0.5 * (B * B)[None, :] * v_t)
    argB = sg * (rstar - m[:, None] + B[None, :] * v_t) / s
    e_intr = (cA[None, :] * eterm * nphi(argB)).sum(1)
    e_intr = sg * (e_intr - strike * nphi(sg * (rstar - m) / s))
    # polynomial side (the complement): truncated power moments
    my = (m - mu) / sd
    vy = v_t / (sd * sd)
    sy = s / sd
    cy = (rstar - mu) / sd
    alpha = (cy - my) / sy
    phi_a = _npdf(alpha)
    # upper moments T_p = E[y^p 1{y > cy}]
    T = [nphi(-alpha)]
    T.append(my * T[0] + sy * phi_a)
    T.append(my * T[1] + vy * T[0] + sy * cy * phi_a)
    T.append(my * T[2] + 2.0 * vy * T[1] + sy * cy * cy * phi_a)
    if sg < 0:  # payer: continuation side is r < c -> lower = full - upper
        full = [torch.ones_like(my), my, my * my + vy,
                my * (my * my) + 3 * my * vy]
        T = [f - t for f, t in zip(full, T)]
    e_poly = sum(gamma[p] * T[p] for p in range(BASIS_DEGREE + 1))
    return w0 * (e_intr + e_poly)


def _bisect(f, a, b, iters=60):
    """Bisection assuming f(a) > 0 > f(b), elementwise on tensors a, b of
    any one shape (each element its own root; they need not be ordered).
    No value leaves the device."""
    for _ in range(iters):
        mid = 0.5 * (a + b)
        pos = f(mid) > 0
        a = torch.where(pos, mid, a)
        b = torch.where(pos, b, mid)
    return 0.5 * (a + b)


class BermudanResult(NamedTuple):
    price: torch.Tensor            # out-of-sample LSMC lower bound
    price_in_sample: torch.Tensor  # in-sample (upward-biased)
    std_error: torch.Tensor        # out-of-sample SE
    upper: torch.Tensor            # Andersen-Broadie dual upper bound
    upper_std_error: torch.Tensor
    n_paths: int
    exercise_dates: tuple
    # martingale-CV lower bound: the expectation of ``price`` (optional
    # stopping: E[M_tau] = 0), its variance collapsed by subtracting the
    # dual's exact martingale at the policy's stopping time
    price_cv: torch.Tensor | None = None
    cv_std_error: torch.Tensor | None = None


def _bermudan_fn(cfg: HWConfig, ex_dates: tuple, sched: CouponSchedule,
                 strike: float, payer: bool, n_paths: int, n_blocks: int,
                 rqmc: bool, dev: torch.device, mesh=None):
    """``compute(key, sigma, market)`` -> (lower, in-sample, SE, upper,
    upper SE, CV lower, CV SE): the two-pass estimator as a function of a
    float32 sigma tensor on ``dev`` (``torch.func.jvp`` differentiates it);
    the evaluation pass's blocks optionally sharded over ``mesh``."""
    k = len(ex_dates)
    prec = cfg.matmul_precision
    ivp = _interval_params(cfg, ex_dates)
    sds_unit = [float(np.linalg.norm(
        _shock_shapes(cfg, _step_index(cfg, t))[0], ord=2))
        for t in ex_dates]
    sg = 1.0 if not payer else -1.0   # receiver exercises at low r

    def payoff_at(r_j, cA, B):
        V = (cA[None, :] * _exp(-B[None, :] * r_j[:, None])).sum(1)
        intrinsic = (strike - V) if payer else (V - strike)
        return torch.clamp(intrinsic, min=0.0)

    def backward(r, integral, stats, terms, v0s, betas=None,
                 fit_value=False):
        """LSMC backward induction; optionally also fit the dual value
        proxy's continuation coefficients gamma_j on the continuation-
        region paths (the exercise side of the proxy is exact)."""
        D = _exp(-integral)
        cf = payoff_at(r[:, k - 1], *terms[k - 1]) * D[:, k - 1]
        stop = torch.full((r.shape[0],), k - 1, dtype=torch.int64,
                          device=dev)
        est = betas is None
        out_betas = [None] * max(k - 1, 0)
        # last-date value proxy: the exact payoff (zero continuation fit)
        gammas = [None] * (k - 1) + [torch.zeros(BASIS_DEGREE + 1,
                                                 device=dev)]
        for j in range(k - 2, -1, -1):
            pj = payoff_at(r[:, j], *terms[j])
            X = _basis(r[:, j], stats[0][j], stats[1][j], *terms[j], v0s[j])
            y = cf / D[:, j]
            itm = (pj > 0.0).to(torch.float32)
            if est:
                beta = _wls(X, y, itm, prec)
                out_betas[j] = beta
            else:
                beta = betas[j]
            cont = dot(X, beta, prec)
            exercise = (pj > cont) & (pj > 0.0)
            if fit_value:
                wc = 1.0 - exercise.to(torch.float32)
                gammas[j] = _wls(X[:, :BASIS_DEGREE + 1], y, wc, prec)
            cf = torch.where(exercise, pj * D[:, j], cf)
            stop = torch.where(exercise, j, stop)
        return cf, out_betas, gammas, stop

    def exercise_boundaries(stats, terms, v0s, betas):
        """Per-date boundary r*_j of the fitted policy (last date: the
        strike root): g(r) = intrinsic - max(cont, 0) is positive exactly
        on the policy's exercise set; a 60-step bisection between the deep
        in-the-money end and the strike root locates its crossing."""
        rstars = []
        for j in range(k):
            cA, B = terms[j]
            mu, sd = stats[0][j], stats[1][j]

            def intr(rv, cA=cA, B=B):
                return sg * ((cA * _exp(-B * rv)).sum(0, keepdim=True)
                             - strike)

            far = mu - sg * 14.0 * sd          # deep ITM end
            r_k = _bisect(intr, far, mu + sg * 14.0 * sd)
            if j == k - 1:
                rstars.append(r_k)             # exact payoff proxy
                continue
            beta, v0 = betas[j], v0s[j]

            def g(rv, cA=cA, B=B, mu=mu, sd=sd, beta=beta, v0=v0):
                cont = dot(_basis(rv, mu, sd, cA, B, v0), beta, prec)
                return intr(rv) - torch.clamp(cont, min=0.0)

            rstars.append(_bisect(g, far, r_k))
        return rstars

    def dual_path_bound(r, integral, sig2, r_det, i_det, stats, terms,
                        gammas, rstars):
        """max_j (Z_j - M_j) per path, and M after each date's increment:
        the AB dual with the closed-form martingale increments of the
        piecewise value proxy."""
        D = _exp(-integral)
        M = torch.zeros(r.shape[0], device=dev)
        Ms = []
        best = None
        for j in range(k):
            p = ivp[j]
            if j == 0:
                r_s = torch.full((r.shape[0],), cfg.r0, device=dev)
                D_prev = torch.ones_like(M)
                rdet_s = float(np.float32(cfg.r0))
                didet = i_det[0]
            else:
                r_s = r[:, j - 1]
                D_prev = D[:, j - 1]
                rdet_s = r_det[j - 1]
                didet = i_det[j] - i_det[j - 1]
            f32 = lambda v: float(np.float32(v))  # noqa: E731
            m_t = r_det[j] + f32(p["bt"]) * (r_s - rdet_s)
            mI = didet + f32(p["bI"]) * (r_s - rdet_s)
            v_t = sig2 * f32(p["vt"])
            vI = sig2 * f32(p["vI"])
            ctI = sig2 * f32(p["ctI"])
            cA, B = terms[j]
            mu, sd = stats[0][j], stats[1][j]
            cond = _piecewise_cond(gammas[j], mu, sd, cA, B, strike,
                                   rstars[j], sg, m_t, v_t, mI, vI, ctI)
            vhat = _piecewise_value(r[:, j], gammas[j], mu, sd, cA, B,
                                    strike, rstars[j], sg, prec)
            M = M + D[:, j] * vhat - D_prev * cond
            Ms.append(M)
            Z = D[:, j] * payoff_at(r[:, j], *terms[j])
            best = Z - M if best is None else torch.maximum(best, Z - M)
        return best, torch.stack(Ms, dim=1)

    def compute(key: Key, sigma: torch.Tensor, market: MarketCurve):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
        LT = torch.as_tensor(_joint_chol(cfg, ex_dates), device=dev)
        r_det, i_det = _det_states(cfg, tables, ex_dates)
        # the per-date scalars are (1,) tensors: under torch.func.jvp a
        # 0-dim tensor times a Python float takes a float64 tangent
        sds = tables.sig_st * torch.tensor(sds_unit, device=dev)
        stats = ([r_det[j:j + 1] for j in range(k)],
                 [sds[j:j + 1] for j in range(k)])
        terms = [_bond_value_terms(cfg, tables.sigma, market, sched,
                                   t=ex_dates[j]) for j in range(k)]
        # bond value at the model-mean rate (basis normalizer)
        v0s = [(terms[j][0] * _exp(-terms[j][1] * stats[0][j]))
               .sum(0, keepdim=True) for j in range(k)]
        sig2 = (tables.sig_st * tables.sig_st).reshape(1)
        k_est, k_val = key.split(2)

        def states(x):
            z = tables.sig_st * dot(x, LT, prec)
            return r_det[None, :] + z[:, 0::2], i_det[None, :] + z[:, 1::2]

        # pass 1: estimate the policy and the value proxy (one batch)
        r_a, i_a = states(normal(k_est, (n_paths, 2 * k), device=dev))
        cf_in, betas, gammas, _ = backward(r_a, i_a, stats, terms, v0s,
                                           fit_value=True)
        p_in = cf_in.mean()
        rstars = exercise_boundaries(stats, terms, v0s, betas)

        # pass 2: out-of-sample lower + dual upper, block by block
        def block(b):
            r_b, i_b = states(block_normals(k_val, b, (n_paths, 2 * k),
                                            rqmc=rqmc, device=dev))
            cf, _, _, stop = backward(r_b, i_b, stats, terms, v0s,
                                      betas=betas)
            u, Ms = dual_path_bound(r_b, i_b, sig2, r_det, i_det, stats,
                                    terms, gammas, rstars)
            # martingale control variate: E[M_tau] = 0 by optional
            # stopping, and cf ~ V0 + M_tau for a near-optimal policy
            m_tau = torch.gather(Ms, 1, stop[:, None])[:, 0]
            cv = cf - m_tau
            return torch.stack([cf.sum(), (cf * cf).sum(), u.sum(),
                                (u * u).sum(), cv.sum(), (cv * cv).sum()])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)  # (n_blocks, 6)
        n_tot = 1.0 * n_paths * n_blocks
        # (lower, upper, CV) means and their SEs, as (3,) vectors
        means = per_block.sum(0) / n_tot
        mean = means[0::2]
        if rqmc:
            # the Sobol points are deterministic given the shift: the
            # shifts are the independent replicates (n_blocks >= 2)
            ses = ((per_block[:, 0::2] / n_paths).std(0, correction=1)
                   / math.sqrt(1.0 * n_blocks))
        else:
            ses = torch.sqrt(torch.clamp(means[1::2] - mean ** 2, min=0.0)
                             / n_tot)
        return mean[0], p_in, ses[0], mean[1], ses[1], mean[2], ses[2]

    return compute


def _check_dates(sched: CouponSchedule, exercise_dates, rqmc: bool,
                 n_blocks: int) -> tuple:
    ex = tuple(sorted(float(t) for t in exercise_dates))
    if not ex:
        raise ValueError("need at least one exercise date")
    if ex[-1] >= max(sched.times):
        raise ValueError("exercise dates must precede the last cashflow")
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent SE replicates)")
    return ex


def price_bermudan(cfg: HWConfig, key: Key, market: MarketCurve,
                   sched: CouponSchedule, exercise_dates: Sequence[float],
                   *, strike: float = 1.0, payer: bool = False, sigma=None,
                   n_paths: int | None = None, n_blocks: int = 1,
                   rqmc: bool = False, mesh=None,
                   device) -> BermudanResult:
    """Two-pass LSMC Bermudan price bracketed by the AB dual upper bound.

    ``n_paths`` is the per-block path count (the policy pass uses one
    block); the evaluation pass runs ``n_blocks`` independent blocks, so
    the out-of-sample sample is n_paths * n_blocks in constant memory.
    ``rqmc=True`` draws each evaluation block from a 2k-dimensional
    digitally shifted Sobol sequence (the shifts are the replicates).
    Exercising on a payment date forfeits that payment (exercise happens
    just after the coupon)."""
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    ex = _check_dates(sched, exercise_dates, rqmc, n_blocks)
    fn = _bermudan_fn(cfg, ex, sched, float(strike), bool(payer),
                      int(n_paths), int(n_blocks), bool(rqmc), dev, mesh)
    p_out, p_in, se, up, up_se, p_cv, cv_se = fn(
        key, torch.as_tensor(sigma, dtype=torch.float32, device=dev),
        market)
    return BermudanResult(price=p_out, price_in_sample=p_in, std_error=se,
                          upper=up, upper_std_error=up_se,
                          n_paths=int(n_paths) * int(n_blocks),
                          exercise_dates=ex, price_cv=p_cv,
                          cv_std_error=cv_se)


# ---------------------------------------------------------------------------
# Near-exact oracle: 1-d dynamic programming on the Gauss-Markov short rate
# ---------------------------------------------------------------------------

def exact_lin_expect(m, s, grid, V):
    """E[V^(X)], X ~ N(m, s^2) per element of m, with V^ the piecewise
    linear interpolant of (grid, V) and flat extrapolation: the numpy
    form of the C++ sweep ``hw_dp_continuation`` (its plain version in
    the tests)."""
    from scipy.stats import norm

    m = np.atleast_1d(m)
    t = (grid[None, :] - m[:, None]) / s
    Phi = norm.cdf(t)
    phi = norm.pdf(t)
    b = np.diff(V) / np.diff(grid)
    a = V[:-1] - b * grid[:-1]
    dPhi = Phi[:, 1:] - Phi[:, :-1]
    dphi = phi[:, 1:] - phi[:, :-1]
    mid = np.sum((a[None, :] + b[None, :] * m[:, None]) * dPhi
                 - b[None, :] * s * dphi, axis=1)
    return mid + V[0] * Phi[:, 0] + V[-1] * (1.0 - Phi[:, -1])


def dp_oracle(cfg: HWConfig, market: MarketCurve, sched: CouponSchedule,
              exercise_dates: Sequence[float], *, strike: float = 1.0,
              payer: bool = False, n_grid: int = 1501,
              width: float = 8.5, order: str = "cubic") -> float:
    """float64 Bermudan price by backward induction on an r-grid:
    V_k(r) = payoff_k(r); V_j(r) = max(payoff_j(r),
    E[e^{-dI} V_{j+1}(r') | r]), the conditional expectation of a
    cubic-Hermite (or piecewise-linear) interpolant integrated exactly
    against the tilted Gaussian.  Host work only, no ``device``: the
    market may lie on any device (``dp_solution``)."""
    return dp_solution(cfg, market, sched, exercise_dates, strike=strike,
                       payer=payer, n_grid=n_grid, width=width,
                       order=order)["price"]


def dp_solution(cfg: HWConfig, market: MarketCurve, sched: CouponSchedule,
                exercise_dates: Sequence[float], *, strike: float = 1.0,
                payer: bool = False, n_grid: int = 1501,
                width: float = 8.5, order: str = "cubic") -> dict:
    """The full ``dp_oracle`` solution: a dict with the exercise dates
    ``ex``, per-date r-``grids``, post-decision value ``V``,
    ``cont``inuation and ``payoff`` arrays, deterministic states
    ``r_det``/``i_det``, interval params ``ivp``, per-date state ``sds``,
    ``sig`` and the rolled-back ``price``.

    It takes the market on any device and computes in host float64 (numpy
    and the C++ library): it has no device work and takes no ``device``.
    The continuation sweep is ``hw_dp_continuation3`` (order="cubic") or
    ``hw_dp_continuation`` ("linear"), built at first use; a failed build
    raises."""
    from .utils import native as hw_native

    if order not in ("cubic", "linear"):
        raise ValueError("order must be 'cubic' or 'linear'")
    market = market.to("cpu")
    ex = tuple(sorted(float(t) for t in exercise_dates))
    k = len(ex)
    ivp = _interval_params(cfg, ex)
    (r_det, i_det), sig = _det_host64(cfg, cfg.sigma, ex)
    sds = np.array([np.linalg.norm(np.asarray(
        _shock_shapes(cfg, _step_index(cfg, t))[0], np.float64))
        for t in ex]) * sig

    def payoff_np(j, r):
        cA, B = (np.asarray(a.numpy(), np.float64) for a in
                 _bond_value_terms(cfg, cfg.sigma, market, sched, t=ex[j]))
        V = np.sum(cA[None, :] * np.exp(-B[None, :] * r[:, None]), axis=1)
        return np.maximum((strike - V) if payer else (V - strike), 0.0)

    def continuation(r_s, j_to, rdet_s, V):
        """cont(r_s) for the interval ending at date index j_to."""
        p = ivp[j_to]
        didet = i_det[j_to] - (i_det[j_to - 1] if j_to > 0 else 0.0)
        v_t, vI, ctI = (sig * sig * p["vt"], sig * sig * p["vI"],
                        sig * sig * p["ctI"])
        return hw_native.dp_continuation(
            r_s, grids[j_to], V, rdet_s, r_det[j_to], didet,
            p["bt"], p["bI"], v_t, vI, ctI, order=order)

    grids = [r_det[j] + sds[j] * np.linspace(-width, width, n_grid)
             for j in range(k)]
    payoffs = [payoff_np(j, grids[j]) for j in range(k)]
    Vs = [None] * k
    conts = [None] * k
    Vs[k - 1] = payoffs[k - 1]
    conts[k - 1] = np.zeros(n_grid)
    for j in range(k - 2, -1, -1):
        conts[j] = continuation(grids[j], j + 1, r_det[j], Vs[j + 1])
        Vs[j] = np.maximum(payoffs[j], conts[j])
    # discount from e_1 to 0 (deterministic start r(0) = r0)
    price = float(continuation(np.array([cfg.r0]), 0, cfg.r0, Vs[0])[0])
    return dict(ex=ex, grids=grids, V=Vs, cont=conts, payoff=payoffs,
                r_det=r_det, i_det=i_det, ivp=ivp, sds=sds, sig=sig,
                price=price)
