"""Backward-looking RFR (overnight-rate) caps, caplets and floorlets
(PyTorch port of ``hullwhite_tpu.rfr``).

Products on the model's own realized short rate over accrual periods
[t_j, t_{j+1}] (the SOFR/ESTR convention family):

  * compounded: the continuously-compounded setting of the daily compound,
    R_j = (e^{I(t_{j+1}) - I(t_j)} - 1) / delta_j with I(t) = int_0^t r du
    the model's discount integral.  Payoff at t_{j+1}:
    delta_j max(zeta (R_j - K), 0), zeta = +1 cap / -1 floor.
  * averaged: the arithmetic average A_j = (1/m) sum_i r(t_i) over m
    right-endpoint observation dates per period.  Payoff at t_{j+1}:
    delta_j max(zeta (A_j - K), 0).

A cap/floor is the strip over a schedule; a caplet is the one-period
strip.  The payoff touches only Gaussian functionals (I at the period
boundaries; r at the observations and I at the payments), so the Monte
Carlo draws them directly from one joint Cholesky factor
(``bermudan._functional_chol`` / ``g2pp._g2_functional_chol``), no path
scan, and the fp64 oracles are closed form per period: after the
Gaussian tilt by e^{-I_e}, a Black formula (compounded) or a Bachelier
formula (averaged).

The G2++ twins have the same structure: I and dI are Gaussian under G2++
too, and r(t) = phi(t) + x(t) + y(t) with phi(t) = f(0,t) + V'(t)/2, so
the averaged twin samples the unit strip projection ("u", t, 1, 1) =
x + y.  Their discounting is market-consistent.

The Monte Carlo is plain PyTorch on the device (no hand-written kernel):
blocks drawn from their global index (``ops.rng.block_normals``, iid
threefry normals or, with ``rqmc=True``, digitally shifted Sobol points
whose shifts are the SE replicates) one after the other or sharded over a
path mesh (``mesh=``, ``parallel.mesh.map_blocks``: the sharded run
equals the single one bit for bit), the product at
``cfg.matmul_precision`` (``engine_linear.dot``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .bermudan import (RIDGE, _det_affine, _functional_chol,
                       _functional_det, _step_index)
from .config import HWConfig, resolve_device
from .models import hull_white as hw
from .models.g2pp import (_B, _g2_functional_chol, _g2_functional_cov,
                          _np_P, _v_integral, _vec32)
from .models.hull_white import MarketCurve
from .models.oracles import _phi
from .ops.engine_linear import _shock_shapes, dot
from .ops.rng import Key, block_normals
from .parallel import mesh as pmesh


class RFRResult(NamedTuple):
    price: torch.Tensor
    std_error: torch.Tensor
    caplets: torch.Tensor  # (n_periods,) per-period MC values
    n_paths: int


def _check_grid(cfg: HWConfig, t: float, what: str) -> float:
    n = round(t / cfg.dt)
    if abs(n * cfg.dt - t) > 1e-9 or not (0 < n <= cfg.n_steps):
        raise ValueError(f"{what} {t} must sit on the step grid")
    return float(n * cfg.dt)


def _obs_dates(cfg: HWConfig, start: float, end: float,
               n_obs: int) -> tuple:
    """m right-endpoint observation dates start + i (end - start)/m,
    i = 1..m, each on the step grid."""
    step = (end - start) / n_obs
    if abs(round(step / cfg.dt) * cfg.dt - step) > 1e-9:
        raise ValueError("(end - start)/n_obs must be a multiple of dt")
    return tuple(start + (i + 1) * step for i in range(n_obs))


def _bounds(cfg: HWConfig, start, end, tenor, freq, n_obs, style):
    """Period boundaries (t_0, ..., t_n) and per-period observation count
    from either (start, end) single-caplet or (start, tenor, freq) strip
    arguments."""
    if start is None:
        start = cfg.s1
    start = _check_grid(cfg, start, "start")
    if end is not None:
        end = _check_grid(cfg, end, "end")
        if end <= start:
            raise ValueError("end must exceed start")
        bounds = (start, end)
    else:
        if tenor is None:
            tenor = 10 * cfg.mat_spacing
        n = int(round(tenor * freq))
        if n < 1:
            raise ValueError("tenor * freq must be >= 1")
        bounds = tuple(start + j / freq for j in range(n + 1))
        for t in bounds[1:]:
            _check_grid(cfg, t, "period boundary")
    if style not in ("compounded", "averaged"):
        raise ValueError(f"unknown RFR style {style!r}")
    if style == "averaged" and n_obs is None:
        n_obs = int(round((bounds[1] - bounds[0]) / cfg.dt))
    return bounds, n_obs


def _specs(bounds: tuple, n_obs, style: str, cfg: HWConfig):
    if style == "compounded":
        return tuple(("I", t) for t in bounds)
    obs = [t for j in range(len(bounds) - 1)
           for t in _obs_dates(cfg, bounds[j], bounds[j + 1], n_obs)]
    return tuple([("r", t) for t in obs]
                 + [("I", t) for t in bounds[1:]])


def _cov_np(cfg: HWConfig, specs: tuple) -> np.ndarray:
    """fp64 covariance of the spec functionals per unit sig_st, with the
    sampler's RIDGE jitter (``bermudan._functional_chol``), so the closed
    forms integrate exactly the law the sampler draws from."""
    U = np.zeros((cfg.n_steps, len(specs)))
    for c, (kind, t) in enumerate(specs):
        n = _step_index(cfg, t)
        u, w = _shock_shapes(cfg, n)
        U[:n, c] = np.asarray(u if kind == "r" else w, np.float64)
    return U.T @ U + RIDGE * np.eye(len(specs))


def _strip_stats(per_block: torch.Tensor, n_paths: int, n_blocks: int,
                 n: int, rqmc: bool):
    """(cap, cap_se, flo, flo_se, cap_per, flo_per) from the stacked
    per-block sums [capsum, capsq, flosum, flosq, cap_per(n),
    flo_per(n)]."""
    s = per_block.sum(0)
    n_tot = 1.0 * n_paths * n_blocks

    def stat(s1, s2, col):
        mean = s1 / n_tot
        if rqmc:
            se = ((per_block[:, col] / n_paths).std(correction=1)
                  / math.sqrt(1.0 * n_blocks))
        else:
            var = torch.clamp(s2 / n_tot - mean * mean, min=0.0)
            var = var * n_tot / max(n_tot - 1.0, 1.0)
            se = torch.sqrt(var / n_tot)
        return mean, se

    cap, cap_se = stat(s[0], s[1], 0)
    flo, flo_se = stat(s[2], s[3], 2)
    return cap, cap_se, flo, flo_se, s[4:4 + n] / n_tot, s[4 + n:] / n_tot


def _block_sums(cap: torch.Tensor, flo: torch.Tensor) -> torch.Tensor:
    """One block's [sum ct, sum ct^2, sum ft, sum ft^2, per-period cap
    sums, per-period floor sums] of the (paths, n) period values."""
    ct, ft = cap.sum(1), flo.sum(1)
    return torch.cat([torch.stack([ct.sum(), (ct * ct).sum(), ft.sum(),
                                   (ft * ft).sum()]),
                      cap.sum(0), flo.sum(0)])


def _antithetic(leg):
    """The period values' antithetic means over the legs sgn = +1, -1."""
    cp, fp_ = leg(1.0)
    cm, fm = leg(-1.0)
    return 0.5 * (cp + cm), 0.5 * (fp_ + fm)


# ---------------------------------------------------------------------------
# Hull-White
# ---------------------------------------------------------------------------

def _rfr_fn(cfg: HWConfig, style: str, strike: float, bounds: tuple,
            n_obs, n_paths: int, n_blocks: int, rqmc: bool,
            dev: torch.device, mesh=None):
    """``compute(key, sigma)`` -> ``_strip_stats``, a function of a float32
    sigma tensor on ``dev`` (``torch.func.jvp`` differentiates it)."""
    specs = _specs(bounds, n_obs, style, cfg)
    LT = torch.as_tensor(_functional_chol(cfg, specs), device=dev)
    n = len(bounds) - 1
    deltas = _vec32([bounds[j + 1] - bounds[j] for j in range(n)], dev)
    kbs = 1.0 + deltas * strike
    m = 0 if style == "compounded" else n * n_obs

    def compute(key: Key, sigma: torch.Tensor):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
        det = _functional_det(cfg, sigma, specs)

        def block(bi):
            x = block_normals(key, bi, (n_paths, len(specs)), rqmc=rqmc,
                              device=dev)
            z = tables.sig_st * dot(x, LT, cfg.matmul_precision)

            def leg(sgn):
                f = det[None, :] + sgn * z
                if style == "compounded":
                    i_b = f  # (paths, n+1) at the boundaries
                    disc = torch.exp(-i_b[:, 1:])
                    fwd = torch.exp(i_b[:, 1:] - i_b[:, :-1])
                    cap = disc * torch.clamp(fwd - kbs[None, :], min=0.0)
                    flo = disc * torch.clamp(kbs[None, :] - fwd, min=0.0)
                else:
                    avg = f[:, :m].reshape(-1, n, n_obs).mean(2)
                    disc = torch.exp(-f[:, m:])
                    cap = (deltas[None, :] * disc
                           * torch.clamp(avg - strike, min=0.0))
                    flo = (deltas[None, :] * disc
                           * torch.clamp(strike - avg, min=0.0))
                return cap, flo

            return _block_sums(*_antithetic(leg))

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _strip_stats(per_block, n_paths, n_blocks, n, rqmc)

    return compute


def _common(cfg: HWConfig, n_paths, n_blocks, rqmc) -> int:
    if n_paths is None:
        n_paths = cfg.n_paths
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    return int(n_paths)


def _caplet_end(cfg: HWConfig, start, end):
    """The single caplet's end: [start, start + one maturity decade] by
    default (start defaults to s1)."""
    if end is None:
        s = cfg.s1 if start is None else start
        end = s + 10 * cfg.mat_spacing
    return end


def price_rfr_cap(cfg: HWConfig, key: Key, market: MarketCurve = None, *,
                  strike: float, start: float | None = None,
                  end: float | None = None, tenor: float | None = None,
                  freq: float = 1.0, style: str = "compounded",
                  n_obs: int | None = None, floor: bool = False,
                  sigma=None, n_paths: int | None = None,
                  n_blocks: int = 1, rqmc: bool = False, mesh=None,
                  device) -> RFRResult:
    """Monte Carlo backward-looking RFR cap (or floor) under Hull-White: a
    strip of compounded or averaged caplets over [start, start + tenor] at
    ``freq`` periods a year (or a single caplet when ``end`` is given),
    all periods from one exact joint functional sample (antithetic;
    optionally RQMC), blocks keyed on their global index.  The leg is
    discounted inside the model (e^{-I}), so ``market`` is accepted for a
    uniform signature and not used.  fp64 oracle: rfr_cap_closed_form."""
    del market
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = _common(cfg, n_paths, n_blocks, rqmc)
    bounds, n_obs = _bounds(cfg, start, end, tenor, freq, n_obs, style)
    cap, cap_se, flo, flo_se, cper, fper = _rfr_fn(
        cfg, style, float(strike), bounds, n_obs, n_paths, int(n_blocks),
        bool(rqmc), dev, mesh)(key, torch.as_tensor(
            sigma, dtype=torch.float32, device=dev))
    price, se, per = ((flo, flo_se, fper) if floor
                      else (cap, cap_se, cper))
    return RFRResult(price=price, std_error=se, caplets=per,
                     n_paths=n_paths * int(n_blocks))


def price_rfr_caplet(cfg: HWConfig, key: Key, market: MarketCurve = None,
                     *, strike: float, start: float | None = None,
                     end: float | None = None, style: str = "compounded",
                     n_obs: int | None = None, floor: bool = False,
                     sigma=None, n_paths: int | None = None,
                     n_blocks: int = 1, rqmc: bool = False, mesh=None,
                     device) -> RFRResult:
    """Single backward-looking RFR caplet/floorlet: the one-period strip
    over [start, end] (defaults: [s1, s1 + one maturity decade])."""
    return price_rfr_cap(cfg, key, market, strike=strike, start=start,
                         end=_caplet_end(cfg, start, end), style=style,
                         n_obs=n_obs, floor=floor, sigma=sigma,
                         n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc,
                         mesh=mesh, device=device)


def rfr_cap_closed_form(cfg: HWConfig, *, strike: float,
                        start: float | None = None,
                        end: float | None = None,
                        tenor: float | None = None, freq: float = 1.0,
                        style: str = "compounded",
                        n_obs: int | None = None, floor: bool = False,
                        sigma: float | None = None):
    """(total, per-period list): float64 RFR cap/floor in closed form.

    compounded: caplet = P_s Phi(d1) - Kb P_e Phi(d2), Kb = 1 + delta K,
    d2 = (mu~ - ln Kb)/s_D, d1 = d2 + s_D, mu~ = E[dI] - Cov(I_e, dI),
    s_D^2 = Var dI, P_t = E[e^{-I(t)}] the model bond.  averaged: the tilt
    shifts the Gaussian average's mean by -Cov(A, I_e), so caplet =
    delta P_e [(mu~_A - K) Phi(h) + s_A phi(h)], h = (mu~_A - K)/s_A.
    Deterministic parts from the exact host affine decomposition
    (``bermudan._det_affine``), covariances from the shock shapes: the law
    the sampler integrates."""
    if sigma is None:
        sigma = cfg.sigma
    bounds, n_obs = _bounds(cfg, start, end, tenor, freq, n_obs, style)
    zeta = -1.0 if floor else 1.0

    tables = hw.step_tables(cfg, sigma, cfg.sigma, device="cpu")
    sig = float(tables.sig_st)
    rA, rB, iA, iB = _det_affine(cfg)
    c0 = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)

    def det(kind, t):
        nidx = _step_index(cfg, t) - 1
        return ((rA[nidx] + c0 * rB[nidx]) if kind == "r"
                else (iA[nidx] + c0 * iB[nidx]))

    per = []
    for j in range(len(bounds) - 1):
        s_, e_ = bounds[j], bounds[j + 1]
        delta = e_ - s_
        specs = _specs((s_, e_), n_obs, style, cfg)
        C = sig * sig * _cov_np(cfg, specs)
        mu_e, v_e = det("I", e_), C[-1, -1]
        P_e = math.exp(-mu_e + 0.5 * v_e)
        if style == "compounded":
            kb = 1.0 + delta * strike
            mu_s, v_s = det("I", s_), C[0, 0]
            P_s = math.exp(-mu_s + 0.5 * v_s)
            v_d = C[0, 0] + C[1, 1] - 2.0 * C[0, 1]
            if v_d <= 0.0:
                per.append(max(zeta * (P_s / P_e - kb), 0.0) * P_e)
                continue
            s_d = math.sqrt(v_d)
            cov = C[1, 1] - C[0, 1]  # Cov(I_e, dI)
            mu_t = (mu_e - mu_s) - cov
            d2 = (mu_t - math.log(kb)) / s_d
            d1 = d2 + s_d
            per.append(zeta * (P_s * _phi(zeta * d1)
                               - kb * P_e * _phi(zeta * d2)))
        else:
            mm = len(specs) - 1
            mu_a = sum(det("r", t) for _, t in specs[:mm]) / mm
            var_a = float(np.mean(C[:mm, :mm]))
            cov_a = float(np.mean(C[:mm, mm]))
            per.append(delta * P_e * _bachelier(mu_a - cov_a, strike,
                                                math.sqrt(var_a), zeta))
    return sum(per), per


def _bachelier(mu: float, strike: float, s: float, zeta: float) -> float:
    """E[max(zeta (A - K), 0)] for A ~ N(mu, s^2)."""
    h = zeta * (mu - strike) / s
    return (zeta * (mu - strike) * _phi(h)
            + s * math.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi))


def rfr_caplet_closed_form(cfg: HWConfig, *, strike: float,
                           start: float | None = None,
                           end: float | None = None,
                           style: str = "compounded",
                           n_obs: int | None = None, floor: bool = False,
                           sigma: float | None = None) -> float:
    """float64 single RFR caplet/floorlet (one-period strip)."""
    return rfr_cap_closed_form(cfg, strike=strike, start=start,
                               end=_caplet_end(cfg, start, end),
                               style=style, n_obs=n_obs, floor=floor,
                               sigma=sigma)[0]


def vega_rfr_cap(cfg: HWConfig, key: Key, market: MarketCurve = None, *,
                 strike: float, start: float | None = None,
                 end: float | None = None, tenor: float | None = None,
                 freq: float = 1.0, style: str = "compounded",
                 n_obs: int | None = None, floor: bool = False,
                 sigma=None, n_paths: int | None = None,
                 n_blocks: int = 1, rqmc: bool = False, mesh=None, device):
    """(price, vega) by one ``torch.func.jvp`` through the sigma-scalar
    form (sigma enters only through sig_st and the affine drift, so the
    tangent is exact; under ``mesh`` the gather carries it)."""
    del market
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = _common(cfg, n_paths, n_blocks, rqmc)
    bounds, n_obs = _bounds(cfg, start, end, tenor, freq, n_obs, style)
    fn = _rfr_fn(cfg, style, float(strike), bounds, n_obs, n_paths,
                 int(n_blocks), bool(rqmc), dev, mesh)
    idx = 2 if floor else 0
    s = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    return torch.func.jvp(lambda v: fn(key, v)[idx], (s,),
                          (torch.ones_like(s),))


def vega_rfr_caplet(cfg: HWConfig, key: Key, market: MarketCurve = None, *,
                    strike: float, start: float | None = None,
                    end: float | None = None, style: str = "compounded",
                    n_obs: int | None = None, floor: bool = False,
                    sigma=None, n_paths: int | None = None,
                    n_blocks: int = 1, rqmc: bool = False, mesh=None,
                    device):
    """(price, vega) of the single one-period caplet, with
    price_rfr_caplet's end default (end = start + one maturity decade);
    vega_rfr_cap without ``end`` would price the multi-period strip."""
    return vega_rfr_cap(cfg, key, market, strike=strike, start=start,
                        end=_caplet_end(cfg, start, end), style=style,
                        n_obs=n_obs, floor=floor, sigma=sigma,
                        n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc,
                        mesh=mesh, device=device)


# ---------------------------------------------------------------------------
# G2++ twins
# ---------------------------------------------------------------------------

def _v_prime(g, t: float) -> float:
    """V'(t) = d/dt Var(int_0^t (x+y)): sig^2 Ba(t)^2 + eta^2 Bb(t)^2
    + 2 rho sig eta Ba(t) Bb(t), the phi(t) adjustment term."""
    ba, bb = _B(g.a, t), _B(g.b, t)
    return (g.sigma * g.sigma * ba * ba + g.eta * g.eta * bb * bb
            + 2.0 * g.rho * g.sigma * g.eta * ba * bb)


def _specs_g2(bounds: tuple, n_obs, style: str, cfg: HWConfig):
    if style == "compounded":
        return tuple(("I", t) for t in bounds)
    obs = [t for j in range(len(bounds) - 1)
           for t in _obs_dates(cfg, bounds[j], bounds[j + 1], n_obs)]
    return tuple([("u", t, 1.0, 1.0) for t in obs]
                 + [("I", t) for t in bounds[1:]])


def _rfr_g2_stats(cfg: HWConfig, g, key: Key, market: MarketCurve,
                  style: str, strike: float, bounds: tuple, n_obs,
                  n_paths: int, n_blocks: int, rqmc: bool,
                  dev: torch.device, mesh=None):
    """``_strip_stats`` of the G2++ strip on ``dev``, over ``mesh``."""
    specs = _specs_g2(bounds, n_obs, style, cfg)
    LT = torch.as_tensor(_g2_functional_chol(g, specs), device=dev)
    n = len(bounds) - 1
    deltas = _vec32([bounds[j + 1] - bounds[j] for j in range(n)], dev)
    kbs = 1.0 + deltas * strike
    m = 0 if style == "compounded" else n * n_obs
    vs = [_v_integral(g, t) for t in bounds]
    P = hw.interp_curve(market.P, _vec32(bounds, dev), cfg)
    disc0 = P[1:] * torch.exp(_vec32([-0.5 * v for v in vs[1:]], dev))
    fwd0 = (P[:-1] / P[1:]) * torch.exp(_vec32(
        [0.5 * (vs[j + 1] - vs[j]) for j in range(n)], dev))
    if style == "averaged":
        obs = [t for j in range(n)
               for t in _obs_dates(cfg, bounds[j], bounds[j + 1], n_obs)]
        phis = (hw.interp_curve(market.f, _vec32(obs, dev), cfg)
                + _vec32([0.5 * _v_prime(g, t) for t in obs], dev)
                ).reshape(n, n_obs)

    def block(bi):
        x = block_normals(key, bi, (n_paths, len(specs)), rqmc=rqmc,
                          device=dev)
        z = dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            if style == "compounded":
                i_b = sgn * z  # (paths, n+1), centered
                disc = disc0[None, :] * torch.exp(-i_b[:, 1:])
                fwd = fwd0[None, :] * torch.exp(i_b[:, 1:] - i_b[:, :-1])
                cap = disc * torch.clamp(fwd - kbs[None, :], min=0.0)
                flo = disc * torch.clamp(kbs[None, :] - fwd, min=0.0)
            else:
                avg = (phis[None, :, :]
                       + sgn * z[:, :m].reshape(-1, n, n_obs)).mean(2)
                disc = disc0[None, :] * torch.exp(-sgn * z[:, m:])
                cap = (deltas[None, :] * disc
                       * torch.clamp(avg - strike, min=0.0))
                flo = (deltas[None, :] * disc
                       * torch.clamp(strike - avg, min=0.0))
            return cap, flo

        return _block_sums(*_antithetic(leg))

    per_block = pmesh.map_blocks(block, n_blocks, mesh)
    return _strip_stats(per_block, n_paths, n_blocks, n, rqmc)


def price_rfr_cap_g2(cfg: HWConfig, g, key: Key, market: MarketCurve, *,
                     strike: float, start: float | None = None,
                     end: float | None = None, tenor: float | None = None,
                     freq: float = 1.0, style: str = "compounded",
                     n_obs: int | None = None, floor: bool = False,
                     n_paths: int | None = None, n_blocks: int = 1,
                     rqmc: bool = False, mesh=None,
                     device) -> RFRResult:
    """G2++ twin of price_rfr_cap: the compounded style samples I at the
    period boundaries; the averaged style samples the unit strip
    projection x + y at the observations (r = phi + x + y, phi(t) =
    f(0,t) + V'(t)/2) and I at the payments.  Market-consistent
    discounting.  fp64 oracle: rfr_cap_closed_form_g2."""
    dev = resolve_device(device)
    n_paths = _common(cfg, n_paths, n_blocks, rqmc)
    bounds, n_obs = _bounds(cfg, start, end, tenor, freq, n_obs, style)
    cap, cap_se, flo, flo_se, cper, fper = _rfr_g2_stats(
        cfg, g, key, market.to(dev), style, float(strike), bounds, n_obs,
        n_paths, int(n_blocks), bool(rqmc), dev, mesh)
    price, se, per = ((flo, flo_se, fper) if floor
                      else (cap, cap_se, cper))
    return RFRResult(price=price, std_error=se, caplets=per,
                     n_paths=n_paths * int(n_blocks))


def price_rfr_caplet_g2(cfg: HWConfig, g, key: Key, market: MarketCurve, *,
                        strike: float, start: float | None = None,
                        end: float | None = None,
                        style: str = "compounded",
                        n_obs: int | None = None, floor: bool = False,
                        n_paths: int | None = None, n_blocks: int = 1,
                        rqmc: bool = False, mesh=None,
                        device) -> RFRResult:
    """Single G2++ RFR caplet/floorlet (one-period strip)."""
    return price_rfr_cap_g2(cfg, g, key, market, strike=strike,
                            start=start, end=_caplet_end(cfg, start, end),
                            style=style, n_obs=n_obs, floor=floor,
                            n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc,
                            mesh=mesh, device=device)


def rfr_cap_closed_form_g2(cfg: HWConfig, g, market: MarketCurve, *,
                           strike: float, start: float | None = None,
                           end: float | None = None,
                           tenor: float | None = None, freq: float = 1.0,
                           style: str = "compounded",
                           n_obs: int | None = None, floor: bool = False):
    """(total, per-period list): float64 G2++ RFR cap/floor, the same Black
    / Bachelier closed forms per period with the covariances read off
    ``_g2_functional_cov`` (the sampler's own matrix) and the market's P
    and f interpolated in fp64.  Host work: the market may lie on any
    device."""
    bounds, n_obs = _bounds(cfg, start, end, tenor, freq, n_obs, style)
    zeta = -1.0 if floor else 1.0
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P0 = _np_P(market)
    f0 = market.f.detach().cpu().numpy().astype(np.float64)

    per = []
    for j in range(len(bounds) - 1):
        s_, e_ = bounds[j], bounds[j + 1]
        delta = e_ - s_
        specs = _specs_g2((s_, e_), n_obs, style, cfg)
        C = _g2_functional_cov(g, specs)
        P_s = float(np.interp(s_, Ts, P0))
        P_e = float(np.interp(e_, Ts, P0))
        v_s, v_e = _v_integral(g, s_), _v_integral(g, e_)
        if style == "compounded":
            kb = 1.0 + delta * strike
            v_d = C[0, 0] + C[1, 1] - 2.0 * C[0, 1]
            if v_d <= 0.0:
                per.append(max(zeta * (P_s / P_e - kb), 0.0) * P_e)
                continue
            s_d = math.sqrt(v_d)
            cov = C[1, 1] - C[0, 1]
            mu_t = math.log(P_s / P_e) + 0.5 * (v_e - v_s) - cov
            d2 = (mu_t - math.log(kb)) / s_d
            d1 = d2 + s_d
            per.append(zeta * (P_s * _phi(zeta * d1)
                               - kb * P_e * _phi(zeta * d2)))
        else:
            mm = len(specs) - 1
            obs = _obs_dates(cfg, s_, e_, n_obs)
            mu_a = float(np.mean([np.interp(t, Ts, f0)
                                  + 0.5 * _v_prime(g, t) for t in obs]))
            var_a = float(np.mean(C[:mm, :mm]))
            cov_a = float(np.mean(C[:mm, mm]))
            per.append(delta * P_e * _bachelier(mu_a - cov_a, strike,
                                                math.sqrt(var_a), zeta))
    return sum(per), per


def rfr_caplet_closed_form_g2(cfg: HWConfig, g, market: MarketCurve, *,
                              strike: float, start: float | None = None,
                              end: float | None = None,
                              style: str = "compounded",
                              n_obs: int | None = None,
                              floor: bool = False) -> float:
    """float64 single G2++ RFR caplet/floorlet (one-period strip)."""
    return rfr_cap_closed_form_g2(cfg, g, market, strike=strike,
                                  start=start,
                                  end=_caplet_end(cfg, start, end),
                                  style=style, n_obs=n_obs,
                                  floor=floor)[0]
