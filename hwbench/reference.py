"""The benchmark's plain reference: Hull-White Q1 curve sums, Q2b control
variate moments and Q3 pathwise vega, in float64, written from the model's
equations and a frozen copy of the counter-hash random stream.

It imports nothing of the program.  Everything the program derives in its
set-up is derived here again from the configuration and the request's key:
the threefry key chain, the per-tile seeds, the murmur3 counter hash, the
Box-Muller normals (radius from log, angle from the degree-5 polynomials
that define the exact tier's normals), the full-step raws and their
Hadamard mix, the shock shapes, the Cholesky factors of the exact tier,
the deterministic (G = 0) path and the option constants.  The market curve
is the closed form of the configuration's piecewise-linear theta
(``market_curve``), which the benchmark hands to both sides.

Every function takes a ``device``: the benchmark runs the reference on the
card once its measured window has closed, in blocks of tiles.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
SEED_STRIDE = 1000003
PAD = 128
SALTS = {"curve": 101, "zbc": 202, "vega": 303}
# exact tier: curve tiles of (4096, 128) Box-Muller pairs, both normals of a
# pair are rows of X; option tiles of (256, 128) pairs
CURVE_ROWS = 4096
OPTION_ROWS = 256
# full step: curve tiles of 2048 paths (1024 word rows of 128 steps), option
# tiles of 4096 paths (64 word rows of 128 steps), 128-step mix blocks
FULL_CURVE_PATHS = 2048
FULL_OPTION_PATHS = 4096
MIX_BLOCK = 128
MIX_E2 = 224.3269920349121
MIX_Q0 = 0.005889892578125
MIX_W_SCALE = 1.0 / math.sqrt(128 * MIX_Q0 * MIX_Q0 * MIX_E2)
MIX_D_SEED = 12345
COS5 = (0.9999992108812327, -4.934745090535487, 4.0580410955948345,
        -1.3323690970594237, 0.22965036551851092, -0.020577251866763305)
SIN5 = (3.1415924582721866, -5.167698654480206, 2.5499982307289915,
        -0.5985505692547316, 0.08074781848280516, -0.006089474441873218)
# words hashed per block of the reference (memory: ~10 int64 temporaries)
BLOCK_WORDS = 1 << 25


# ---------------------------------------------------------------------------
# Keys: threefry2x32 (20 rounds), as jax.random's key and fold_in
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple:
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key_words(seed: int) -> tuple:
    """The two words of the key of a (up to 64-bit) seed."""
    seed = int(seed)
    return (seed >> 32) & M32, seed & M32


def fold_in(words: tuple, data: int) -> tuple:
    return threefry2x32(words[0], words[1], 0, int(data) & M32)


def tile_seeds(words: tuple, kind: str) -> tuple:
    """(seed0, seed1) of a kernel kind: the key folded with its salt."""
    return fold_in(words, SALTS[kind])


# ---------------------------------------------------------------------------
# The counter hash (murmur3 finalizer, three rounds) on int64 tensors
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _fmix(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def draw(s0, s1: int, idx, salt: int):
    """32-bit words of elements ``idx`` under tile seeds ``s0`` (int64
    tensors that broadcast)."""
    x = _fmix(idx ^ ((salt * 0x9E3779B9) & M32) ^ s0)
    x = _fmix((x + s1) & M32)
    return _fmix(x ^ s0)


def tile_s0(seed0: int, first: int, n: int, device):
    """(n, 1, 1) int64 seeds of tiles first .. first + n - 1."""
    t = torch.arange(first, first + n, dtype=torch.int64, device=device)
    return ((seed0 + t * SEED_STRIDE) & M32).reshape(n, 1, 1)


def _poly(coef, y):
    p = torch.full_like(y, coef[-1])
    for k in coef[-2::-1]:
        p = p * y + k
    return p


def box_muller(s0, s1: int, idx):
    """The two normals of each element of ``idx``: u1 in (0, 1] from the
    top 23 bits of the first word, x in [-1, 1) from the second's, radius
    sqrt(-2 log u1), angle cos(pi x) and sin(pi x) from the degree-5
    Chebyshev polynomials in x^2."""
    m1 = (draw(s0, s1, idx, 0) >> 9).to(torch.float64)
    m2 = (draw(s0, s1, idx, 1) >> 9).to(torch.float64)
    u1 = 1.0 - m1 * 2.0 ** -23
    x = m2 * 2.0 ** -22 - 1.0
    rad = torch.sqrt(-2.0 * torch.log(u1))
    y = x * x
    return rad * _poly(COS5, y), rad * (_poly(SIN5, y) * x)


def raws(s0, s1: int, idx, salt: int):
    """Full-step raws of the words ``idx`` (..., R, C): (..., 2R, C) float64,
    row 2i from the low 16 bits of word row i, 2i + 1 from the high 16.  A
    half with sign bit s, mantissa bits m (7) and octave bit c = b8 &
    (b9 | b10) is (-1)^s (1 + m / 128) 16^c."""
    b = draw(s0, s1, idx, salt)
    halves = []
    for h in (b & 0xFFFF, b >> 16):
        sign = 1.0 - 2.0 * ((h >> 15) & 1).to(torch.float64)
        mant = 1.0 + (h & 0x7F).to(torch.float64) / 128.0
        octave = ((h >> 8) & ((h >> 9) | (h >> 10)) & 1).to(torch.float64)
        halves.append(sign * mant * (1.0 + 15.0 * octave))
    v = torch.stack(halves, dim=-2)
    return v.reshape(*v.shape[:-3], -1, v.shape[-1])


# ---------------------------------------------------------------------------
# The model: shapes, deterministic path, Cholesky factors (float64)
# ---------------------------------------------------------------------------

def _theta_pieces(th: dict):
    """[(start, end, alpha, beta)] of the piecewise-linear theta."""
    tb = float(th["t_break"])
    return [(-math.inf, tb, th["alpha0"], th["beta0"]),
            (tb, math.inf, th["alpha1"], th["beta1"])]


def _int_theta_exp(a: float, th: dict, s: float, t: float, T: float) -> float:
    """int_s^t theta(u) e^{-a (T - u)} du."""
    total = 0.0
    for lo, hi, al, be in _theta_pieces(th):
        u0, u1 = max(s, lo), min(t, hi)
        if u1 <= u0:
            continue
        F = lambda u: math.exp(-a * (T - u)) * ((al + be * u) / a  # noqa: E731
                                                - be / (a * a))
        total += F(u1) - F(u0)
    return total


def _int_theta(th: dict, s: float, t: float) -> float:
    total = 0.0
    for lo, hi, al, be in _theta_pieces(th):
        u0, u1 = max(s, lo), min(t, hi)
        if u1 > u0:
            total += al * (u1 - u0) + 0.5 * be * (u1 * u1 - u0 * u0)
    return total


def market_curve(cfg: dict):
    """Closed-form P(0, T) and f(0, T) on the maturity grid, float64:
    ln P = -E[int r] + Var[int r] / 2 under dr = (theta - a r) dt + sigma dW,
    f = -d ln P / dT."""
    a, sig, r0, T_end = cfg["a"], cfg["sigma"], cfg["r0"], cfg["t_final"]
    th = cfg["theta"]
    Ts = np.linspace(0.0, T_end, cfg["n_mat"])
    P, f = np.empty_like(Ts), np.empty_like(Ts)
    for k, T in enumerate(Ts):
        B = (1.0 - math.exp(-a * T)) / a
        mean_i = r0 * B + (_int_theta(th, 0.0, T)
                           - _int_theta_exp(a, th, 0.0, T, T)) / a
        var_i = sig * sig / (a * a) * (T - 2.0 * B + (1.0 - math.exp(
            -2.0 * a * T)) / (2.0 * a))
        P[k] = math.exp(-mean_i + 0.5 * var_i)
        f[k] = (r0 * math.exp(-a * T) + _int_theta_exp(a, th, 0.0, T, T)
                - 0.5 * sig * sig * B * B)
    return P, f


class Model:
    """The configuration's float64 step tables."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.a, self.sigma, self.r0 = cfg["a"], cfg["sigma"], cfg["r0"]
        self.n_steps, self.n_mat = cfg["n_steps"], cfg["n_mat"]
        self.dt = cfg["t_final"] / self.n_steps
        self.E = math.exp(-self.a * self.dt)
        self.sig_st = self.sigma * math.sqrt(
            (1.0 - math.exp(-2.0 * self.a * self.dt)) / (2.0 * self.a))
        self.stride = self.n_steps // (self.n_mat - 1)
        self.n1 = int(round(cfg["s1"] / self.dt))

    def drift(self):
        """int over each step of e^{-a (t - u)} theta(u) du, and its
        derivative in sigma at sigma0 = sigma: sigma psi."""
        a, dt = self.a, self.dt
        d = np.array([_int_theta_exp(a, self.cfg["theta"], i * dt,
                                     (i + 1) * dt, (i + 1) * dt)
                      for i in range(self.n_steps)])
        s = np.arange(self.n_steps) * dt
        t = s + dt
        psi = (1.0 + np.exp(-2.0 * a * t) - self.E - np.exp(-a * (t + s))) / (
            a * a)
        return d, self.sigma * psi

    def det_path(self, n: int):
        """(r, I, dr/dsigma, dI/dsigma) of the G = 0 path after n steps, and
        I after every step."""
        d, ds = self.drift()
        r, i_r, dr, di = self.r0, 0.0, 0.0, 0.0
        integrals = np.empty(n)
        for k in range(n):
            r_next = r * self.E + d[k]
            i_r += 0.5 * (r + r_next) * self.dt
            dr_next = dr * self.E + ds[k]
            di += 0.5 * (dr + dr_next) * self.dt
            r, dr = r_next, dr_next
            integrals[k] = i_r
        return (r, i_r, dr, di), integrals

    def w_of(self, m: np.ndarray) -> np.ndarray:
        """dI_n / dG_i / sig_st for m = n - 1 - i steps after the shock."""
        Em = self.E ** m
        return self.dt * ((1.0 - Em) / (1.0 - self.E) + 0.5 * Em)

    def curve_shape(self) -> np.ndarray:
        """(n_steps, n_mat) dI(T_m) / dG_i / sig_st."""
        i = np.arange(self.n_steps, dtype=np.float64)[:, None]
        n = (np.arange(self.n_mat) * self.stride)[None, :]
        return np.where(i < n, self.w_of(np.maximum(n - 1 - i, 0)), 0.0)

    def option_shapes(self):
        """(u, w) = (dr(S1), dI(S1)) / dG_i / sig_st over the n1 steps."""
        m = (self.n1 - 1) - np.arange(self.n1, dtype=np.float64)
        return self.E ** m, self.w_of(m)

    def curve_det(self) -> np.ndarray:
        """(n_mat,) deterministic I(T_m), I(T_0) = 0."""
        integrals = self.det_path(self.n_steps)[1]
        return np.concatenate([[0.0], integrals[self.stride - 1::self.stride]])

    def option_consts(self, P: np.ndarray, f: np.ndarray) -> dict:
        """Deterministic state at S1, the bond factors and the strike."""
        cfg, a, sig = self.cfg, self.a, self.sigma
        s1, s2 = cfg["s1"], cfg["s2"]
        Ts = np.linspace(0.0, cfg["t_final"], self.n_mat)
        P0 = lambda T: float(np.interp(T, Ts, P))  # noqa: E731
        B = (1.0 - math.exp(-a * (s2 - s1))) / a
        f0 = float(np.interp(s1, Ts, f))
        conv = sig * sig / (4.0 * a) * (1.0 - math.exp(-2.0 * a * s1)) * B * B
        (c_r, c_i, c_dr, c_di), _ = self.det_path(self.n1)
        u, w = self.option_shapes()
        l11 = math.sqrt(u @ u)
        l21 = (u @ w) / l11
        l22 = math.sqrt(w @ w - l21 * l21)
        return {"c_r": c_r, "c_i": c_i, "c_dr": c_dr, "c_di": c_di,
                "A": P0(s2) / P0(s1) * math.exp(B * f0 - conv), "B": B,
                "K": cfg["strike"], "P0S2": float(P[-1]), "sigma": sig,
                "q": sig / (2.0 * a) * (1.0 - math.exp(-2.0 * a * s1)) * B,
                "l": (self.sig_st * l11, self.sig_st * l21,
                      self.sig_st * l22)}


def mix_signs(n: int) -> np.ndarray:
    """The full-step mix's +/-1 scramble of n step rows."""
    return np.random.default_rng(MIX_D_SEED).choice([-1.0, 1.0], n)


def hadamard() -> np.ndarray:
    H = np.array([[1.0]])
    while H.shape[0] < MIX_BLOCK:
        H = np.block([[H, H], [H, -H]])
    return H * MIX_Q0


def premix(shape: np.ndarray, sig_st: float) -> np.ndarray:
    """(nb * 128, cols) weights of raws: per 128-step block q,
    sig_st W_SCALE (H q0) (D_q shape_q), the shape zero-padded in steps."""
    nb = -(-shape.shape[0] // MIX_BLOCK)
    S = np.zeros((nb * MIX_BLOCK, shape.shape[1]))
    S[:shape.shape[0]] = shape
    S *= mix_signs(nb * MIX_BLOCK)[:, None]
    H = hadamard()
    out = np.concatenate([H @ S[q * MIX_BLOCK:(q + 1) * MIX_BLOCK]
                          for q in range(nb)])
    return out * (sig_st * MIX_W_SCALE)


# ---------------------------------------------------------------------------
# Products: the kernels' outputs of one request
# ---------------------------------------------------------------------------

def _tile_blocks(n_tiles: int, words_per_tile: int):
    per = max(1, BLOCK_WORDS // words_per_tile)
    for first in range(0, n_tiles, per):
        yield first, min(per, n_tiles - first)


def curve_exact(cfg: dict, words: tuple, n_pairs: int,
                device) -> np.ndarray:
    """(n_mat,) [count, per-maturity discount sums over both legs]."""
    m = Model(cfg)
    k = m.n_mat - 1
    Ws = m.curve_shape()[:, 1:]
    L = np.linalg.cholesky(Ws.T @ Ws).T * m.sig_st        # (k, k) upper
    W = torch.as_tensor(L, device=device)
    c = torch.as_tensor(m.curve_det()[1:], device=device)
    n_tiles = n_pairs // (2 * CURVE_ROWS)
    seed0, seed1 = tile_seeds(words, "curve")
    idx = torch.arange(CURVE_ROWS * PAD, dtype=torch.int64,
                       device=device).reshape(CURVE_ROWS, PAD)[:, :k]
    acc = torch.zeros(k, dtype=torch.float64, device=device)
    for first, n in _tile_blocks(n_tiles, CURVE_ROWS * k):
        z0, z1 = box_muller(tile_s0(seed0, first, n, device), seed1, idx)
        X = torch.cat([z0, z1], dim=1).reshape(-1, k)
        e = torch.exp(-(X @ W))
        acc += (e + torch.reciprocal(e)).sum(0)
    sums = acc * torch.exp(-c)
    return np.concatenate([[2.0 * n_pairs], sums.cpu().numpy()])


def _zbc_terms(k: dict, z_r, z_i):
    P_base = k["A"] * math.exp(-k["B"] * k["c_r"])
    d_base = math.exp(-k["c_i"])
    out = []
    for sgn in (1.0, -1.0):
        P = P_base * torch.exp(-k["B"] * sgn * z_r)
        disc = d_base * torch.exp(-sgn * z_i)
        x = disc * torch.clamp(P - k["K"], min=0.0)
        y = disc * P - k["P0S2"]
        out.append((x, y))
    (xa, ya), (xb, yb) = out
    return [xa + xb, ya + yb, xa * xa + xb * xb, ya * ya + yb * yb,
            xa * ya + xb * yb]


def _vega_terms(k: dict, z_r, z_i):
    r, i_r = k["c_r"] + z_r, k["c_i"] + z_i
    dr, di = k["c_dr"] + z_r / k["sigma"], k["c_di"] + z_i / k["sigma"]
    P = k["A"] * torch.exp(-k["B"] * r)
    disc = torch.exp(-i_r)
    dP = -P * k["B"] * (k["q"] + dr)
    return [torch.where(P > k["K"], dP * disc, torch.zeros_like(P))
            - di * disc * torch.clamp(P - k["K"], min=0.0)]


def _option_sums(terms, k: dict, states) -> np.ndarray:
    acc = None
    for z_r, z_i in states:
        s = torch.stack([t.sum() for t in terms(k, z_r, z_i)])
        acc = s if acc is None else acc + s
    return acc.cpu().numpy()


def _exact_states(words, kind, n_pairs, k, device):
    n_tiles = n_pairs // (OPTION_ROWS * PAD)
    seed0, seed1 = tile_seeds(words, kind)
    idx = torch.arange(OPTION_ROWS * PAD, dtype=torch.int64,
                       device=device).reshape(OPTION_ROWS, PAD)
    l11, l21, l22 = k["l"]
    for first, n in _tile_blocks(n_tiles, OPTION_ROWS * PAD):
        x1, x2 = box_muller(tile_s0(seed0, first, n, device), seed1, idx)
        yield l11 * x1, l21 * x1 + l22 * x2


def zbc_exact(words: tuple, n_pairs: int, consts: dict,
              device) -> np.ndarray:
    """(6,) [sum X, sum Yc, sum X^2, sum Yc^2, sum X Yc, count], both legs."""
    s = _option_sums(_zbc_terms, consts,
                     _exact_states(words, "zbc", n_pairs, consts, device))
    return np.concatenate([s, [2.0 * n_pairs]])


def vega_exact(words: tuple, n_pairs: int, consts: dict,
               device) -> np.ndarray:
    """(2,) [sum of pathwise vega terms, count], one leg."""
    s = _option_sums(_vega_terms, consts,
                     _exact_states(words, "vega", n_pairs, consts, device))
    return np.concatenate([s, [1.0 * n_pairs]])


def curve_full(cfg: dict, words: tuple, n_pairs: int, device) -> np.ndarray:
    """(n_mat,) [count, per-maturity discount sums over both legs] of the
    full-step tier: z = sum over 128-step blocks of raws @ premixed
    weights."""
    m = Model(cfg)
    Wp = torch.as_tensor(premix(m.curve_shape(), m.sig_st), device=device)
    nb = Wp.shape[0] // MIX_BLOCK
    n_tiles = n_pairs // FULL_CURVE_PATHS
    seed0, seed1 = tile_seeds(words, "curve")
    idx = torch.arange(FULL_CURVE_PATHS // 2 * MIX_BLOCK, dtype=torch.int64,
                       device=device).reshape(FULL_CURVE_PATHS // 2, MIX_BLOCK)
    acc = torch.zeros(m.n_mat, dtype=torch.float64, device=device)
    for first, n in _tile_blocks(n_tiles, FULL_CURVE_PATHS // 2 * MIX_BLOCK):
        s0 = tile_s0(seed0, first, n, device)
        z = torch.zeros(n, FULL_CURVE_PATHS, m.n_mat, dtype=torch.float64,
                        device=device)
        for q in range(nb):
            z += raws(s0, seed1, idx, q) @ Wp[q * MIX_BLOCK:(q + 1) * MIX_BLOCK]
        t = torch.exp(-z)
        acc += (t + torch.reciprocal(t)).sum((0, 1))
    sums = (acc * torch.exp(-torch.as_tensor(m.curve_det(),
                                             device=device))).cpu().numpy()
    sums[0] = 2.0 * n_pairs
    return sums


def _full_states(cfg, words, kind, n_pairs, device):
    m = Model(cfg)
    u, w = m.option_shapes()
    Wp = torch.as_tensor(premix(np.stack([u, w], 1), m.sig_st).T.copy(),
                         device=device)                   # (2, nb * 128)
    nb = Wp.shape[1] // MIX_BLOCK
    n_tiles = n_pairs // FULL_OPTION_PATHS
    seed0, seed1 = tile_seeds(words, kind)
    idx = torch.arange(MIX_BLOCK // 2 * FULL_OPTION_PATHS, dtype=torch.int64,
                       device=device).reshape(MIX_BLOCK // 2,
                                              FULL_OPTION_PATHS)
    for first, n in _tile_blocks(n_tiles, MIX_BLOCK // 2 * FULL_OPTION_PATHS):
        s0 = tile_s0(seed0, first, n, device)
        z = torch.zeros(n, 2, FULL_OPTION_PATHS, dtype=torch.float64,
                        device=device)
        for q in range(nb):
            z += Wp[:, q * MIX_BLOCK:(q + 1) * MIX_BLOCK] @ raws(
                s0, seed1, idx, q)
        yield z[:, 0], z[:, 1]


def zbc_full(cfg: dict, words: tuple, n_pairs: int, consts: dict,
             device) -> np.ndarray:
    s = _option_sums(_zbc_terms, consts,
                     _full_states(cfg, words, "zbc", n_pairs, device))
    return np.concatenate([s, [2.0 * n_pairs]])


def vega_full(cfg: dict, words: tuple, n_pairs: int, consts: dict,
              device) -> np.ndarray:
    s = _option_sums(_vega_terms, consts,
                     _full_states(cfg, words, "vega", n_pairs, device))
    return np.concatenate([s, [1.0 * n_pairs]])


# ---------------------------------------------------------------------------
# The finish: curve, control-variate price and beta, vega
# ---------------------------------------------------------------------------

def cv_finish(moments: np.ndarray) -> dict:
    sx, sy, sxx, syy, sxy, n = (float(v) for v in moments)
    mx, my = sx / n, sy / n
    var_y = syy / n - my * my
    var_x = sxx / n - mx * mx
    beta = (sxy / n - mx * my) / var_y
    return {"price": mx - beta * my, "beta": beta, "var_x": var_x}
