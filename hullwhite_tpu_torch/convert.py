"""Carry state across from the JAX package, given as numpy arrays.

The port never imports JAX; a caller that holds JAX values (a test, a
migration script) converts them with ``np.asarray`` and hands them here.
Each function returns the port's own container on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import HWConfig
from .kernels.fused import (PAD, CurveFullPrepared, CurvePrepared,
                            GridPrepared, OptionFullPrepared, OptionPrepared,
                            curve_exact_operands, curve_full_operands,
                            grid_bs)
from .models.hull_white import MarketCurve
from .ops.rng import Key


def market_curve(P, f, *, device) -> MarketCurve:
    """``hull_white.MarketCurve`` from its P and f arrays."""
    return MarketCurve(P=torch.as_tensor(np.array(P, np.float32), device=device),
                       f=torch.as_tensor(np.array(f, np.float32), device=device))


def curve_prepared(prepared, *, device) -> CurvePrepared:
    """``fused.curve_prepared(..., exact=True)`` output (W (PAD, PAD),
    c_pad (1, PAD)) as the exact curve kernel's operands, with the kernel's
    split of W and chunk masks built from it
    (``fused.curve_exact_operands``)."""
    W, c_pad = (np.array(a, np.float32) for a in prepared)  # owned copies
    if W.shape != (PAD, PAD) or c_pad.shape != (1, PAD):
        raise ValueError("expected W (128, 128) and c (1, 128)")
    W = torch.as_tensor(W)
    w_split, live = curve_exact_operands(W)
    return CurvePrepared(W.to(device),
                         torch.as_tensor(c_pad[0], device=device),
                         w_split.to(device), live)


def option_prepared(prepared, *, device) -> OptionPrepared:
    """``fused.option_prepared(..., exact=True)`` output ((13,) consts,) as
    the option kernels' operands."""
    (consts,) = prepared
    consts = np.array(consts, np.float32)  # an owned, writable copy
    if consts.shape != (13,):
        raise ValueError("expected the 13 exact-kernel consts")
    return OptionPrepared(consts=consts, device=torch.device(device))


def delta_prepared(prepared, *, device) -> OptionPrepared:
    """``fused.option_prepared(..., exact=True, kind="delta",
    extra_consts=(dr_dr0, di_dr0))`` output ((15,) consts,) as the delta
    kernel's operands."""
    (consts,) = prepared
    consts = np.array(consts, np.float32)
    if consts.shape != (15,):
        raise ValueError("expected the 15 delta-kernel consts")
    return OptionPrepared(consts=consts, device=torch.device(device))


def grid_prepared(cfg: HWConfig, consts, Ks, S2s, *, device) -> GridPrepared:
    """The consts of ``fused.grid_local_fn`` ([c_r, c_I, l11, l21, l22,
    A_j.., P0_j..]) and its strikes and maturities as the surface kernel's
    operands; B_j is rebuilt from ``S2s`` in fp64 as the JAX kernel bakes
    it in."""
    consts = np.array(consts, np.float32)
    if consts.shape != (5 + 2 * len(S2s),):
        raise ValueError("expected 5 + 2 nS2 surface consts")
    return GridPrepared(consts=consts, Bs=grid_bs(cfg, S2s),
                        Ks=np.array([float(k) for k in Ks], np.float32),
                        device=torch.device(device))


def curve_full_prepared(prepared, *, device) -> CurveFullPrepared:
    """``fused.curve_prepared(..., exact=False)`` output (W (nb * 128, PAD),
    exp_c (PAD,)) as the full-step curve kernel's operands, with the
    kernel's split of W and live mask built from it
    (``fused.curve_full_operands``)."""
    W, exp_c = (np.array(a, np.float32) for a in prepared)  # owned copies
    if W.ndim != 2 or W.shape[1] != PAD or W.shape[0] % 128 or \
            exp_c.shape != (PAD,):
        raise ValueError("expected W (nb * 128, 128) and exp_c (128,)")
    W = torch.as_tensor(W)
    return CurveFullPrepared(
        W.to(device), torch.as_tensor(exp_c, device=device),
        *(a.to(device) for a in curve_full_operands(W)))


def option_full_prepared(prepared, *, device) -> OptionFullPrepared:
    """``fused.option_prepared(..., exact=False)`` output (W (8, nb * 128),
    (10,) consts) as the full-step option kernels' operands."""
    W, consts = (np.array(a, np.float32) for a in prepared)
    if W.ndim != 2 or W.shape[0] != 8 or W.shape[1] % 128 or \
            consts.shape != (10,):
        raise ValueError("expected W (8, nb * 128) and the 10 consts")
    return OptionFullPrepared(W=torch.as_tensor(W, device=device),
                              consts=consts)


def key(key_data) -> Key:
    """``Key`` from ``jax.random.key_data(key)`` (two uint32 words)."""
    words = np.asarray(key_data, np.uint32).reshape(-1)
    if words.shape != (2,):
        raise ValueError("expected a threefry key's two words")
    return Key(words=(int(words[0]), int(words[1])))
