#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``hullwhite_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. setup: the card's name and power limit, the kernels' build from
   ``hullwhite_tpu_torch/csrc`` (nvcc, sm_90a, one process per source),
   TF32 off;
1. each hand-written kernel against its plain PyTorch version on the card,
   with stated tolerances, at a few tiles and at the full main-path shape
   (2^20 pairs, the curve kernels in both precisions; the surface kernel
   at the CLI's 5 x 5 surface; the full-step unit walls' lanes bit for
   bit, their checksums within a tolerance below one word's share where
   fp32 can resolve one; the exact tier's walls per lane, the Box-Muller wall at 8 tiles and 2^20 pairs,
   the exp and reciprocal walls at 1 tile, 2^20 and 2^24 pairs, their
   checksums within a float32 summation bound, ``compare_exact_wall``;
   the exact ZBC, vega and delta kernels, the surface kernel and the
   option normals kernel also at odd tile counts, 1, 3 and 33, and at
   2^24 pairs, each check run twice and bitwise equal; the surface kernel
   also at 16 x 16 and 1 x 1 on 3 tiles);
   then at the timed shape (2^20 pairs; the exp and reciprocal walls at
   2^24, as the roofline times them) each kernel's device time (with its
   reduce pass; the curve kernels' in both precisions) and its
   plain version's wall time per call;
2. both main paths at full width (HWConfig(): 2^20 pairs, 1000 steps, 101
   maturities) through the CLI a user runs, q1, q2 --validate 5,
   q3 --validate 5 and grid, first with ``--engine fused_exact`` (exact
   sampling), then with ``--engine fused`` (full step; its surface runs on
   the exact tier's surface kernel, as in the JAX package); after each,
   its deterministic gate (exact: the option kernel's own normals through
   the exact engine; full step: the option kernel's own shocks through
   the linear engine) and the results against the published reference
   values and the fp64 oracles, every surface cell within 6 SE + 2e-4 of
   the closed form on the q1 curve;
   then the delta/gamma path at full width on the fp64 oracle curve
   (``pricing.pathwise_delta``, ``greeks.gamma_zbc``) against the closed
   forms, and two deterministic gates at 2^20 pairs: the delta kernel's
   and the surface kernel's own normals through the exact engine
   (``payoffs.delta_sum``, ``grid._grid_moments``);
   then ``cli benchmark --roofline`` at full width, as a user runs it:
   both JSON files (full step and exact tier), every fraction finite and
   > 0 where its count is, no exact-tier fraction of a wall and no
   full-step fraction of the tensor peak above 1.02, the full-step tier
   times and the exact Q1 time within 5% of phase 1's;
3. the launch counters: each path's kernels ran in that path's run
   (counts reset just before it and read just after it: the CLI run of
   each engine, the delta/gamma step, the roofline run), and the
   generator's check kernel option_normals ran in its own phase-1 window;
4. determinism: two ZBC prices, two curves, two deltas and two surfaces
   under one key are bitwise equal (prices and curves in both engines);
5. the XLA engine tier (``linear``, ``exact``, ``scan``: plain PyTorch on
   the card over threefry block normals, no hand-written kernel): the
   generator on the card against the CPU at one full (2^15, 1000) block
   (bits bitwise, normals within 4 ulps) and its device time per block;
   scan against linear on one G, and linear's float32 products against
   float64 (the gate that shows TF32); ``cli all --reps 1`` and ``cli
   grid`` at full width per engine, held to phase 2's gates, the AD vega
   within 3% of the pathwise one, every vega-surface cell within
   test_grid.py's bound of the closed form, and no kernel launched outside
   the engine table that ``all`` ends with (its fused tiers launch theirs);
   the first ``cli all``'s engine table with its price-consistency PASS;
   ZBC and vega reruns bitwise on linear and exact; each engine's
   time per Q1, Q2b and Q3 call, the generator's share of it and the
   phase's peak device memory, beside the card's name and power limit;
6. RQMC and the European coupon-bond options / swaptions (plain PyTorch,
   no hand-written kernel on their calls) at full width: ``cli q1``, ``cli
   q2 --qmc 65536`` and ``cli q3 --qmc 65536`` (2^16 points x 8 shifts;
   the MC parts on the fused_exact kernels): the RQMC ZBC within 5 SE +
   5e-5 and the RQMC vega within 5 SE + 1e-3 of the fp64 oracles on the
   q1 curve, the RQMC SE at least 10x below the MC SE q2 prints; on the
   fp64 oracle curve, as tests/test_instruments.py prices them, ``cli
   swaption --tenor 4`` receiver and payer (MC on ``exact`` at 2^20
   pairs): MC within 5 SE + 2e-4 and RQMC within 6 SE + 5e-5 (SE < 5e-5)
   of Jamshidian, receiver - payer within 5e-4 of the forward swap value,
   the MC bitwise on a rerun; ``vega_swaption`` within 3% + 5e-4 of a CRN
   central difference; ``bootstrap_curve_qmc`` (101 maturities, 2^16 x 8,
   n_qmc 32) within 5 SE + 3e-5 of the fp64 oracle at every maturity; the
   Sobol points on the card bitwise the CPU's, the RQMC ZBC and swaption
   price within 2e-7 of the CPU's, reruns bitwise; no kernel launched by
   the swaption runs and the checks; then, per call at 2^16 and 2^20
   points, the median and range of five interleaved wall times, the host
   ms until the call returns, the device-busy ms and the device
   operations, and the phase's peak device memory, beside the card's
   name and power limit;
7. the Bermudan swaption and the multi-date instruments (plain PyTorch on
   the card, no hand-written kernel; the DP oracle in host float64 and
   the C++ sweep built at first use) at full width on a ``cli q1 --engine
   exact`` curve: ``cli swaption --bermudan --delta`` receiver (with
   ``--bermudan-sweep``) and payer, tenor 5, 2^20 paths, five annual
   exercises: the martingale-CV lower bound within 5 CV-SE + 1e-6 of the
   DP oracle, the upper bound >= DP - (4 SE + 1e-6), CV <= upper + 4 (sum
   of the SEs), the CV SE >= 20x below the raw LSMC SE, the dual curve
   delta within 2e-3 relative of the oracle's FD and the lower's within
   3e-2; the sweep (k = 1..5): the DP rising with k, both ends of every
   bracket within 5 SE + 1e-6 of its DP, k = 1 within 5 SE + 2e-4 of
   Jamshidian; ``cli cap`` and ``cli cms`` exit 0 on their agreement
   lines, the cap's CRN-FD vega within 1% + 1e-3 of the closed form's
   FD; ``price_cms_spread`` and ``price_range_accrual`` at 2^20 paths
   within 5 SE + 2e-4 of their oracles; at bench.py's setting (2^17 x 8
   blocks, k = 5) ``bermudan_vega`` jvp against fd (upper within 1e-3,
   lower 5e-2) and the RQMC bracket around the DP within 5 SE + 1e-6;
   ``price_bermudan`` at 2^14 paths, k = 3, card vs CPU (prices 1e-6,
   SEs 1% relative); reruns bitwise; no kernel launched; per call
   (``price_bermudan`` at 2^17 x 8 and 2^20 x 1, ``bermudan_vega`` jvp,
   ``dp_oracle`` host wall only, ``price_cap`` and ``price_cms`` at 2^20)
   the median and range of two wall times after a warm call, the host
   ms, the device-busy ms and device operations, and the phase's peak
   device memory, beside the card's name and power limit;
8. calibration and the European half of G2++ (plain PyTorch on the card,
   no hand-written kernel; the closed forms and the calibrations in host
   float64) at full width on the fp64 oracle curve written as the q1
   market: ``cli calibrate`` (Hull-White a within 1e-4 and sigma within
   1e-5, G2++ sigma and eta within 1e-5 and rho within 1e-3 of the truth),
   ``cli g2pp --validate 5`` under its own gate (curve, ZBC, CRN-FD and
   RQMC vegas), its swaptions' MC within 5 SE + 2e-4 and RQMC within
   6 SE + 5e-5 of the conditional-decomposition oracle; ``cli grid
   --engine exact``: every G2++ surface cell within 6 SE + 2e-4 of the
   closed form and every vega-surface cell within 6 SE + 5e-5 of the
   closed-form FD; ``cli cms --g2`` under its z-gate; ``price_zbc_g2``,
   ``price_swaption_g2_qmc`` and ``bootstrap_curve_g2`` on the card
   against the CPU (``G2_CARD_CPU_TOL``); ``price_zbc_g2`` reruns bitwise;
   no kernel launched; per call (the ZBC, swaption, surface and CMS at
   2^20 paths, the curve at 2^18, the RQMC ZBC and its vega at 2^16 x 8,
   ``calibrate_g2`` on the host) the median and range of five wall
   times, the host ms, the device-busy ms and device operations, and the
   phase's peak device memory, beside the card's name and power limit;
9. the G2++ Bermudan and the backward-looking RFR caps (plain PyTorch on
   the card, no hand-written kernel; the DP oracle and the closed forms in
   host float64) at full width on the fp64 oracle curve written as the q1
   market: ``cli g2pp`` with its Bermudan at the CLI defaults (2^20 paths,
   five annual exercises of the 5-year 2.5% receiver), ``cli rfr --g2``
   [``--averaged`` | ``--rqmc``]: every cap and floor, HW and G2++, within
   5 SE + 1e-6 of its closed form, the jvp vega within 1% of the closed
   form's FD; ``price_bermudan_g2`` at k = 3 and k = 5 (2^20 paths): the
   CV lower at most the DP oracle (241 x 64 grid) + 4 SE + 3.4e-6, the
   upper at least the oracle - 4 SE - 3.4e-6, the CV SE >= 10x below the
   raw, the k = 5 call on cli g2pp's key equal to the CLI's bracket;
   ``vega_bermudan_g2`` (k = 1) and ``delta_bermudan_g2`` (k = 3) at 2^17
   paths against the European oracle's and the DP oracle's FD; the
   Bermudan (k = 2, 2^12 paths) and two RFR caps on the card against the
   CPU (``G2B_CARD_CPU_TOL``); the k = 5 Bermudan reruns bitwise; no
   kernel launched; per call (the Bermudan at k = 3 and 5, the DP oracle
   on the host, the RFR caps at 2^20, the RQMC cap at 2^17 x 8) the
   median and range of the wall times, the host ms, the device-busy ms
   and device operations, and the phase's peak device memory, beside the
   card's name and power limit;
10. the Hull-White note layer (plain PyTorch on the card, no hand-written
   kernel; the DP oracles in host float64) at full width on a ``cli q1
   --engine exact`` curve: ``cli notes``, both halves, with its six
   agreement lines PASS (the snowball, the callable snowball, the
   callable capped floater, Hull-White then G2++), nothing named as not
   ported and the ``*_g2`` keys written; its three G2++ DP oracles are
   patched in-process to a small grid (``G2_CLI_GRID``: at the command's
   defaults they take ~13 minutes of host time), the MC runs at 2^20
   paths either way; ``price_range_note`` under the DP boundary and
   ``price_tarn`` (m = 1) at 2^20 paths within 4 SE or 2e-4 of their DP
   oracles;
   ``vega_range_note`` at 2^16 within 3 SE (16 replicates) of the DP's
   central difference; ``price_snowball(rqmc=True)`` at 2^16 x 8 within
   5 SE + 1e-6 of the DP with an SE below the MC's; the five price_*
   calls at 2^14 on the card against the CPU (0.1 SE); reruns bitwise;
   no kernel launched; per price_* call at 2^20 the median and range of
   the wall times, the host ms, the device-busy ms and device operations,
   each DP oracle's host wall, and the phase's peak device memory, beside
   the card's name and power limit;
11. the G2++ note layer (``g2_note``: plain PyTorch on the card, no
   hand-written kernel; the (u, w[, c]) DP oracles in host float64 on the
   grids of ``G2_DP_GRIDS``, the snowball's at its default, ~3 minutes of
   host time that dominate the phase) at full width on phase 10's curve with
   G2Params(): ``price_range_note_g2`` under its DP curves,
   ``price_tarn_g2``, ``price_capped_floater_g2`` and
   ``price_snowball_g2`` at 2^20 paths within 4 SE or 2e-4 of their DP
   oracles, ``price_callable_snowball_g2`` within 5e-4 of its DP;
   ``vega_range_note_g2`` at 2^16 within 3 SE (16 replicates) of the DP's
   central difference; ``price_snowball_g2(rqmc=True)`` at 2^16 x 8
   within 5 SE + 1e-6 of the DP with an SE below the MC's; the five
   price_*_g2 calls at 2^14 on the card against the CPU (0.1 SE); reruns
   bitwise; no kernel launched; per price_*_g2 call at 2^20 the median and
   range of the wall times, the host ms, the device-busy ms and device
   operations, each DP oracle's host wall, and the phase's peak device
   memory and wall, beside the card's name and power limit.
12. the exotics layer (``ratchet``, ``barrier``, ``chooser``: plain
   PyTorch on the card, no hand-written kernel; host float64 oracles) on
   phase 10's curve: ``cli exotics`` at full width (2^20 paths; its four
   G2++ DPs on ``G2_SMALL_GRID``, as phase 10's ``cli notes``, the
   Hull-White ones at the command's grids) with its 15 agreement lines
   PASS (the CMS
   spread, the range accrual and its G2++ twin, the puttable note, the
   TARN and their G2++ twins, the chooser cap and the auto-cap under
   both models, the G2++ chooser at 2^17 paths within 2.5e-4 of its DP,
   the ratchet cap and the up-and-out cap under both models) and the JAX
   command's sections written; each oracle's host wall (the G2++ DPs on
   ``G2_SMALL_GRID``); the nine new price_* calls (the ratchet plain,
   RQMC at 2^17 x 8 and G2++, the knock-out cap under both models, the
   chooser and the auto-cap under both models) at 2^14 on the card
   against the CPU (0.1 SE); reruns bitwise; no kernel launched; per
   call at 2^20 the median and range of the wall times, the host ms, the
   device-busy ms and device operations, and the phase's peak device
   memory and wall, beside the card's name and power limit.
13. the Hull-White XVA layer (``credit``, ``xva``: plain PyTorch on the
   card, no hand-written kernel; host float64 oracles) on phase 10's
   curve: ``cli xva --netting --csa --bilateral --wwr --mva --kva --cds``
   at full width (2^20 paths x 4 blocks) with its "validation:" line
   PASS, no CHECK, the CS01 line "[agree]" and the JAX command's sections
   written; each oracle's host wall; the XVA product x @ LT against
   float64 with TF32 off (and the same product on TF32-rounded operands
   past the gate's bound); the nine new estimators (``price_exposure``
   plain and RQMC, ``vega_cva``, ``price_netting``, ``price_collateral``,
   ``price_bilateral``, ``price_wwr``, ``price_mva``, ``price_kva``) at
   2^14 x 4 on the card against the CPU (0.1 SE); reruns bitwise; no
   kernel launched; per call at 2^20 x 4 the median and range of the
   wall times, the host ms, the device-busy ms and device operations,
   and the phase's peak device memory and wall, beside the card's name
   and power limit.
14. the rest of the XVA layer (the G2++ twins of ``xva``: exposure,
   netting, CSA, bilateral, WWR, MVA, KVA; the Bermudan swaption's
   exposure under Hull-White and G2++; plain PyTorch on the card, no
   hand-written kernel; host float64 oracles) on phase 10's curve: each
   new oracle once at the command's arguments with its host wall; ``cli
   xva --g2 --netting --csa --bilateral --wwr --mva --kva --bermudan`` at
   full width (2^20 paths x 4 blocks, the Hull-White Bermudan oracle at
   3001 nodes) with its "validation:" line PASS (every z-gate, the G2++
   Bermudan's 5 SE + 3e-6), no CHECK, FAIL or "not ported" line, and the
   JAX command's sections written (``"bermudan"``, ``"g2"`` with its
   seven); the G2++ product xn @ LT and the Bermudan product sig_st x @ LT
   against float64 with TF32 off (and on TF32-rounded operands past the
   gate's bound); the ten new estimators (``price_exposure_g2``,
   ``vega_cva_g2``, ``price_netting_g2``, ``price_collateral_g2``,
   ``price_bilateral_g2``, ``price_wwr_g2``, ``price_mva_g2``,
   ``price_kva_g2``, ``price_bermudan_xva``, ``price_bermudan_xva_g2``) at
   2^14 x 4 on the card against the CPU (0.1 SE); reruns bitwise; no
   kernel launched; per call at 2^20 x 4 the median and range of the wall
   times, the host ms, the device-busy ms and device operations, and the
   phase's peak device memory and wall, beside the card's name and power
   limit.
15. the path mesh (``parallel/``: ranks of ``torch.distributed`` started
   by ``parallel.launch``) and ``cli pipeline``: each fused kernel a rank
   launches (the exact curve, ZBC, vega and surface kernels, the
   full-step curve, ZBC and vega kernels) at 2^16 pairs from a non-zero
   base tile (rank 1's first tile of a 2-rank 2^24-pair sweep) against
   its plain version at the same base tile, and unequal to its base-0
   run; a 1-rank NCCL group running ``bootstrap_curve``, ``price_zbc``
   and ``pathwise_vega`` through the mesh at full width, bitwise equal
   to the meshless calls; ``cli q1``, then ``cli pipeline`` at full width
   (both calibrations recovered, every gate PASS, the artifact's keys
   the JAX command's); ``cli sweep`` at 2^24 pairs with ``--mesh 1``
   (NCCL) and ``--mesh 2`` (two gloo ranks on the card), P(0,10), the
   ZBC, the vega and the surface's middle cell within the JAX package's
   sharded-vs-single tolerances of each other, the times per call of the
   slowest rank beside the card's name and power limit; the sweep's
   kernel launches, counted by its ranks, join the ``kernels`` line as
   its own path.
16. the mesh's second slice: the certificate ``parallel.dryrun`` (the
   JAX package's ``dryrun_multichip``, 51 checks: every product priced
   through a 2-rank mesh and without it in each rank, within 1e-6, the
   Bermudans 2e-6; the ``fused_exact`` ZBC from each rank's base tile,
   whose ``zbc_exact`` launches join that kernel's count) on two gloo
   ranks on the card, then its companion (the core trio and the uneven
   blocks' rejection) on four; then at full width (``HWConfig()``) the
   ``price_*`` functions of the note, exotic and XVA modules and
   ``cva_cs01`` (the certificate's hand-set policies; 2^20 paths a block,
   two blocks for the notes and exotics, four for XVA) through a 2-rank
   mesh against the same call without it in the rank, every number
   within 1e-6 (bit for bit where the block loop is ``map_blocks``),
   with the ms per call with one rank and with two.
17. (run right after phase 0: after phase 1's kernel work the kernel
   timestamps the profiler reads no longer match the host's clock, and a
   trace loses its kernels) the CUDA kernel analysis
   (``utils/profile.py``) at full width: for
   ``--engine fused_exact`` and ``--engine fused`` the vega step's report
   (registers equal to the kept ptxas log's, no spill, at least one CTA
   an SM, the limiting unit ``kernel_bounds``' bound unit, beside the
   card's name and power limit) and every row of the launch datasheet
   (the launch as the C entry's attribute query reports it: threads and
   shared bytes within the kernel's and the card's per-block limits, at
   least one CTA an SM); ``cli q3 --profile
   --trace DIR`` against ``cli q3`` on the same key (the same results,
   the report before the timed loop, the trace's kernel events as many
   as the launch counters moved in the traced call); ``cli all --profile
   --reps 1`` (q1-q3 held to phase 2's gates, the engine table's price
   consistency PASS with its fused tiers, the exact trio's and the
   table's full-step ZBC kernel's launches); ``python -m
   hullwhite_tpu_torch.analyze`` on that run's ``data_torch/`` (rc 0,
   every results file's task in the summary, the no-plot line where
   matplotlib is missing).

Then each kernel's bound (``kernels.roofline.kernel_bounds`` at its timed
shape: the function's work, its integer instructions per word and its
fp32 and MUFU instructions per Box-Muller element, exp and reciprocal those
of the unit walls in this build's SASS, at this card's SMs and maximum SM
clock), which its phase-1 time must not beat, and, as a diagnostic, the
pipe mix of the curve kernels', the option kernels' and the exact-tier
walls' innermost loops (the exact ZBC, vega and delta kernels' and the
normals kernel's also per element, the surface kernel's per maturity;
each curve kernel must hold tensor-core instructions, the full-step one
no FFMA loop, and no instance of the exact curve, ZBC, vega, delta,
surface or normals kernel may spill: their registers and spills are
printed from the build's ptxas log, kept beside the library).
The last
two lines are a JSON object of
per-kernel numbers and the contract line {"ok": true, "device": {...}}.
Without CUDA the script fails before printing any result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# the exact tier's unit walls; the exp and reciprocal walls are timed at
# the 2^24 pairs of the roofline's option rows (at 2^20 they hold 4 us of
# MUFU work, a launch's overhead)
EXACT_WALLS = ("bm_peak", "exp_peak", "recip_peak")
WALL_PAIRS = 1 << 24
# the kernels that walk units on a persistent grid: the exact option and
# surface kernels, which sum their partials in their last CTA, and the
# option normals kernel, which stores; checked at odd tile counts and at
# 2^24 pairs too, each check run twice (bitwise equal)
WALK_KERNELS = ("zbc_exact", "vega_exact", "delta_exact", "grid_exact",
                "option_normals")
# the surface shapes checked beside the CLI's 5 x 5 (its largest and
# smallest: one kernel instance per strike count), at this many tiles
SURFACE_SHAPES = ((16, 16), (1, 1))
SURFACE_SHAPE_TILES = 3


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, n, k):
    """Device time per call (kernel + its reduce pass), min over k windows,
    each queued behind a sleep kernel (``bench(hold=True)``), so the n
    calls run back to back on the card and host work stays out of it."""
    from hullwhite_tpu_torch.utils.timing import bench

    return bench(fn, device="cuda", n=n, k=k, hold=True)[0] * 1e3


def analytic_market(cfg, device):
    """fp64 oracle curve, as float32 tensors: market data for phase 1 that
    does not come from the kernels under test."""
    import numpy as np
    import torch

    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.models import oracles

    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts], np.float32)
    f = np.asarray(oracles.forward_rate(cfg, Ts), np.float32)
    return hw.MarketCurve(P=torch.as_tensor(P, device=device),
                          f=torch.as_tensor(f, device=device))


def surface_of(rows, n_k=5, n_s2=5):
    """The CV surface of the grid kernel's rows (the CLI's 5 x 5 axes by
    default)."""
    from hullwhite_tpu_torch import grid

    return grid.surface(grid.moments_from_rows(rows, n_k, n_s2), None, None)


def compare_surface(k, p, n_k=5, n_s2=5):
    """The surface kernel's rows against its plain version's: per cell CV
    price within 1e-6 and beta within 1e-4, equal counts."""
    check(float(k[0]) == float(p[0]), f"grid_exact {n_k} x {n_s2} count")
    ek, ep = surface_of(k, n_k, n_s2), surface_of(p, n_k, n_s2)
    d_price = float((ek.price - ep.price).abs().max())
    d_beta = float((ek.beta - ep.beta).abs().max())
    check(d_price <= 1e-6 and d_beta <= 1e-4,
          f"grid_exact {n_k} x {n_s2} disagrees: {d_price:.3e}, "
          f"{d_beta:.3e}")
    return d_price, (f"max cell |dprice| = {d_price:.3e} (tol 1e-6), "
                     f"|dbeta| = {d_beta:.3e} (tol 1e-4), price(K, S2) "
                     f"{float(ek.price[n_k // 2, -1]):.8f}")


def compare(name, k, p):
    """Kernel output ``k`` against its plain version's ``p``: (the error
    reported as max_abs_err, a printable summary); raises when a stated
    tolerance is exceeded."""
    from hullwhite_tpu_torch.ops.payoffs import cv_estimate

    if name == "option_normals":
        err = max(float((k[0] - p[0]).abs().max()),
                  float((k[1] - p[1]).abs().max()))
        check(err <= 2e-6, f"option_normals disagree: {err:.3e}")
        return err, f"max|dx| = {err:.3e} (tol 2e-6)"
    product = name.split("_")[0]  # both tiers hold the same tolerances
    if product == "curve":
        check(float(k[0]) == float(p[0]), f"{name} count")
        rels = (k[1:] - p[1:]) / p[1:]
        rel, mean = float(rels.abs().max()), float(rels.mean())
        dP = float(((k - p) / k[0]).abs().max())  # error of P = sums / count
        check(rel <= 1e-5, f"{name} disagrees: max rel {rel:.3e}")
        return dP, (f"max rel = {rel:.3e} (tol 1e-5), mean signed rel = "
                    f"{mean:.3e}, max|dP| = {dP:.3e}")
    if product == "zbc":
        check(float(k[5]) == float(p[5]), f"{name} count")
        # price and beta do not depend on P(0,S2), which only uncenters
        # the control's mean
        ek, ep = cv_estimate(k, 0.0), cv_estimate(p, 0.0)
        d_price = abs(float(ek.price) - float(ep.price))
        d_beta = abs(float(ek.beta) - float(ep.beta))
        check(d_price <= 1e-6 and d_beta <= 1e-4,
              f"{name} disagrees: {d_price:.3e}, {d_beta:.3e}")
        return d_price, (f"|dprice| = {d_price:.3e} (tol 1e-6), |dbeta| = "
                         f"{d_beta:.3e} (tol 1e-4), price "
                         f"{float(ek.price):.8f}")
    if product == "grid":
        return compare_surface(k, p)
    if product == "delta":
        check(float(k[1]) == float(p[1]), f"{name} count")
        err = abs(float(k[0] / k[1]) - float(p[0] / p[1]))
        check(err <= 1e-6, f"{name} disagrees: {err:.3e}")
        return err, (f"|ddelta| = {err:.3e} (tol 1e-6), delta "
                     f"{float(k[0] / k[1]):.8f}")
    assert product == "vega", name
    check(float(k[1]) == float(p[1]), f"{name} count")
    err = abs(float(k[0] / k[1]) - float(p[0] / p[1]))
    check(err <= 1e-5, f"{name} disagrees: {err:.3e}")
    return err, (f"|dvega| = {err:.3e} (tol 1e-5), vega "
                 f"{float(k[0] / k[1]):.6f}")


def compare_peak(name, k, p):
    """A unit wall against its plain version: the per-lane values (exact
    raw sums, integer digests of the row accumulators) bit for bit, which
    any skipped word fails; the kernel's float32 checksum within
    max(0.01, 2 ulp of its value) of the plain version's exact sum.  A
    word's mean share of the checksum is about 1 (raw: two raws), 0.25
    (draw) and 0.33 (bitops); the tolerance is below it except where the
    total outgrows float32's resolution of one word (bitops at 2^20
    lanes), where the lanes alone see a word."""
    import numpy as np
    import torch

    lanes = torch.equal(k.lanes, p.lanes)
    count = float(k.out[1]) == float(p.out[1])
    got, want = float(k.out[0]), float(p.out[0])
    tol = max(0.01, 2 * float(np.spacing(np.float32(abs(want)))))
    err = abs(got - want)
    check(lanes and count and err <= tol,
          f"{name} disagrees: lanes equal {lanes}, [checksum, lanes] "
          f"{k.out.tolist()} vs {p.out.tolist()} (tol {tol:.3g})")
    return err, (f"{k.lanes.numel()} lanes bit for bit, checksum {got!r} vs "
                 f"exact {want!r}: |d| = {err:.3g} (tol {tol:.3g})")


def compare_exact_wall(name, k, p):
    """An exact-tier wall against its plain version, per lane:
    * recip_peak bit for bit: __frcp_rn and torch's 1/(x + 1) both round to
      nearest, and so does x + 1;
    * exp_peak within 8 ulp of the fixed point x* = 0.567 (8 x 2^-24 =
      4.8e-7): CUDA's expf is within 2 ulp, and the chain contracts by
      |f'(x*)| = 0.567, so a gap settles near 3 ulp / (1 - 0.567);
    * bm_peak within BM_LANE_ROWS x 2 x 2e-6 = 1.28e-4: a lane sums 32
      elements of two normals each, and the kernel's normals equal the
      plain version's to 2e-6 (option_normals); a dropped element moves its
      lane by |z0 + z1|, 1.13 on average.
    The float32 checksum is the fixed-order sum of the kernel's own lanes:
    it must be within 2^-16 x sum |lanes| of their exact sum, a first-order
    bound on the rounding of any summation tree of depth <= 256 (the
    kernel's, with 256-thread blocks, is 26 + n_lanes / 65536 deep at
    most, < 256 at every checked size)."""
    import torch

    from hullwhite_tpu_torch.kernels import fused

    tol = {"bm_peak": fused.BM_LANE_ROWS * 2 * 2e-6,
           "exp_peak": 8 * 2.0 ** -24, "recip_peak": 0.0}[name]
    n = k.lanes.numel()
    count = float(k.out[1]) == float(p.out[1]) == n == p.lanes.numel()
    err = float((k.lanes - p.lanes).abs().max())
    lanes_ok = (torch.equal(k.lanes, p.lanes) if name == "recip_peak"
                else err <= tol)
    lanes64 = k.lanes.to(torch.float64)
    exact = float(lanes64.sum())
    c_tol = 2.0 ** -16 * float(lanes64.abs().sum())
    c_err = abs(float(k.out[0]) - exact)
    check(count and lanes_ok and c_err <= c_tol,
          f"{name} disagrees: count {count}, max lane |d| {err:.3e} (tol "
          f"{tol:.3e}), checksum {float(k.out[0])!r} vs {exact!r} (tol "
          f"{c_tol:.3g})")
    return err, (f"{n} lanes, max |d| = {err:.3e} (tol {tol:.3e}"
                 f"{', bit for bit' if name == 'recip_peak' else ''}), "
                 f"checksum {float(k.out[0])!r} vs its lanes' exact sum "
                 f"{exact!r}: |d| = {c_err:.3g} (tol {c_tol:.3g}); plain "
                 f"checksum {float(p.out[0])!r}")


def phase1(dev):
    """Kernels vs plain versions at a few tiles and at the full main-path
    shape, then times at the full shape.  Returns the errors, the times and
    the option_normals launches of its own check window."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key, cli
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.utils.timing import bench

    cfg = HWConfig()
    key = Key(2026)
    n_live = cfg.n_mat - 1
    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
    market = analytic_market(cfg, dev)
    cp = fused.curve_prepared(cfg, tables)
    op = fused.option_prepared(cfg, tables, market, cfg.sigma)
    consts = torch.as_tensor(op.consts, device=dev)  # the plain versions'
    cfp = fused.curve_full_prepared(cfg, tables)
    ofp = fused.option_full_prepared(cfg, tables, market, cfg.sigma)
    consts_full = torch.as_tensor(ofp.consts, device=dev)
    dp = fused.delta_prepared(cfg, tables, market, cfg.sigma)
    consts_delta = torch.as_tensor(dp.consts, device=dev)
    gp = fused.grid_prepared(cfg, tables, market, cfg.sigma,
                             *cli.grid_axes(cfg))
    grid_ops = [torch.as_tensor(x, device=dev)
                for x in (gp.consts, gp.Bs, gp.Ks)]
    s = {kind: fused.kernel_seeds(key, kind) for kind in fused.SALTS}
    _, nb = fused._peak_geometry(cfg)

    def pair(name, n_tiles, prec=cfg.matmul_precision):
        """(kernel call, plain call) of ``name`` over n_tiles tiles."""
        return {
            "curve_exact": (
                lambda: fused.curve_exact(s["curve"], cp, n_tiles, n_live,
                                          prec),
                lambda: fused.curve_exact_plain(s["curve"], cp.W, cp.c,
                                                n_tiles, n_live, prec)),
            "zbc_exact": (
                lambda: fused.zbc_exact(s["zbc"], op, n_tiles),
                lambda: fused.zbc_exact_plain(s["zbc"], consts, n_tiles)),
            "vega_exact": (
                lambda: fused.vega_exact(s["vega"], op, n_tiles),
                lambda: fused.vega_exact_plain(s["vega"], consts, n_tiles)),
            "delta_exact": (
                lambda: fused.delta_exact(s["delta"], dp, n_tiles),
                lambda: fused.delta_exact_plain(s["delta"], consts_delta,
                                                n_tiles)),
            "grid_exact": (
                lambda: fused.grid_exact(s["grid"], gp, n_tiles),
                lambda: fused.grid_exact_plain(s["grid"], *grid_ops,
                                               n_tiles)),
            "option_normals": (
                lambda: fused.option_normals(s["zbc"], n_tiles, device=dev),
                lambda: fused.option_normals_plain(s["zbc"], n_tiles, dev)),
            "curve_full": (
                lambda: fused.curve_full(s["curve"], cfp, n_tiles,
                                         cfg.n_mat, prec),
                lambda: fused.curve_full_plain(s["curve"], cfp.W, cfp.exp_c,
                                               n_tiles, cfg.n_mat, prec)),
            "zbc_full": (
                lambda: fused.zbc_full(s["zbc"], ofp, n_tiles, prec),
                lambda: fused.zbc_full_plain(s["zbc"], ofp.W, consts_full,
                                             n_tiles, prec)),
            "vega_full": (
                lambda: fused.vega_full(s["vega"], ofp, n_tiles, prec),
                lambda: fused.vega_full_plain(s["vega"], ofp.W, consts_full,
                                              n_tiles, prec)),
            "raw_peak": (
                lambda: fused.raw_peak(s["raw_peak"], n_tiles, nb,
                                       device=dev),
                lambda: fused.raw_peak_plain(s["raw_peak"], n_tiles, nb,
                                             dev)),
            "draw_peak": (
                lambda: fused.draw_peak(s["draw_peak"], n_tiles, nb,
                                        device=dev),
                lambda: fused.draw_peak_plain(s["draw_peak"], n_tiles, nb,
                                              dev)),
            "bitops_peak": (
                lambda: fused.bitops_peak(s["bitops_peak"], n_tiles,
                                          device=dev),
                lambda: fused.bitops_peak_plain(s["bitops_peak"], n_tiles,
                                                dev)),
            "bm_peak": (
                lambda: fused.bm_peak(s["bm_peak"], n_tiles, device=dev),
                lambda: fused.bm_peak_plain(s["bm_peak"], n_tiles, dev)),
            "exp_peak": (
                lambda: fused.exp_peak(s["exp_peak"], n_tiles, device=dev),
                lambda: fused.exp_peak_plain(s["exp_peak"], n_tiles, dev)),
            "recip_peak": (
                lambda: fused.recip_peak(s["recip_peak"], n_tiles,
                                         device=dev),
                lambda: fused.recip_peak_plain(s["recip_peak"], n_tiles,
                                               dev)),
        }[name]

    # pairs per tile; every kernel is timed at 2^20 pairs but the exp and
    # reciprocal walls, timed at 2^24 as the roofline times them
    tile_pairs = {"curve_exact": fused.CURVE_TILE_PATHS,
                  "option_normals": fused.OPTION_TILE_PATHS,
                  "curve_full": fused.CURVE_FULL_TILE_PATHS,
                  "zbc_full": fused.OPTION_FULL_TILE_PATHS,
                  "bm_peak": fused.CURVE_TILE_PATHS,
                  "exp_peak": fused.CHAIN_TILE_PATHS,
                  "recip_peak": fused.CHAIN_TILE_PATHS}
    for name in ("zbc_exact", "vega_exact", "delta_exact", "grid_exact"):
        tile_pairs[name] = tile_pairs["option_normals"]
    for name in ("vega_full", "raw_peak", "draw_peak", "bitops_peak"):
        tile_pairs[name] = tile_pairs["zbc_full"]
    n_full = {name: (WALL_PAIRS if name in ("exp_peak", "recip_peak")
                     else cfg.n_paths) // tp
              for name, tp in tile_pairs.items()}
    walk_tiles = (8, 1, 3, 33, WALL_PAIRS // fused.OPTION_TILE_PATHS)
    n_few = {"curve_exact": (16,), "zbc_exact": walk_tiles,
             "vega_exact": walk_tiles, "delta_exact": walk_tiles,
             "grid_exact": walk_tiles, "option_normals": walk_tiles,
             "curve_full": (16,), "zbc_full": (8,), "vega_full": (8,),
             "raw_peak": (8,), "draw_peak": (8,), "bitops_peak": (8,),
             "bm_peak": (8,),
             "exp_peak": (1, cfg.n_paths // fused.CHAIN_TILE_PATHS),
             "recip_peak": (1, cfg.n_paths // fused.CHAIN_TILE_PATHS)}

    def pairs_of(name, n_tiles):
        n = n_tiles * tile_pairs[name]
        return f"2^{n.bit_length() - 1} pairs" if n & (n - 1) == 0 else \
            f"{n} pairs"

    err = {name: 0.0 for name in n_full}
    checks = [(name, n, prec) for name in n_full for n in n_few[name]
              for prec in (("highest", "default") if name.startswith("curve")
                           else (cfg.matmul_precision,))]
    checks += [(name, n_full[name], prec) for name in n_full
               for prec in (("highest", "default") if name.startswith("curve")
                            else (cfg.matmul_precision,))]
    normals_launches = None
    for name, n_tiles, prec in checks:
        kern, plain = pair(name, n_tiles, prec)
        if name == "option_normals" and normals_launches is None:
            # the check kernel's own window: the main path never runs it
            fused.reset_launch_counts()
            k = kern()
            normals_launches = fused.launch_counts()["option_normals"]
        else:
            k = kern()
        if name in WALK_KERNELS:
            k2 = kern()
            torch.cuda.synchronize()
            if name == "option_normals":  # (x1, x2)
                check(all(map(torch.equal, k, k2)), f"{name} reruns differ "
                      f"at {n_tiles} tiles")
            else:
                check(torch.equal(k, k2), f"{name} reruns differ at "
                      f"{n_tiles} tiles: {k.tolist()} vs {k2.tolist()}")
        torch.cuda.synchronize()
        compare_fn = (compare_exact_wall if name in EXACT_WALLS else
                      compare_peak if name.endswith("_peak") else compare)
        e, text = compare_fn(name, k, plain())
        if name in WALK_KERNELS:
            text += ", rerun bitwise equal"
        err[name] = max(err[name], e)
        label = f"{n_tiles} tiles, {pairs_of(name, n_tiles)}"
        if n_tiles == n_full[name]:
            label = "timed shape, " + label
        tag = f" [{prec}]" if name.startswith("curve") else ""
        print(f"[phase 1] {name}{tag} {label}: {text}")
    for n_k, n_s2 in SURFACE_SHAPES:
        # strikes K (0.92 .. 1.08), maturities S1 + 0.5 .. t_final; 1 x 1
        # is the reference option (K, S2)
        Ks = [cfg.strike * (0.92 + 0.16 * i / (n_k - 1)) if n_k > 1
              else cfg.strike for i in range(n_k)]
        S2s = [cfg.s2 - (cfg.s2 - cfg.s1 - 0.5) * j / (n_s2 - 1)
               if n_s2 > 1 else cfg.s2 for j in range(n_s2)][::-1]
        g = fused.grid_prepared(cfg, tables, market, cfg.sigma, Ks, S2s)
        k = fused.grid_exact(s["grid"], g, SURFACE_SHAPE_TILES)
        k2 = fused.grid_exact(s["grid"], g, SURFACE_SHAPE_TILES)
        torch.cuda.synchronize()
        check(torch.equal(k, k2), f"grid_exact {n_k} x {n_s2} reruns differ")
        e, text = compare_surface(k, fused.grid_exact_plain(
            s["grid"], *(torch.as_tensor(x, device=dev)
                         for x in (g.consts, g.Bs, g.Ks)),
            SURFACE_SHAPE_TILES), n_k, n_s2)
        err["grid_exact"] = max(err["grid_exact"], e)
        print(f"[phase 1] grid_exact {n_k} x {n_s2} "
              f"{SURFACE_SHAPE_TILES} tiles, "
              f"{pairs_of('grid_exact', SURFACE_SHAPE_TILES)}: {text}, "
              f"rerun bitwise equal")

    times = {}
    for name in n_full:
        kern, plain = pair(name, n_full[name])
        # plain, kernel, kernel, plain: each figure is the min of its windows;
        # the kernel's is device time, the plain version's the caller's wall
        p1 = bench(plain, device=dev, n=2, k=2)[0] * 1e3
        k1 = device_ms(kern, 20, 3)
        k2 = device_ms(kern, 20, 3)
        p2 = bench(plain, device=dev, n=2, k=2)[0] * 1e3
        times[name] = (min(k1, k2), min(p1, p2))
        print(f"[phase 1] time at {pairs_of(name, n_full[name])}: {name}: "
              f"kernel "
              f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms "
              f"(kernel runs {k1:.4f} / {k2:.4f}, plain {p1:.4f} / {p2:.4f})")
        if name.startswith("curve"):  # one bf16 pass instead of 3 or 6
            kern, _ = pair(name, n_full[name], "default")
            print(f"[phase 1] time at {pairs_of(name, n_full[name])}: "
                  f"{name} [default]: kernel "
                  f"{min(device_ms(kern, 20, 3), device_ms(kern, 20, 3)):.4f}"
                  f" ms")
    return err, times, normals_launches


def deterministic_gate(cfg, dev, engine, market):
    """The option kernel's own random field fed through an engine that
    takes it as an argument reproduces the kernel's ZBC price: exact tier,
    its normals through the exact engine at 2^20 pairs; full step, its
    shocks (raws, Hadamard mix, D scramble) through the linear engine at 8
    option tiles.  Returns (|dprice|, |dbeta|, tiles)."""
    import torch

    from hullwhite_tpu_torch import Key, pricing
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.ops import engine_exact, engine_linear, payoffs

    key = Key(7)
    seeds = fused.kernel_seeds(key, "zbc")
    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
    if engine == "fused_exact":
        n_tiles = cfg.n_paths // fused.OPTION_TILE_PATHS
        x1, x2 = fused.option_normals(seeds, n_tiles, device=dev)
        G = torch.stack([x1.reshape(-1), x2.reshape(-1)], dim=1)
        eng = engine_exact
        est = pricing.price_zbc(cfg, key, market, device=dev)
    else:
        n_tiles = 8
        G = fused.option_full_shocks(seeds, n_tiles, cfg.n_steps_s1, dev)
        eng = engine_linear
        op = fused.option_full_prepared(cfg, tables, market, cfg.sigma)
        est = payoffs.cv_estimate(fused.zbc_full(seeds, op, n_tiles),
                                  float(op.consts[5]))
    state = eng.antithetic_state(cfg, eng.zbc_weights(cfg, tables), G)
    ref = payoffs.cv_estimate(
        payoffs.zbc_moments(cfg, cfg.sigma, market, state), market.P[-1])
    return (abs(float(est.price) - float(ref.price)),
            abs(float(est.beta) - float(ref.beta)), n_tiles)


def phase2(dev, engine):
    """One main path at full width through the CLI with ``--engine
    engine``, then its deterministic gate; returns the launch counts of the
    CLI run alone (reset just before it, read just after it)."""
    from hullwhite_tpu_torch import HWConfig, cli
    from hullwhite_tpu_torch.kernels import fused

    cfg = HWConfig()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fused.reset_launch_counts()
            for argv in (["q1"], ["q2", "--validate", "5"],
                         ["q3", "--validate", "5"], ["grid"]):
                t0 = time.perf_counter()
                rc = cli.main(argv + ["--engine", engine,
                                      "--device", str(dev)])
                print(f"[phase 2] {engine}: cli {' '.join(argv)}: rc {rc}, "
                      f"{time.perf_counter() - t0:.1f} s")
                check(rc == 0, f"cli {argv[0]} --engine {engine} failed")
            counts = fused.launch_counts()
            market = cli.hwio.load_market(cfg, device=dev)
            d_price, d_beta, n_tiles = deterministic_gate(cfg, dev, engine,
                                                          market)
            print(f"[phase 2] {engine}: deterministic gate at {n_tiles} "
                  f"option tiles: |dprice| = {d_price:.3e} (tol 1e-6), "
                  f"|dbeta| = {d_beta:.3e} (tol 1e-4)")
            check(d_price <= 1e-6 and d_beta <= 1e-4,
                  f"{engine} deterministic gate")
            res = {name: json.load(open(os.path.join(
                "data_torch", f"{name}_results.json")))
                for name in ("q1", "q2a", "q2b", "q3", "grid")}
        finally:
            os.chdir(cwd)

    check_results(cfg, engine, res, "phase 2")
    return counts


def check_results(cfg, engine, res, tag):
    """The CLI's result files of one engine's main path against the
    published reference values and the fp64 oracles (phase 2's gates)."""
    import numpy as np

    from hullwhite_tpu_torch.models import oracles

    check(all(res[q]["results"].get("engine", engine) == engine
              for q in res), "results name another engine")
    P = np.asarray(res["q1"]["P"])
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P_true = np.array([oracles.bond_price(cfg, T) for T in Ts])
    se = 0.1 * P_true / math.sqrt(2 * cfg.n_paths)
    worst = float(np.max(np.abs(P - P_true) - 5 * se))
    print(f"[{tag}] {engine}: P(0,10) = {P[-1]:.6f} (|d| vs 0.876844 = "
          f"{abs(P[-1] - 0.876844):.2e}, tol 5e-4); worst |P - oracle| - 5 SE "
          f"= {worst:.2e} (tol 1e-4)")
    check(abs(P[-1] - 0.876844) < 5e-4 and worst < 1e-4, f"{engine} Q1 curve")
    th = res["q2a"]["results"]["max_error"]
    print(f"[{tag}] {engine}: theta recovery max error = {th:.3e} "
          "(tol 1e-2)")
    check(th < 1e-2, f"{engine} Q2a theta recovery")
    zbc = res["q2b"]["results"]
    print(f"[{tag}] {engine}: ZBC (CV) = {zbc['ZBC_control_variate']:.8f} "
          f"in [0.0353, 0.0357], beta = {zbc['beta_optimal']:.5f} in "
          "[0.15, 0.18]")
    check(0.0353 <= zbc["ZBC_control_variate"] <= 0.0357
          and 0.15 <= zbc["beta_optimal"] <= 0.18, f"{engine} Q2b ZBC")
    q3 = res["q3"]["results"]
    pw, fd = q3["sensitivity_mc"], q3["sensitivity_fd"]
    print(f"[{tag}] {engine}: vega pathwise = {pw:.6f} in [0.225, 0.236], "
          f"FD-CRN = {fd:.6f}, |pw - fd|/pw = {abs(pw - fd) / pw:.3%} "
          f"(tol 3%), FD-recalibrated = "
          f"{q3['sensitivity_fd_recalibrated']:.6f}")
    check(0.225 <= pw <= 0.236 and abs(pw - fd) / pw < 0.03,
          f"{engine} Q3 vega")
    if "grid" in res:  # cli all runs no grid
        check_surface(cfg, engine, res["grid"], P, tag)
    for q in ("q1", "q2b", "q3"):
        perf = res[q]["performance"]
        print(f"[{tag}] {engine}: {q} at {cfg.n_paths} pairs: "
              f"{perf['simulation_time_ms']} ms, "
              f"{perf['throughput_Mpaths_per_sec']} M paths/s "
              f"({perf['device']})")


def check_surface(cfg, engine, doc, P, tag):
    """The CLI's surface: every cell within 6 SE + 2e-4 of the closed form
    on the q1 curve P (test_grid.py's gate), prices decreasing in strike."""
    import numpy as np

    from hullwhite_tpu_torch.models import oracles

    price, se = np.asarray(doc["price"]), np.asarray(doc["std_error_raw"])
    Ks, S2s = doc["results"]["strikes"], doc["results"]["maturities"]
    check(price.shape == (len(Ks), len(S2s)) == (5, 5), "surface shape")
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(P, np.float64)
    worst = -np.inf
    for i, K in enumerate(Ks):
        for j, S2 in enumerate(S2s):
            true = oracles.zbc_price(cfg.replace(strike=K, s2=S2),
                                     float(np.interp(cfg.s1, Ts, P)),
                                     float(np.interp(S2, Ts, P)))
            worst = max(worst, abs(price[i, j] - true)
                        - (6 * max(se[i, j], 1e-6) + 2e-4))
    print(f"[{tag}] {engine}: surface 5 x 5, price(K, S2=10) = "
          f"{price[2, 4]:.8f}, worst |price - oracle| - (6 SE + 2e-4) = "
          f"{worst:.3e} (tol 0), decreasing in strike: "
          f"{bool(np.all(np.diff(price, axis=0) < 0))}")
    check(worst < 0 and np.all(np.diff(price, axis=0) < 0),
          f"{engine} option surface")


def phase2_delta(dev):
    """The delta/gamma path at full width on the fp64 oracle curve, then
    the delta and surface kernels' deterministic gates at 2^20 pairs;
    returns the launch counts of the delta/gamma step alone."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key, cli, greeks, grid, pricing
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.models import oracles
    from hullwhite_tpu_torch.ops import engine_exact, engine_linear, payoffs

    cfg = HWConfig()
    market = analytic_market(cfg, dev)
    key = Key(13)
    eps = 2e-4
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    delta = float(pricing.pathwise_delta(cfg, key, market, device=dev))
    gamma = float(greeks.gamma_zbc(cfg, key, market, eps=eps, device=dev))
    counts = fused.launch_counts()
    wall = time.perf_counter() - t0

    P1, P2 = float(market.P[cfg.n_mat // 2]), float(market.P[-1])
    dr, dI = engine_linear.r0_sensitivities(cfg)
    B = (1 - math.exp(-cfg.a * (cfg.s2 - cfg.s1))) / cfg.a
    delta_true = oracles.zbc_delta(cfg, P0_s1=P1, P0_s2=P2)

    def delta_at(shift):  # test_pricing.py's fp64 oracle of the gamma
        return oracles.zbc_delta(cfg, P0_s1=P1 * math.exp(-dI * shift),
                                 P0_s2=P2 * math.exp(-(dI + B * dr) * shift),
                                 dr_dr0=dr, di_dr0=dI)

    gamma_true = (delta_at(1e-5) - delta_at(-1e-5)) / 2e-5
    d_rel = abs(delta - delta_true) / abs(delta_true)
    print(f"[phase 2] delta/gamma at {cfg.n_paths} pairs ({wall:.2f} s): "
          f"delta = {delta:.8f} vs closed form {delta_true:.8f} "
          f"(rel {d_rel:.3%}, tol 1%); gamma (eps {eps}) = {gamma:.6f} vs "
          f"fp64 FD {gamma_true:.6f} (|d| {abs(gamma - gamma_true):.2e}, "
          f"tol {0.05 * abs(gamma_true) + 5e-3:.2e})")
    check(d_rel < 0.01, "pathwise delta vs closed form")
    check(abs(gamma - gamma_true) < 0.05 * abs(gamma_true) + 5e-3,
          "gamma vs fp64 FD")
    try:
        pricing.pathwise_delta(cfg, key, market, engine="fused", device=dev)
    except ValueError as e:
        print(f"[phase 2] pathwise_delta(engine='fused') raises: {e}")
    else:
        raise SmokeFailure("pathwise_delta accepted the full-step engine")

    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
    zw = engine_exact.zbc_weights(cfg, tables)
    n_tiles = cfg.n_paths // fused.OPTION_TILE_PATHS

    def state_of(kind):
        x1, x2 = fused.option_normals(fused.kernel_seeds(key, kind), n_tiles,
                                      device=dev)
        G = torch.stack([x1.reshape(-1), x2.reshape(-1)], dim=1)
        return engine_exact.antithetic_state(cfg, zw, G)

    ref = payoffs.delta_sum(cfg, cfg.sigma, market, state_of("delta"), dr, dI)
    d_gate = abs(delta - float(ref[0] / ref[1]))
    print(f"[phase 2] delta deterministic gate at {n_tiles} option tiles: "
          f"|ddelta| = {d_gate:.3e} (tol 1e-6)")
    check(d_gate <= 1e-6, "delta deterministic gate")
    Ks, S2s = (torch.tensor(x, dtype=torch.float32, device=dev)
               for x in cli.grid_axes(cfg))
    g_ref = grid.surface(grid._grid_moments(cfg, cfg.sigma, market,
                                            state_of("grid"), Ks, S2s),
                         Ks, S2s)
    g = grid.price_zbc_grid(cfg, key, market, Ks.tolist(), S2s.tolist(),
                            device=dev)
    d_price = float((g.price - g_ref.price).abs().max())
    d_beta = float((g.beta - g_ref.beta).abs().max())
    print(f"[phase 2] surface deterministic gate at {n_tiles} option tiles: "
          f"max cell |dprice| = {d_price:.3e} (tol 1e-6), |dbeta| = "
          f"{d_beta:.3e} (tol 1e-4)")
    check(d_price <= 1e-6 and d_beta <= 1e-4, "surface deterministic gate")
    return counts


def phase2_roofline(dev, times):
    """``cli benchmark --roofline`` at full width with its default windows:
    its return code, the two JSON files it writes, every fraction finite
    and > 0 where its count is, no exact-tier fraction of a wall or peak
    and no full-step fraction of the tensor peak above 1.02 (a tier above
    its wall means a count is wrong), and its full-step tier times and
    exact Q1 time within 5% of the same kernels' phase-1 device times.
    Returns the launch counts of the CLI run alone."""
    from hullwhite_tpu_torch import cli
    from hullwhite_tpu_torch.kernels import fused

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fused.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(["benchmark", "--roofline", "--device", str(dev)])
            counts = fused.launch_counts()
            print(f"[phase 2] cli benchmark --roofline: rc {rc}, "
                  f"{time.perf_counter() - t0:.1f} s")
            check(rc == 0, "cli benchmark --roofline failed")
            doc, ex_doc = (json.load(open(os.path.join("data_torch", f)))
                           for f in ("fullstep_roofline.json",
                                     "exact_roofline.json"))
        finally:
            os.chdir(cwd)
    from hullwhite_tpu_torch.benchmarks import FULLSTEP_FRACTIONS as counted

    res = doc["results"]
    print(f"[phase 2] roofline JSON device: {res['device']}")
    check(res["device"]["name"] and res["device"]["power_limit"],
          "the roofline JSON names no card")
    for name, kernel in (("q1_fullstep", "curve_full"),
                         ("zbc_fullstep", "zbc_full"),
                         ("vega_fullstep", "vega_full")):
        t = res["tiers"][name]
        fr = {f: t[f] for f in counted}
        check(all(math.isfinite(v) and (v > 0) == (t[counted[f]] > 0)
                  for f, v in fr.items())
              and max(t["fraction_of_tensor_peak"],
                      t["fraction_of_tensor_peak_live"]) <= 1.02,
              f"{name}: fractions {fr}")
        rel = t["ms"] / times[kernel][0] - 1.0
        print(f"[phase 2] roofline {name}: {t['ms']:.4f} ms (phase-1 device "
              f"time {times[kernel][0]:.4f} ms, {rel:+.2%}, tol 5%), "
              + ", ".join(f"{k[12:]} {v:.4f}" for k, v in fr.items())
              + f", serial sum {t['serial_occupancy_sum']:.4f}, limiting "
              f"unit {t['limiting_unit']}")
        check(abs(rel) <= 0.05, f"{name}: roofline time {t['ms']:.4f} ms vs "
              f"phase-1 device time {times[kernel][0]:.4f} ms")
    print(f"[phase 2] roofline walls: "
          f"{res['raw_wall_peak_raws_per_sec'] / 1e9:.2f} G raws/s, "
          f"{res['generator_peak_words_per_sec'] / 1e9:.2f} G words/s, "
          f"{res['int_alu_peak_ops_per_sec'] / 1e12:.4f} T ALU-pipe "
          f"instructions/s ({res['int_op_counts_origin']}; "
          f"{res['bitops_alu_ops_per_lane']:.0f} per lane); wall ms "
          f"{res['wall_ms']}")
    check_exact_roofline(ex_doc["results"], times)
    return counts


def check_exact_roofline(ex, times):
    """The exact-tier table of ``exact_roofline.json`` (phase2_roofline)."""
    check(ex["device"]["name"] and ex["device"]["power_limit"],
          "the exact roofline JSON names no card")
    print(f"[phase 2] exact roofline walls: "
          + ", ".join(f"{w} {v['per_sec'] / 1e9:.2f} G/s in {v['ms']:.4f} ms "
                      f"at {v['wall_pairs']} pairs"
                      for w, v in ex["walls"].items())
          + f" ({ex['int_op_counts_origin']}; per item {ex['math_counts']})")
    from hullwhite_tpu_torch.benchmarks import EXACT_FRACTIONS as counted

    check({"q1_exact", "zbc_exact", "vega_exact"} <= set(ex["tiers"]),
          f"exact roofline rows: {sorted(ex['tiers'])}")
    for name, t in ex["tiers"].items():
        fr = {f: t[f] for f in counted}
        check(all(math.isfinite(v) and (v > 0) == (t[counted[f]] > 0)
                  and v <= 1.02 for f, v in fr.items()),
              f"{name}: fractions {fr}")
        print(f"[phase 2] exact roofline {name} at {t['pairs']} pairs: "
              f"{t['ms']:.4f} ms, "
              + ", ".join(f"{k[12:]} {v:.4f}" for k, v in fr.items())
              + f", serial sum {t['serial_occupancy_sum']:.4f}, limiting "
              f"unit {t['limiting_unit']}")
    rel = ex["tiers"]["q1_exact"]["ms"] / times["curve_exact"][0] - 1.0
    print(f"[phase 2] exact roofline q1_exact: phase-1 device time "
          f"{times['curve_exact'][0]:.4f} ms, {rel:+.2%} (tol 5%)")
    check(abs(rel) <= 0.05, f"q1_exact: roofline time vs phase 1 {rel:+.2%}")


# ---------------------------------------------------------------------------
# phase 5: the XLA engine tier (linear, scan, exact), plain PyTorch on the
# card over threefry block normals
# ---------------------------------------------------------------------------

XLA_ENGINES = ("linear", "exact", "scan")
# normals on the card vs the CPU: float32 ulps (CUDA's log1p and sqrt
# against the CPU's; the bits are equal)
XLA_NORMAL_ULPS = 4
# scan vs linear on one G at the reference configuration's 500 and 1000
# steps: the bounds of tests/test_engines.py's across-configs check (its
# tiny-config bounds are for 100 steps; the walk's rounding grows with
# the steps)
XLA_STATE_TOL = (2e-4, 5e-6)
# the engines' float32 products against float64 on the same G: relative to
# the largest entry (true fp32 ~5e-7; TF32's 10-bit mantissas ~3e-4)
XLA_PRODUCT_RTOL = 1e-5


def phase5_generator(cfg, dev):
    """``block_normals`` on the card against the same call on the CPU at one
    full (path_block, n_steps) block: the bits bitwise, the normals within
    ``XLA_NORMAL_ULPS``; then the device time of one block's normals per
    engine column count (ms per block, by column count)."""
    import numpy as np
    import torch

    from hullwhite_tpu_torch import Key
    from hullwhite_tpu_torch.ops import rng

    key = Key(2026).fold_in(3)
    shape = (cfg.path_block, cfg.n_steps)
    bits = rng.random_bits(key, shape, device=dev)
    bits_cpu = rng.random_bits(key, shape, device="cpu")
    same = bool(torch.equal(bits.cpu(), bits_cpu))
    x = rng.normals_from_bits(bits).cpu().numpy()
    x_cpu = rng.normals_from_bits(bits_cpu).numpy()
    del bits, bits_cpu
    ulps = float(np.max(np.abs(x - x_cpu) / np.spacing(np.abs(x_cpu))))
    print(f"[phase 5] generator at {shape}: bits equal to the CPU's: {same}; "
          f"normals max {ulps:.0f} ulps from the CPU's (tol "
          f"{XLA_NORMAL_ULPS}), {np.mean(x != x_cpu):.2%} differ; mean "
          f"{x.mean():+.2e}, sd {x.std():.6f}")
    check(same and ulps <= XLA_NORMAL_ULPS and np.all(np.isfinite(x)),
          "block_normals on the card differs from the CPU")
    gen_ms = {}
    for cols in sorted({cfg.n_steps, cfg.n_steps_s1, cfg.n_mat - 1, 2}):
        gen_ms[cols] = device_ms(lambda c=cols: rng.block_normals(
            key, 0, (cfg.path_block, c), device=dev), 3, 3)
        print(f"[phase 5] generator: {gen_ms[cols]:.3f} ms per "
              f"({cfg.path_block}, {cols}) block (device time)")
    return gen_ms


def phase5_engine_gate(cfg, dev):
    """scan against linear on one G (antithetic and dual states at S1, the
    curve sums), and linear's float32 products against float64 on the same
    G: the gate that shows a TF32 product."""
    import torch

    from hullwhite_tpu_torch import Key
    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.ops import engine_linear, engine_scan, rng

    rtol, atol = XLA_STATE_TOL
    tables = hw.step_tables(cfg, cfg.sigma, device=dev)
    G = rng.block_normals(Key(5), 0, (cfg.path_block, cfg.n_steps),
                          device=dev)
    n1 = cfg.n_steps_s1
    zw = engine_linear.zbc_weights(cfg, tables)
    worst = {}
    for name in ("antithetic_state", "dual_state"):
        a = getattr(engine_scan, name)(cfg, tables, G[:, :n1])
        b = getattr(engine_linear, name)(cfg, zw, G[:, :n1])
        worst[name] = max(float(((x - y).abs() - (atol + rtol * y.abs()))
                                .max()) for x, y in zip(a, b))
    cw = engine_linear.curve_weights(cfg, tables)
    s_a = engine_scan.curve_discount_sums(cfg, tables, G)
    s_b = engine_linear.curve_discount_sums(cfg, cw, G)
    worst["curve_discount_sums"] = float(((s_a - s_b).abs()
                                          - rtol * s_b.abs()).max())
    print(f"[phase 5] scan vs linear on one ({cfg.path_block}, "
          f"{cfg.n_steps}) G: worst |scan - linear| - (atol {atol} + rtol "
          f"{rtol} |linear|) = {worst} (tol 0)")
    check(all(v <= 0 for v in worst.values()), "scan and linear disagree")
    rel = {}
    for name, x, w in (("option U", G[:, :n1], zw.U), ("curve W", G, cw.W)):
        z = engine_linear.dot(x, w, cfg.matmul_precision).double()
        z64 = x.double() @ w.double()
        rel[name] = float((z - z64).abs().max() / z64.abs().max())
    print(f"[phase 5] linear's float32 products vs float64 on the same G: "
          f"max rel {rel} (tol {XLA_PRODUCT_RTOL}); "
          f"allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
          f"float32_matmul_precision = "
          f"{torch.get_float32_matmul_precision()}")
    check(all(v <= XLA_PRODUCT_RTOL for v in rel.values()),
          "an XLA engine's product is not float32 (TF32?)")


def phase5_main_path(cfg, dev, engine, gen_ms):
    """``cli all --engine engine --reps 1`` and ``cli grid`` at full width,
    held to phase 2's gates, the AD vega within 3% of the pathwise one and
    every vega-surface cell within test_grid.py's bound of the fp64 closed
    form on the q1 curve; returns the kernels' launch counts of the run
    outside the engine table ``all`` ends with (none expected: the XLA
    tier is plain PyTorch), its times and the table's results."""
    import numpy as np

    from hullwhite_tpu_torch import cli
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import oracles

    cwd = os.getcwd()
    table = {}
    run_table = cli.cmd_benchmark

    def counted_table(args):
        # the table's fused tiers launch their kernels: kept apart
        before = fused.launch_counts()
        rc = run_table(args)
        table.update({k: v - before[k]
                      for k, v in fused.launch_counts().items()})
        return rc

    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        cli.cmd_benchmark = counted_table
        try:
            fused.reset_launch_counts()
            for argv in (["all", "--reps", "1"], ["grid"]):
                t0 = time.perf_counter()
                rc = cli.main(argv + ["--engine", engine,
                                      "--device", str(dev)])
                print(f"[phase 5] {engine}: cli {' '.join(argv)}: rc {rc}, "
                      f"{time.perf_counter() - t0:.1f} s")
                check(rc == 0, f"cli {argv[0]} --engine {engine} failed")
            counts = {k: v - table.get(k, 0)
                      for k, v in fused.launch_counts().items()}
            res = {name: json.load(open(os.path.join(
                "data_torch", f"{name}_results.json")))
                for name in ("q1", "q2a", "q2b", "q3", "grid")}
            engines = json.load(open(os.path.join(
                "data_torch", "benchmark_engines.json")))["results"]
            paths = np.fromfile(os.path.join("data_torch", "r_paths.bin"),
                                np.float32)
        finally:
            cli.cmd_benchmark = run_table
            os.chdir(cwd)
    print(f"[phase 5] {engine}: the engine table of cli all: consistency "
          f"{'PASS' if engines['consistency_pass'] else 'FAIL'} over "
          f"{sorted(engines['engines'])}; its launches {table}")
    check(paths.shape == (32 * (cfg.n_steps + 1),)
          and np.all(np.isfinite(paths)), "r_paths.bin")
    check_results(cfg, engine, res, "phase 5")
    q3 = res["q3"]["results"]
    pw, ad = q3["sensitivity_mc"], q3["sensitivity_ad_jvp"]
    print(f"[phase 5] {engine}: AD (jvp) vega = {ad:.6f}, |ad - pw|/pw = "
          f"{abs(ad - pw) / pw:.3%} (tol 3%)")
    check(abs(ad - pw) / pw < 0.03, f"{engine} AD vega")
    doc = res["grid"]
    vega = np.asarray(doc["vega"])
    P = np.asarray(res["q1"]["P"], np.float64)
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    worst = -np.inf
    for i, K in enumerate(doc["results"]["strikes"]):
        for j, S2 in enumerate(doc["results"]["maturities"]):
            true = oracles.zbc_vega(cfg.replace(strike=K, s2=S2),
                                    float(np.interp(cfg.s1, Ts, P)),
                                    float(np.interp(S2, Ts, P)))
            worst = max(worst, abs(vega[i, j] - true)
                        - (0.06 * abs(true) + 5e-3))
    print(f"[phase 5] {engine}: vega surface 5 x 5, vega(K, S2=10) = "
          f"{vega[2, 4]:.6f}, worst |vega - oracle| - (6% + 5e-3) = "
          f"{worst:.3e} (tol 0)")
    check(vega.shape == (5, 5) and worst < 0, f"{engine} vega surface")
    cols = {"q1": cfg.n_mat - 1 if engine == "exact" else cfg.n_steps,
            "q2b": 2 if engine == "exact" else cfg.n_steps_s1,
            "q3": 2 if engine == "exact" else cfg.n_steps_s1}
    times = {}
    for q, c in cols.items():
        ms = float(res[q]["performance"]["simulation_time_ms"])
        share = cfg.n_blocks * gen_ms[c] / ms
        times[q] = {"ms": ms, "generator_share": share}
        print(f"[phase 5] {engine}: {q} {ms:.1f} ms per call at "
              f"{cfg.n_paths} pairs; generator {cfg.n_blocks} x "
              f"{gen_ms[c]:.3f} ms = {share:.0%} of it")
    return counts, times, engines


def phase5(dev, smi):
    """The XLA tier (module docstring, phase 5); returns its launch counts
    per engine."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key, pricing

    cfg = HWConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    gen_ms = phase5_generator(cfg, dev)
    phase5_engine_gate(cfg, dev)
    counts, times, tables = {}, {}, {}
    for engine in XLA_ENGINES:
        counts[engine], times[engine], tables[engine] = phase5_main_path(
            cfg, dev, engine, gen_ms)
    # the engine table (``cli benchmark``'s) that each engine's cli all
    # ends with
    for engine, table in tables.items():
        check(table["consistency_pass"] is True, f"cli all --engine "
              f"{engine}: the engine table's price consistency failed")
    market = analytic_market(cfg, dev)
    for engine in ("linear", "exact"):
        a, b = (pricing.price_zbc(cfg, Key(11), market, engine=engine,
                                  device=dev) for _ in range(2))
        v1, v2 = (pricing.pathwise_vega(cfg, Key(11), market, engine=engine,
                                        device=dev) for _ in range(2))
        print(f"[phase 5] {engine}: rerun determinism: ZBC "
              f"{float(a.price)!r} == {float(b.price)!r}, vega "
              f"{float(v1)!r} == {float(v2)!r}")
        check(float(a.price) == float(b.price) and float(v1) == float(v2),
              f"{engine} reruns differ")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 5] XLA tier times per call at {cfg.n_paths} pairs "
          f"[{smi}]: " + json.dumps(times))
    print(f"[phase 5] peak device memory of the XLA phase: {peak:.2f} GiB "
          f"[{smi}]")
    return counts


# ---------------------------------------------------------------------------
# phase 6: RQMC and the European coupon-bond options / swaptions, plain
# PyTorch on the card (no hand-written kernel on these calls)
# ---------------------------------------------------------------------------

# bench.py's RQMC setting: 2^16 Sobol points x 8 shifts
QMC_POINTS = 1 << 16
QMC_SHIFTS = 8
# the card against the CPU on one key, absolute: float32 noise (the card's
# log and exp against the CPU's, the order of the float32 sums)
QMC_CARD_CPU_TOL = 2e-7


def _cli(argv, tag):
    """``cli.main(argv)`` with its output captured and echoed under
    ``tag``; (rc, text, seconds)."""
    import contextlib
    import io

    from hullwhite_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        print(f"[{tag}] | {line}")
    print(f"[{tag}] cli {' '.join(argv)}: rc {rc}, {wall:.1f} s")
    check(rc == 0, f"cli {argv[0]} failed")
    return text


def phase6_cli(cfg, dev):
    """``cli q1``, ``cli q2 --qmc``, ``cli q3 --qmc`` (the MC parts on the
    default fused_exact kernels), then, on the fp64 oracle curve written
    to ``data_torch/market.npz``, ``cli swaption --tenor 4`` [--payer], at
    full width in a fresh directory; returns the oracle market, the q1
    curve, the q2 RQMC line's numbers, the q3 results, the swaption
    results and the kernels' launch counts of the two swaption runs."""
    import re

    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.utils import io as hwio

    argv = ["--device", str(dev), "--reps", "1"]
    qmc = ["--qmc", str(QMC_POINTS)]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            _cli(["q1", *argv], "phase 6")
            text = _cli(["q2", *qmc, *argv], "phase 6")
            _cli(["q3", *qmc, *argv], "phase 6")
            q1 = json.load(open(os.path.join("data_torch",
                                             "q1_results.json")))
            # the swaptions price on the fp64 oracle curve, as
            # tests/test_instruments.py does: Jamshidian is exact for the
            # model only on a curve the model reprices
            market = analytic_market(cfg, dev)
            hwio.save_market(cfg, market)
            fused.reset_launch_counts()
            swaption = {}
            for payer in (False, True):
                _cli(["swaption", "--tenor", "4", *argv]
                     + (["--payer"] if payer else []), "phase 6")
                swaption[payer] = json.load(open(os.path.join(
                    "data_torch", "swaption_results.json")))["results"]
            counts = fused.launch_counts()
            q3 = json.load(open(os.path.join("data_torch",
                                             "q3_results.json")))
        finally:
            os.chdir(cwd)
    num = r"([-+0-9.e]+)"
    m_price = re.search(rf"price = {num} \+/- {num} \(SE\)", text)
    m_se = re.search(rf"SE vs per-leg-iid MC at 2\^\d+ pairs: {num} vs "
                     rf"{num}", text)
    check(m_price is not None and m_se is not None, "cli q2 --qmc printed "
          "no RQMC price line")
    q2 = {"price": float(m_price.group(1)), "se": float(m_price.group(2)),
          "mc_se": float(m_se.group(2))}
    return market, q1["P"], q2, q3["results"], swaption, counts


def phase6_gates(cfg, dev, market, P_q1, q2, q3, swaption):
    """The slice's results at full width: the RQMC ZBC and vega against the
    fp64 oracles on the q1 curve, the swaptions (on the oracle curve)
    against Jamshidian, the swaption MC on a rerun."""
    import numpy as np
    import torch

    from hullwhite_tpu_torch import Key, greeks, instruments
    from hullwhite_tpu_torch.models import oracles
    from hullwhite_tpu_torch.ops import qmc

    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(P_q1, np.float64)
    p1, p2 = float(np.interp(cfg.s1, Ts, P)), float(np.interp(cfg.s2, Ts, P))
    zbc, vega = oracles.zbc_price(cfg, p1, p2), oracles.zbc_vega(cfg, p1, p2)
    print(f"[phase 6] cli q2 --qmc {QMC_POINTS}: RQMC ZBC {q2['price']:.8f} "
          f"+/- {q2['se']:.2e}, fp64 oracle on the q1 curve {zbc:.8f}, |d| = "
          f"{abs(q2['price'] - zbc):.2e} (tol 5 SE + 5e-5); MC SE "
          f"{q2['mc_se']:.2e} = {q2['mc_se'] / q2['se']:.0f} x the RQMC SE "
          f"(tol >= 10)")
    check(abs(q2["price"] - zbc) <= 5 * q2["se"] + 5e-5, "RQMC ZBC")
    check(q2["mc_se"] >= 10 * q2["se"], "RQMC SE not 10x below the MC SE")
    v, v_se = q3["sensitivity_qmc"], q3["sensitivity_qmc_se"]
    print(f"[phase 6] cli q3 --qmc {QMC_POINTS}: RQMC vega {v:.6f} +/- "
          f"{v_se:.2e}, fp64 oracle {vega:.6f}, |d| = {abs(v - vega):.2e} "
          f"(tol 5 SE + 1e-3)")
    check(abs(v - vega) <= 5 * v_se + 1e-3, "RQMC vega")

    key = Key(cfg.seed).fold_in(4242)
    sched = instruments.swap_fixed_leg(cfg, 0.025, 4.0)
    mc = {}
    for payer, res in swaption.items():
        kind = "payer" if payer else "receiver"
        est = instruments.price_swaption(cfg, key, market, rate=0.025,
                                         tenor=4.0, payer=payer, device=dev)
        mc[payer] = float(est.price)
        se = float(torch.sqrt(est.var_x / est.n))
        jam = res["jamshidian"]
        print(f"[phase 6] swaption {kind}: MC {res['mc_price']:.8f} (SE "
              f"{se:.2e}; rerun {mc[payer]!r} == {res['mc_price']!r}), "
              f"RQMC {res['qmc_price']:.8f} +/- {res['qmc_se']:.2e}, "
              f"Jamshidian {jam:.8f}: |MC - J| = "
              f"{abs(res['mc_price'] - jam):.2e} (tol 5 SE + 2e-4), "
              f"|RQMC - J| = {abs(res['qmc_price'] - jam):.2e} (tol 6 SE + "
              f"5e-5, SE < 5e-5)")
        check(mc[payer] == res["mc_price"], f"swaption {kind}: MC reruns "
              "differ")
        check(abs(res["mc_price"] - jam) <= 5 * se + 2e-4,
              f"swaption {kind}: MC vs Jamshidian")
        check(res["qmc_se"] < 5e-5 and abs(res["qmc_price"] - jam)
              <= 6 * res["qmc_se"] + 5e-5, f"swaption {kind}: RQMC vs "
              "Jamshidian")
    fwd = sum(c * np.interp(t, Ts, P) for c, t in
              zip(sched.coupons, sched.times)) - np.interp(cfg.s1, Ts, P)
    par = swaption[False]["mc_price"] - swaption[True]["mc_price"]
    print(f"[phase 6] swaption receiver - payer = {par:.8f}, forward swap "
          f"value {fwd:.8f}, |d| = {abs(par - fwd):.2e} (tol 5e-4)")
    check(abs(par - fwd) <= 5e-4, "swaption payer/receiver parity")

    _, v_ad = greeks.vega_swaption(cfg, key, market, sched, 1.0, payer=True,
                                   device=dev)
    eps = 1e-3
    legs = [float(instruments.price_coupon_bond_option(
        cfg, key, market, sched, 1.0, payer=True, sigma=cfg.sigma + s * eps,
        device=dev).price) for s in (-1.0, 1.0)]
    fd = (legs[1] - legs[0]) / (2 * eps)
    print(f"[phase 6] vega_swaption (payer) = {float(v_ad):.6f}, CRN FD "
          f"(eps {eps}) = {fd:.6f}, |d| = {abs(float(v_ad) - fd):.2e} (tol "
          f"3% + 5e-4)")
    check(abs(float(v_ad) - fd) <= 0.03 * abs(fd) + 5e-4, "vega_swaption")

    curve = qmc.bootstrap_curve_qmc(cfg, Key(2026), n_points=QMC_POINTS,
                                    n_shifts=QMC_SHIFTS, n_qmc=32,
                                    device=dev)
    Pq = curve.market.P.cpu().numpy().astype(np.float64)
    se = curve.std_error.cpu().numpy().astype(np.float64)
    true = np.array([oracles.bond_price(cfg, T) for T in Ts])
    worst = float(np.max(np.abs(Pq - true) - (5 * se + 3e-5)))
    print(f"[phase 6] bootstrap_curve_qmc ({cfg.n_mat} maturities, "
          f"{QMC_POINTS} x {QMC_SHIFTS}, n_qmc 32): P(0,10) = {Pq[-1]:.6f} "
          f"+/- {se[-1]:.2e}, worst |P - oracle| - (5 SE + 3e-5) = "
          f"{worst:.2e} (tol 0)")
    check(Pq[0] == 1.0 and worst <= 0 and np.all(np.isfinite(Pq)),
          "bootstrap_curve_qmc")


def phase6_card_vs_cpu(cfg, dev, market):
    """The Sobol points on the card bitwise the CPU's; the RQMC ZBC and the
    swaption's RQMC price on one key within QMC_CARD_CPU_TOL of the CPU's;
    reruns bitwise."""
    import torch

    from hullwhite_tpu_torch import Key, instruments
    from hullwhite_tpu_torch.ops import qmc, rng, sobol

    shift = rng.random_bits(Key(5), (32,), device=dev)
    pts = {"sobol2": (qmc.sobol2(QMC_POINTS, shift[:2]),
                      qmc.sobol2(QMC_POINTS, shift[:2].cpu())),
           "sobol": (sobol.sobol(QMC_POINTS, 32, shift),
                     sobol.sobol(QMC_POINTS, 32, shift.cpu()))}
    same = {k: bool(torch.equal(a.cpu(), b)) for k, (a, b) in pts.items()}
    print(f"[phase 6] Sobol points at {QMC_POINTS} (sobol2, and sobol in 32 "
          f"dims): the card's bitwise the CPU's: {same}")
    check(all(same.values()), "Sobol points on the card differ from the CPU")

    key = Key(cfg.seed).fold_in(54321)
    cpu_market = market.to("cpu")
    a = qmc.price_zbc_qmc(cfg, key, market, n_points=QMC_POINTS, device=dev)
    b = qmc.price_zbc_qmc(cfg, key, market, n_points=QMC_POINTS, device=dev)
    c = qmc.price_zbc_qmc(cfg, key, cpu_market, n_points=QMC_POINTS,
                          device="cpu")
    sched = instruments.swap_fixed_leg(cfg, 0.025, 4.0)
    skey = Key(cfg.seed).fold_in(4242)
    sw_dev, sw_cpu = (instruments.price_coupon_bond_option_qmc(
        cfg, skey, m, sched, 1.0, payer=True, device=d)[0]
        for m, d in ((market, dev), (cpu_market, "cpu")))
    d_zbc = abs(float(a.value) - float(c.value))
    d_sw = abs(float(sw_dev) - float(sw_cpu))
    print(f"[phase 6] price_zbc_qmc card {float(a.value)!r} vs CPU "
          f"{float(c.value)!r}: |d| = {d_zbc:.2e}; swaption RQMC card "
          f"{float(sw_dev)!r} vs CPU {float(sw_cpu)!r}: |d| = {d_sw:.2e} "
          f"(tol {QMC_CARD_CPU_TOL}); rerun {float(b.value)!r}")
    check(d_zbc <= QMC_CARD_CPU_TOL and d_sw <= QMC_CARD_CPU_TOL,
          "RQMC on the card vs the CPU")
    check(float(a.value) == float(b.value)
          and torch.equal(a.per_shift, b.per_shift), "RQMC reruns differ")


def phase6_times(cfg, dev, market, smi, reps=5):
    """Per call of the slice, the RQMC ones at 2^16 and 2^20 points, the MC
    ones at 2^20 pairs, after one warm call of each: the synchronised wall
    ms of ``reps`` rounds (median, least and most), each round running
    every call with the two sizes of a call back to back; the host ms
    until the call returns, before the closing synchronise (median: the
    time the host takes to enqueue the call's work, with any wait inside
    the call); the device-busy ms and the device operations per call of
    one ``torch.profiler`` window."""
    import statistics

    import torch

    from hullwhite_tpu_torch import Key, greeks, instruments
    from hullwhite_tpu_torch.ops import qmc
    from hullwhite_tpu_torch.utils.step_profile import _profile

    key = Key(cfg.seed).fold_in(4242)
    sched = instruments.swap_fixed_leg(cfg, 0.025, 4.0)
    qmc_calls = {
        "price_zbc_qmc": lambda n: qmc.price_zbc_qmc(
            cfg, key, market, n_points=n, device=dev).value,
        "vega_zbc_qmc": lambda n: qmc.vega_zbc_qmc(
            cfg, key, market, n_points=n, device=dev).value,
        "swaption_qmc": lambda n: instruments.price_coupon_bond_option_qmc(
            cfg, key, market, sched, 1.0, payer=True, n_points=n,
            device=dev)[0],
        "bootstrap_curve_qmc": lambda n: qmc.bootstrap_curve_qmc(
            cfg, key, n_points=n, device=dev).market.P}
    calls = {f"{name}@{n}": (lambda fn=fn, n=n: fn(n))
             for name, fn in qmc_calls.items() for n in (QMC_POINTS, 1 << 20)}
    calls[f"swaption_mc@{cfg.n_paths}"] = lambda: instruments.price_swaption(
        cfg, key, market, rate=0.025, tenor=4.0, payer=True,
        device=dev).price
    calls[f"vega_swaption@{cfg.n_paths}"] = lambda: greeks.vega_swaption(
        cfg, key, market, sched, 1.0, payer=True, device=dev)[1]
    for fn in calls.values():
        fn()
    walls = {name: [] for name in calls}
    hosts = {name: [] for name in calls}
    for _ in range(reps):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            hosts[name].append((t1 - t0) * 1e3)
    times = {}
    for name, fn in calls.items():
        prof = _profile(fn, 1)
        ops = sum(e["count_per_call"] for e in prof["device_events"].values())
        t = times[name] = {
            "wall_ms": statistics.median(walls[name]),
            "wall_ms_min": min(walls[name]), "wall_ms_max": max(walls[name]),
            "host_ms": statistics.median(hosts[name]),
            "device_ms": prof["device_busy_us_per_call"] / 1e3,
            "device_ops": ops}
        print(f"[phase 6] {name}: wall median {t['wall_ms']:.3f} ms "
              f"[{t['wall_ms_min']:.3f}, {t['wall_ms_max']:.3f}] over "
              f"{reps}, host {t['host_ms']:.3f} ms, device busy "
              f"{t['device_ms']:.3f} ms, {ops:.0f} device ops "
              f"({t['host_ms'] * 1e3 / max(ops, 1):.1f} us of host each) "
              f"per call [{smi}]")
    return times


def phase6(dev, smi):
    """RQMC and the swaptions (module docstring, phase 6); returns the
    kernels' launch counts of the RQMC and swaption calls."""
    import torch

    from hullwhite_tpu_torch import HWConfig
    from hullwhite_tpu_torch.kernels import fused

    cfg = HWConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    market, P_q1, q2, q3, swaption, counts = phase6_cli(cfg, dev)
    fused.reset_launch_counts()
    phase6_gates(cfg, dev, market, P_q1, q2, q3, swaption)
    phase6_card_vs_cpu(cfg, dev, market)
    for name, n in fused.launch_counts().items():
        counts[name] += n
    times = phase6_times(cfg, dev, market, smi)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 6] times per call [{smi}]: " + json.dumps(times))
    print(f"[phase 6] peak device memory of the RQMC/swaption phase: "
          f"{peak:.2f} GiB [{smi}]")
    return counts


# ---------------------------------------------------------------------------
# phase 7: the Bermudan swaption and the multi-date instruments (caps, CMS,
# CMS spread, range accrual), plain PyTorch on the card (no hand-written
# kernel on these calls) and the fp64 DP oracle on the host
# ---------------------------------------------------------------------------

# bench.py's Bermudan setting: 2^17 paths x 8 blocks, five annual exercises
BERM_PATHS, BERM_BLOCKS = 1 << 17, 8
BERM_EX = (5.0, 6.0, 7.0, 8.0, 9.0)
# the card against the CPU on one key at 2^14 paths, k = 3, absolute on the
# three prices and relative on their SEs: the QR backends differ (cuSOLVER
# against LAPACK) and so do the card's log1p and sqrt in the normals
BERM_CARD_CPU_TOL, BERM_CARD_CPU_SE_TOL = 1e-6, 1e-2


def phase7_cli(cfg, dev):
    """``cli q1 --engine exact``, then on its curve ``cli swaption
    --bermudan --delta``
    (receiver with ``--bermudan-sweep``, then payer), ``cli cap`` and
    ``cli cms`` at full width in a fresh directory; returns the q1
    market, the swaption results per side, the sweep and the cap and cms
    results."""
    from hullwhite_tpu_torch.utils import io as hwio

    argv = ["--device", str(dev), "--reps", "1"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            def results(name):
                return json.load(open(os.path.join("data_torch",
                                                   name)))["results"]

            # the XLA tier's exact engine: no kernel launches in the phase
            _cli(["q1", "--engine", "exact", *argv], "phase 7")
            market = hwio.load_market(cfg, device=dev)
            swaption = {}
            for payer in (False, True):
                extra = ["--payer"] if payer else ["--bermudan-sweep"]
                _cli(["swaption", "--bermudan", "--delta", *extra, *argv],
                     "phase 7")
                swaption[payer] = results("swaption_results.json")
                if not payer:
                    sweep = results("bermudan_sweep.json")
            _cli(["cap", *argv], "phase 7")
            cap = results("cap_results.json")
            _cli(["cms", *argv], "phase 7")
            cms = results("cms_results.json")
        finally:
            os.chdir(cwd)
    return market, swaption, sweep, cap, cms


def phase7_gates(swaption, sweep, cap, cms):
    """The CLI's results: each side's martingale-CV lower bound and dual
    upper bound against the DP oracle, the CV's variance reduction, the
    curve deltas against the oracle's FD; the sweep's bracket at every k;
    the cap's vega against the closed form's FD; cap and cms agreement."""
    for payer, r in swaption.items():
        kind = "payer" if payer else "receiver"
        dp, cv, cv_se = (r["bermudan_dp_oracle"], r["bermudan_lower_cv"],
                         r["bermudan_cv_se"])
        up, up_se = r["bermudan_upper"], r["bermudan_upper_se"]
        print(f"[phase 7] swaption {kind} Bermudan (k = 5): CV lower "
              f"{cv:.8f} +/- {cv_se:.2e}, upper {up:.8f} +/- {up_se:.2e}, "
              f"DP {dp:.8f}; CV - DP = {cv - dp:+.2e} (tol 5 SE + 1e-6), "
              f"upper - DP = {up - dp:+.2e} (tol >= -(4 SE + 1e-6)); raw "
              f"LSMC SE {r['bermudan_se']:.2e} = "
              f"{r['bermudan_se'] / cv_se:.0f} x the CV SE (tol >= 20)")
        check(abs(cv - dp) <= 5 * cv_se + 1e-6, f"{kind}: CV lower vs DP")
        check(up >= dp - (4 * up_se + 1e-6), f"{kind}: upper below DP")
        check(cv <= up + 4 * (cv_se + up_se), f"{kind}: CV above upper")
        check(cv_se * 20 <= r["bermudan_se"], f"{kind}: CV SE not 20x below "
              "the raw LSMC SE")
        d_dp = r["bermudan_delta_dp_oracle"]
        dl, du = r["bermudan_delta_lower"], r["bermudan_delta_upper"]
        print(f"[phase 7] swaption {kind} curve delta: lower {dl:.6f}, "
              f"upper {du:.6f}, DP FD {d_dp:.6f}; rel. gaps "
              f"{abs(dl - d_dp) / abs(d_dp):.2e} (tol 3e-2), "
              f"{abs(du - d_dp) / abs(d_dp):.2e} (tol 2e-3)")
        check(abs(du - d_dp) <= 2e-3 * abs(d_dp), f"{kind}: dual delta")
        check(abs(dl - d_dp) <= 3e-2 * abs(d_dp), f"{kind}: lower delta")
    dps = sweep["dp_oracle"]
    check(sweep["k"] == [1, 2, 3, 4, 5], "bermudan sweep: k != 1..5")
    check(all(b > a for a, b in zip(dps, dps[1:])), "bermudan sweep: DP not "
          "rising with k")
    for i, k in enumerate(sweep["k"]):
        lo, lo_se = sweep["lower"][i], sweep["lower_se"][i]
        up, up_se = sweep["upper"][i], sweep["upper_se"][i]
        print(f"[phase 7] sweep k = {k}: [{lo:.8f}, {up:.8f}], DP "
              f"{dps[i]:.8f}: lower - DP = {lo - dps[i]:+.2e} (tol 5 SE "
              f"{5 * lo_se:.1e} + 1e-6), upper - DP = {up - dps[i]:+.2e} (tol "
              f"5 SE {5 * up_se:.1e} + 1e-6)")
        check(abs(lo - dps[i]) <= 5 * lo_se + 1e-6
              and abs(up - dps[i]) <= 5 * up_se + 1e-6,
              f"bermudan sweep k = {k}: bracket vs DP")
    jam = sweep["european"]
    print(f"[phase 7] sweep k = 1 vs Jamshidian {jam:.8f}: "
          f"{sweep['lower'][0] - jam:+.2e} (tol 5 SE + 2e-4)")
    check(abs(sweep["lower"][0] - jam) <= 5 * sweep["lower_se"][0] + 2e-4,
          "bermudan sweep k = 1 vs Jamshidian")
    v, va = cap["vega_fd"], cap["vega_closed_fd"]
    print(f"[phase 7] cli cap: MC {cap['mc_price']:.8f} +/- "
          f"{cap['mc_se']:.2e}, closed form {cap['closed_form']:.8f}, z = "
          f"{cap['z']:.2f}; CRN-FD vega {v:.6f}, closed-form FD {va:.6f} "
          f"(tol 1% + 1e-3)")
    check(abs(v - va) < 0.01 * abs(va) + 1e-3, "cap vega")
    print(f"[phase 7] cli cms: MC {cms['mc_price']:.8f} +/- "
          f"{cms['mc_se']:.2e}, quadrature {cms['quadrature']:.8f}, z = "
          f"{cms['z']:.2f}")


def phase7_direct(cfg, dev, market):
    """The calls with no command of their own at full width on the q1
    curve: the CMS spread and range accrual legs against their oracles,
    ``bermudan_vega`` jvp against fd and the RQMC bracket at bench.py's
    setting."""
    from hullwhite_tpu_torch import Key, bermudan, greeks, instruments

    key = Key(cfg.seed).fold_in(9393)
    kw = dict(strike=0.002, tenor=3.0, long_tenor=4.0, short_tenor=1.0)
    sp = instruments.price_cms_spread(cfg, key, market, device=dev, **kw)
    orc, _ = instruments.cms_spread_quadrature(cfg, market, **kw)
    ra_kw = dict(coupon=0.03, lo=0.010, hi=0.022, tenor=3.0,
                 obs_per_period=5)
    ra = instruments.price_range_accrual(cfg, key, market, device=dev,
                                         **ra_kw)
    orc_ra, _ = instruments.range_accrual_closed_form(cfg, market, **ra_kw)
    for name, res, o in (("price_cms_spread", sp, orc),
                         ("price_range_accrual", ra, orc_ra)):
        p, se = float(res.price), float(res.std_error)
        print(f"[phase 7] {name} at {cfg.n_paths} paths: {p:.8f} +/- "
              f"{se:.2e}, oracle {o:.8f}, |d| = {abs(p - o):.2e} (tol 5 SE + "
              f"2e-4)")
        check(abs(p - o) <= 5 * se + 2e-4, f"{name} vs its oracle")
    fr = ra.mean_fraction.cpu()
    check(bool(((fr >= 0) & (fr <= 1)).all()), "range accrual fractions")

    sched = instruments.swap_fixed_leg(cfg, 0.025, 5.0)
    bkey = Key(cfg.seed).fold_in(4242)
    bw = dict(n_paths=BERM_PATHS, n_blocks=BERM_BLOCKS, device=dev)
    dp = bermudan.dp_oracle(cfg, market, sched, BERM_EX)
    _, dpj, _, duj = greeks.bermudan_vega(cfg, bkey, market, sched, BERM_EX,
                                          **bw)
    _, dpf, _, duf = greeks.bermudan_vega(cfg, bkey, market, sched, BERM_EX,
                                          mode="fd", **bw)
    dpj, duj, dpf, duf = (float(x) for x in (dpj, duj, dpf, duf))
    print(f"[phase 7] bermudan_vega at {BERM_PATHS} x {BERM_BLOCKS}, k = 5: "
          f"jvp lower {dpj:.6f} upper {duj:.6f}; fd lower {dpf:.6f} upper "
          f"{duf:.6f}; |d| upper {abs(duj - duf):.2e} (tol 1e-3), lower "
          f"{abs(dpj - dpf):.2e} (tol 5e-2)")
    check(abs(duj - duf) < 1e-3 and abs(dpj - dpf) < 5e-2,
          "bermudan_vega jvp vs fd")
    rq = bermudan.price_bermudan(cfg, bkey, market, sched, BERM_EX,
                                 rqmc=True, **bw)
    lo, lo_se = float(rq.price_cv), float(rq.cv_std_error)
    up, up_se = float(rq.upper), float(rq.upper_std_error)
    print(f"[phase 7] RQMC Bermudan at {BERM_PATHS} x {BERM_BLOCKS} shifts: "
          f"[{lo:.8f}, {up:.8f}] (SE {lo_se:.2e} / {up_se:.2e}), DP "
          f"{dp:.8f} (tol 5 SE + 1e-6 each side)")
    check(lo - (5 * lo_se + 1e-6) <= dp <= up + 5 * up_se + 1e-6,
          "RQMC Bermudan bracket vs DP")


def phase7_card_vs_cpu(cfg, dev, market):
    """``price_bermudan`` at 2^14 paths, k = 3, on the card and on the CPU
    under one key: the port's own numbers on both devices."""
    from hullwhite_tpu_torch import Key, bermudan, instruments

    sched = instruments.swap_fixed_leg(cfg, 0.025, 5.0)
    key = Key(cfg.seed).fold_in(777)
    out = {}
    for d, m in ((dev, market), ("cpu", market.to("cpu"))):
        r = bermudan.price_bermudan(cfg, key, m, sched, BERM_EX[:3],
                                    n_paths=1 << 14, device=d)
        out[str(d)] = [float(x) for x in (r.price, r.price_cv, r.upper,
                                          r.std_error, r.cv_std_error,
                                          r.upper_std_error)]
    a, b = out[str(dev)], out["cpu"]
    d_price = max(abs(x - y) for x, y in zip(a[:3], b[:3]))
    d_se = max(abs(x - y) / y for x, y in zip(a[3:], b[3:]))
    print(f"[phase 7] price_bermudan at 2^14 paths, k = 3, card vs CPU: "
          f"(lower, CV, upper) {a[:3]} vs {b[:3]}: max |d| = {d_price:.2e} "
          f"(tol {BERM_CARD_CPU_TOL}); SEs max rel. d = {d_se:.2e} (tol "
          f"{BERM_CARD_CPU_SE_TOL})")
    check(d_price <= BERM_CARD_CPU_TOL and d_se <= BERM_CARD_CPU_SE_TOL,
          "price_bermudan on the card vs the CPU")


def _device_window(fn):
    """(device-busy ms, device operations) of one call of ``fn``: one
    ``torch.profiler`` window on the card's activity only, read from the
    raw events (building the profiler's event tree takes minutes at a
    Bermudan call's 10^5 operations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() if hasattr(e, "duration_ns")
          else 1e3 * e.duration_us()
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return sum(ns) / 1e6, len(ns)


def phase7_times(cfg, dev, market, smi, reps=2):
    """Per call, after one warm call of each: the synchronised wall ms of
    ``reps`` rounds (median, least, most), the host ms until the call
    returns, the device-busy ms and device operations of one profiler
    window (``_device_window``; ``dp_oracle``: host wall only); the
    Bermudan reruns bitwise."""
    import statistics

    import torch

    from hullwhite_tpu_torch import Key, bermudan, greeks, instruments

    sched = instruments.swap_fixed_leg(cfg, 0.025, 5.0)
    key = Key(cfg.seed).fold_in(4242)

    def berm(n, nb):
        r = bermudan.price_bermudan(cfg, key, market, sched, BERM_EX,
                                    n_paths=n, n_blocks=nb, device=dev)
        return torch.stack([r.price, r.price_cv, r.upper])

    calls = {
        f"price_bermudan@{BERM_PATHS}x{BERM_BLOCKS}":
            lambda: berm(BERM_PATHS, BERM_BLOCKS),
        f"price_bermudan@{cfg.n_paths}x1": lambda: berm(cfg.n_paths, 1),
        f"bermudan_vega_jvp@{BERM_PATHS}x{BERM_BLOCKS}":
            lambda: torch.stack(greeks.bermudan_vega(
                cfg, key, market, sched, BERM_EX, n_paths=BERM_PATHS,
                n_blocks=BERM_BLOCKS, device=dev)),
        "dp_oracle": lambda: bermudan.dp_oracle(cfg, market, sched, BERM_EX),
        f"price_cap@{cfg.n_paths}": lambda: instruments.price_cap(
            cfg, key, market, rate=0.02, tenor=4.0, device=dev).price,
        f"price_cms@{cfg.n_paths}": lambda: instruments.price_cms(
            cfg, key, market, rate=0.02, tenor=4.0, device=dev).price}
    first = {name: fn() for name, fn in calls.items()}
    walls = {name: [] for name in calls}
    hosts = {name: [] for name in calls}
    for _ in range(reps):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            hosts[name].append((t1 - t0) * 1e3)
            if name.startswith("price_bermudan"):
                check(torch.equal(out, first[name]), f"{name}: reruns "
                      "differ")
    print(f"[phase 7] price_bermudan reruns bitwise: "
          f"{[float(x) for x in first[f'price_bermudan@{cfg.n_paths}x1']]}")
    times = {}
    for name, fn in calls.items():
        t = times[name] = {
            "wall_ms": statistics.median(walls[name]),
            "wall_ms_min": min(walls[name]), "wall_ms_max": max(walls[name]),
            "host_ms": statistics.median(hosts[name])}
        line = (f"[phase 7] {name}: wall median {t['wall_ms']:.3f} ms "
                f"[{t['wall_ms_min']:.3f}, {t['wall_ms_max']:.3f}] over "
                f"{reps}, host {t['host_ms']:.3f} ms")
        if name != "dp_oracle":
            t["device_ms"], ops = _device_window(fn)
            t["device_ops"] = ops
            line += (f", device busy {t['device_ms']:.3f} ms, {ops:.0f} "
                     f"device ops ({t['host_ms'] * 1e3 / max(ops, 1):.1f} us "
                     f"of host each)")
        print(f"{line} per call [{smi}]")
    return times


def phase7(dev, smi):
    """The Bermudan swaption and the multi-date instruments (module
    docstring, phase 7); returns the kernels' launch counts of the whole
    phase."""
    import torch

    from hullwhite_tpu_torch import HWConfig
    from hullwhite_tpu_torch.kernels import fused

    cfg = HWConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    market, swaption, sweep, cap, cms = phase7_cli(cfg, dev)
    phase7_gates(swaption, sweep, cap, cms)
    phase7_direct(cfg, dev, market)
    phase7_card_vs_cpu(cfg, dev, market)
    times = phase7_times(cfg, dev, market, smi)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 7] times per call [{smi}]: " + json.dumps(times))
    print(f"[phase 7] peak device memory of the Bermudan/multi-date phase: "
          f"{peak:.2f} GiB [{smi}]; phase wall {time.perf_counter() - t0:.1f}"
          f" s")
    return fused.launch_counts()


# ---------------------------------------------------------------------------
# phase 8: calibration and the European half of G2++ (plain PyTorch on the
# card, no hand-written kernel on these calls; the closed forms and the
# calibrations in host float64)
# ---------------------------------------------------------------------------

# the card against the CPU on one key: float32 noise (the card's log1p, exp
# and sums against the CPU's); the curve at 2^15 paths, the ZBC at 2^16,
# the RQMC swaption at 2^16 points x 8 shifts.  Prices and the curve
# absolute; the MC SE relative; the RQMC SE (~2.6e-7, the spread of eight
# per-shift means ~0.07) absolute, ~3 float32 ulps of a mean
G2_CARD_CPU_TOL = dict(price=2e-7, curve=5e-7, se_rel=1e-3, qmc_se=2e-8)


def phase8_cli(cfg, dev):
    """On the fp64 oracle curve written as the q1 market: ``cli
    calibrate``, ``cli g2pp --validate 5``, ``cli grid --engine exact``
    and ``cli cms --g2`` at full width in a fresh directory; returns each
    command's JSON document."""
    from hullwhite_tpu_torch.utils import io as hwio

    argv = ["--device", str(dev), "--reps", "1"]
    cwd = os.getcwd()
    docs = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            hwio.save_market(cfg, analytic_market(cfg, dev))
            for name, cmd in (
                    ("calibration", ["calibrate"]),
                    ("g2pp", ["g2pp", "--validate", "5"]),
                    ("grid", ["grid", "--engine", "exact"]),
                    ("cms", ["cms", "--g2"])):
                _cli([*cmd, *argv], "phase 8")
                docs[name] = json.load(open(os.path.join(
                    "data_torch", f"{name}_results.json")))
        finally:
            os.chdir(cwd)
    return docs


def phase8_gates(cfg, docs):
    """The commands' results: the calibrations' recovery gates, g2pp's
    own gate and the swaptions against their oracle, the G2++ surfaces
    against their closed forms, the G2++ CMS against its quadrature."""
    import numpy as np

    r = docs["calibration"]["results"]
    print(f"[phase 8] cli calibrate: HW (a, sigma) = ({r['hw_a']:.8f}, "
          f"{r['hw_sigma']:.8f}) in {r['hw_iters']} iterations; G2++ "
          f"(sigma, eta, rho) = ({r['g2_sigma']:.8f}, {r['g2_eta']:.8f}, "
          f"{r['g2_rho']:.6f}) in {r['g2_iters']} iterations")
    check(abs(r["hw_a"] - cfg.a) < 1e-4 and abs(r["hw_sigma"] - cfg.sigma)
          < 1e-5, "Hull-White calibration recovery")
    check(abs(r["g2_sigma"] - 0.08) < 1e-5 and abs(r["g2_eta"] - 0.02)
          < 1e-5 and abs(r["g2_rho"] + 0.6) < 1e-3, "G2++ calibration "
          "recovery")

    r = docs["g2pp"]["results"]
    curve_tol = 6.0 * 0.15 / np.sqrt(2.0 * min(cfg.n_paths, 1 << 18)) + 5e-5
    zbc_d = abs(r["zbc_mc"] - r["zbc_closed"])
    zbc_tol = 5 * r["zbc_mc_se_raw"] + 2e-4
    v_tol = 5.0 * 0.174 / np.sqrt(cfg.n_paths) + 1e-3
    vq_tol = 0.02 * abs(r["zbc_vega_analytic"]) + 1e-4
    print(f"[phase 8] cli g2pp: curve max err {r['curve_max_err']:.2e} (tol "
          f"{curve_tol:.2e}); ZBC MC {r['zbc_mc']:.8f}, RQMC "
          f"{r['zbc_qmc']:.8f} +/- {r['zbc_qmc_se']:.1e}, closed "
          f"{r['zbc_closed']:.8f} (|MC - closed| {zbc_d:.2e}, tol "
          f"{zbc_tol:.2e}); vega CRN-FD {r['zbc_vega_fd']:.6f}, RQMC "
          f"{r['zbc_vega_rqmc']:.6f}, closed FD {r['zbc_vega_analytic']:.6f}"
          f" (tol {v_tol:.1e} / {vq_tol:.1e}); {cfg.n_paths}-path "
          f"validation z = {r['validation_z_vs_closed']:.2f}")
    check(r["curve_max_err"] < curve_tol and zbc_d < zbc_tol
          and abs(r["zbc_vega_fd"] - r["zbc_vega_analytic"]) < v_tol
          and abs(r["zbc_vega_rqmc"] - r["zbc_vega_analytic"]) < vq_tol,
          "cli g2pp's gate")
    for kind in ("receiver", "payer"):
        orc = r[f"swaption_{kind}_oracle"]
        mc, mc_se = r[f"swaption_{kind}_mc"], r[f"swaption_{kind}_mc_se_raw"]
        q, q_se = r[f"swaption_{kind}_rqmc"], r[f"swaption_{kind}_rqmc_se"]
        print(f"[phase 8] G2++ swaption {kind}: MC {mc:.8f} (raw SE "
              f"{mc_se:.2e}), RQMC {q:.8f} +/- {q_se:.1e}, oracle {orc:.8f}:"
              f" |MC - oracle| {abs(mc - orc):.2e} (tol 5 SE + 2e-4), "
              f"|RQMC - oracle| {abs(q - orc):.2e} (tol 6 SE + 5e-5)")
        check(abs(mc - orc) < 5 * mc_se + 2e-4, f"G2++ {kind} swaption MC")
        check(abs(q - orc) < 6 * q_se + 5e-5, f"G2++ {kind} swaption RQMC")
    print(f"[phase 8] G2++ exchange option: MC {r['exchange_mc']:.8f}, "
          f"closed form {r['exchange_closed']:.8f}")

    doc = docs["grid"]
    price, se, closed = (np.asarray(doc[k]) for k in
                         ("g2_price", "g2_std_error_raw", "g2_closed"))
    vega, vse, vfd = (np.asarray(doc[k]) for k in
                      ("g2_vega", "g2_vega_se", "g2_vega_closed_fd"))
    z = np.abs(price - closed) / (6 * se + 2e-4)
    zv = np.abs(vega - vfd) / (6 * vse + 5e-5)
    print(f"[phase 8] cli grid G2++ surface: max |MC - closed| "
          f"{np.abs(price - closed).max():.2e}, worst cell at "
          f"{z.max():.2f} of 6 SE + 2e-4; vega surface max |RQMC - FD| "
          f"{np.abs(vega - vfd).max():.2e}, worst at {zv.max():.2f} of "
          f"6 SE + 5e-5")
    check(price.shape == (5, 5) and bool((z < 1).all()), "G2++ surface")
    check(vega.shape == (5, 5) and bool((zv < 1).all()), "G2++ vega "
          "surface")

    g = docs["cms"]["results"]["g2"]
    print(f"[phase 8] cli cms --g2: MC {g['mc_price']:.8f} +/- "
          f"{g['mc_se']:.2e}, quadrature {g['quadrature']:.8f}, z = "
          f"{g['z']:.2f}")
    check(abs(g["z"]) < 4 or abs(g["mc_price"] - g["quadrature"]) < 2e-4,
          "G2++ CMS vs its quadrature")


def phase8_card_vs_cpu(cfg, dev, market):
    """``price_zbc_g2``, ``price_swaption_g2_qmc`` and
    ``bootstrap_curve_g2`` on the card and on the CPU under one key."""
    from hullwhite_tpu_torch import Key, instruments
    from hullwhite_tpu_torch.models import g2pp

    g = g2pp.G2Params()
    key = Key(cfg.seed).fold_in(9292)
    sched = instruments.swap_fixed_leg(cfg, 0.025, 5.0)
    tol = G2_CARD_CPU_TOL
    out = {}
    for d, m in ((dev, market), ("cpu", market.to("cpu"))):
        z = g2pp.price_zbc_g2(cfg, g, key, m, n_paths=1 << 16, device=d)
        q, qse = g2pp.price_swaption_g2_qmc(cfg, g, key, m, sched,
                                            device=d)
        c = g2pp.bootstrap_curve_g2(cfg, g, key, m, n_paths=1 << 15,
                                    device=d)
        out[str(d)] = ([float(z.price), float(z.price_raw), float(q)],
                       [float(z.std_error_raw), float(qse)], c.P.cpu())
    (pa, sa, ca), (pb, sb, cb) = out[str(dev)], out["cpu"]
    d_price = max(abs(x - y) for x, y in zip(pa, pb))
    d_se = abs(sa[0] - sb[0]) / sb[0]
    d_qse = abs(sa[1] - sb[1])
    d_curve = float((ca - cb).abs().max())
    print(f"[phase 8] card vs CPU: price_zbc_g2 at 2^16 (price, raw) and "
          f"price_swaption_g2_qmc at 2^16 x 8: {pa} vs {pb}, max |d| = "
          f"{d_price:.2e} (tol {tol['price']}); MC SE rel. d = {d_se:.2e} "
          f"(tol {tol['se_rel']}), RQMC SE {sa[1]:.4e} vs {sb[1]:.4e}, |d| "
          f"= {d_qse:.2e} (tol {tol['qmc_se']}); bootstrap_curve_g2 at "
          f"2^15: max |d| = {d_curve:.2e} (tol {tol['curve']})")
    check(d_price <= tol["price"] and d_se <= tol["se_rel"]
          and d_qse <= tol["qmc_se"] and d_curve <= tol["curve"],
          "G2++ on the card vs the CPU")


def phase8_times(cfg, dev, market, smi, reps=5):
    """Per call, after one warm call of each: the synchronised wall ms of
    ``reps`` rounds (median, least, most), the host ms until the call
    returns, the device-busy ms and device operations of one profiler
    window (``_device_window``); ``price_zbc_g2`` reruns bitwise."""
    import statistics

    import torch

    from hullwhite_tpu_torch import Key, instruments
    from hullwhite_tpu_torch.cli import grid_axes
    from hullwhite_tpu_torch.models import g2pp

    g = g2pp.G2Params()
    key = Key(cfg.seed).fold_in(9292)
    sched = instruments.swap_fixed_leg(cfg, 0.025, 5.0)
    sched3 = instruments.swap_fixed_leg(cfg, 0.03, 3.0)
    host_market = market.to("cpu")
    axes = grid_axes(cfg)

    def calibrate():
        m = host_market
        gp = [lambda p: g2pp.zbc_price_analytic(cfg, p, m),
              lambda p: g2pp.swaption_g2_analytic(cfg, p, m, sched),
              lambda p: g2pp.swaption_g2_analytic(cfg, p, m, sched3,
                                                  payer=True),
              lambda p: g2pp.cap_closed_form_g2(cfg, p, m, rate=0.02)[0]]
        g0 = g2pp.G2Params(sigma=0.16, eta=0.04, rho=0.3)
        return g2pp.calibrate_g2(cfg, g0, [(p, p(g)) for p in gp]).rmse

    calls = {
        f"price_zbc_g2@{cfg.n_paths}": lambda: torch.stack(
            g2pp.price_zbc_g2(cfg, g, key, market, device=dev)[:4]),
        f"bootstrap_curve_g2@{1 << 18}": lambda: g2pp.bootstrap_curve_g2(
            cfg, g, key, market, n_paths=1 << 18, device=dev).P,
        f"price_swaption_g2@{cfg.n_paths}": lambda: g2pp.price_swaption_g2(
            cfg, g, key, market, sched, device=dev).price,
        "price_zbc_g2_qmc@65536x8": lambda: torch.stack(
            g2pp.price_zbc_g2_qmc(cfg, g, key, market, device=dev)),
        "vega_zbc_g2_rqmc@65536x8": lambda: torch.stack(
            g2pp.vega_zbc_g2_rqmc(cfg, g, key, market, device=dev)),
        f"price_zbc_grid_g2@{cfg.n_paths}": lambda: g2pp.price_zbc_grid_g2(
            cfg, g, key, market, *axes, device=dev).price,
        f"price_cms_g2@{cfg.n_paths}": lambda: g2pp.price_cms_g2(
            cfg, g, key, market, rate=0.02, tenor=4.0, device=dev).price,
        "calibrate_g2": calibrate}
    first = {name: fn() for name, fn in calls.items()}
    walls = {name: [] for name in calls}
    hosts = {name: [] for name in calls}
    zbc = f"price_zbc_g2@{cfg.n_paths}"
    for _ in range(reps):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            hosts[name].append((t1 - t0) * 1e3)
            if name == zbc:
                check(torch.equal(out, first[name]), f"{name}: reruns "
                      "differ")
    print(f"[phase 8] price_zbc_g2 reruns bitwise: "
          f"{[float(x) for x in first[zbc]]}")
    times = {}
    for name, fn in calls.items():
        t = times[name] = {
            "wall_ms": statistics.median(walls[name]),
            "wall_ms_min": min(walls[name]), "wall_ms_max": max(walls[name]),
            "host_ms": statistics.median(hosts[name])}
        t["device_ms"], ops = _device_window(fn)
        t["device_ops"] = ops
        print(f"[phase 8] {name}: wall median {t['wall_ms']:.3f} ms "
              f"[{t['wall_ms_min']:.3f}, {t['wall_ms_max']:.3f}] over {reps}"
              f", host {t['host_ms']:.3f} ms, device busy "
              f"{t['device_ms']:.3f} ms, {ops:.0f} device ops "
              f"({t['host_ms'] * 1e3 / max(ops, 1):.1f} us of host each) "
              f"per call [{smi}]")
    return times


def phase8(dev, smi):
    """Calibration and the European half of G2++ (module docstring, phase
    8); returns the kernels' launch counts of the whole phase."""
    import torch

    from hullwhite_tpu_torch import HWConfig
    from hullwhite_tpu_torch.kernels import fused

    cfg = HWConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    docs = phase8_cli(cfg, dev)
    phase8_gates(cfg, docs)
    market = analytic_market(cfg, dev)
    phase8_card_vs_cpu(cfg, dev, market)
    times = phase8_times(cfg, dev, market, smi)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 8] times per call [{smi}]: " + json.dumps(times))
    print(f"[phase 8] peak device memory of the calibration/G2++ phase: "
          f"{peak:.2f} GiB [{smi}]; phase wall {time.perf_counter() - t0:.1f}"
          f" s")
    return fused.launch_counts()


# ---------------------------------------------------------------------------
# phase 9: the G2++ Bermudan (closed-form dual proxy, fp64 2-d DP oracle,
# vega, curve delta) and the backward-looking RFR caps, plain PyTorch on
# the card (no hand-written kernel on these calls) and host float64 oracles
# ---------------------------------------------------------------------------

G2B_EX3 = (5.0, 6.0, 7.0)
G2B_EX5 = (5.0, 6.0, 7.0, 8.0, 9.0)
# the reference's own float32 evaluation floor on the k = 3 bracket
G2B_EVAL_FLOOR = 3.4e-6
# the DP oracle's grid for the bracket gates: the default (121, 48) grid is
# biased by ~+6e-6 at k = 3 and ~-6e-6 at k = 5 against (481, 96) (CPU
# measurement), (241, 64) is within 1.6e-6 and 5e-8
G2B_DP_GRID = dict(n_grid=241, n_quad=64)
# vega and delta at 2^17 paths
G2B_GREEK_PATHS = 1 << 17
# the card against the CPU on one key at 2^12 paths, k = 2: the lower bound
# absolute (its policy reads the fitted chain only through its sign
# tests); the upper and CV lower, which rest on the chain fitted by float32
# QR (cuSOLVER against LAPACK), within half their SE; the RFR caps'
# prices absolute (float32 noise)
G2B_CARD_CPU_TOL = dict(lower=1e-6, se_frac=0.5, rfr=2e-7)


def phase9_cli(cfg, dev):
    """On the fp64 oracle curve written as the q1 market: ``cli g2pp``
    (with its Bermudan at the CLI defaults), ``cli rfr --g2``, ``cli rfr
    --g2 --averaged`` and ``cli rfr --g2 --rqmc`` at full width in a fresh
    directory; returns the g2pp results and each rfr run's results."""
    from hullwhite_tpu_torch.utils import io as hwio

    argv = ["--device", str(dev), "--reps", "1"]
    cwd = os.getcwd()
    rfr_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            def results(name):
                return json.load(open(os.path.join("data_torch",
                                                   name)))["results"]

            hwio.save_market(cfg, analytic_market(cfg, dev))
            _cli(["g2pp", *argv], "phase 9")
            g2 = results("g2pp_results.json")
            for extra in ([], ["--averaged"], ["--rqmc"]):
                _cli(["rfr", "--g2", *extra, *argv], "phase 9")
                rfr_runs[" ".join(["--g2", *extra])] = results(
                    "rfr_results.json")
        finally:
            os.chdir(cwd)
    return g2, rfr_runs


def phase9_rfr_gates(rfr_runs):
    """Every MC / RQMC cap and floor within 5 SE + 1e-6 of its closed form,
    the jvp vega within 1% of the closed form's FD."""
    for name, r in rfr_runs.items():
        for kind in ("cap", "floor", "g2_cap", "g2_floor"):
            x = r[kind]
            d = abs(x["mc"] - x["closed_form"])
            tol = 5 * x["se"] + 1e-6
            print(f"[phase 9] cli rfr {name} {kind}: MC {x['mc']:.8f} +/- "
                  f"{x['se']:.2e}, closed form {x['closed_form']:.8f}, |d| "
                  f"{d:.2e} (tol {tol:.2e})")
            check(d <= tol, f"cli rfr {name} {kind} vs its closed form")
        v, va = r["vega_jvp"], r["vega_closed_fd"]
        print(f"[phase 9] cli rfr {name} vega: jvp {v:.6f}, closed-form FD "
              f"{va:.6f}")
        check(abs(v - va) <= 0.01 * abs(va), f"cli rfr {name} vega")


def phase9_bermudan(cfg, dev, market, g2doc):
    """price_bermudan_g2 at k = 3 and k = 5 (2^20 paths) against the DP
    oracle; the k = 5 call on cli g2pp's key equals the CLI's bracket;
    vega (k = 1) and curve delta (k = 3) at 2^17 against their oracles.
    Returns the k = 5 bracket (the timings' warm call)."""
    import torch

    from hullwhite_tpu_torch import Key, greeks, instruments
    from hullwhite_tpu_torch.models import g2pp

    g = g2pp.G2Params()
    key = Key(cfg.seed).fold_in(9292)      # cli g2pp's key
    sched = instruments.swap_fixed_leg(cfg, 0.025, 5.0)
    host = market.to("cpu")
    out = {}
    for ex in (G2B_EX3, G2B_EX5):
        t0 = time.perf_counter()
        r = g2pp.price_bermudan_g2(cfg, g, key, market, sched, ex,
                                   device=dev)
        vals = torch.stack([r.price, r.price_cv, r.upper, r.std_error,
                            r.cv_std_error, r.upper_std_error]).tolist()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        dp = g2pp.dp_oracle_g2(cfg, g, host, sched, ex, **G2B_DP_GRID)
        dp_wall = time.perf_counter() - t0
        lo, cv, up, se, cv_se, up_se = vals
        k = len(ex)
        print(f"[phase 9] price_bermudan_g2 k = {k} at {cfg.n_paths} paths "
              f"({wall:.1f} s): lower {lo:.8f} +/- {se:.2e}, CV lower "
              f"{cv:.8f} +/- {cv_se:.2e}, upper {up:.8f} +/- {up_se:.2e}; "
              f"DP ({G2B_DP_GRID['n_grid']} x {G2B_DP_GRID['n_quad']}, "
              f"{dp_wall:.1f} s) {dp:.8f}: CV - DP {cv - dp:+.2e} (tol 4 SE "
              f"+ {G2B_EVAL_FLOOR} = {4 * cv_se + G2B_EVAL_FLOOR:.2e}), "
              f"DP - upper {dp - up:+.2e} (tol "
              f"{4 * up_se + G2B_EVAL_FLOOR:.2e})")
        check(cv <= dp + 4 * cv_se + G2B_EVAL_FLOOR, f"k = {k}: CV lower "
              "above the DP oracle")
        check(up >= dp - 4 * up_se - G2B_EVAL_FLOOR, f"k = {k}: upper "
              "below the DP oracle")
        check(cv_se < se / 10.0, f"k = {k}: the CV SE did not collapse")
        out[k] = vals
    lo, cv, up = out[5][:3]
    cli_vals = (g2doc["bermudan_lower"], g2doc["bermudan_lower_cv"],
                g2doc["bermudan_upper"])
    print(f"[phase 9] cli g2pp Bermudan (lower, CV, upper) {cli_vals} vs "
          f"the direct call on its key {(lo, cv, up)}")
    check(cli_vals == (lo, cv, up), "cli g2pp's bracket differs from "
          "price_bermudan_g2 on its key")

    # vega (k = 1) against the fp64 FD of the European oracle, as
    # tests/test_g2pp.py gates it; delta (k = 3) against the DP oracle's
    # FD on the shifted curves (its coarse grid, as the JAX test)
    e = 1e-4
    vref = (g2pp.swaption_g2_analytic(cfg, g.bump_sigma(e), host, sched)
            - g2pp.swaption_g2_analytic(cfg, g.bump_sigma(-e), host,
                                        sched)) / (2.0 * e)
    t0 = time.perf_counter()
    vlo, vup = g2pp.vega_bermudan_g2(cfg, g, key, market, sched, [5.0],
                                     n_paths=G2B_GREEK_PATHS, device=dev)
    print(f"[phase 9] vega_bermudan_g2 k = 1 at {G2B_GREEK_PATHS} paths "
          f"({time.perf_counter() - t0:.1f} s): lower {vlo:.6f}, upper "
          f"{vup:.6f}, European oracle FD {vref:.6f} (tol 2e-2 / 5e-4)")
    check(abs(vup - vref) < 5e-4 and abs(vlo - vref) < 2e-2,
          "vega_bermudan_g2 vs the European oracle")
    h = 1e-3
    t0 = time.perf_counter()
    dl, du = g2pp.delta_bermudan_g2(cfg, g, key, market, sched, G2B_EX3,
                                    n_paths=G2B_GREEK_PATHS, h=h,
                                    device=dev)
    wall = time.perf_counter() - t0
    dp = (g2pp.dp_oracle_g2(cfg, g, greeks.shift_curve(cfg, host, +h),
                            sched, G2B_EX3)
          - g2pp.dp_oracle_g2(cfg, g, greeks.shift_curve(cfg, host, -h),
                              sched, G2B_EX3)) / (2 * h)
    print(f"[phase 9] delta_bermudan_g2 k = 3 at {G2B_GREEK_PATHS} paths "
          f"({wall:.1f} s): lower {dl:.6f}, upper {du:.6f}, DP FD {dp:.6f}"
          f" (tol 3e-2 / 1e-2 relative)")
    check(abs(du - dp) < 1e-2 * abs(dp) and abs(dl - dp) < 3e-2 * abs(dp),
          "delta_bermudan_g2 vs the DP oracle's FD")
    return out[5]


def phase9_card_vs_cpu(cfg, dev, market):
    """price_bermudan_g2 (k = 2, 2^12 paths) and the RFR caps on the card
    and on the CPU under one key."""
    from hullwhite_tpu_torch import Key, instruments, rfr
    from hullwhite_tpu_torch.models import g2pp

    g = g2pp.G2Params()
    key = Key(cfg.seed).fold_in(9292)
    sched = instruments.swap_fixed_leg(cfg, 0.025, 5.0)
    tol = G2B_CARD_CPU_TOL
    got = {}
    for d, m in ((dev, market), ("cpu", market.to("cpu"))):
        r = g2pp.price_bermudan_g2(cfg, g, key, m, sched, (5.0, 6.0),
                                   n_paths=1 << 12, device=d)
        caps = [float(rfr.price_rfr_cap(cfg, key, m, strike=0.02,
                                        n_paths=1 << 14, device=d).price),
                float(rfr.price_rfr_cap_g2(cfg, g, key, m, strike=0.02,
                                           style="averaged",
                                           n_paths=1 << 14,
                                           device=d).price)]
        got[str(d)] = ([float(r.price), float(r.price_cv), float(r.upper)],
                       [float(r.std_error), float(r.cv_std_error),
                        float(r.upper_std_error)], caps)
    (pa, sa, ca), (pb, sb, cb) = got[str(dev)], got["cpu"]
    d = [abs(x - y) for x, y in zip(pa, pb)]
    d_rfr = max(abs(x - y) for x, y in zip(ca, cb))
    print(f"[phase 9] card vs CPU: price_bermudan_g2 k = 2 at 2^12 (lower, "
          f"CV, upper) {pa} vs {pb}: |d| {[f'{x:.2e}' for x in d]} (tol "
          f"{tol['lower']}, {tol['se_frac']} CV SE {sb[1]:.2e}, "
          f"{tol['se_frac']} upper SE {sb[2]:.2e}); price_rfr_cap and "
          f"price_rfr_cap_g2 (averaged) at 2^14 {ca} vs {cb}: max |d| "
          f"{d_rfr:.2e} (tol {tol['rfr']})")
    check(d[0] <= tol["lower"] and d[1] <= tol["se_frac"] * sb[1]
          and d[2] <= tol["se_frac"] * sb[2] and d_rfr <= tol["rfr"],
          "the G2++ Bermudan and the RFR caps on the card vs the CPU")


def phase9_times(cfg, dev, market, smi, first5, reps=2):
    """Per call: the synchronised wall ms of ``reps`` rounds (median,
    least, most; the Bermudan's warm call is phase9_bermudan's), the host
    ms until the call returns, the device-busy ms and device operations of
    one profiler window (``_device_window``; ``dp_oracle_g2``: host wall
    only); the k = 5 Bermudan reruns bitwise."""
    import statistics

    import torch

    from hullwhite_tpu_torch import Key, instruments, rfr
    from hullwhite_tpu_torch.models import g2pp

    g = g2pp.G2Params()
    key = Key(cfg.seed).fold_in(9292)
    sched = instruments.swap_fixed_leg(cfg, 0.025, 5.0)
    host = market.to("cpu")

    def berm(ex):
        r = g2pp.price_bermudan_g2(cfg, g, key, market, sched, ex,
                                   device=dev)
        return torch.stack([r.price, r.price_cv, r.upper, r.std_error,
                            r.cv_std_error, r.upper_std_error])

    k5 = f"price_bermudan_g2@{cfg.n_paths}xk5"
    calls = {
        k5: lambda: berm(G2B_EX5),
        f"price_bermudan_g2@{cfg.n_paths}xk3": lambda: berm(G2B_EX3),
        "dp_oracle_g2@k5": lambda: g2pp.dp_oracle_g2(cfg, g, host, sched,
                                                     G2B_EX5),
        f"price_rfr_cap@{cfg.n_paths}": lambda: rfr.price_rfr_cap(
            cfg, key, market, strike=0.02, device=dev).price,
        f"price_rfr_cap_averaged@{cfg.n_paths}": lambda: rfr.price_rfr_cap(
            cfg, key, market, strike=0.02, style="averaged",
            device=dev).price,
        f"vega_rfr_cap@{cfg.n_paths}": lambda: torch.stack(rfr.vega_rfr_cap(
            cfg, key, market, strike=0.02, device=dev)),
        f"price_rfr_cap_g2@{cfg.n_paths}": lambda: rfr.price_rfr_cap_g2(
            cfg, g, key, market, strike=0.02, device=dev).price,
        f"price_rfr_cap_rqmc@{cfg.n_paths // 8}x8": lambda:
            rfr.price_rfr_cap(cfg, key, market, strike=0.02, rqmc=True,
                              n_blocks=8, n_paths=cfg.n_paths // 8,
                              device=dev).price}
    walls = {name: [] for name in calls}
    hosts = {name: [] for name in calls}
    for name, fn in calls.items():
        if not name.startswith("price_bermudan"):
            fn()                                # warm call
    for _ in range(reps):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            hosts[name].append((t1 - t0) * 1e3)
            if name == k5:
                check(out.tolist() == first5, f"{name}: reruns differ")
    print(f"[phase 9] price_bermudan_g2 k = 5 reruns bitwise: {first5}")
    times = {}
    for name, fn in calls.items():
        t = times[name] = {
            "wall_ms": statistics.median(walls[name]),
            "wall_ms_min": min(walls[name]), "wall_ms_max": max(walls[name]),
            "host_ms": statistics.median(hosts[name])}
        line = (f"[phase 9] {name}: wall median {t['wall_ms']:.3f} ms "
                f"[{t['wall_ms_min']:.3f}, {t['wall_ms_max']:.3f}] over "
                f"{reps}, host {t['host_ms']:.3f} ms")
        if not name.startswith("dp_oracle"):
            t["device_ms"], ops = _device_window(fn)
            t["device_ops"] = ops
            line += (f", device busy {t['device_ms']:.3f} ms, {ops:.0f} "
                     f"device ops ({t['host_ms'] * 1e3 / max(ops, 1):.1f} us "
                     f"of host each)")
        print(f"{line} per call [{smi}]")
    return times


def phase9(dev, smi):
    """The G2++ Bermudan and the RFR caps (module docstring, phase 9);
    returns the kernels' launch counts of the whole phase."""
    import torch

    from hullwhite_tpu_torch import HWConfig
    from hullwhite_tpu_torch.kernels import fused

    cfg = HWConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    g2doc, rfr_runs = phase9_cli(cfg, dev)
    phase9_rfr_gates(rfr_runs)
    market = analytic_market(cfg, dev)
    first5 = phase9_bermudan(cfg, dev, market, g2doc)
    phase9_card_vs_cpu(cfg, dev, market)
    times = phase9_times(cfg, dev, market, smi, first5)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 9] times per call [{smi}]: " + json.dumps(times))
    print(f"[phase 9] peak device memory of the G2++ Bermudan/RFR phase: "
          f"{peak:.2f} GiB [{smi}]; phase wall {time.perf_counter() - t0:.1f}"
          f" s")
    return fused.launch_counts()


# ---------------------------------------------------------------------------
# phase 10: the Hull-White note layer (the puttable range note, the TARN,
# the callable capped floater, the snowball and the callable snowball),
# plain PyTorch on the card (no hand-written kernel on these calls) and
# host float64 DP oracles
# ---------------------------------------------------------------------------

NOTE_KW = dict(coupon=0.03, lo=0.010, hi=0.022, tenor=3.0, obs_per_period=5)
TARN_KW = dict(coupon=0.03, lo=0.005, hi=0.03, target=0.055, tenor=4.0)
SNOWBALL_KW = dict(initial=0.02, spread=0.013, cap=0.06, floor=0.0,
                   tenor=4.0)                     # cli notes' defaults
FLOATER_KW = dict(cap=0.016, floor=0.0, spread=0.004, tenor=3.0)
# the note vega at 2^16 paths; its SE from 16 independent replicates of
# 2^12 paths (the same total) under the frozen DP boundary
NOTE_VEGA_PATHS = 1 << 16
NOTE_VEGA_REPS = 16
# RQMC snowball: 2^16 points x 8 shifts
SNOWBALL_RQMC = (1 << 16, 8)
# the card against the CPU on one key at 2^14 paths: prices within 0.1 SE
NOTES_CARD_CPU_PATHS = 1 << 14
NOTES_CARD_CPU_SE_FRAC = 0.1


# the G2++ DP oracles inside phase 10's ``cli notes`` run: (61, 21, 8),
# n_c = 21, whatever grid the command asks for (its defaults, up to
# (161, 61, 41, 16), take ~13 minutes of host time over its 11 oracles)
G2_SMALL_GRID = dict(n_u=61, n_w=21, n_quad=8)
G2_CLI_GRID = {"dp_oracle_snowball_g2": dict(G2_SMALL_GRID, n_c=21),
               "dp_oracle_callable_snowball_g2": dict(G2_SMALL_GRID, n_c=21),
               "dp_oracle_capped_floater_g2": G2_SMALL_GRID}
G2_NOTE_KEYS = ("snowball_g2", "callable_snowball_g2", "capped_floater_g2")


def _forced_grid(fn, grid):
    def call(*args, **kw):
        return fn(*args, **{**kw, **grid})
    return call


def phase10_cli(cfg, dev):
    """``cli q1 --engine exact``, then on its curve ``cli notes`` at full
    width in a fresh directory, its G2++ DP oracles on ``G2_CLI_GRID``;
    returns the q1 market and the notes results."""
    from hullwhite_tpu_torch import g2_note
    from hullwhite_tpu_torch.utils import io as hwio

    argv = ["--device", str(dev), "--reps", "1"]
    cwd = os.getcwd()
    saved = {name: getattr(g2_note, name) for name in G2_CLI_GRID}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            _cli(["q1", "--engine", "exact", *argv], "phase 10")
            market = hwio.load_market(cfg, device=dev)
            for name, grid in G2_CLI_GRID.items():
                setattr(g2_note, name, _forced_grid(saved[name], grid))
            text = _cli(["notes", *argv], "phase 10")
            doc = json.load(open(os.path.join("data_torch",
                                              "notes_results.json")))
        finally:
            for name, fn in saved.items():
                setattr(g2_note, name, fn)
            os.chdir(cwd)
    check(text.count("(PASS)") == 6 and "CHECK" not in text,
          "cli notes: an agreement line is not PASS")
    check("not ported" not in text
          and all(k in doc["results"] for k in G2_NOTE_KEYS),
          "cli notes: the G2++ half did not run")
    return market, doc["results"]


def phase10_direct(cfg, dev, market, smi):
    """The range note and the TARN (m = 1) at 2^20 paths within 4 SE or
    2e-4 of their DP oracles, the note vega at 2^16 within 3 SE of the
    DP's central difference, the RQMC snowball at 2^16 x 8 within 5 SE +
    1e-6 of its DP with an SE below the MC's at the same paths.  Returns
    the DP results (the policies the timings reuse) and each oracle's host
    wall."""
    import numpy as np

    from hullwhite_tpu_torch import Key, floater, range_note, snowball

    key = Key(cfg.seed).fold_in(77121)              # cli notes' key
    host = market.to("cpu")
    dps, dp_wall = {}, {}
    for name, fn, kw in (
            ("dp_oracle_range_note", range_note.dp_oracle_range_note,
             NOTE_KW),
            ("dp_oracle_tarn", range_note.dp_oracle_tarn, TARN_KW),
            ("dp_oracle_capped_floater", floater.dp_oracle_capped_floater,
             FLOATER_KW),
            ("dp_oracle_snowball", snowball.dp_oracle_snowball,
             SNOWBALL_KW),
            ("dp_oracle_callable_snowball",
             snowball.dp_oracle_callable_snowball, SNOWBALL_KW)):
        t0 = time.perf_counter()
        dps[name] = fn(cfg, host, **kw)
        dp_wall[name] = (time.perf_counter() - t0) * 1e3
        print(f"[phase 10] {name}: {dps[name].price:.8f} (host wall "
              f"{dp_wall[name]:.1f} ms) [{smi}]")

    note_dp = dps["dp_oracle_range_note"]
    r = range_note.price_range_note(cfg, key, market,
                                    boundaries=note_dp.boundaries,
                                    device=dev, **NOTE_KW)
    t = range_note.price_tarn(cfg, key, market, device=dev, **TARN_KW)
    tarn_dp = dps["dp_oracle_tarn"]
    for name, res, dpv in (("price_range_note", r, note_dp.price),
                           ("price_tarn (m = 1)", t, tarn_dp.price)):
        p, se = float(res.price), float(res.std_error)
        z = (p - dpv) / max(se, 1e-12)
        print(f"[phase 10] {name} at {cfg.n_paths} paths: {p:.8f} +/- "
              f"{se:.2e}, DP {dpv:.8f}: z = {z:+.2f} (gate |z| < 4 or |d| "
              f"< 2e-4)")
        check(abs(z) < 4 or abs(p - dpv) < 2e-4, f"{name} vs its DP oracle")
    ko = float(t.ko_fraction)
    print(f"[phase 10] TARN knockout fraction {ko:.5f}, DP "
          f"{tarn_dp.ko_prob:.5f}; range note put fraction "
          f"{float(r.put_fraction):.5f}")

    v = range_note.vega_range_note(cfg, key, market,
                                   n_paths=NOTE_VEGA_PATHS, device=dev,
                                   **NOTE_KW)
    n_rep = NOTE_VEGA_PATHS // NOTE_VEGA_REPS
    reps = []
    for i in range(NOTE_VEGA_REPS):
        k = key.fold_in(1000 + i)
        pm, pp = (range_note.price_range_note(
            cfg, k, market, sigma=cfg.sigma + sgn * v.epsilon,
            boundaries=note_dp.boundaries, n_paths=n_rep, device=dev,
            **NOTE_KW).price for sgn in (-1.0, 1.0))
        reps.append(float(pp - pm) / (2.0 * v.epsilon))
    se_v = float(np.std(reps, ddof=1)) / math.sqrt(NOTE_VEGA_REPS)
    d = float(v.vega) - v.dp_vega
    print(f"[phase 10] vega_range_note at {NOTE_VEGA_PATHS} paths: CRN-FD "
          f"{float(v.vega):.6f}, DP FD {v.dp_vega:.6f}, |d| {abs(d):.2e} "
          f"(SE {se_v:.2e} from {NOTE_VEGA_REPS} replicates of {n_rep}, "
          f"replicate mean {float(np.mean(reps)):.6f}; gate 3 SE)")
    check(abs(d) <= 3 * se_v, "vega_range_note vs the DP's central "
          "difference")

    sb_dp = dps["dp_oracle_snowball"]
    n_pts, n_sh = SNOWBALL_RQMC
    rq = snowball.price_snowball(cfg, key, market, n_paths=n_pts,
                                 n_blocks=n_sh, rqmc=True, device=dev,
                                 **SNOWBALL_KW)
    mc = snowball.price_snowball(cfg, key, market, n_paths=n_pts,
                                 n_blocks=n_sh, device=dev, **SNOWBALL_KW)
    p, se, mse = float(rq.price), float(rq.std_error), float(mc.std_error)
    print(f"[phase 10] price_snowball RQMC at {n_pts} x {n_sh}: {p:.8f} +/- "
          f"{se:.2e} (MC SE at the same paths {mse:.2e}), DP "
          f"{sb_dp.price:.8f}: |d| {abs(p - sb_dp.price):.2e} (tol 5 SE + "
          f"1e-6 = {5 * se + 1e-6:.2e})")
    check(abs(p - sb_dp.price) <= 5 * se + 1e-6 and se < mse,
          "price_snowball(rqmc=True) vs its DP oracle")
    return dps, dp_wall


def _note_calls(cfg, key, market, dps, dev, n_paths=None):
    """The five price_* calls under the DP policies: name -> fn returning
    a tensor of (price, SE, the put / knockout / call fraction or the mean
    final coupon)."""
    import torch

    from hullwhite_tpu_torch import floater, range_note, snowball

    cdp = dps["dp_oracle_callable_snowball"]

    def stack(res, third):
        return torch.stack([res.price, res.std_error, getattr(res, third)])

    return {
        "price_range_note": lambda: stack(range_note.price_range_note(
            cfg, key, market, n_paths=n_paths,
            boundaries=dps["dp_oracle_range_note"].boundaries, device=dev,
            **NOTE_KW), "put_fraction"),
        "price_tarn": lambda: stack(range_note.price_tarn(
            cfg, key, market, n_paths=n_paths, device=dev, **TARN_KW),
            "ko_fraction"),
        "price_capped_floater": lambda: stack(floater.price_capped_floater(
            cfg, key, market, n_paths=n_paths,
            boundaries=dps["dp_oracle_capped_floater"].boundaries,
            device=dev, **FLOATER_KW), "call_fraction"),
        "price_snowball": lambda: stack(snowball.price_snowball(
            cfg, key, market, n_paths=n_paths, device=dev, **SNOWBALL_KW),
            "mean_final_coupon"),
        "price_callable_snowball": lambda: stack(
            snowball.price_callable_snowball(
                cfg, key, market, n_paths=n_paths,
                boundaries=cdp.boundaries, c_grid=cdp.c_grid,
                plain_mean=cdp.plain_price, device=dev, **SNOWBALL_KW),
            "call_fraction")}


def phase10_card_vs_cpu(cfg, dev, market, dps):
    """Each price_* at 2^14 paths on the card and on the CPU under one key:
    prices within 0.1 SE."""
    from hullwhite_tpu_torch import Key

    key = Key(cfg.seed).fold_in(77121)
    got = {}
    for d, m in ((dev, market), ("cpu", market.to("cpu"))):
        got[str(d)] = {name: fn().tolist() for name, fn in _note_calls(
            cfg, key, m, dps, d, n_paths=NOTES_CARD_CPU_PATHS).items()}
    for name, (p, se, x) in got["cpu"].items():
        pc, _, xc = got[str(dev)][name]
        print(f"[phase 10] card vs CPU: {name} at {NOTES_CARD_CPU_PATHS} "
              f"paths: {pc:.8f} vs {p:.8f}, |d| {abs(pc - p):.2e} (tol "
              f"{NOTES_CARD_CPU_SE_FRAC} SE = "
              f"{NOTES_CARD_CPU_SE_FRAC * se:.2e}); third field {xc} vs {x}")
        check(abs(pc - p) <= NOTES_CARD_CPU_SE_FRAC * se,
              f"{name} on the card vs the CPU")


def _note_times(calls, cfg, smi, dp_wall, tag, reps=3):
    """Per price_* call at 2^20 paths under the DP policies, after one warm
    call: the synchronised wall ms of ``reps`` rounds (median, least,
    most), the host ms until the call returns, the device-busy ms and
    device operations of one profiler window; every rerun bitwise equal to
    the warm call.  The DP oracles' host walls come from the caller."""
    import statistics

    import torch

    first = {name: fn() for name, fn in calls.items()}
    walls = {name: [] for name in calls}
    hosts = {name: [] for name in calls}
    for _ in range(reps):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            hosts[name].append((t1 - t0) * 1e3)
            check(torch.equal(out, first[name]), f"{name}: reruns differ")
    print(f"[{tag}] price_* reruns bitwise: "
          + str({name: out.tolist() for name, out in first.items()}))
    times = {}
    for name, fn in calls.items():
        t = times[f"{name}@{cfg.n_paths}"] = {
            "wall_ms": statistics.median(walls[name]),
            "wall_ms_min": min(walls[name]), "wall_ms_max": max(walls[name]),
            "host_ms": statistics.median(hosts[name])}
        t["device_ms"], ops = _device_window(fn)
        t["device_ops"] = ops
        print(f"[{tag}] {name}@{cfg.n_paths}: wall median "
              f"{t['wall_ms']:.3f} ms [{t['wall_ms_min']:.3f}, "
              f"{t['wall_ms_max']:.3f}] over {reps}, host "
              f"{t['host_ms']:.3f} ms, device busy {t['device_ms']:.3f} ms, "
              f"{ops:.0f} device ops ({t['host_ms'] * 1e3 / max(ops, 1):.1f} "
              f"us of host each) per call [{smi}]")
    for name, ms in dp_wall.items():
        times[name] = {"host_wall_ms": ms}
    return times


def phase10(dev, smi):
    """The Hull-White note layer (module docstring, phase 10); returns the
    kernels' launch counts of the whole phase."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key
    from hullwhite_tpu_torch.kernels import fused

    cfg = HWConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    market, notes = phase10_cli(cfg, dev)
    for name, r in notes.items():
        gap = (f"z = {r['z']:+.2f}" if "z" in r
               else f"|d| = {abs(r['mc_price'] - r['dp_price']):.2e}")
        print(f"[phase 10] cli notes {name}: MC {r['mc_price']:.8f} +/- "
              f"{r['mc_se']:.2e}, DP {r['dp_price']:.8f}, {gap}; "
              f"vega CRN-FD {r['vega_crn_fd']:.6f}, DP FD "
              f"{r['vega_dp_fd']:.6f}")
    dps, dp_wall = phase10_direct(cfg, dev, market, smi)
    phase10_card_vs_cpu(cfg, dev, market, dps)
    times = _note_times(_note_calls(cfg, Key(cfg.seed).fold_in(77121),
                                    market, dps, dev),
                        cfg, smi, dp_wall, "phase 10")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 10] times per call [{smi}]: " + json.dumps(times))
    print(f"[phase 10] peak device memory of the note phase: {peak:.2f} GiB "
          f"[{smi}]; phase wall {time.perf_counter() - t0:.1f} s")
    return fused.launch_counts(), market

# ---------------------------------------------------------------------------
# phase 11: the G2++ note layer (the puttable range note, the TARN, the
# callable capped floater, the snowball and the callable snowball under
# G2++), plain PyTorch on the card (no hand-written kernel on these calls)
# and host float64 (u, w[, c]) DP oracles
# ---------------------------------------------------------------------------

# the DP oracles' grids (n_u, n_w, n_quad[, n_c]): (61, 21, 8) where the
# gate is 2e-4 or 5e-4 absolute (their bias against the (121, 41, 12)
# grid: 1.3e-5 to 3.9e-5, CPU); the snowball's at its default (161, 61,
# 41, 16), the one grid within the RQMC gate's 5 SE + 1e-6 (~6.5e-6) of
# the RQMC price: its errors at (61, 21, 21, 8) / (81, 31, 41, 10) /
# (121, 41, 41, 12) are +3.4e-5 / -7.4e-6 / +1.3e-5, at the default
# +3.1e-6 (CPU, the fp64 oracle curve).  The note's grid also serves the
# vega's three DPs.
G2_DP_GRIDS = {"dp_oracle_range_note_g2": G2_SMALL_GRID,
               "dp_oracle_tarn_g2": G2_SMALL_GRID,
               "dp_oracle_capped_floater_g2": G2_SMALL_GRID,
               "dp_oracle_snowball_g2": dict(n_u=161, n_w=61, n_c=41,
                                             n_quad=16),
               "dp_oracle_callable_snowball_g2": dict(G2_SMALL_GRID,
                                                      n_c=21)}
G2_DP_KW = {"dp_oracle_range_note_g2": NOTE_KW,
            "dp_oracle_tarn_g2": TARN_KW,
            "dp_oracle_capped_floater_g2": FLOATER_KW,
            "dp_oracle_snowball_g2": SNOWBALL_KW,
            "dp_oracle_callable_snowball_g2": SNOWBALL_KW}


def phase11_direct(cfg, dev, g, market, smi):
    """The five G2++ estimators at 2^20 paths against their DP oracles (4
    SE or 2e-4; the callable snowball 5e-4), the note vega at 2^16 within
    3 SE of the DP's central difference, the RQMC snowball at 2^16 x 8
    within 5 SE + 1e-6 of its DP with an SE below the MC's.  Returns the DP
    results and each oracle's host wall."""
    import numpy as np

    from hullwhite_tpu_torch import Key, g2_note

    key = Key(cfg.seed).fold_in(77121)
    host = market.to("cpu")
    dps, dp_wall = {}, {}
    for name, grid in G2_DP_GRIDS.items():
        t0 = time.perf_counter()
        dps[name] = getattr(g2_note, name)(cfg, g, host, **G2_DP_KW[name],
                                           **grid)
        dp_wall[name] = (time.perf_counter() - t0) * 1e3
        print(f"[phase 11] {name} {grid}: {dps[name].price:.8f} (host wall "
              f"{dp_wall[name]:.1f} ms) [{smi}]")

    calls = _g2_note_calls(cfg, key, market, dps, dev)
    for name, dp_name, third in (
            ("price_range_note_g2", "dp_oracle_range_note_g2",
             "put fraction"),
            ("price_tarn_g2", "dp_oracle_tarn_g2", "knockout fraction"),
            ("price_capped_floater_g2", "dp_oracle_capped_floater_g2",
             "call fraction"),
            ("price_snowball_g2", "dp_oracle_snowball_g2",
             "mean final coupon"),
            ("price_callable_snowball_g2", "dp_oracle_callable_snowball_g2",
             "call fraction")):
        p, se, x = calls[name]().tolist()
        dpv = dps[dp_name].price
        z = (p - dpv) / max(se, 1e-12)
        if name == "price_callable_snowball_g2":
            ok, gate = abs(p - dpv) < 5e-4, "|d| < 5e-4"
        else:
            ok, gate = abs(z) < 4 or abs(p - dpv) < 2e-4, \
                "|z| < 4 or |d| < 2e-4"
        print(f"[phase 11] {name} at {cfg.n_paths} paths: {p:.8f} +/- "
              f"{se:.2e}, DP {dpv:.8f}: z = {z:+.2f}, |d| {abs(p - dpv):.2e} "
              f"(gate {gate}); {third} {x:.5f}")
        check(ok, f"{name} vs its DP oracle")
    print(f"[phase 11] TARN knockout probability (DP) "
          f"{dps['dp_oracle_tarn_g2'].ko_prob:.5f}")

    grid = G2_DP_GRIDS["dp_oracle_range_note_g2"]
    note_dp = dps["dp_oracle_range_note_g2"]
    v = g2_note.vega_range_note_g2(cfg, g, key, market,
                                   n_paths=NOTE_VEGA_PATHS, dp_kwargs=grid,
                                   device=dev, **NOTE_KW)
    n_rep = NOTE_VEGA_PATHS // NOTE_VEGA_REPS
    reps = []
    for i in range(NOTE_VEGA_REPS):
        k = key.fold_in(1000 + i)
        pm, pp = (g2_note.price_range_note_g2(
            cfg, g.bump_sigma(sgn * v.epsilon), k, market,
            boundaries=note_dp.boundaries, n_paths=n_rep, device=dev,
            **NOTE_KW).price for sgn in (-1.0, 1.0))
        reps.append(float(pp - pm) / (2.0 * v.epsilon))
    se_v = float(np.std(reps, ddof=1)) / math.sqrt(NOTE_VEGA_REPS)
    d = float(v.vega) - v.dp_vega
    print(f"[phase 11] vega_range_note_g2 at {NOTE_VEGA_PATHS} paths: CRN-FD "
          f"{float(v.vega):.6f}, DP FD {v.dp_vega:.6f}, |d| {abs(d):.2e} "
          f"(SE {se_v:.2e} from {NOTE_VEGA_REPS} replicates of {n_rep}, "
          f"replicate mean {float(np.mean(reps)):.6f}; gate 3 SE)")
    check(abs(d) <= 3 * se_v, "vega_range_note_g2 vs the DP's central "
          "difference")

    sb_dp = dps["dp_oracle_snowball_g2"]
    n_pts, n_sh = SNOWBALL_RQMC
    rq = g2_note.price_snowball_g2(cfg, g, key, market, n_paths=n_pts,
                                   n_blocks=n_sh, rqmc=True, device=dev,
                                   **SNOWBALL_KW)
    mc = g2_note.price_snowball_g2(cfg, g, key, market, n_paths=n_pts,
                                   n_blocks=n_sh, device=dev, **SNOWBALL_KW)
    p, se, mse = float(rq.price), float(rq.std_error), float(mc.std_error)
    print(f"[phase 11] price_snowball_g2 RQMC at {n_pts} x {n_sh}: {p:.8f} "
          f"+/- {se:.2e} (MC SE at the same paths {mse:.2e}), DP "
          f"{sb_dp.price:.8f}: |d| {abs(p - sb_dp.price):.2e} (tol 5 SE + "
          f"1e-6 = {5 * se + 1e-6:.2e})")
    check(abs(p - sb_dp.price) <= 5 * se + 1e-6 and se < mse,
          "price_snowball_g2(rqmc=True) vs its DP oracle")
    return dps, dp_wall


def _g2_note_calls(cfg, key, market, dps, dev, n_paths=None):
    """The five price_*_g2 calls at G2Params() under the DP policies: name
    -> fn returning a tensor of (price, SE, the put / knockout / call
    fraction or the mean final coupon)."""
    import torch

    from hullwhite_tpu_torch import g2_note
    from hullwhite_tpu_torch.models import g2pp

    g = g2pp.G2Params()
    cdp = dps["dp_oracle_callable_snowball_g2"]

    def stack(res, third):
        return torch.stack([res.price, res.std_error, getattr(res, third)])

    return {
        "price_range_note_g2": lambda: stack(g2_note.price_range_note_g2(
            cfg, g, key, market, n_paths=n_paths,
            boundaries=dps["dp_oracle_range_note_g2"].boundaries,
            device=dev, **NOTE_KW), "put_fraction"),
        "price_tarn_g2": lambda: stack(g2_note.price_tarn_g2(
            cfg, g, key, market, n_paths=n_paths, device=dev, **TARN_KW),
            "ko_fraction"),
        "price_capped_floater_g2": lambda: stack(
            g2_note.price_capped_floater_g2(
                cfg, g, key, market, n_paths=n_paths,
                boundaries=dps["dp_oracle_capped_floater_g2"].boundaries,
                device=dev, **FLOATER_KW), "call_fraction"),
        "price_snowball_g2": lambda: stack(g2_note.price_snowball_g2(
            cfg, g, key, market, n_paths=n_paths, device=dev,
            **SNOWBALL_KW), "mean_final_coupon"),
        "price_callable_snowball_g2": lambda: stack(
            g2_note.price_callable_snowball_g2(
                cfg, g, key, market, n_paths=n_paths,
                boundaries=cdp.boundaries, c_grid=cdp.c_grid,
                plain_mean=cdp.plain_price, device=dev, **SNOWBALL_KW),
            "call_fraction")}


def phase11_card_vs_cpu(cfg, dev, market, dps):
    """Each price_*_g2 at 2^14 paths on the card and on the CPU under one
    key: prices within 0.1 SE."""
    from hullwhite_tpu_torch import Key

    key = Key(cfg.seed).fold_in(77121)
    got = {}
    for d, m in ((dev, market), ("cpu", market.to("cpu"))):
        got[str(d)] = {name: fn().tolist() for name, fn in _g2_note_calls(
            cfg, key, m, dps, d, n_paths=NOTES_CARD_CPU_PATHS).items()}
    for name, (p, se, x) in got["cpu"].items():
        pc, _, xc = got[str(dev)][name]
        print(f"[phase 11] card vs CPU: {name} at {NOTES_CARD_CPU_PATHS} "
              f"paths: {pc:.8f} vs {p:.8f}, |d| {abs(pc - p):.2e} (tol "
              f"{NOTES_CARD_CPU_SE_FRAC} SE = "
              f"{NOTES_CARD_CPU_SE_FRAC * se:.2e}); third field {xc} vs {x}")
        check(abs(pc - p) <= NOTES_CARD_CPU_SE_FRAC * se,
              f"{name} on the card vs the CPU")


def phase11(dev, smi, market):
    """The G2++ note layer on phase 10's curve (module docstring, phase
    11); returns the kernels' launch counts of the whole phase."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import g2pp

    cfg = HWConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    dps, dp_wall = phase11_direct(cfg, dev, g2pp.G2Params(), market, smi)
    phase11_card_vs_cpu(cfg, dev, market, dps)
    times = _note_times(_g2_note_calls(cfg, Key(cfg.seed).fold_in(77121),
                                       market, dps, dev),
                        cfg, smi, dp_wall, "phase 11")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 11] times per call [{smi}]: " + json.dumps(times))
    print(f"[phase 11] peak device memory of the G2++ note phase: "
          f"{peak:.2f} GiB [{smi}]; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    return fused.launch_counts()


# ---------------------------------------------------------------------------
# phase 12: the exotics layer (the ratchet cap, the up-and-out cap, the
# chooser cap and auto-cap, each under Hull-White and G2++), plain PyTorch
# on the card (no hand-written kernel on these calls) and host float64
# oracles
# ---------------------------------------------------------------------------

# cli exotics' products at its defaults (tenor 3, cap rate 1.3%, barrier
# 5%, k = 2 rights, ratchet spread 0)
RATCHET_KW = dict(spread=0.0, tenor=3.0)
KO_KW = dict(rate=0.013, barrier=0.05, tenor=3.0)
CHOOSER_KW = dict(rate=0.013, k=2, tenor=3.0)
# the RQMC ratchet as cli exotics runs it: 8 shifts of a 1/8 of the paths
RQMC_SHIFTS = 8
EXOTICS_KEYS = ("cms_spread", "range_accrual", "range_accrual_g2",
                "range_note", "range_note_vega", "tarn", "range_note_g2",
                "range_note_g2_vega", "tarn_g2", "chooser_cap",
                "chooser_cap_g2", "ratchet_cap", "ratchet_cap_g2", "ko_cap",
                "ko_cap_g2")


# the DP oracles cli exotics calls twice with the same arguments (the
# price's and its vega's base-sigma oracle): phase 12 answers the second
# call from the first (deterministic host functions; an argument left to
# its default counts as the value the oracle resolves it to)
EXOTICS_MEMO = (("range_note", "dp_oracle_range_note"),
                ("g2_note", "dp_oracle_range_note_g2"),
                ("chooser", "dp_oracle_chooser_cap"))
# the G2++ DP oracles of cli exotics, run on G2_SMALL_GRID: at the
# command's (161, 61, 16) they took 169-212 s of host time, which pushed
# the script past 1050 s once phase 15 came (the grids' accuracy is held
# by tests/test_torch_g2_note.py, test_torch_chooser.py and
# test_torch_barrier.py; at G2_SMALL_GRID the chooser and knock-out DPs
# move by ~4e-6 and phase 11 gates the note and the TARN)
EXOTICS_G2_DPS = (("g2_note", "dp_oracle_range_note_g2"),
                  ("g2_note", "dp_oracle_tarn_g2"),
                  ("chooser", "dp_oracle_chooser_cap_g2"),
                  ("barrier", "dp_oracle_ko_cap_g2"))


def _memoized(fn, hits):
    import inspect

    sig = inspect.signature(fn)
    cache = {}

    def key(name, a, cfg):
        if a is None and name in ("sigma", "start"):
            return cfg.sigma if name == "sigma" else cfg.s1
        try:
            hash(a)
            return a
        except TypeError:                       # the market's tensors
            return ("id", id(a))

    def call(*args, **kw):
        b = sig.bind(*args, **kw)
        b.apply_defaults()
        cfg = b.arguments["cfg"]
        k = tuple((n, key(n, a, cfg)) for n, a in b.arguments.items())
        if k in cache:
            hits.append(fn.__name__)
        else:
            cache[k] = fn(*args, **kw)
        return cache[k]
    return call


def phase12_cli(cfg, dev, market):
    """``cli exotics`` at full width (2^20 paths; the G2++ DPs of
    ``EXOTICS_G2_DPS`` on ``G2_SMALL_GRID``) in a fresh directory on phase
    10's curve, the oracles of ``EXOTICS_MEMO`` computed once per argument
    set: rc 0, its 15 agreement lines PASS, no CHECK, the JAX command's
    sections written."""
    import importlib

    from hullwhite_tpu_torch.utils import io as hwio

    names = EXOTICS_MEMO + EXOTICS_G2_DPS
    mods = {m: importlib.import_module(f"hullwhite_tpu_torch.{m}")
            for m, _ in names}
    saved = {(m, n): getattr(mods[m], n) for m, n in names}
    hits = []
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            hwio.save_market(cfg, market)
            for (m, n), fn in saved.items():
                if (m, n) in EXOTICS_MEMO:
                    fn = _memoized(fn, hits)
                if (m, n) in EXOTICS_G2_DPS:
                    fn = _forced_grid(fn, G2_SMALL_GRID)
                setattr(mods[m], n, fn)
            t0 = time.perf_counter()
            text = _cli(["exotics", "--device", str(dev), "--reps", "1"],
                        "phase 12")
            wall = time.perf_counter() - t0
            doc = json.load(open(os.path.join("data_torch",
                                              "exotics_results.json")))
        finally:
            for (m, n), fn in saved.items():
                setattr(mods[m], n, fn)
            os.chdir(cwd)
    print(f"[phase 12] cli exotics: oracle calls answered from an earlier "
          f"identical call: {hits}")
    check(text.count("(PASS)") == 15 and "CHECK" not in text,
          "cli exotics: an agreement line is not PASS")
    check(set(doc["results"]) == set(EXOTICS_KEYS),
          "cli exotics: its sections differ from the JAX command's")
    return doc["results"], wall


def phase12_oracles(cfg, g, market, smi):
    """The oracles the direct calls read (the chooser policies and their
    CV means; the G2++ chooser's curves on ``G2_SMALL_GRID``, which only
    the timings use) and the host wall of each of the module's oracles."""
    from hullwhite_tpu_torch import barrier, chooser, ratchet

    host = market.to("cpu")
    out, wall = {}, {}
    for name, fn in (
            ("ratchet_cap_quadrature", lambda: ratchet.ratchet_cap_quadrature(
                cfg, host, **RATCHET_KW)[0]),
            ("ratchet_cap_quadrature_g2",
             lambda: ratchet.ratchet_cap_quadrature_g2(
                 cfg, g, host, **RATCHET_KW)[0]),
            ("dp_oracle_ko_cap", lambda: barrier.dp_oracle_ko_cap(
                cfg, host, **KO_KW)),
            ("dp_oracle_ko_cap_g2 (61, 21, 8)",
             lambda: barrier.dp_oracle_ko_cap_g2(cfg, g, host, **KO_KW,
                                                 **G2_SMALL_GRID)),
            ("dp_oracle_chooser_cap", lambda: chooser.dp_oracle_chooser_cap(
                cfg, host, **CHOOSER_KW)),
            ("dp_oracle_chooser_cap auto",
             lambda: chooser.dp_oracle_chooser_cap(cfg, host, auto=True,
                                                   **CHOOSER_KW)),
            ("dp_oracle_chooser_cap_g2 (61, 21, 8)",
             lambda: chooser.dp_oracle_chooser_cap_g2(
                 cfg, g, host, **CHOOSER_KW, **G2_SMALL_GRID)),
            ("cap_closed_form_g2", lambda: barrier.cap_closed_form_g2(
                cfg, g, host, rate=CHOOSER_KW["rate"],
                tenor=CHOOSER_KW["tenor"])[0])):
        t0 = time.perf_counter()
        out[name] = fn()
        wall[name] = (time.perf_counter() - t0) * 1e3
        v = out[name] if isinstance(out[name], float) else out[name].price
        print(f"[phase 12] {name}: {v:.8f} (host wall {wall[name]:.1f} ms) "
              f"[{smi}]")
    return out, wall


def _exotic_calls(cfg, g, key, market, orc, dev, n_paths=None):
    """The new price_* calls (the chooser under the oracles' policies, the
    CV means given): name -> fn returning a tensor of (price, SE, the raw
    price / knock-out fraction / mean rights used).  ``n_paths`` is the
    total: the RQMC ratchet splits it over its shifts."""
    import torch

    from hullwhite_tpu_torch import barrier, chooser, ratchet

    n = cfg.n_paths if n_paths is None else n_paths
    rq = dict(n_paths=n // RQMC_SHIFTS, n_blocks=RQMC_SHIFTS, rqmc=True)
    ch, au = orc["dp_oracle_chooser_cap"], orc["dp_oracle_chooser_cap auto"]
    ch2 = orc["dp_oracle_chooser_cap_g2 (61, 21, 8)"]
    cap2 = orc["cap_closed_form_g2"]

    def stack(res, third):
        return torch.stack([res.price, res.std_error, getattr(res, third)])

    return {
        "price_ratchet_cap": lambda: stack(ratchet.price_ratchet_cap(
            cfg, key, market, n_paths=n, device=dev, **RATCHET_KW),
            "raw_price"),
        "price_ratchet_cap rqmc": lambda: stack(ratchet.price_ratchet_cap(
            cfg, key, market, device=dev, **rq, **RATCHET_KW), "raw_price"),
        "price_ratchet_cap_g2": lambda: stack(ratchet.price_ratchet_cap_g2(
            cfg, g, key, market, n_paths=n, device=dev, **RATCHET_KW),
            "raw_price"),
        "price_ko_cap": lambda: stack(barrier.price_ko_cap(
            cfg, key, market, n_paths=n, device=dev, **KO_KW),
            "ko_fraction"),
        "price_ko_cap_g2": lambda: stack(barrier.price_ko_cap_g2(
            cfg, g, key, market, n_paths=n, device=dev, **KO_KW),
            "ko_fraction"),
        "price_chooser_cap": lambda: stack(chooser.price_chooser_cap(
            cfg, key, market, boundaries=ch.boundaries,
            cap_mean=ch.cap_price, n_paths=n, device=dev, **CHOOSER_KW),
            "used_mean"),
        "price_chooser_cap auto": lambda: stack(chooser.price_chooser_cap(
            cfg, key, market, auto=True, boundaries=(),
            cap_mean=au.cap_price, n_paths=n, device=dev, **CHOOSER_KW),
            "used_mean"),
        "price_chooser_cap_g2": lambda: stack(chooser.price_chooser_cap_g2(
            cfg, g, key, market, boundaries=ch2.boundaries, cap_mean=cap2,
            n_paths=n, device=dev, **CHOOSER_KW), "used_mean"),
        "price_chooser_cap_g2 auto": lambda: stack(
            chooser.price_chooser_cap_g2(
                cfg, g, key, market, auto=True, cap_mean=cap2, n_paths=n,
                device=dev, **CHOOSER_KW), "used_mean")}


def phase12_card_vs_cpu(cfg, g, dev, market, orc):
    """Each new price_* at 2^14 paths on the card and on the CPU under one
    key: prices within 0.1 SE (the gap printed)."""
    from hullwhite_tpu_torch import Key

    key = Key(cfg.seed).fold_in(9393)
    got = {}
    for d, m in ((dev, market), ("cpu", market.to("cpu"))):
        got[str(d)] = {name: fn().tolist() for name, fn in _exotic_calls(
            cfg, g, key, m, orc, d, n_paths=NOTES_CARD_CPU_PATHS).items()}
    for name, (p, se, x) in got["cpu"].items():
        pc, _, xc = got[str(dev)][name]
        print(f"[phase 12] card vs CPU: {name} at {NOTES_CARD_CPU_PATHS} "
              f"paths: {pc:.8f} vs {p:.8f}, |d| {abs(pc - p):.2e} (tol "
              f"{NOTES_CARD_CPU_SE_FRAC} SE = "
              f"{NOTES_CARD_CPU_SE_FRAC * se:.2e}); third field {xc} vs {x}")
        check(abs(pc - p) <= NOTES_CARD_CPU_SE_FRAC * se,
              f"{name} on the card vs the CPU")


def phase12(dev, smi, market):
    """The exotics layer on phase 10's curve (module docstring, phase 12);
    returns the kernels' launch counts of the whole phase."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import g2pp

    cfg = HWConfig()
    g = g2pp.G2Params()
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    res, cli_wall = phase12_cli(cfg, dev, market)
    for name in ("ratchet_cap", "ratchet_cap_g2", "ko_cap", "ko_cap_g2",
                 "chooser_cap", "chooser_cap_g2"):
        r = res[name]
        orc = r.get("quadrature", r.get("dp_price"))
        print(f"[phase 12] cli exotics {name}: MC {r['mc_price']:.8f} +/- "
              f"{r['mc_se']:.2e}, oracle {orc:.8f}, |d| "
              f"{abs(r['mc_price'] - orc):.2e}")
    orc, dp_wall = phase12_oracles(cfg, g, market, smi)
    phase12_card_vs_cpu(cfg, g, dev, market, orc)
    times = _note_times(_exotic_calls(cfg, g, Key(cfg.seed).fold_in(9393),
                                      market, orc, dev),
                        cfg, smi, dp_wall, "phase 12")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 12] times per call [{smi}]: " + json.dumps(times))
    print(f"[phase 12] peak device memory of the exotics phase: {peak:.2f} "
          f"GiB [{smi}]; cli exotics {cli_wall:.1f} s; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    return fused.launch_counts()


# ---------------------------------------------------------------------------
# phase 13: the Hull-White XVA layer (credit.py and the Hull-White half of
# xva.py: exposure, netting, CSA collateral, bilateral, wrong-way risk, MVA,
# KVA, CS01), plain PyTorch on the card (no hand-written kernel on these
# calls) and host float64 oracles
# ---------------------------------------------------------------------------

# cli xva with every ported section; the CDS quotes of the JAX package's
# tests
XVA_QUOTES = ((1.0, 0.006), (3.0, 0.009), (5.0, 0.013))
XVA_ARGV = ["--netting", "--csa", "--bilateral", "--wwr", "--mva", "--kva",
            "--cds", ",".join(f"{m:g}:{q:g}" for m, q in XVA_QUOTES)]
XVA_KEYS = ("netting", "csa", "bilateral", "wwr", "mva", "kva", "cds",
            "side", "dates", "ee_mc", "ee_se", "ee_oracle", "pfe", "exceed",
            "epe", "cva_mc", "cva_se", "cva_oracle", "cva_z",
            "hazard_delta_mc", "hazard_delta_oracle", "vega_jvp", "vega_fd",
            "vega_oracle", "quantile", "n_paths")
# the direct calls' books at cli xva's defaults (rate 2%, tenor 4): the
# three-swap netting book, the one swap of the CSA, bilateral and WWR
# sections, and the MVA book of short payers and a long receiver whose
# gradient changes sign (cli xva's own MVA book is one-signed: its CV is
# exact and its SE 0, which a 0.1 SE card-vs-CPU gate cannot read)
XVA_BOOK = ((0.02, 4.0, False), (0.012, 3.0, True), (0.03, 2.0, False))
XVA_SWAP = ((0.02, 4.0, False),)
XVA_MVA_BOOK = ((0.02, 2.0, True), (0.02, 2.0, True), (0.0, 4.0, False))
XVA_CSA = dict(threshold=0.005, lag=1)
XVA_BIL = dict(hazard_own=0.01, recovery_own=0.4, spread_borrow=0.005,
               spread_lend=0.002)
XVA_BLOCKS = 4
# the XVA product x @ LT (2^20 x 8 normals, the netting book's 8 x 8
# Cholesky factor) against float64, relative to the largest entry: true
# float32 ~1e-7; a TF32 product (10-bit mantissas) ~1e-3
XVA_PRODUCT_RTOL = 1e-5


def phase13_cli(cfg, dev, market):
    """``cli xva`` with every ported section at full width (2^20 paths x 4
    blocks) in a fresh directory on phase 10's curve: rc 0, its
    "validation:" line PASS, no CHECK, the CS01 line "[agree]", the JAX
    command's sections written."""
    from hullwhite_tpu_torch.utils import io as hwio

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            hwio.save_market(cfg, market)
            t0 = time.perf_counter()
            text = _cli(["xva", "--device", str(dev), "--reps", "1",
                         *XVA_ARGV], "phase 13")
            wall = time.perf_counter() - t0
            doc = json.load(open(os.path.join("data_torch",
                                              "xva_results.json")))
        finally:
            os.chdir(cwd)
    check("validation: PASS" in text and "CHECK" not in text
          and "[agree]" in text, "cli xva: an agreement line is not PASS")
    check(set(doc["results"]) == set(XVA_KEYS),
          "cli xva: its sections differ from the JAX command's")
    return doc["results"], wall


def phase13_oracles(cfg, market, smi):
    """Each oracle of the layer once at the direct calls' arguments: its
    value and host wall."""
    from hullwhite_tpu_torch import credit, xva

    host = market.to("cpu")
    wall = {}
    for name, fn in (
            ("exposure_oracle", lambda: xva.exposure_oracle(cfg, host).cva),
            ("netting_oracle",
             lambda: xva.netting_oracle(cfg, host, XVA_BOOK).cva),
            ("collateral_oracle", lambda: xva.collateral_oracle(
                cfg, host, XVA_SWAP, **XVA_CSA).cva),
            ("bilateral_oracle", lambda: xva.bilateral_oracle(
                cfg, host, XVA_SWAP, **XVA_BIL).bcva),
            ("wwr_oracle", lambda: xva.wwr_oracle(cfg, host, XVA_SWAP).cva),
            ("mva_oracle",
             lambda: xva.mva_oracle(cfg, host, XVA_MVA_BOOK).mva),
            ("kva_oracle", lambda: xva.kva_oracle(cfg, host, XVA_BOOK).kva),
            ("bootstrap_cds + cs01_weights", lambda: credit.cs01_weights(
                credit.market_df(cfg, host), XVA_QUOTES,
                xva.exposure_dates(cfg, 4.0))[0].hazards[-1])):
        t0 = time.perf_counter()
        v = fn()
        wall[name] = (time.perf_counter() - t0) * 1e3
        print(f"[phase 13] {name}: {v:.8f} (host wall {wall[name]:.1f} ms) "
              f"[{smi}]")
    return wall


def _xva_calls(cfg, key, market, dev, n_paths=None):
    """The new estimators at ``n_paths`` paths per block x ``XVA_BLOCKS``
    blocks: name -> fn returning a float64 tensor of (estimate, SE, a
    third number: the raw estimate, the FVA or the gamma delta; for
    vega_cva the jvp and the CRN-FD vega and the CVA at sigma)."""
    import torch

    from hullwhite_tpu_torch import xva

    kw = dict(n_paths=cfg.n_paths if n_paths is None else n_paths,
              n_blocks=XVA_BLOCKS, device=dev)

    def stack(*ts):
        return torch.stack([t.to(torch.float64) for t in ts])

    def vega():
        v = xva.vega_cva(cfg, key, market, **kw)
        return stack(v.vega, v.fd_vega, xva.price_exposure(
            cfg, key, market, **kw).cva)

    return {
        "price_exposure": lambda: (lambda r: stack(
            r.cva, r.std_error, r.raw_cva))(
                xva.price_exposure(cfg, key, market, **kw)),
        "price_exposure rqmc": lambda: (lambda r: stack(
            r.cva, r.std_error, r.raw_cva))(
                xva.price_exposure(cfg, key, market, rqmc=True, **kw)),
        "vega_cva": vega,
        "price_netting": lambda: (lambda r: stack(
            r.cva, r.std_error, r.raw_cva))(
                xva.price_netting(cfg, key, market, XVA_BOOK, **kw)),
        "price_collateral": lambda: (lambda r: stack(
            r.cva, r.std_error, r.raw_cva))(
                xva.price_collateral(cfg, key, market, XVA_SWAP, **XVA_CSA,
                                     **kw)),
        "price_bilateral": lambda: (lambda r: stack(
            r.bcva, r.bcva_se, r.fva))(
                xva.price_bilateral(cfg, key, market, XVA_SWAP, **XVA_BIL,
                                    **kw)),
        "price_wwr": lambda: (lambda r: stack(
            r.cva, r.std_error, r.gamma_delta))(
                xva.price_wwr(cfg, key, market, XVA_SWAP, **kw)),
        "price_mva": lambda: (lambda r: stack(
            r.mva, r.std_error, r.raw_mva))(
                xva.price_mva(cfg, key, market, XVA_MVA_BOOK, **kw)),
        "price_kva": lambda: (lambda r: stack(
            r.kva, r.std_error, r.raw_kva))(
                xva.price_kva(cfg, key, market, XVA_BOOK, **kw))}


def phase13_card_vs_cpu(cfg, dev, market):
    """Each new estimator at 2^14 paths x 4 blocks on the card and on the
    CPU under one key: estimates within 0.1 SE (vega_cva: both vegas within
    0.1 SE / eps, eps = 1e-3, the CRN legs each within 0.1 SE)."""
    from hullwhite_tpu_torch import Key

    key = Key(cfg.seed).fold_in(9292)
    got = {}
    for d, m in ((dev, market), ("cpu", market.to("cpu"))):
        got[str(d)] = {name: fn().tolist() for name, fn in _xva_calls(
            cfg, key, m, d, n_paths=NOTES_CARD_CPU_PATHS).items()}
    se_cva = got["cpu"]["price_exposure"][1]
    for name, cpu in got["cpu"].items():
        card = got[str(dev)][name]
        if name == "vega_cva":
            tol = NOTES_CARD_CPU_SE_FRAC * se_cva / 1e-3
            pairs = ((card[0], cpu[0]), (card[1], cpu[1]))
        else:
            tol = NOTES_CARD_CPU_SE_FRAC * cpu[1]
            pairs = ((card[0], cpu[0]),)
        print(f"[phase 13] card vs CPU: {name} at {NOTES_CARD_CPU_PATHS} x "
              f"{XVA_BLOCKS} paths: {card} vs {cpu}, |d| "
              f"{[abs(a - b) for a, b in pairs]} (tol {tol:.2e})")
        check(all(abs(a - b) <= tol for a, b in pairs),
              f"{name} on the card vs the CPU")


def _tf32_round(x):
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties
    away), the operands a TF32 tensor-core product multiplies."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_gate(tag, what, x, LT, precision, scale=1.0):
    """A product ``scale * dot(x, LT)`` against float64 on the same
    operands: TF32 off and the product float32 (max rel <=
    ``XVA_PRODUCT_RTOL``); the same product on TF32-rounded operands moves
    past that bound, so the gate would see a TF32 product.  The card's own
    product with TF32 allowed is printed."""
    import torch

    from hullwhite_tpu_torch.ops.engine_linear import dot

    z64 = scale * (x.double() @ LT.double())
    top = float(z64.abs().max())

    def rel(z):
        return float((z.double() - z64).abs().max()) / top

    r32 = rel(scale * dot(x, LT, precision))
    r_emul = rel(scale * (_tf32_round(x).double()
                          @ _tf32_round(LT).double()))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        r_card = rel(scale * (x @ LT))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[{tag}] {what} at {tuple(x.shape)} x {tuple(LT.shape)} vs "
          f"float64: max rel {r32:.2e} (tol {XVA_PRODUCT_RTOL}); on "
          f"TF32-rounded operands {r_emul:.2e}; the card's product with "
          f"TF32 allowed {r_card:.2e}; allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and r32 <= XVA_PRODUCT_RTOL, f"{what} is not float32")
    check(r_emul > XVA_PRODUCT_RTOL, f"the TF32 gate cannot see a TF32 "
          f"{what}")


def phase13_tf32(cfg, dev):
    """The XVA product ``dot(x, LT)`` (the netting book's 8 functionals at
    2^20 paths) through ``_tf32_gate``."""
    import torch

    from hullwhite_tpu_torch import Key, xva
    from hullwhite_tpu_torch.bermudan import _functional_chol
    from hullwhite_tpu_torch.ops.rng import block_normals

    dates = xva.exposure_dates(cfg, 4.0)
    LT = torch.as_tensor(_functional_chol(cfg, xva._specs(dates)),
                         device=dev)
    x = block_normals(Key(cfg.seed).fold_in(9292), 0,
                      (cfg.n_paths, 2 * len(dates)), device=dev)
    _tf32_gate("phase 13", "the XVA product x @ LT", x, LT,
               cfg.matmul_precision)


def phase13(dev, smi, market):
    """The Hull-White XVA layer on phase 10's curve (module docstring,
    phase 13); returns the kernels' launch counts of the whole phase."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key
    from hullwhite_tpu_torch.kernels import fused

    cfg = HWConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    res, cli_wall = phase13_cli(cfg, dev, market)
    for name, z in (("cva", res["cva_z"]),
                    ("netting", res["netting"]["cva_z"]),
                    ("csa", res["csa"]["cva_z"]),
                    ("bilateral BCVA", res["bilateral"]["bcva_z"]),
                    ("bilateral FVA", res["bilateral"]["fva_z"]),
                    ("wwr", res["wwr"]["cva_z"]),
                    ("kva", res["kva"]["kva_z"]),
                    ("cds", res["cds"]["cva_z"])):
        print(f"[phase 13] cli xva {name}: z = {z:+.2f}")
    mva = res["mva"]
    print(f"[phase 13] cli xva mva: MC {mva['mva_mc']:.10f} +/- "
          f"{mva['mva_se']:.2e}, oracle {mva['mva_oracle']:.10f}, |d| "
          f"{abs(mva['mva_mc'] - mva['mva_oracle']):.2e} (its book's "
          f"gradient is one-signed: the CV is exact)")
    print(f"[phase 13] cli xva vega: jvp {res['vega_jvp']:.6f}, CRN-FD "
          f"{res['vega_fd']:.6f}, oracle FD {res['vega_oracle']:.6f}; CS01 "
          f"MC {res['cds']['cs01_mc']} vs oracle {res['cds']['cs01_oracle']}")
    wall = phase13_oracles(cfg, market, smi)
    phase13_tf32(cfg, dev)
    phase13_card_vs_cpu(cfg, dev, market)
    times = _note_times(_xva_calls(cfg, Key(cfg.seed).fold_in(9292), market,
                                   dev),
                        cfg, smi, wall, "phase 13")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 13] times per call at {cfg.n_paths} x {XVA_BLOCKS} paths "
          f"[{smi}]: " + json.dumps(times))
    print(f"[phase 13] peak device memory of the XVA phase: {peak:.2f} GiB "
          f"[{smi}]; cli xva {cli_wall:.1f} s; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    return fused.launch_counts()


# ---------------------------------------------------------------------------
# phase 14: the rest of the XVA layer (the G2++ twins of xva.py and the
# Bermudan swaption's exposure under both models), plain PyTorch on the card
# (no hand-written kernel on these calls) and host float64 oracles
# ---------------------------------------------------------------------------

# cli xva with the G2++ twin, the Bermudan exposure and every section the
# twin reads
XVA14_ARGV = ["--g2", "--netting", "--csa", "--bilateral", "--wwr", "--mva",
              "--kva", "--bermudan"]
XVA14_G2_SECTIONS = ("netting", "csa", "bilateral", "wwr", "mva", "kva",
                     "bermudan")
# the command's defaults (rate 2%, tenor 4, receiver, ...): the direct
# calls take the command's books and arguments, built as it builds them,
# so that the command reads the oracles the direct calls computed from the
# oracle memo
XVA14_RATE, XVA14_TENOR = 0.02, 4.0
XVA14_BOOK = ((XVA14_RATE, XVA14_TENOR, False),
              (XVA14_RATE * 0.6, max(XVA14_TENOR - 1.0, 1.0), True),
              (XVA14_RATE * 1.5, max(XVA14_TENOR - 2.0, 1.0), False))
XVA14_SWAP = ((XVA14_RATE, XVA14_TENOR, False),)
XVA14_MVA_BOOK = ((XVA14_RATE, XVA14_TENOR, False),
                  (XVA14_RATE, max(XVA14_TENOR - 2.0, 1.0), False),
                  (XVA14_RATE * 0.0, XVA14_TENOR, True))
XVA14_KW = dict(freq=1.0, quantile=0.95, hazard=0.02, recovery=0.4)
XVA14_CSA = dict(threshold=0.005, lag=1)
XVA14_BIL = dict(freq=1.0, hazard=0.02, recovery=0.4, hazard_own=0.01,
                 recovery_own=0.4, spread_borrow=0.005, spread_lend=0.002)
XVA14_WWR = dict(lambda0=0.02, gamma=0.5, freq=1.0, recovery=0.4)
XVA14_MVA = dict(mpor=0.1, quantile_im=0.99, spread_im=0.005, freq=1.0,
                 hazard=0.02, hazard_own=0.01)
XVA14_KVA = dict(freq=1.0, cost_of_capital=0.10, capital_ratio=0.08,
                 hazard=0.02, hazard_own=0.01)
# the Bermudan exposure: the command's 4-year 2% receiver, annual
# exercises from 5y (four under Hull-White on the 3001-node DP, three under
# G2++ on the 121 x 121 DP)
XVA14_BERM_EX = (5.0, 6.0, 7.0, 8.0)
XVA14_BERM_EX_G2 = (5.0, 6.0, 7.0)
XVA14_BERM_GRID = 3001


def phase14_oracles(cfg, g2, market, smi):
    """Each new oracle once (the memo emptied first) at the command's
    arguments: its value and host wall.  The command then reads them from
    the memo."""
    from hullwhite_tpu_torch import xva
    from hullwhite_tpu_torch.instruments import swap_fixed_leg

    host = market.to("cpu")
    xva._G2_ORACLE_CACHE.clear()
    sched = swap_fixed_leg(cfg, XVA14_RATE, XVA14_TENOR)
    swap_kw = dict(rate=XVA14_RATE, tenor=XVA14_TENOR, payer=False,
                   **XVA14_KW)
    wall = {}
    for name, fn in (
            ("exposure_oracle_g2", lambda: xva.exposure_oracle_g2(
                cfg, g2, host, **swap_kw).cva),
            ("netting_oracle_g2", lambda: xva.netting_oracle_g2(
                cfg, g2, host, XVA14_BOOK, **XVA14_KW).cva),
            ("collateral_oracle_g2", lambda: xva.collateral_oracle_g2(
                cfg, g2, host, XVA14_SWAP, **XVA14_CSA, **XVA14_KW).cva),
            ("bilateral_oracle_g2", lambda: xva.bilateral_oracle_g2(
                cfg, g2, host, XVA14_SWAP, **XVA14_BIL).bcva),
            ("wwr_oracle_g2", lambda: xva.wwr_oracle_g2(
                cfg, g2, host, XVA14_SWAP, **XVA14_WWR).cva),
            ("mva_oracle_g2", lambda: xva.mva_oracle_g2(
                cfg, g2, host, XVA14_MVA_BOOK, **XVA14_MVA).mva),
            ("kva_oracle_g2", lambda: xva.kva_oracle_g2(
                cfg, g2, host, XVA14_BOOK, **XVA14_KVA).kva),
            ("bermudan_exposure_oracle", lambda: xva.bermudan_exposure_oracle(
                cfg, host, sched, XVA14_BERM_EX, n_grid=XVA14_BERM_GRID,
                **{k: v for k, v in XVA14_KW.items() if k != "freq"}).cva),
            ("bermudan_exposure_oracle_g2",
             lambda: xva.bermudan_exposure_oracle_g2(
                 cfg, g2, host, sched, XVA14_BERM_EX_G2,
                 **{k: v for k, v in XVA14_KW.items() if k != "freq"}).cva)):
        t0 = time.perf_counter()
        v = fn()
        wall[name] = (time.perf_counter() - t0) * 1e3
        print(f"[phase 14] {name}: {v:.8f} (host wall {wall[name]:.1f} ms) "
              f"[{smi}]")
    return wall


def phase14_cli(cfg, dev, market):
    """``cli xva --g2 --netting --csa --bilateral --wwr --mva --kva
    --bermudan`` at full width (2^20 paths x 4 blocks) in a fresh
    directory on phase 10's curve: rc 0, its "validation:" line PASS, no
    CHECK, FAIL or "not ported" line, the JAX command's sections written
    (the G2++ twin's under "g2"); also the oracle entries the command added
    to the memo."""
    from hullwhite_tpu_torch import xva
    from hullwhite_tpu_torch.utils import io as hwio

    cwd = os.getcwd()
    memo = len(xva._G2_ORACLE_CACHE)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            hwio.save_market(cfg, market)
            t0 = time.perf_counter()
            text = _cli(["xva", "--device", str(dev), "--reps", "1",
                         *XVA14_ARGV], "phase 14")
            wall = time.perf_counter() - t0
            doc = json.load(open(os.path.join("data_torch",
                                              "xva_results.json")))
        finally:
            os.chdir(cwd)
    check("validation: PASS" in text and "CHECK" not in text
          and "FAIL" not in text and "not ported" not in text,
          "cli xva --g2 --bermudan: an agreement line is not PASS")
    res = doc["results"]
    check(set(res) == (set(XVA_KEYS) - {"cds"}) | {"g2", "bermudan"}
          and set(XVA14_G2_SECTIONS) <= set(res["g2"]),
          "cli xva --g2 --bermudan: its sections differ from the JAX "
          "command's")
    return res, wall, len(xva._G2_ORACLE_CACHE) - memo


def _xva14_calls(cfg, g2, key, market, dev, n_paths=None):
    """The ten new estimators at ``n_paths`` paths per block x
    ``XVA_BLOCKS`` blocks: name -> fn returning a float64 tensor of
    (estimate, SE, a third number: the raw estimate, the FVA or the gamma
    delta; for vega_cva_g2 the CRN vega twice and the CVA at sigma)."""
    import torch

    from hullwhite_tpu_torch import xva
    from hullwhite_tpu_torch.instruments import swap_fixed_leg

    kw = dict(n_paths=cfg.n_paths if n_paths is None else n_paths,
              n_blocks=XVA_BLOCKS, device=dev)
    sched = swap_fixed_leg(cfg, XVA14_RATE, XVA14_TENOR)
    swap_kw = dict(rate=XVA14_RATE, tenor=XVA14_TENOR, payer=False,
                   **XVA14_KW)
    berm_kw = {k: v for k, v in XVA14_KW.items() if k != "freq"}

    def stack(*ts):
        return torch.stack([torch.as_tensor(t).to(torch.float64)
                            for t in ts])

    def cva3(r):
        return stack(r.cva, r.std_error, r.raw_cva)

    def vega():
        v = xva.vega_cva_g2(cfg, g2, key, market, **swap_kw, **kw)
        return stack(v.vega, v.fd_vega, xva.price_exposure_g2(
            cfg, g2, key, market, **swap_kw, **kw).cva)

    return {
        "price_exposure_g2": lambda: cva3(xva.price_exposure_g2(
            cfg, g2, key, market, **swap_kw, **kw)),
        "vega_cva_g2": vega,
        "price_netting_g2": lambda: cva3(xva.price_netting_g2(
            cfg, g2, key, market, XVA14_BOOK, **XVA14_KW, **kw)),
        "price_collateral_g2": lambda: cva3(xva.price_collateral_g2(
            cfg, g2, key, market, XVA14_SWAP, **XVA14_CSA, **XVA14_KW,
            **kw)),
        "price_bilateral_g2": lambda: (lambda r: stack(
            r.bcva, r.bcva_se, r.fva))(xva.price_bilateral_g2(
                cfg, g2, key, market, XVA14_SWAP, quantile=0.95,
                **XVA14_BIL, **kw)),
        "price_wwr_g2": lambda: (lambda r: stack(
            r.cva, r.std_error, r.gamma_delta))(xva.price_wwr_g2(
                cfg, g2, key, market, XVA14_SWAP, quantile=0.95,
                **XVA14_WWR, **kw)),
        "price_mva_g2": lambda: (lambda r: stack(
            r.mva, r.std_error, r.raw_mva))(xva.price_mva_g2(
                cfg, g2, key, market, XVA14_MVA_BOOK, **XVA14_MVA, **kw)),
        "price_kva_g2": lambda: (lambda r: stack(
            r.kva, r.std_error, r.raw_kva))(xva.price_kva_g2(
                cfg, g2, key, market, XVA14_BOOK, **XVA14_KVA, **kw)),
        "price_bermudan_xva": lambda: cva3(xva.price_bermudan_xva(
            cfg, key, market, sched, XVA14_BERM_EX,
            n_grid=XVA14_BERM_GRID, **berm_kw, **kw)[0]),
        "price_bermudan_xva_g2": lambda: cva3(xva.price_bermudan_xva_g2(
            cfg, g2, key, market, sched, XVA14_BERM_EX_G2, **berm_kw,
            **kw)[0])}


def phase14_card_vs_cpu(cfg, g2, dev, market):
    """Each new estimator at 2^14 paths x 4 blocks on the card and on the
    CPU under one key: estimates within 0.1 SE (vega_cva_g2: the CRN vega
    within 0.1 SE / eps, eps = 1e-3)."""
    from hullwhite_tpu_torch import Key

    key = Key(cfg.seed).fold_in(9292)
    got = {}
    for d, m in ((dev, market), ("cpu", market.to("cpu"))):
        got[str(d)] = {name: fn().tolist() for name, fn in _xva14_calls(
            cfg, g2, key, m, d, n_paths=NOTES_CARD_CPU_PATHS).items()}
    se_cva = got["cpu"]["price_exposure_g2"][1]
    for name, cpu in got["cpu"].items():
        card = got[str(dev)][name]
        if name == "vega_cva_g2":
            tol = NOTES_CARD_CPU_SE_FRAC * se_cva / 1e-3
            pairs = ((card[0], cpu[0]),)
        else:
            tol = NOTES_CARD_CPU_SE_FRAC * cpu[1]
            pairs = ((card[0], cpu[0]),)
        print(f"[phase 14] card vs CPU: {name} at {NOTES_CARD_CPU_PATHS} x "
              f"{XVA_BLOCKS} paths: {card} vs {cpu}, |d| "
              f"{[abs(a - b) for a, b in pairs]} (tol {tol:.2e})")
        check(all(abs(a - b) <= tol for a, b in pairs),
              f"{name} on the card vs the CPU")


def phase14_tf32(cfg, g2, dev):
    """The G2++ product ``dot(xn, LT)`` (x, y, I at the netting book's four
    dates: 12 functionals at 2^20 paths) and the Hull-White Bermudan
    product ``sig_st dot(x, LT)`` (r, I at the four exercise dates) through
    ``_tf32_gate``."""
    import torch

    from hullwhite_tpu_torch import Key, xva
    from hullwhite_tpu_torch.bermudan import _functional_chol
    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.models.g2pp import _g2_functional_chol
    from hullwhite_tpu_torch.ops.rng import block_normals

    key = Key(cfg.seed).fold_in(9292)
    dates = xva.exposure_dates(cfg, XVA14_TENOR)
    LT = torch.as_tensor(_g2_functional_chol(g2, xva._g2_specs(dates)),
                         device=dev)
    xn = block_normals(key, 0, (cfg.n_paths, 3 * len(dates)), device=dev)
    _tf32_gate("phase 14", "the G2++ XVA product xn @ LT", xn, LT,
               cfg.matmul_precision)
    specs = tuple([("r", t) for t in XVA14_BERM_EX]
                  + [("I", t) for t in XVA14_BERM_EX])
    LT = torch.as_tensor(_functional_chol(cfg, specs), device=dev)
    x = block_normals(key, 0, (cfg.n_paths, len(specs)), device=dev)
    sig_st = float(hw.step_tables(cfg, cfg.sigma, cfg.sigma,
                                  device="cpu").sig_st)
    _tf32_gate("phase 14", "the Bermudan exposure product sig_st x @ LT",
               x, LT, cfg.matmul_precision, scale=sig_st)


def phase14(dev, smi, market):
    """The G2++ twins of the XVA layer and the Bermudan exposure on phase
    10's curve (module docstring, phase 14); returns the kernels' launch
    counts of the whole phase."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models.g2pp import G2Params

    cfg = HWConfig()
    g2 = G2Params()
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    wall = phase14_oracles(cfg, g2, market, smi)
    res, cli_wall, fresh = phase14_cli(cfg, dev, market)
    g2res = res["g2"]
    for name, z in (("g2 cva", g2res["cva_z"]),
                    ("g2 netting", g2res["netting"]["cva_z"]),
                    ("g2 csa", g2res["csa"]["cva_z"]),
                    ("g2 bilateral BCVA", g2res["bilateral"]["bcva_z"]),
                    ("g2 bilateral FVA", g2res["bilateral"]["fva_z"]),
                    ("g2 wwr", g2res["wwr"]["cva_z"]),
                    ("g2 wwr dCVA/dgamma", g2res["wwr"]["gamma_delta_z"]),
                    ("g2 mva", g2res["mva"]["mva_z"]),
                    ("g2 kva", g2res["kva"]["kva_z"]),
                    ("bermudan", res["bermudan"]["cva_z"])):
        print(f"[phase 14] cli xva {name}: z = {z:+.2f}")
    for tag, b in (("bermudan", res["bermudan"]),
                   ("g2 bermudan", g2res["bermudan"])):
        print(f"[phase 14] cli xva {tag}: DP price {b['price']:.8f}, "
              f"stopping identity {b['stopping_identity']:.1e}, CVA MC "
              f"{b['cva_mc']:.10f} +/- {b['cva_se']:.2e}, oracle "
              f"{b['cva_oracle']:.10f}, |d| "
              f"{abs(b['cva_mc'] - b['cva_oracle']):.2e}")
    print(f"[phase 14] cli xva --g2 --bermudan: {cli_wall:.1f} s; oracle "
          f"entries it added to the memo: {fresh}")
    phase14_tf32(cfg, g2, dev)
    phase14_card_vs_cpu(cfg, g2, dev, market)
    times = _note_times(_xva14_calls(cfg, g2, Key(cfg.seed).fold_in(9292),
                                     market, dev),
                        cfg, smi, wall, "phase 14")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[phase 14] times per call at {cfg.n_paths} x {XVA_BLOCKS} paths "
          f"[{smi}]: " + json.dumps(times))
    print(f"[phase 14] peak device memory of the phase: {peak:.2f} GiB "
          f"[{smi}]; phase wall {time.perf_counter() - t0:.1f} s")
    return fused.launch_counts()


# ---------------------------------------------------------------------------
# phase 15: the path mesh (parallel/mesh.py on torch.distributed) and cli
# pipeline
# ---------------------------------------------------------------------------

# the fused kernels a rank of the mesh launches at a non-zero base tile,
# with the seed kind and the pairs per tile of each
MESH_KERNELS = (("curve_exact", "curve", "CURVE_TILE_PATHS"),
                ("zbc_exact", "zbc", "OPTION_TILE_PATHS"),
                ("vega_exact", "vega", "OPTION_TILE_PATHS"),
                ("grid_exact", "grid", "OPTION_TILE_PATHS"),
                ("curve_full", "curve", "CURVE_FULL_TILE_PATHS"),
                ("zbc_full", "zbc", "OPTION_FULL_TILE_PATHS"),
                ("vega_full", "vega", "OPTION_FULL_TILE_PATHS"))
MESH_CHECK_PAIRS = 1 << 16
# rank 1's first block in cli sweep --mesh 2 (2^24 pairs in blocks of 2^15)
MESH_BASE_BLOCK = 256
# the kernels of cli sweep's default engine (fused_exact)
SWEEP_KERNELS = ("curve_exact", "zbc_exact", "vega_exact", "grid_exact")
# cli sweep --mesh 2 against --mesh 1: the JAX package's tolerances of its
# sharded runs against the single-device ones (tests/test_sharding.py,
# tests/test_grid.py::test_grid_sharded)
SWEEP_TOL = dict(P10_rel=1e-5, zbc=1e-6, vega=1e-6, grid_mid=1e-6)
# the keys of the JAX package's data/pipeline_results.json
PIPELINE_KEYS = ("cap", "cva", "g2_calibration", "g2_netted_cva", "g2_zbc",
                 "hw_calibration", "range_accrual", "swaption")


def phase15_base_tiles(dev):
    """Each fused kernel that a rank launches, at MESH_CHECK_PAIRS pairs
    from rank 1's first tile of a 2-rank 2^24-pair sweep, against its plain
    version at the same base tile (``compare``'s tolerances); its result
    must differ from the run at base tile 0 (the base tile reaches the
    stream).  Returns the errors."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key, cli
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import hull_white as hw

    cfg = HWConfig()
    key = Key(2026)
    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
    market = analytic_market(cfg, dev)
    cp = fused.curve_prepared(cfg, tables)
    op = fused.option_prepared(cfg, tables, market, cfg.sigma)
    consts = torch.as_tensor(op.consts, device=dev)
    cfp = fused.curve_full_prepared(cfg, tables)
    ofp = fused.option_full_prepared(cfg, tables, market, cfg.sigma)
    consts_full = torch.as_tensor(ofp.consts, device=dev)
    gp = fused.grid_prepared(cfg, tables, market, cfg.sigma,
                             *cli.grid_axes(cfg))
    grid_ops = [torch.as_tensor(x, device=dev)
                for x in (gp.consts, gp.Bs, gp.Ks)]
    prec, n_live = cfg.matmul_precision, cfg.n_mat - 1
    pairs = {
        "curve_exact": (
            lambda s, n: fused.curve_exact(s, cp, n, n_live, prec),
            lambda s, n: fused.curve_exact_plain(s, cp.W, cp.c, n, n_live,
                                                 prec)),
        "zbc_exact": (lambda s, n: fused.zbc_exact(s, op, n),
                      lambda s, n: fused.zbc_exact_plain(s, consts, n)),
        "vega_exact": (lambda s, n: fused.vega_exact(s, op, n),
                       lambda s, n: fused.vega_exact_plain(s, consts, n)),
        "grid_exact": (lambda s, n: fused.grid_exact(s, gp, n),
                       lambda s, n: fused.grid_exact_plain(s, *grid_ops, n)),
        "curve_full": (
            lambda s, n: fused.curve_full(s, cfp, n, cfg.n_mat, prec),
            lambda s, n: fused.curve_full_plain(s, cfp.W, cfp.exp_c, n,
                                                cfg.n_mat, prec)),
        "zbc_full": (
            lambda s, n: fused.zbc_full(s, ofp, n, prec),
            lambda s, n: fused.zbc_full_plain(s, ofp.W, consts_full, n,
                                              prec)),
        "vega_full": (
            lambda s, n: fused.vega_full(s, ofp, n, prec),
            lambda s, n: fused.vega_full_plain(s, ofp.W, consts_full, n,
                                               prec))}
    err = {}
    for name, kind, tile_attr in MESH_KERNELS:
        tile = getattr(fused, tile_attr)
        base = MESH_BASE_BLOCK * (cfg.path_block // tile)
        n_tiles = MESH_CHECK_PAIRS // tile
        seeds = fused.kernel_seeds(key, kind, base)
        kern, plain = pairs[name]
        k = kern(seeds, n_tiles)
        p = plain(seeds, n_tiles)
        torch.cuda.synchronize()
        err[name], text = compare(name, k, p)
        k0 = kern(fused.kernel_seeds(key, kind, 0), n_tiles)
        check(not torch.equal(k, k0), f"{name}: base tile {base} gives the "
              "base-0 result")
        print(f"[phase 15] {name} at base tile {base}, {n_tiles} tiles "
              f"({MESH_CHECK_PAIRS} pairs) vs its plain version: {text}")
    return err


def phase15_nccl(dev):
    """A 1-rank NCCL group (``parallel.launch``) running bootstrap_curve,
    price_zbc and pathwise_vega through the mesh at full width, each bitwise
    equal to the same call without the mesh in the same rank."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key
    from hullwhite_tpu_torch.parallel import launch

    cfg = HWConfig()
    key = Key(2026)
    market = analytic_market(cfg, "cpu")
    names = ("bootstrap_curve", "price_zbc", "pathwise_vega")
    calls = [("hullwhite_tpu_torch.pricing:bootstrap_curve", (cfg, key), {}),
             ("hullwhite_tpu_torch.pricing:price_zbc", (cfg, key, market),
              {}),
             ("hullwhite_tpu_torch.pricing:pathwise_vega",
              (cfg, key, market), {})]
    _, backend = launch.placement(1, dev)
    check(backend == "nccl", f"a 1-rank group on the card is {backend}")
    t0 = time.perf_counter()
    (res,) = launch.run("hullwhite_tpu_torch.parallel.launch:call_each", 1,
                        calls, device=dev, single=True)
    wall = time.perf_counter() - t0
    for name, (mesh_run, single) in zip(names, res):
        if name == "bootstrap_curve":
            same = torch.equal(mesh_run.P, single.P)
            value = float(mesh_run.P[-1])
        elif name == "price_zbc":
            same = (torch.equal(mesh_run.price, single.price)
                    and torch.equal(mesh_run.beta, single.beta))
            value = float(mesh_run.price)
        else:
            same = torch.equal(mesh_run, single)
            value = float(mesh_run)
        print(f"[phase 15] 1-rank NCCL mesh {name}: {value!r}, bitwise equal "
              f"to the meshless run: {same}")
        check(same, f"{name} through the 1-rank NCCL mesh differs")
    print(f"[phase 15] 1-rank NCCL group: {wall:.1f} s from spawn to exit")


def phase15_cli(dev, smi):
    """``cli q1``, then ``cli pipeline`` on its curve and ``cli sweep`` at
    2^24 pairs with ``--mesh 1`` (NCCL) and ``--mesh 2`` (two gloo ranks
    on the card), in a fresh directory; returns the sweeps' kernel
    launches."""
    argv = ["--device", str(dev)]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            _cli(["q1", "--reps", "1", *argv], "phase 15")
            text = _cli(["pipeline", *argv], "phase 15")
            pipe = json.load(open(os.path.join("data_torch",
                                               "pipeline_results.json")))
            sweeps = {}
            for n in (1, 2):
                t0 = time.perf_counter()
                _cli(["sweep", "--mesh", str(n), *argv], "phase 15")
                sweeps[n] = json.load(open(os.path.join(
                    "data_torch", "sweep_results.json")))
                sweeps[n]["wall"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    r = pipe["results"]
    check("pipeline validation: PASS" in text and "CHECK" not in text,
          "cli pipeline: a gate failed")
    check(tuple(sorted(r)) == PIPELINE_KEYS,
          f"cli pipeline: the artifact's keys {sorted(r)}")
    check(r["hw_calibration"]["ok"] and r["g2_calibration"]["ok"],
          "cli pipeline: a calibration missed its parameters")
    print(f"[phase 15] cli pipeline: every gate PASS; z "
          + str({k: round(r[k]["z"], 2) for k in PIPELINE_KEYS
                 if "z" in r[k]}))
    one, two = sweeps[1], sweeps[2]
    check(one["performance"]["backend"] == "nccl"
          and two["performance"]["backend"] == "gloo",
          "cli sweep: the backends are "
          f"{one['performance']['backend']}, {two['performance']['backend']}")
    a, b = one["results"], two["results"]
    diffs = {"P10_rel": abs(b["P10"] - a["P10"]) / a["P10"],
             **{k: abs(b[k] - a[k]) for k in ("zbc", "vega", "grid_mid")}}
    for k, d in diffs.items():
        check(d <= SWEEP_TOL[k], f"cli sweep --mesh 2 vs 1: {k} {d:.3e} > "
              f"{SWEEP_TOL[k]}")
    for n, doc in sweeps.items():
        res = doc["results"]
        print(f"[phase 15] cli sweep --mesh {n} ({doc['performance']['backend']}"
              f"): P(0,10) {res['P10']!r}, ZBC {res['zbc']!r}, vega "
              f"{res['vega']!r}, surface mid {res['grid_mid']!r}; ms per "
              f"call (slowest rank) curve {res['curve_ms']:.3f}, ZBC "
              f"{res['zbc_ms']:.3f}, vega {res['vega_ms']:.3f} [{smi}]; "
              f"command {doc['wall']:.1f} s")
    print(f"[phase 15] cli sweep --mesh 2 vs --mesh 1: "
          + str({k: float(f"{d:.3e}") for k, d in diffs.items()})
          + f" (tol {SWEEP_TOL})")
    launches = {}
    for doc in sweeps.values():
        for name, n in doc["performance"]["kernel_launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches


def phase15(dev, smi):
    """The path mesh and cli pipeline (module docstring, phase 15); returns
    the sweep path's kernel launches (counted by its ranks) and the base
    tile errors."""
    t0 = time.perf_counter()
    err = phase15_base_tiles(dev)
    t1 = time.perf_counter()
    phase15_nccl(dev)
    t2 = time.perf_counter()
    launches = phase15_cli(dev, smi)
    print(f"[phase 15] phase wall {time.perf_counter() - t0:.1f} s (base "
          f"tiles {t1 - t0:.1f} s, NCCL group {t2 - t1:.1f} s, CLI "
          f"{time.perf_counter() - t2:.1f} s)")
    return launches, err


# ---------------------------------------------------------------------------
# phase 16: the mesh's second slice (mesh= on the note, exotic and XVA
# functions) and the certificate parallel/dryrun.py
# ---------------------------------------------------------------------------

MESH2_RANKS = 2
# the companion's ranks (the certificate's 2N) run if the phase has spent
# less than this when the certificate ends
MESH2_COMPANION_BUDGET_S = 90.0
MESH2_TOL = 1e-6
MESH2_NOTE = dict(n_paths=1 << 20, n_blocks=2)
MESH2_XVA = dict(n_paths=1 << 20, n_blocks=4)
# the tail products of the seven modules at MESH2_NOTE, then at MESH2_XVA
# (the RFR caps and range_note's two ran under the mesh in phase 15's
# slice)
MESH2_NOTES = ("snowball", "callable_snowball", "capped_floater",
               "g2_range_note", "g2_tarn", "g2_capped_floater",
               "g2_snowball", "g2_callable_snowball", "chooser_cap",
               "ratchet_cap", "ko_cap", "g2_ratchet_cap", "g2_ko_cap",
               "g2_chooser_cap")
MESH2_XVAS = ("xva", "xva_netting", "xva_csa", "xva_bilateral", "g2_netting",
              "g2_bilateral", "g2_csa", "xva_wwr", "g2_wwr", "xva_mva",
              "g2_mva", "xva_kva", "g2_kva", "bermudan_xva",
              "g2_bermudan_xva")


def phase16_dryrun(dev, t_phase):
    """``dryrun_multichip(2)`` on the card, then its 4-rank companion if
    the phase's budget allows; returns the certificate's kernel launches
    (counted by its ranks)."""
    from hullwhite_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    out = dryrun.dryrun_multichip(MESH2_RANKS, device=dev, companion=False)
    wall = time.perf_counter() - t0
    check(list(out["deltas"]) == dryrun.check_names(),
          "dryrun: the checks differ from the certificate's")
    worst = max(out["deltas"].items(), key=lambda kv: kv[1])
    print(f"[phase 16] dryrun_multichip({MESH2_RANKS}) on the card: "
          f"{len(out['deltas'])} checks within tolerance (largest "
          f"{worst[0]} {worst[1]:.2e}), fused ZBC "
          f"{out['core']['zbc_fused']!r} vs linear {out['core']['zbc']!r}; "
          f"{wall:.1f} s (rank 0 {out['seconds']:.1f} s after spawn); "
          f"launches {out['launches']}")
    check(out["launches"]["zbc_exact"] > 0,
          "dryrun: zbc_exact was not launched under the mesh")
    spent = time.perf_counter() - t_phase
    if spent < MESH2_COMPANION_BUDGET_S:
        t1 = time.perf_counter()
        d = dryrun.run_companion(2 * MESH2_RANKS, device=dev)
        print(f"[phase 16] companion on {2 * MESH2_RANKS} gloo ranks: "
              f"{d}; {time.perf_counter() - t1:.1f} s")
    else:
        print(f"[phase 16] companion skipped: the phase had spent "
              f"{spent:.1f} s of its {MESH2_COMPANION_BUDGET_S:.0f} s "
              "budget before it")
    return out["launches"]


def _leaf_delta(a, b):
    """(largest |a - b| over the float leaves, every leaf bitwise equal)."""
    import torch

    if isinstance(a, torch.Tensor):
        same = a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
        if not a.is_floating_point():
            return (0.0 if same else math.inf), same
        d = (a.double().cpu() - b.double().cpu()).abs()
        return (float(d.max()) if d.numel() else 0.0), same
    if isinstance(a, (tuple, list)):
        worst, same = 0.0, len(a) == len(b)
        for x, y in zip(a, b):
            dx, sx = _leaf_delta(x, y)
            worst, same = max(worst, dx), same and sx
        return worst, same
    if isinstance(a, float):
        return abs(a - b), a == b
    return (0.0 if a == b else math.inf), a == b


def phase16_full_width(dev, smi):
    """Each ``price_*`` of the seven modules and ``cva_cs01`` at full width
    through a 2-rank gloo mesh on the card against the same call without
    the mesh in the rank (``launch.timed_pairs``)."""
    from hullwhite_tpu_torch import HWConfig, Key
    from hullwhite_tpu_torch.models import g2pp
    from hullwhite_tpu_torch.parallel import dryrun, launch

    cfg = HWConfig()
    key = Key(2026)
    market = analytic_market(cfg, "cpu")
    calls, names = [], []
    for products, kw in ((MESH2_NOTES, MESH2_NOTE), (MESH2_XVAS, MESH2_XVA)):
        tail = dryrun.tail_calls(cfg, key, market, **kw)
        for product in products:
            fn, args, kwargs = tail[product]
            calls.append((f"{fn.__module__}:{fn.__name__}", args, kwargs))
            names.append(f"{fn.__name__} ({product})")
    legs = ((0.02, 3.0, False), (0.012, 2.0, True))
    calls += [("hullwhite_tpu_torch.xva:price_exposure_g2",
               (cfg, g2pp.G2Params(), key, market), dict(MESH2_XVA)),
              ("hullwhite_tpu_torch.xva:cva_cs01", (cfg, key, market, legs),
               dict(quotes=XVA_QUOTES, **MESH2_XVA))]
    names += ["price_exposure_g2", "cva_cs01"]
    # the 30 price_* of the seven modules and cva_cs01, each once
    check(len({path for path, _, _ in calls}) == len(calls) == 31,
          f"{len(calls)} full-width calls, not 31")
    t0 = time.perf_counter()
    ranks = launch.run("hullwhite_tpu_torch.parallel.launch:timed_pairs",
                       MESH2_RANKS, calls, device=dev)
    wall = time.perf_counter() - t0
    for i, name in enumerate(names):
        per = [r[i] for r in ranks]
        delta, same = _leaf_delta(per[0]["sharded"], per[0]["single"])
        _, s_ranks = _leaf_delta(per[0]["sharded"], per[1]["sharded"])
        check(s_ranks, f"{name}: the ranks' mesh results differ")
        check(delta < MESH2_TOL, f"{name}: sharded vs single {delta:.2e}")
        head = dryrun.result_of(per[0]["sharded"])
        value = getattr(head, "price", None)
        for attr in ("cva", "bcva", "mva", "kva", "cva_mc"):
            if value is None:
                value = getattr(head, attr, None)
        ms_mesh = max(r["ms_mesh"] for r in per)
        print(f"[phase 16] {name}: {float(value)!r}; 2-rank mesh vs "
              f"meshless {delta:.2e} (bitwise: {same}); ms per call one "
              f"rank {per[0]['ms_single']:.1f}, two ranks {ms_mesh:.1f} "
              f"[{smi}]")
    print(f"[phase 16] {len(calls)} full-width calls on {MESH2_RANKS} gloo "
          f"ranks: {wall:.1f} s from spawn to exit")


def phase16(dev, smi):
    """The mesh's second slice (module docstring, phase 16); returns the
    certificate's kernel launches, counted by its ranks."""
    t0 = time.perf_counter()
    launches = phase16_dryrun(dev, t0)
    t1 = time.perf_counter()
    phase16_full_width(dev, smi)
    print(f"[phase 16] phase wall {time.perf_counter() - t0:.1f} s "
          f"(certificate {t1 - t0:.1f} s, full width "
          f"{time.perf_counter() - t1:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the CUDA kernel analysis (utils/profile.py), cli q3 --profile /
# --trace, cli all --profile with its engine table, and analyze
# ---------------------------------------------------------------------------

# (datasheet name, ptxas name and source) of each engine's vega step
PROFILE_KERNELS = {"fused_exact": ("vega_exact",),
                   "fused": ("vega_full", "vega_full_reduce")}
# the kernels' names in the profiler's trace and their launch counters
TRACE_KERNELS = {"fused_exact": (("vega_exact_kernel", "vega_exact"),),
                 "fused": (("vega_full_kernel", "vega_full"),
                           ("reduce_kernel", "vega_full"))}


def _cli_out(argv, tag):
    """``cli.main(argv)``, its stdout echoed and returned; rc 0 or fail."""
    import contextlib
    import io

    from hullwhite_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    text = out.getvalue()
    for line in text.splitlines():
        print(f"[{tag}] | {line}")
    print(f"[{tag}] cli {' '.join(argv)}: rc {rc}, "
          f"{time.perf_counter() - t0:.1f} s")
    check(rc == 0, f"cli {' '.join(argv)} failed")
    return text


def phase17_report(cfg, dev, engine, smi):
    """The analysis of ``engine``'s vega step against the kept ptxas log,
    the attribute queries and the roofline's bound unit."""
    from hullwhite_tpu_torch.kernels import fused, roofline
    from hullwhite_tpu_torch.utils import profile

    rep = profile.kernel_report(cfg, engine, "vega", device=dev)
    check([k["sheet"] for k in rep["kernels"]] == list(
        PROFILE_KERNELS[engine]), f"{engine}: the report's kernels")
    for k in rep["kernels"]:
        print(f"[phase 17] {engine}: {k['name']} ({k['source']}): registers "
              f"{k['registers']} (ptxas {k['ptxas_registers']}), spills "
              f"{k['spill_stores']}/{k['spill_loads']} B, shared "
              f"{k['static_smem']} + {k['dynamic_smem']} B, local "
              f"{k['local_bytes']} B, threads {k['threads']} (max "
              f"{k['max_threads']}), {k['ctas_per_sm']} CTAs/SM, grid "
              f"{k['grid']} [{smi}]")
        check(k["registers"] == k["ptxas_registers"],
              f"{k['name']}: registers differ from the ptxas log's")
        check(k["spill_stores"] == 0 and k["spill_loads"] == 0
              and k["local_bytes"] == 0, f"{k['name']} spills")
        check(k["ctas_per_sm"] >= 1, f"{k['name']}: no CTA fits an SM")
    p = rep["peaks"]
    bound = roofline.kernel_bounds(cfg, p["max_sm_mhz"], p["sms"])[
        PROFILE_KERNELS[engine][0]]
    lf = profile.limiting_factor(rep)
    print(f"[phase 17] {engine}: limiting factor {lf['factor']} "
          f"({lf['detail']}); kernel_bounds' unit {bound['bound_unit']}; "
          f"card {rep['card']['sms']} SMs, {p['max_sm_mhz']:.0f} MHz, HBM "
          f"{p['hbm_bytes_per_s'] / 1e12:.3f} TB/s [{smi}]")
    check(lf["unit"] == bound["bound_unit"], f"{engine}: limiting unit "
          f"{lf['unit']} is not kernel_bounds' {bound['bound_unit']}")
    limit = rep["card"]["smem_per_block"]
    for name, row in fused.smem_datasheet(cfg, device=dev).items():
        print(f"[phase 17] datasheet {name}: threads {row['threads']} (max "
              f"{row['max_threads']}), shared {row['dynamic_smem']} dynamic "
              f"+ {row['static_smem']} static B (the kernel's dynamic limit "
              f"{row['max_dynamic_smem']}, the card's {limit}), grid "
              f"{row['grid']}, {row['registers']} registers, "
              f"{row['ctas_per_sm']} CTAs/SM [{smi}]")
        check(row["dynamic_smem"] + row["static_smem"] <= limit
              and row["dynamic_smem"] <= row["max_dynamic_smem"]
              and row["threads"] <= row["max_threads"]
              and row["ctas_per_sm"] >= 1 and row["grid"] >= 1,
              f"datasheet {name}: the launch does not fit")
    return rep


def phase17_q3(engine, dev, plain, smi):
    """``cli q3 --profile --trace DIR`` in this process against ``cli q3``
    on the same key (``plain``: its results and launches): the same
    results; the report printed before the timed loop; the trace's kernel
    events as many as the launch counters moved in the traced call, the
    one call the flagged command adds.  Returns its launches."""
    from hullwhite_tpu_torch.kernels import fused

    trace_dir = os.path.abspath(f"trace_{engine}")
    fused.reset_launch_counts()
    text = _cli_out(["q3", "--engine", engine, "--device", str(dev),
                     "--reps", "1", "--profile", "--trace", trace_dir],
                    "phase 17")
    counts = fused.launch_counts()
    moved = {k: v - plain["launches"][k] for k, v in counts.items()}
    flagged = json.load(open(os.path.join("data_torch", "q3_results.json")))
    same = (flagged["results"] == plain["doc"]["results"]
            and flagged["parameters"] == plain["doc"]["parameters"])
    print(f"[phase 17] {engine}: q3_results.json results with --profile "
          f"--trace equal to without: {same} (vega "
          f"{flagged['results']['sensitivity_mc']!r})")
    check(same, f"{engine}: --profile/--trace changed q3's results")
    for line in ("CUDA kernel analysis", "limiting factor:",
                 "Fused-kernel launch datasheet",
                 f"[trace] profiler trace written to {trace_dir}/"):
        check(line in text, f"{engine}: q3 --profile printed no {line!r}")
    check(text.index("limiting factor:") < text.index("[pathwise"),
          f"{engine}: the report did not precede the timed loop")
    (name,) = os.listdir(trace_dir)
    events = json.load(open(os.path.join(trace_dir, name)))["traceEvents"]
    cats = sorted({str(e.get("cat")) for e in events})
    # the port's kernels sit in an anonymous namespace (PyTorch's own
    # reductions are at::native::reduce_kernel)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"
               and ("anonymous namespace" in e["name"]
                    or "_GLOBAL__N_" in e["name"])]
    for kernel, counter in TRACE_KERNELS[engine]:
        n = sum(kernel in k for k in kernels)
        print(f"[phase 17] {engine}: trace {name} ({len(events)} events, "
              f"categories {cats}): {n} {kernel} events, {counter} launches "
              f"in the traced call {moved[counter]} [{smi}]")
        check(n == moved[counter] > 0, f"{engine}: the trace holds {n} "
              f"{kernel} events for {moved[counter]} launches")
    return counts


def phase17(dev, smi):
    """The CUDA kernel analysis (module docstring, phase 17); returns the
    kernels' launches of its cli runs."""
    import importlib.util

    from hullwhite_tpu_torch import HWConfig
    from hullwhite_tpu_torch.analyze import NO_MATPLOTLIB
    from hullwhite_tpu_torch.kernels import fused

    t0 = time.perf_counter()
    cfg = HWConfig()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fused.reset_launch_counts()
            _cli_out(["q1", "--device", str(dev)], "phase 17")
            launches = fused.launch_counts()
            for engine in ("fused_exact", "fused"):
                phase17_report(cfg, dev, engine, smi)
                fused.reset_launch_counts()
                _cli_out(["q3", "--engine", engine, "--device", str(dev),
                          "--reps", "1"], "phase 17")
                plain = {"launches": fused.launch_counts(),
                         "doc": json.load(open(os.path.join(
                             "data_torch", "q3_results.json")))}
                flagged = phase17_q3(engine, dev, plain, smi)
                launches = {k: v + plain["launches"][k] + flagged[k]
                            for k, v in launches.items()}
            os.makedirs("all")
            os.chdir("all")
            fused.reset_launch_counts()
            _cli_out(["all", "--profile", "--reps", "1", "--device",
                      str(dev)], "phase 17")
            counts = fused.launch_counts()
            res = {name: json.load(open(os.path.join(
                "data_torch", f"{name}_results.json")))
                for name in ("q1", "q2a", "q2b", "q3")}
            table = json.load(open(os.path.join(
                "data_torch", "benchmark_engines.json")))
            written = sorted(os.listdir("data_torch"))
            proc = subprocess.run(
                [sys.executable, "-m", "hullwhite_tpu_torch.analyze",
                 "--data-dir", "data_torch", "--plots-dir", "plots_torch"],
                cwd=os.getcwd(), capture_output=True, text=True, timeout=300,
                env=dict(os.environ, PYTHONPATH=cwd))
        finally:
            os.chdir(cwd)
    check_results(cfg, "fused_exact", res, "phase 17")
    tiers = sorted(table["results"]["engines"])
    print(f"[phase 17] cli all --profile: engine table over {tiers}: "
          f"consistency {table['results']['consistency_pass']}; launches "
          f"{counts}")
    check(table["results"]["consistency_pass"] is True
          and {"fused", "fused_exact"} <= set(tiers),
          "cli all: the engine table's price consistency or its fused tiers")
    for name in ("curve_exact", "zbc_exact", "vega_exact", "zbc_full"):
        check(counts[name] > 0, f"cli all did not launch {name}")
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    summary = proc.stdout.splitlines()
    for line in summary:
        print(f"[phase 17] analyze | {line}")
    tasks = [res[q]["task"] for q in res] + [table["task"]]
    print(f"[phase 17] analyze: rc {proc.returncode}, files written "
          f"{written}")
    check(proc.returncode == 0, f"analyze failed: {proc.stderr[-2000:]}")
    check("HULLWHITE_TPU_TORCH RUN SUMMARY" in summary, "analyze title")
    for task in tasks:
        check(any(line.startswith(f"[{task}]") for line in summary),
              f"analyze's summary does not name {task}")
    if importlib.util.find_spec("matplotlib") is None:
        check(summary[-1] == NO_MATPLOTLIB, "analyze: no no-plot line")
    else:
        check(any(line.startswith("saved ") for line in summary),
              "analyze made no plot")
    print(f"[phase 17] phase wall {time.perf_counter() - t0:.1f} s [{smi}]")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    from hullwhite_tpu_torch import HWConfig, Key, pricing
    from hullwhite_tpu_torch.kernels import build

    # phase 0
    smi = nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"[phase 0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{kind}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    print(f"[phase 0] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_INFO['seconds']:.1f} s): "
          f"{build.library_path().name}")
    for line in build.BUILD_INFO["log"].splitlines():
        if ("Used" in line and "registers" in line) or "spill" in line \
                or "Performance Loss" in line:
            print(f"[phase 0] ptxas: {line.strip()}")

    # phase 17 runs first: its traces need a context whose kernel
    # timestamps still match the host's clock (PERF.md, open questions)
    profile_counts = phase17(dev, smi)
    err, times, normals_launches = phase1(dev)
    # each path's run and its kernels; the surface kernel serves both
    # engines' cli grid
    paths = {"fused_exact": ("curve_exact", "zbc_exact", "vega_exact",
                             "grid_exact"),
             "fused": ("curve_full", "zbc_full", "vega_full", "grid_exact"),
             "delta/gamma": ("delta_exact",),
             "roofline": ("raw_peak", "draw_peak", "bitops_peak",
                          *EXACT_WALLS)}
    engines = ("fused_exact", "fused")
    counts = {engine: phase2(dev, engine) for engine in engines}
    counts["delta/gamma"] = phase2_delta(dev)
    counts["roofline"] = phase2_roofline(dev, times)
    launches = {}
    for run, kernels in paths.items():
        what = {"delta/gamma": "pathwise_delta + gamma_zbc",
                "roofline": "cli benchmark --roofline"}.get(
                    run, "its cli commands")
        print(f"[phase 3] launches in the {run} main-path run ({what}): "
              f"{counts[run]}")
        for name in kernels:
            check(counts[run][name] > 0,
                  f"kernel {name} was not launched by the {run} path")
            launches[name] = launches.get(name, 0) + counts[run][name]
    print(f"[phase 3] option_normals, the generator's check kernel (not on "
          f"the main path): {normals_launches} launch(es) in its phase-1 "
          f"check window")
    check(normals_launches > 0, "option_normals was not launched")

    cfg = HWConfig()
    market = analytic_market(cfg, dev)
    for engine in engines:
        a = pricing.price_zbc(cfg, Key(11), market, engine=engine, device=dev)
        b = pricing.price_zbc(cfg, Key(11), market, engine=engine, device=dev)
        c1 = pricing.bootstrap_curve(cfg, Key(11), engine=engine, device=dev)
        c2 = pricing.bootstrap_curve(cfg, Key(11), engine=engine, device=dev)
        same_curve = bool(torch.equal(c1.P, c2.P))
        print(f"[phase 4] {engine}: rerun determinism: ZBC "
              f"{float(a.price)!r} == {float(b.price)!r}, curve equal: "
              f"{same_curve}")
        check(float(a.price) == float(b.price) and same_curve,
              f"{engine} reruns differ")
    from hullwhite_tpu_torch import cli, grid

    d1 = pricing.pathwise_delta(cfg, Key(11), market, device=dev)
    d2 = pricing.pathwise_delta(cfg, Key(11), market, device=dev)
    axes = cli.grid_axes(cfg)
    g1 = grid.price_zbc_grid(cfg, Key(11), market, *axes, device=dev)
    g2 = grid.price_zbc_grid(cfg, Key(11), market, *axes, device=dev)
    same_surface = bool(torch.equal(g1.price, g2.price)
                        and torch.equal(g1.beta, g2.beta))
    print(f"[phase 4] rerun determinism: delta {float(d1)!r} == "
          f"{float(d2)!r}, surface equal: {same_surface}")
    check(float(d1) == float(d2) and same_surface, "delta/surface reruns "
          "differ")

    xla_counts = phase5(dev, smi)
    for engine, c in xla_counts.items():
        print(f"[phase 5] launches of the hand-written kernels in the "
              f"{engine} main-path run (cli all, cli grid): "
              f"{sum(c.values())} (the XLA tier is plain PyTorch)")
        check(not any(c.values()), f"the {engine} path launched a kernel")

    qmc_counts = phase6(dev, smi)
    print(f"[phase 6] launches of the hand-written kernels in the RQMC and "
          f"swaption calls (cli swaption, the gates, card vs CPU): "
          f"{sum(qmc_counts.values())} (plain PyTorch)")
    check(not any(qmc_counts.values()), "an RQMC or swaption call launched "
          "a kernel")

    berm_counts = phase7(dev, smi)
    print(f"[phase 7] launches of the hand-written kernels in the Bermudan "
          f"and multi-date calls (cli swaption --bermudan, cap, cms, the "
          f"direct calls, card vs CPU, the timings): "
          f"{sum(berm_counts.values())} (plain PyTorch)")
    check(not any(berm_counts.values()), "a Bermudan or multi-date call "
          "launched a kernel")

    g2_counts = phase8(dev, smi)
    print(f"[phase 8] launches of the hand-written kernels in the "
          f"calibration and G2++ calls (cli calibrate, g2pp, grid --engine "
          f"exact, cms --g2, card vs CPU, the timings): "
          f"{sum(g2_counts.values())} kernel launches (plain PyTorch)")
    check(not any(g2_counts.values()), "a calibration or G2++ call "
          "launched a kernel")

    g2b_counts = phase9(dev, smi)
    print(f"[phase 9] launches of the hand-written kernels in the G2++ "
          f"Bermudan and RFR calls (cli g2pp, rfr --g2 [--averaged|--rqmc], "
          f"the direct calls, card vs CPU, the timings): "
          f"{sum(g2b_counts.values())} kernel launches (plain PyTorch)")
    check(not any(g2b_counts.values()), "a G2++ Bermudan or RFR call "
          "launched a kernel")

    note_counts, note_market = phase10(dev, smi)
    print(f"[phase 10] launches of the hand-written kernels in the note "
          f"calls (cli q1 --engine exact, cli notes, the direct calls, card "
          f"vs CPU, the timings): {sum(note_counts.values())} kernel "
          f"launches (plain PyTorch)")
    check(not any(note_counts.values()), "a note call launched a kernel")

    g2_note_counts = phase11(dev, smi, note_market)
    print(f"[phase 11] launches of the hand-written kernels in the G2++ "
          f"note calls (the direct calls, card vs CPU, the timings): "
          f"{sum(g2_note_counts.values())} kernel launches (plain PyTorch)")
    check(not any(g2_note_counts.values()), "a G2++ note call launched a "
          "kernel")

    exotic_counts = phase12(dev, smi, note_market)
    print(f"[phase 12] launches of the hand-written kernels in the exotics "
          f"calls (cli exotics, the oracles, card vs CPU, the timings): "
          f"{sum(exotic_counts.values())} kernel launches (plain PyTorch)")
    check(not any(exotic_counts.values()), "an exotics call launched a "
          "kernel")

    xva_counts = phase13(dev, smi, note_market)
    print(f"[phase 13] launches of the hand-written kernels in the XVA "
          f"calls (cli xva, the oracles, the TF32 gate, card vs CPU, the "
          f"timings): {sum(xva_counts.values())} kernel launches (plain "
          f"PyTorch)")
    check(not any(xva_counts.values()), "an XVA call launched a kernel")

    xva14_counts = phase14(dev, smi, note_market)
    print(f"[phase 14] launches of the hand-written kernels in the G2++ XVA "
          f"and Bermudan exposure calls (the oracles, cli xva --g2 "
          f"--bermudan, the TF32 gates, card vs CPU, the timings): "
          f"{sum(xva14_counts.values())} kernel launches (plain PyTorch)")
    check(not any(xva14_counts.values()), "a G2++ XVA or Bermudan exposure "
          "call launched a kernel")

    sweep_counts, _ = phase15(dev, smi)
    print(f"[phase 15] launches in the sweep main-path run (cli sweep --mesh "
          f"1 and --mesh 2, counted by the ranks): {sweep_counts}")
    for name in SWEEP_KERNELS:
        check(sweep_counts[name] > 0,
              f"kernel {name} was not launched by the sweep path")
        launches[name] += sweep_counts[name]

    dryrun_counts = phase16(dev, smi)
    print(f"[phase 16] launches in the certificate's run (dryrun_multichip"
          f"({MESH2_RANKS}), counted by its ranks): {dryrun_counts}")
    check(dryrun_counts["zbc_exact"] > 0,
          "kernel zbc_exact was not launched by the certificate's path")
    launches["zbc_exact"] += dryrun_counts["zbc_exact"]

    print(f"[phase 17] launches in the profile's runs (cli q1, q3 --profile "
          f"--trace per fused engine, cli all --profile): {profile_counts}")
    for name in ("curve_exact", "zbc_exact", "vega_exact", "vega_full",
                 "zbc_full"):
        check(profile_counts[name] > 0,
              f"kernel {name} was not launched by the profile's path")
    for name in launches:
        launches[name] += profile_counts[name]

    replaces = {"curve_exact": "hullwhite_tpu/pallas/fused.py:356",
                "zbc_exact": "hullwhite_tpu/pallas/fused.py:512",
                "vega_exact": "hullwhite_tpu/pallas/fused.py:555",
                "delta_exact": "hullwhite_tpu/pallas/fused.py:574",
                "grid_exact": "hullwhite_tpu/pallas/fused.py:768",
                "option_normals": "hullwhite_tpu/pallas/fused.py:743",
                "curve_full": "hullwhite_tpu/pallas/fused.py:320",
                "zbc_full": "hullwhite_tpu/pallas/fused.py:522",
                "vega_full": "hullwhite_tpu/pallas/fused.py:612",
                "raw_peak": "hullwhite_tpu/pallas/fused.py:933",
                "draw_peak": "hullwhite_tpu/pallas/fused.py:971",
                "bitops_peak": "hullwhite_tpu/pallas/fused.py:1025",
                "bm_peak": "hullwhite_tpu/pallas/fused.py:1079",
                "exp_peak": "hullwhite_tpu/pallas/fused.py:1111",
                "recip_peak": "hullwhite_tpu/pallas/fused.py:1142"}
    # bounds at the shapes timed in phase 1: the reference configuration
    # (the exp and reciprocal walls at 2^24 pairs), the surface at the
    # CLI's 5 x 5, this card's SMs and maximum SM clock, the walls' counts
    # from this build's SASS where cuobjdump is at hand
    from hullwhite_tpu_torch.benchmarks import card
    from hullwhite_tpu_torch.kernels import roofline, sass

    hw = card(dev)
    counts_ops = roofline.op_counts()
    print(f"[bounds] integer instructions per word of the walls "
          f"({counts_ops['origin']}): "
          + str({w: counts_ops[w] for w in ("generator", "raw", "bitops")}))
    print(f"[bounds] fp32 and MUFU instructions per Box-Muller element, "
          f"exp and reciprocal ({counts_ops['origin']}): "
          + str({w: counts_ops[w] for w in ("bm", "exp", "recip")}))
    bounds = roofline.kernel_bounds(cfg, hw["sm_clock_max_mhz"], hw["sms"],
                                    counts_ops)
    big = cfg.replace(n_paths=WALL_PAIRS, path_block=1 << 19)
    bounds_big = roofline.kernel_bounds(big, hw["sm_clock_max_mhz"],
                                        hw["sms"], counts_ops)
    for name in ("exp_peak", "recip_peak"):
        bounds[name] = bounds_big[name]
    tool = sass.cuobjdump()
    if tool:  # diagnostic: what the curve kernels' and walls' loops issue
        funcs = sass.parse(sass.disassemble(build.library_path(), tool))
        ng = -(-(cfg.n_mat - 1) // 8)  # the exact curve's instance
        for name, tmpl in (("curve_full", "ILi3EE"),
                           ("curve_exact", f"ILi3ELi{ng}EE"),
                           ("curve_exact", f"ILi1ELi{ng}EE"),
                           ("zbc_full", "ILb0E"),
                           ("vega_full", "ILb0E"), ("bm_peak", ""),
                           ("exp_peak", ""), ("recip_peak", ""),
                           ("zbc_exact", ""), ("vega_exact", ""),
                           ("delta_exact", ""), ("grid_exact", "ILi5EE"),
                           ("option_normals", "")):
            kernel = f"{name}_kernel"
            loops = sass.kernel_loops(funcs, kernel, tmpl)
            for loop in loops:
                print(f"[sass] {name}{tmpl} innermost loop: {loop}")
                if name in WALK_KERNELS and loop["words"] >= 2:
                    # per element (two hashed words), to compare with the
                    # walls' per-item counts in the [bounds] lines
                    per = {u: round(2 * v, 2) for u, v in
                           sass.per_unit(loop, "words").items()}
                    print(f"[sass] {name} per element: {per}")
            if name.startswith("curve"):  # the product is the tensor cores'
                (whole,) = [sass.profile(body) for k, body in funcs.items()
                            if f"{len(kernel)}{kernel}{tmpl}" in k]
                print(f"[sass] {name}{tmpl} whole kernel: {whole}")
                check(whole["mma"] > 0, f"{name} issues no tensor "
                      "instructions")
                # the full-step loops hash (the exact ones' FFMAs are
                # Box-Muller's and the epilogue's)
                check(name == "curve_exact"
                      or not any(loop["ffma"] for loop in loops),
                      f"{name} loops over an FFMA product")
    for kernel in ("curve_exact_kernel", "zbc_exact_kernel",
                   "vega_exact_kernel", "delta_exact_kernel",
                   "grid_exact_kernel", "option_normals_kernel"):
        check(build.BUILD_INFO["log"], "no ptxas log for the library: "
              "registers and spills unchecked")
        report = build.ptxas_report(build.BUILD_INFO["log"], kernel)
        print(f"[ptxas] {kernel} (registers, spill store bytes, spill load "
              f"bytes) per instance: {report}")
        check(report and not any(st or ld for _, st, ld in report),
              f"{kernel} spills")

    def entry(name, n):
        source = {"_full": "fused_full.cu", "_peak": "fused_peak.cu"}.get(
            name[-5:], "fused_grid.cu" if name == "grid_exact"
            else "fused_exact.cu")
        b = bounds[name]
        print(f"[bounds] {name}: {b['bound_ms']:.5f} ms ({b['bound_unit']}, "
              f"{b['origin']}; {times[name][0]:.5f} ms measured, "
              f"{b['bound_ms'] / times[name][0]:.1%} of bound); pipes ms "
              + str({u: round(v, 5) for u, v in b["pipes_ms"].items()}))
        check(b["bound_ms"] <= times[name][0], f"{name} ran faster than its "
              "bound: the count is wrong")
        return {"name": name, "route": "cuda",
                "source": f"hullwhite_tpu_torch/csrc/{source}",
                "replaces": replaces[name], "launches": n,
                "max_abs_err": err[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "bound_unit": b["bound_unit"],
                "library_ms": None}

    print(f"[script] phases 0-17 took {time.perf_counter() - t_script:.1f} "
          f"s [{smi}]")
    # kernels: the main paths', launches counted in each path's run (the
    # surface kernel's summed over both engines' cli grid; the sweep's
    # counted by its ranks and added to the exact tier's);
    # check_kernels: the generator's check kernel, launches counted in its
    # own window
    print(json.dumps({
        "kernels": [entry(name, n) for name, n in launches.items()],
        "check_kernels": [entry("option_normals", normals_launches)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
