"""Where the curve kernels' time goes, on one CUDA device.

    python -m hullwhite_tpu_torch.utils.curve_profile [--out FILE]

At the reference configuration ``HWConfig()`` (2^20 pairs, 1000 steps,
101 maturities), for each tier (``curve_full``, the full-step kernel;
``curve_exact``, the exact one) and each precision ("highest": the split
passes; "default": one bf16 pass):

* ``ms``: the kernel's device time per call with its reduce pass
  (``utils.timing.bench(hold=True)``: CUDA events, min of 3 windows of 20
  calls queued behind a sleep kernel);
* ``max_rel`` and ``mean_signed_rel``: its maturity sums against the plain
  version's on the same seeds (fp32 products on the card);
* ``ms_by_mask``: the same launches with the prepared live mask replaced:
  ``"none"`` multiplies nothing (the generator, the W staging and the
  epilogue alone: full step, the hash; exact, Box-Muller and the exp and
  reciprocal epilogue: the kernel's floor without a product), ``"all"``
  every block-quad or quad tile (the product over all 128 columns),
  ``"prepared"`` the mask itself.  Only the prepared mask's sums are
  right; the others time the kernel.

Prints one JSON object (and writes it to ``--out`` when given), with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .timing import bench


def _tier_rows(run, plain, prepared, masks, dev, n_calls) -> dict:
    """Per precision: the kernel against the plain version, then its time
    under each mask (``prepared.live`` replaced)."""
    out = {}
    for prec in ("highest", "default"):
        k, p = run(prepared, prec), plain(prec)
        rel = (k[1:] - p[1:]) / p[1:]
        row = {"count_equal": bool(k[0] == p[0]),
               "max_rel": float(rel.abs().max()),
               "mean_signed_rel": float(rel.mean()), "ms_by_mask": {}}
        for name, mask in masks.items():
            row["ms_by_mask"][name] = bench(
                run, prepared._replace(live=mask), prec, device=dev,
                n=n_calls, hold=True)[0] * 1e3
        row["ms"] = row["ms_by_mask"]["prepared"]
        out[prec] = row
    return out


def profile_curve(n_calls: int = 20) -> dict:
    from ..benchmarks import card
    from ..config import HWConfig
    from ..kernels import fused
    from ..models import hull_white as hw
    from ..ops.rng import Key

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = HWConfig()
    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
    seeds = fused.kernel_seeds(Key(cfg.seed), "curve")
    out = {"device": card(dev), "n_paths": cfg.n_paths}
    prepared = fused.curve_full_prepared(cfg, tables)
    n_tiles = cfg.n_paths // fused.TILE_FULL
    nb = prepared.live.numel()
    masks = {"prepared": prepared.live,
             "none": torch.zeros(nb, dtype=torch.int32, device=dev),
             "all": torch.full((nb,), 0xFFFF, dtype=torch.int32, device=dev)}
    out["curve_full"] = {
        "live_masks": prepared.live.tolist(),
        **_tier_rows(
            lambda pr, prec: fused.curve_full(seeds, pr, n_tiles, cfg.n_mat,
                                              prec),
            lambda prec: fused.curve_full_plain(
                seeds, prepared.W, prepared.exp_c, n_tiles, cfg.n_mat, prec),
            prepared, masks, dev, n_calls)}
    prepared = fused.curve_prepared(cfg, tables)
    n_tiles = cfg.n_paths // fused.CURVE_TILE_PATHS
    k = cfg.n_mat - 1
    n = prepared.live.size
    masks = {"prepared": prepared.live, "none": np.zeros(n, np.int32),
             "all": np.full(n, 0xF, np.int32)}
    out["curve_exact"] = {
        "live_masks": prepared.live.tolist(),
        **_tier_rows(
            lambda pr, prec: fused.curve_exact(seeds, pr, n_tiles, k, prec),
            lambda prec: fused.curve_exact_plain(
                seeds, prepared.W, prepared.c, n_tiles, k, prec),
            prepared, masks, dev, n_calls)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("curve_profile: torch.cuda.is_available() is False")
    text = json.dumps(profile_curve(args.calls), indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
