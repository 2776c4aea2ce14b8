"""Where the full-step curve kernel's time goes, on one CUDA device.

    python -m hullwhite_tpu_torch.utils.curve_profile [--out FILE]

At the reference configuration ``HWConfig()`` (2^20 paths, 1000 steps,
101 maturities), for each precision ("highest": three bf16 passes of the
split W; "default": one):

* ``ms``: the kernel's device time per call with its reduce pass
  (``utils.timing.bench(hold=True)``: CUDA events, min of 3 windows of 20
  calls queued behind a sleep kernel);
* ``max_rel`` and ``mean_signed_rel``: its maturity sums against the plain
  version's on the same seeds (fp32 products on the card);
* ``ms_by_mask``: the same launches with the prepared live mask replaced:
  ``"none"`` multiplies nothing (the hash, the W staging and the epilogue
  alone: the kernel's floor without a product), ``"all"`` every block-quad
  (the product over all 128 columns), ``"prepared"`` the mask itself.
  Only the prepared mask's sums are right; the others time the kernel.

Prints one JSON object (and writes it to ``--out`` when given), with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import torch

from .timing import bench


def profile_curve(n_calls: int = 20) -> dict:
    from ..benchmarks import card
    from ..config import HWConfig
    from ..kernels import fused
    from ..models import hull_white as hw
    from ..ops.rng import Key

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = HWConfig()
    prepared = fused.curve_full_prepared(
        cfg, hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev))
    seeds = fused.kernel_seeds(Key(cfg.seed), "curve")
    n_tiles = cfg.n_paths // fused.TILE_FULL
    nb = prepared.live.numel()
    masks = {"prepared": prepared.live,
             "none": torch.zeros(nb, dtype=torch.int32, device=dev),
             "all": torch.full((nb,), 0xFFFF, dtype=torch.int32, device=dev)}
    out = {"device": card(dev), "n_paths": cfg.n_paths,
           "live_masks": prepared.live.tolist()}
    for prec in ("highest", "default"):
        k = fused.curve_full(seeds, prepared, n_tiles, cfg.n_mat, prec)
        p = fused.curve_full_plain(seeds, prepared.W, prepared.exp_c, n_tiles,
                                   cfg.n_mat, prec)
        rel = (k[1:] - p[1:]) / p[1:]
        row = {"count_equal": bool(k[0] == p[0]),
               "max_rel": float(rel.abs().max()),
               "mean_signed_rel": float(rel.mean()), "ms_by_mask": {}}
        for name, mask in masks.items():
            run = prepared._replace(live=mask)
            row["ms_by_mask"][name] = bench(
                fused.curve_full, seeds, run, n_tiles, cfg.n_mat, prec,
                device=dev, n=n_calls, hold=True)[0] * 1e3
        row["ms"] = row["ms_by_mask"]["prepared"]
        out[prec] = row
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
