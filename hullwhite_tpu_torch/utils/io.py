"""I/O and reporting in the CUDA reference's schema (PyTorch port of
``hullwhite_tpu.utils.io``).

Q1 persists the bootstrapped curves, Q2/Q3 load them; results are JSON
with the reference's parameter header, CSV timeseries and comparisons, raw
fp32 ``.bin`` dumps and a cumulative ``summary.txt``.  Everything goes to
``data_torch/`` under the working directory, never ``data/``: the JAX
package's ``data/*.json`` back its RESULTS.md claims.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import HWConfig
from ..models.hull_white import MarketCurve

DATA_DIR = Path("data_torch")


def ensure_dir(path=DATA_DIR):
    Path(path).mkdir(parents=True, exist_ok=True)
    return Path(path)


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float32)


def save_market(cfg: HWConfig, market: MarketCurve, path=None):
    path = Path(path or DATA_DIR / "market.npz")
    ensure_dir(path.parent)
    P, f = _np32(market.P), _np32(market.f)
    np.savez(path, P=P, f=f, n_mat=cfg.n_mat, t_final=cfg.t_final)
    # raw fp32 .bin files byte-compatible with the reference
    save_bin(path.parent / "P.bin", P)
    save_bin(path.parent / "f.bin", f)
    return path


def load_market(cfg: HWConfig, path=None, *, device) -> MarketCurve:
    path = Path(path or DATA_DIR / "market.npz")
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found. Did you run Q1 first? "
            "(python -m hullwhite_tpu_torch.cli q1)")
    z = np.load(path)
    if int(z["n_mat"]) != cfg.n_mat:
        raise ValueError(
            f"market data has n_mat={int(z['n_mat'])}, config wants {cfg.n_mat}")
    return MarketCurve(P=torch.as_tensor(z["P"], device=device),
                       f=torch.as_tensor(z["f"], device=device))


def save_bin(path, arr):
    """Raw little-endian fp32 dump (format of the reference's save_array)."""
    _np32(arr).tofile(path)


def _param_header(cfg: HWConfig):
    return {"N_PATHS": cfg.n_paths, "N_STEPS": cfg.n_steps,
            "N_MAT": cfg.n_mat, "T_FINAL": cfg.t_final, "a": cfg.a,
            "sigma": cfg.sigma, "r0": cfg.r0}


def write_json(path, task: str, cfg: HWConfig, results: dict,
               performance: dict | None = None, arrays: dict | None = None):
    doc = {"task": task,
           "timestamp": time.strftime("%a %b %d %H:%M:%S %Y"),
           "parameters": _param_header(cfg)}
    if arrays:
        doc.update({k: np.asarray(_np32(v), np.float64).round(8).tolist()
                    for k, v in arrays.items()})
    if performance:
        doc["performance"] = performance
    doc["results"] = results
    ensure_dir(Path(path).parent)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return path


def performance_block(time_ms: float, n_paths: int, device: str):
    """Schema of the reference's json_write_performance, plus the device
    the time was measured on."""
    return {"simulation_time_ms": round(time_ms, 3),
            "throughput_Mpaths_per_sec": round(n_paths / time_ms / 1e3, 2),
            "device": device}


def csv_timeseries(path, header: str, data, spacing: float):
    ensure_dir(Path(path).parent)
    arr = np.asarray(_np32(data), np.float64)
    with open(path, "w") as f:
        f.write(f"T,{header}\n")
        for i, v in enumerate(arr):
            f.write(f"{i * spacing:.4f},{v:.8f}\n")
    return path


def csv_comparison(path, x, y1, y2, names):
    ensure_dir(Path(path).parent)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for xi, a, b in zip(_np32(x), _np32(y1), _np32(y2)):
            f.write(f"{xi:.4f},{a:.8f},{b:.8f}\n")
    return path


def csv_rows(path, header: list, rows):
    ensure_dir(Path(path).parent)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(f"{v:.10f}" if isinstance(v, float) else str(v)
                             for v in row) + "\n")
    return path


def summary_init(cfg: HWConfig, path=None):
    path = Path(path or DATA_DIR / "summary.txt")
    ensure_dir(path.parent)
    bar = "=" * 80
    with open(path, "w") as f:
        f.write(f"{bar}\nHULL-WHITE MODEL SIMULATION RESULTS "
                f"(hullwhite_tpu_torch)\n{bar}\n")
        f.write(f"Generated: {time.ctime()}\n\n")
        f.write("Parameters:\n")
        f.write(f"  N_PATHS = {cfg.n_paths} (x2 antithetic = "
                f"{2 * cfg.n_paths} effective)\n")
        f.write(f"  N_STEPS = {cfg.n_steps}\n  N_MAT = {cfg.n_mat}\n")
        f.write(f"  T_FINAL = {cfg.t_final} years\n")
        f.write(f"  a = {cfg.a}, sigma = {cfg.sigma}, r0 = {cfg.r0}\n")
    return path


def summary_append(section: str, lines, path=None):
    path = Path(path or DATA_DIR / "summary.txt")
    ensure_dir(path.parent)
    bar = "=" * 80
    with open(path, "a") as f:
        f.write(f"\n{bar}\n{section}\n{bar}\n")
        for line in lines:
            f.write(f"  {line}\n")
    return path
