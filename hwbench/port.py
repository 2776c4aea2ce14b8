"""The program side of the products: the port's configuration, key and
market curve built from the benchmark's data.  The port is imported inside
the functions, so the harness's own modules load without it."""

from __future__ import annotations

import numpy as np
import torch

HW_FIELDS = ("n_steps", "n_mat", "t_final", "a", "sigma", "r0", "s1", "s2",
             "strike", "path_block", "matmul_precision")


def hw_config(config: dict, n_pairs: int):
    """The port's ``HWConfig`` of a configuration file at ``n_pairs``."""
    from hullwhite_tpu_torch.config import HWConfig, ThetaSpec

    return HWConfig(n_paths=int(n_pairs), theta=ThetaSpec(**config["theta"]),
                    **{k: config[k] for k in HW_FIELDS})


def key(words: tuple):
    """The port's key of the two words (the benchmark's request key)."""
    from hullwhite_tpu_torch.ops.rng import Key

    return Key(words=words)


def market(P: np.ndarray, f: np.ndarray, device):
    """The port's market curve of the benchmark's float32 curve."""
    from hullwhite_tpu_torch.models.hull_white import MarketCurve

    return MarketCurve(P=torch.as_tensor(P, dtype=torch.float32,
                                         device=device),
                       f=torch.as_tensor(f, dtype=torch.float32,
                                         device=device))
