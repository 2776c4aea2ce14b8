"""Q1: one curve bootstrap a request, ``pricing.curve_pricer(...).run`` on
a fresh key at the traffic's pairs.  Its outputs are the (n_mat,) discount
sums [count, e^{-c_m} sum over both legs]; the port's finish is
P(0, T_m) = sums / (2 n_pairs).  Compared: the largest relative gap of P
over the maturities, against the float64 reference on the same key."""

from __future__ import annotations

import numpy as np
import torch

from hwbench import port
from hwbench import reference as ref

NUMBERS = ("p_rel",)


class Program:
    def __init__(self, config: dict, traffic: dict, device, spans):
        from hullwhite_tpu_torch import pricing

        self.cfg = port.hw_config(config, traffic["pairs"])
        self.pricer = pricing.curve_pricer(self.cfg, engine=config["engine"],
                                           device=device)
        self.spans = spans
        self.n_out = self.cfg.n_mat
        self.prepared = None

    def prepare(self):
        self.prepared = self.pricer.prepare(self.cfg.sigma, self.cfg.sigma)

    def submit(self, words: tuple, out: torch.Tensor):
        """Enqueue one request; its outputs land in ``out`` (host)."""
        with self.spans("run"):
            sums = self.pricer.run(port.key(words), self.prepared)
        with self.spans("readback"):
            out.copy_(sums, non_blocking=True)

    def finish(self, outputs: np.ndarray) -> dict:
        P = torch.from_numpy(outputs) / (2.0 * self.cfg.n_paths)
        return {"P": P.numpy()}

    def close(self):
        self.prepared = None


def reference(config: dict, traffic: dict, words: tuple, device) -> dict:
    n = int(traffic["pairs"])
    if config["engine"] == "fused_exact":
        sums = ref.curve_exact(config, words, n, device)
    else:
        sums = ref.curve_full(config, words, n, device)
    return {"P": sums / (2.0 * n)}


def compare(program: dict, reference: dict) -> dict:
    P, Pr = np.asarray(program["P"], np.float64), reference["P"]
    return {"p_rel": float(np.max(np.abs(P - Pr) / np.abs(Pr)))}
