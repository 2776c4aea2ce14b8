"""Q2b and Q3: one request prices the ZBC's control-variate moments and its
pathwise vega on one fresh key (``pricing.zbc_pricer(...).run``, then
``pricing.vega_pricer(...).run``, one readback), on the benchmark's
closed-form market curve, at the traffic's pairs.  Its outputs are the six
CV moments and [vega sum, count]; the port's finish is
``payoffs.cv_estimate`` (price, beta, var_x) and vega = sum / count.
Compared: each of the four's relative gap to the float64 reference on the
same key and the same (float32) curve."""

from __future__ import annotations

import numpy as np
import torch

from hwbench import port
from hwbench import reference as ref

NUMBERS = ("price_rel", "beta_rel", "var_x_rel", "vega_rel")


def curve(config: dict):
    """The market curve both sides get: the closed form, rounded once to
    float32."""
    P, f = ref.market_curve(config)
    return P.astype(np.float32), f.astype(np.float32)


class Program:
    def __init__(self, config: dict, traffic: dict, device, spans):
        from hullwhite_tpu_torch import pricing

        self.cfg = port.hw_config(config, traffic["pairs"])
        kw = dict(engine=config["engine"], device=device)
        self.zbc = pricing.zbc_pricer(self.cfg, **kw)
        self.vega = pricing.vega_pricer(self.cfg, **kw)
        self.market = port.market(*curve(config), device)
        self.spans = spans
        self.n_out = 8
        self.prepared = None

    def prepare(self):
        s = self.cfg.sigma
        self.prepared = (self.zbc.prepare(s, s, self.market),
                         self.vega.prepare(s, s, self.market))

    def submit(self, words: tuple, out: torch.Tensor):
        key = port.key(words)
        with self.spans("run"):
            moments = self.zbc.run(key, self.prepared[0])
        with self.spans("run"):
            vega = self.vega.run(key, self.prepared[1])
        with self.spans("readback"):
            out[:6].copy_(moments, non_blocking=True)
            out[6:].copy_(vega, non_blocking=True)

    def finish(self, outputs: np.ndarray) -> dict:
        from hullwhite_tpu_torch.ops import payoffs

        out = torch.from_numpy(outputs)
        est = payoffs.cv_estimate(out[:6], self.market.P[-1].cpu())
        return {"price": float(est.price), "beta": float(est.beta),
                "var_x": float(est.var_x), "vega": float(out[6] / out[7])}

    def close(self):
        self.prepared = None


def reference(config: dict, traffic: dict, words: tuple, device) -> dict:
    n = int(traffic["pairs"])
    P, f = curve(config)
    consts = ref.Model(config).option_consts(P.astype(np.float64),
                                             f.astype(np.float64))
    if config["engine"] == "fused_exact":
        m = ref.zbc_exact(words, n, consts, device)
        v = ref.vega_exact(words, n, consts, device)
    else:
        m = ref.zbc_full(config, words, n, consts, device)
        v = ref.vega_full(config, words, n, consts, device)
    return {**ref.cv_finish(m), "vega": v[0] / v[1]}


def compare(program: dict, reference: dict) -> dict:
    return {f"{k}_rel": float(abs(program[k] - reference[k]) / abs(reference[k]))
            for k in ("price", "beta", "var_x", "vega")}
