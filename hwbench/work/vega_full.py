"""``vega_full_kernel``: one pathwise-vega launch of the full-step tier to
s1, per path the raws of each 128-step block and their two FMAs; the sum
and the count out."""

from hwbench.roofline import full_option


def work(cfg) -> dict:
    P = cfg.n_paths
    opt = full_option(cfg)
    return {"raw": P * opt["words"], "fp32": P * opt["fma"],
            "bytes": 4.0 * (8 * opt["raws"] + 2)}
