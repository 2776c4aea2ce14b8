"""``zbc_full_kernel``: one ZBC launch of the full-step tier to s1, per
path the raws of each 128-step block and their two FMAs into the rate and
its integral; six moments out."""

from hwbench.roofline import full_option


def work(cfg) -> dict:
    P = cfg.n_paths
    opt = full_option(cfg)
    return {"raw": P * opt["words"], "fp32": P * opt["fma"],
            "bytes": 4.0 * (8 * opt["raws"] + 6)}
