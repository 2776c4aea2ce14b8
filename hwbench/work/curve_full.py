"""``curve_full_kernel``: one Q1 curve launch of the full-step tier, per
path 64 words of raws for each 128-step block, the mix product's live bf16
FMAs (three passes at "highest"), and an exp and a reciprocal for each of
the k = n_mat - 1 live maturities."""

from hwbench.roofline import N8, PAD, matmul_passes, n_blocks


def _live_blocks(cfg) -> int:
    n_live = cfg.n_mat - 1
    return sum(n_blocks(-(-m * cfg.n_steps // n_live))
               for m in range(1, n_live + 1))


def _live_quads(cfg) -> int:
    n_live = cfg.n_mat - 1
    nb = n_blocks(cfg.n_steps)
    last = [n_blocks(-(-m * cfg.n_steps // n_live))
            for m in range(1, n_live + 1)]
    quad_cols = 4 * N8
    return sum(len({m // quad_cols for m, n in zip(range(1, n_live + 1), last)
                    if q < n}) for q in range(nb))


def work(cfg) -> dict:
    P = cfg.n_paths
    k = cfg.n_mat - 1
    passes = matmul_passes(cfg)
    nb = n_blocks(cfg.n_steps)
    return {"raw": P * nb * 64,
            "tensor": P * 128 * _live_blocks(cfg) * passes,
            "exp": P * k, "recip": P * k, "fp32": P * k * 2.0,
            "bytes": 2.0 * 128 * 4 * N8 * _live_quads(cfg) * passes
            + 4.0 * (PAD + nb + cfg.n_mat)}
