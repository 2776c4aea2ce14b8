"""``curve_exact_kernel``: one Q1 curve launch of the exact tier, per pair
a Box-Muller element for each of the k = n_mat - 1 live maturities, their
exp and reciprocal, and the sampling product's live bf16 FMAs (six passes
at "highest", one at "default")."""

from hwbench.roofline import N8, N32, PAD, SPLIT_PASSES


def _passes(cfg) -> int:
    return 6 if cfg.matmul_precision == "highest" else 1


def _executed_weights(cfg) -> int:
    k = cfg.n_mat - 1
    ng = -(-k // N8)
    return sum(16 * N8 * min(4, ng - 4 * q)
               for s in range(-(-k // 16)) for q in range(-(-k // N32))
               if N32 * q + N32 - 1 >= 16 * s)


def work(cfg) -> dict:
    P = cfg.n_paths
    k = cfg.n_mat - 1
    xp = _passes(cfg)
    w_parts = SPLIT_PASSES if xp > 1 else 1
    return {"generator": P * k, "bm": P * k / 2, "exp": P * k,
            "recip": P * k, "tensor": P * k * (k + 1) / 2 * xp,
            "fp32": P * k * 2.0 + P * k * (2.0 if xp > 1 else 0.0),
            "bytes": 2.0 * w_parts * _executed_weights(cfg)
            + 4.0 * (PAD + cfg.n_mat)}
