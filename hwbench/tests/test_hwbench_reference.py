"""The frozen plain reference against the port's plain versions at sizes
the CPU holds: the random stream bit for bit, the normals and raws, the
six kernels' outputs to float32 rounding, the market curve against the
port's fp64 oracles.  (The reference itself imports nothing of the port;
this test does, to tie the two.)"""

import numpy as np
import pytest
import torch

from hwbench import reference as ref
from hwbench.tests.tiny import tiny_parts

fused = pytest.importorskip("hullwhite_tpu_torch.kernels.fused")


def port_seeds(words, kind):
    from hullwhite_tpu_torch.ops.rng import Key

    return [int(v) for v in fused.kernel_seeds(Key(words=words), kind)]


WORDS = ref.fold_in(ref.key_words(2 ** 31 + 12345), 77)


def test_key_chain_matches_the_port():
    from hullwhite_tpu_torch.ops.rng import Key

    k = Key(words=ref.key_words(2 ** 33 + 5)).fold_in(9)
    assert k.words == ref.fold_in(ref.key_words(2 ** 33 + 5), 9)
    s = port_seeds(WORDS, "zbc")
    w = ref.tile_seeds(WORDS, "zbc")
    assert [v & ref.M32 for v in s[:2]] == list(w) and s[2] == 0


def test_hash_normals_and_raws_match_the_port():
    s0p = fused._tile_s0(port_seeds(WORDS, "curve"), 0, 3, "cpu")
    seed0, seed1 = ref.tile_seeds(WORDS, "curve")
    s0 = ref.tile_s0(seed0, 0, 3, "cpu")
    assert torch.equal(s0, s0p)
    idx = torch.arange(64 * 128, dtype=torch.int64).reshape(64, 128)
    assert torch.equal(ref.draw(s0, seed1, idx, 7),
                       fused.tile_draw_plain(s0p, seed1, idx, 7))
    z = ref.box_muller(s0, seed1, idx)
    zp = fused.box_muller_plain(s0p, seed1, idx)
    for a, b in zip(z, zp):
        assert torch.allclose(a, b.double(), rtol=0, atol=2e-6)
    assert torch.equal(ref.raws(s0, seed1, idx, 2),
                       fused.raw_block_plain(s0p, seed1, idx, 2).double())


@pytest.mark.parametrize("config,traffic,pairs", [
    ("hw1f_exact", "curve", 32768), ("hw1f_fullstep", "curve", 32768),
    ("hw1f_exact", "greeks", 65536), ("hw1f_fullstep", "greeks", 32768)])
def test_products_match_the_port_plain_versions(config, traffic, pairs):
    from hwbench import spec
    from hwbench.trace import Spans

    config, traffic = tiny_parts(config, traffic, pairs)
    product = spec.load_module("products", traffic["product"])
    prog = product.Program(config, traffic, torch.device("cpu"),
                           Spans(False))
    prog.prepare()
    out = torch.empty(prog.n_out)
    prog.submit(WORDS, out)
    got = prog.finish(out.numpy())
    want = product.reference(config, traffic, WORDS, "cpu")
    gaps = product.compare(got, want)
    assert max(gaps.values()) < 2e-6, gaps


def test_market_curve_matches_the_port_oracle():
    from hullwhite_tpu_torch.config import HWConfig
    from hullwhite_tpu_torch.models import oracles

    cfg = dict(tiny_parts("hw1f_exact", "greeks")[0], n_mat=101)
    P, f = ref.market_curve(cfg)
    Ts = np.linspace(0, 10, 101)
    hw = HWConfig()
    # the continuous closed form; the published 0.876844 is the MC's
    assert P[-1] == pytest.approx(0.8767774, abs=1e-7)
    for k in (1, 37, 50, 100):
        assert P[k] == pytest.approx(float(oracles.bond_price(hw, Ts[k])),
                                     rel=1e-9)
        assert f[k] == pytest.approx(float(oracles.forward_rate(hw, Ts[k])),
                                     rel=1e-9, abs=1e-12)


def test_option_consts_match_the_port():
    from hullwhite_tpu_torch.config import HWConfig
    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.ops import engine_exact

    cfg = dict(tiny_parts("hw1f_exact", "greeks")[0], n_steps=1000,
               n_mat=101)
    P, f = (a.astype(np.float32) for a in ref.market_curve(cfg))
    k = ref.Model(cfg).option_consts(P.astype(np.float64),
                                   f.astype(np.float64))
    c = HWConfig()
    tables = hw.step_tables(c, c.sigma, c.sigma, device="cpu")
    market = hw.MarketCurve(torch.tensor(P), torch.tensor(f))
    consts = fused.option_prepared(c, tables, market, c.sigma).consts
    names = ("c_r", "c_i", "A", "B", "K", "P0S2", "c_dr", "c_di", "sigma",
             "q")
    for i, name in enumerate(names):
        assert consts[i] == pytest.approx(k[name], rel=2e-6), name
    assert np.allclose(consts[10:], k["l"], rtol=2e-6)
    assert np.allclose(engine_exact.zbc_chol(c), np.array(k["l"])
                       / ref.Model(cfg).sig_st, rtol=1e-6)
