"""The benchmark's command: without a card it exits non-zero and prints no
result; on a card (marked ``card``) a short run of each cell is correct."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from hwbench import spec

ROOT = Path(__file__).resolve().parents[2]


def bench(*args, env=None):
    return subprocess.run([sys.executable, "-m", "hwbench.run", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          env=env, timeout=600)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = bench("--workload", "hw1f_exact.curve", "--seed", "1", "--seconds",
              "1", env=env)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.manifest(ROOT)["workloads"]])
def test_a_short_run_on_the_card_is_correct(card, workload):
    p = bench("--workload", workload, "--seed", str(2 ** 31 + 17),
              "--seconds", "2", "--trace", "1")
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["busy_s"] > 0 and "breakdown" in result
