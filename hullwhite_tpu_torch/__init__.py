"""hullwhite_tpu_torch — Hull-White Monte Carlo on NVIDIA Hopper (PyTorch + CUDA).

The PyTorch port of ``hullwhite_tpu``: zero-coupon curve bootstrap (Q1),
theta recovery (Q2a), control-variate ZBC pricing (Q2b) and vega (Q3),
with the TPU package's Pallas kernels rewritten by hand in CUDA C++ for
sm_90a (``csrc/``).  The port imports PyTorch and numpy only; the JAX
package stays the reference it is tested against.
"""

from .config import HWConfig, ThetaSpec, tiny_config
from .models.hull_white import MarketCurve
from .ops.rng import Key

__all__ = ["HWConfig", "ThetaSpec", "tiny_config", "MarketCurve", "Key"]
__version__ = "0.1.0"
