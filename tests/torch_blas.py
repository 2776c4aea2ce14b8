"""One BLAS thread for each of the port's test modules: ``one_blas_thread``
is an autouse fixture of module scope, active in every module that
imports it.  Under pytest-xdist each worker's numpy would otherwise run
an OpenBLAS pool of every core, and the pools of six workers spinning on
eight cores made the host float64 oracles (DP sweeps, quadratures) up to
ten times slower.  The pool is restored when the module's tests end; the
port's ranks already run with one BLAS thread (``parallel.launch``)."""

import pytest

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # no control of the pools: leave them as they are
    threadpool_limits = None


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    if threadpool_limits is None:
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield
