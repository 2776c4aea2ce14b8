"""The hand-written CUDA kernels' wrappers and their one registry of
counts.

``fused`` holds the fused engines' kernels and the unit walls, ``accurate``
the normal CDF.  Each wrapper adds one to its ``launches`` where it
launches its kernel, and nowhere else; ``accurate.nphi`` also counts its
launches by their elements, in its ``sizes``.  ``launch_counts``,
``launch_sizes``, ``element_counts`` and ``reset_launch_counts`` read and
reset them all.
Nothing here builds or launches a kernel.
"""

from __future__ import annotations

_WRAPPERS: dict = {}


def register(wrappers: dict) -> None:
    """Count the launches of these wrappers (name -> function) from 0."""
    for name, w in wrappers.items():
        w.launches = 0
        _WRAPPERS[name] = w


def _registered() -> dict:
    from . import accurate, fused  # noqa: F401  (each registers its own)

    return _WRAPPERS


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: w.launches for name, w in _registered().items()}


def launch_sizes() -> dict:
    """Launches by their elements ({elements: launches}) per wrapper that
    counts them (``nphi``) since the last reset."""
    return {name: dict(w.sizes) for name, w in _registered().items()
            if hasattr(w, "sizes")}


def element_counts() -> dict:
    """Elements per wrapper that counts them (``nphi``) since the last
    reset."""
    return {name: sum(n * k for n, k in sizes.items())
            for name, sizes in launch_sizes().items()}


def reset_launch_counts() -> None:
    """Every wrapper's launches, and its sizes where it counts them, to 0."""
    for w in _registered().values():
        w.launches = 0
        if hasattr(w, "sizes"):
            w.sizes.clear()
