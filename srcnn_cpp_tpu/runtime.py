"""Process-level runtime: backend choice and the compile cache.

Every entry point takes ``kernel="auto"`` and ``resize="auto"`` and
resolves them here, so the choice of path for a backend lives in one
place:

* ``kernel``: ``"pallas"`` is the fused conv kernel of
  :mod:`.ops.pallas_srcnn` (Pallas, Triton route; CUDA GPUs only) and
  ``"xla"`` the XLA conv stack at ``Precision.HIGHEST``.  ``auto`` picks
  ``pallas`` on a GPU, where it measured 13x faster than ``xla`` at the
  bench geometry, and ``xla`` everywhere else.
* ``resize``: ``"exact"`` (bit-exact with OpenCV 4.6) or ``"fast"``
  (banded-matmul form); ``auto`` is ``exact`` on every backend.
"""

from __future__ import annotations

import os
from pathlib import Path

KERNELS = ("auto", "pallas", "xla")
RESIZE_MODES = ("auto", "exact", "fast")

#: the compile cache when ``JAX_COMPILATION_CACHE_DIR`` is not set
DEFAULT_CACHE = Path(__file__).resolve().parent.parent / ".jax_cache"


def resolve_kernel(kernel: str = "auto", backend: str | None = None) -> str:
    """Map a conv-kernel name to the concrete path for ``backend``.

    ``backend`` defaults to ``jax.default_backend()``.  Raises
    ``ValueError`` for an unknown name, or for ``"pallas"`` on a backend
    that cannot compile the Triton kernel.
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (choose from "
                         f"{', '.join(KERNELS)})")
    if backend is None:
        import jax

        backend = jax.default_backend()
    if kernel == "auto":
        return "pallas" if backend == "gpu" else "xla"
    if kernel == "pallas" and backend != "gpu":
        raise ValueError(
            f"kernel='pallas' is a Triton kernel for CUDA GPUs and cannot "
            f"compile for the {backend!r} backend; use 'xla' (or 'auto')")
    return kernel


def resolve_resize(mode: str = "auto") -> str:
    """Map a resize-engine name to the concrete engine."""
    if mode not in RESIZE_MODES:
        raise ValueError(f"unknown resize mode {mode!r} (choose from "
                         f"{', '.join(RESIZE_MODES)})")
    return "exact" if mode == "auto" else mode


def cache_dir() -> Path:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_CACHE


def enable_compilation_cache() -> Path:
    """Enable JAX's persistent compilation cache (idempotent)."""
    import jax

    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return path
