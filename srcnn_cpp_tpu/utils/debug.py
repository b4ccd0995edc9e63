"""Numerical-safety debugging aids (the sanitizer-shaped aux subsystem).

The reference ships no sanitizers or checkers (SURVEY.md §5.2-5.3); its
failure handling is printf + exit codes.  The equivalents here:

* :func:`nan_guard` — context manager enabling jax debug_nans/debug_infs,
  turning silent NaN propagation into immediate errors at the op that
  produced them (the practical race/corruption detector for functional
  JAX code, where data races per se cannot occur);
* :func:`check_finite` — explicit pytree assertion for checkpoints and
  gradients (catches blown-up training before it poisons a run);
* :data:`EXIT_CODES` — the reference binary's error-code contract
  (srcnn.cpp:479,493,526,555,684 mapped to POSIX-positive values).
"""

from __future__ import annotations

import contextlib

import numpy as np

#: reference exit-code contract (negative codes -> POSIX-positive)
EXIT_CODES = {
    "load_or_scale": 1,   # ref -1: image load / scale failure
    "colorspace": 2,      # ref -2: cvtColor failure
    "split": 3,           # ref -3: channel split failure
    "empty_output": 10,   # ref -10
}


@contextlib.contextmanager
def nan_guard(infs: bool = True):
    """Raise at the first op producing NaN (optionally Inf) under jit."""
    import jax

    prev_nan = jax.config.jax_debug_nans
    prev_inf = jax.config.jax_debug_infs
    jax.config.update("jax_debug_nans", True)
    if infs:
        jax.config.update("jax_debug_infs", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nan)
        jax.config.update("jax_debug_infs", prev_inf)


def check_finite(tree, name: str = "tree") -> None:
    """Assert every leaf of a pytree is finite; raises with the leaf path."""
    import jax

    leaves = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in leaves:
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)}: {bad} non-finite "
                f"values (shape {arr.shape})")
