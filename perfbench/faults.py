"""Faults planted in the program under the timed path.

Each shows that the check catches what a broken program could do.  A fault
is planted with a ``setattr(obj, name, value)``: pytest's
``monkeypatch.setattr`` in the tests, the builtin in :mod:`.control` for a
reading on the chip at a cell's own size.
"""

from __future__ import annotations

import numpy as np


def _altered(out):
    """One value of one answer changed where it is produced."""
    import jax

    if not isinstance(out, jax.Array):
        out = np.array(out, order="C")
        out.reshape(-1)[7] ^= 0x80
        return out
    flat = out.reshape(-1)
    return flat.at[7].set(flat[7] ^ 0x80).reshape(out.shape)


def _stale(orig):
    """Every call after the first answers with the previous call's answer:
    a step that returns its state unchanged."""
    last = []

    def call(*a, **k):
        out = orig(*a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    return call


def batch_altered(setattr):
    from srcnn_cpp_tpu import pipeline

    orig = pipeline.upscale_bgr_batch
    setattr(pipeline, "upscale_bgr_batch",
            lambda *a, **k: _altered(orig(*a, **k)))


def half_batch(setattr):
    """The second half of each batch is not computed: the first half's
    answers stand in for it."""
    import jax.numpy as jnp
    from srcnn_cpp_tpu import pipeline

    orig = pipeline.upscale_bgr_batch

    def half(x, *a, **k):
        out = orig(x[:x.shape[0] // 2], *a, **k)
        return jnp.concatenate([out, out], axis=0)

    setattr(pipeline, "upscale_bgr_batch", half)


def batch_stale(setattr):
    from srcnn_cpp_tpu import pipeline

    setattr(pipeline, "upscale_bgr_batch", _stale(pipeline.upscale_bgr_batch))


def _still(wrap):
    def plant(setattr):
        from srcnn_cpp_tpu import configs

        orig = configs.single_8k
        setattr(configs, "single_8k", lambda *a, **k: wrap(orig(*a, **k)))
    return plant


still_altered = _still(lambda run: lambda img: _altered(run(img)))
still_stale = _still(_stale)


def no_exchange(setattr):
    """The row halo exchange between cards left out: every tile pads its
    seams with copies of its own edge rows."""
    import jax.numpy as jnp
    from srcnn_cpp_tpu.parallel import tiling

    def edge_only(y, halo, axis_name, axis):
        lo, hi = [slice(None)] * y.ndim, [slice(None)] * y.ndim
        lo[axis], hi[axis] = slice(0, 1), slice(-1, None)
        return jnp.concatenate(
            [jnp.repeat(y[tuple(lo)], halo, axis=axis), y,
             jnp.repeat(y[tuple(hi)], halo, axis=axis)], axis=axis)

    setattr(tiling, "_halo_exchange", edge_only)


FAULTS = {"batch_altered": batch_altered, "half_batch": half_batch,
          "batch_stale": batch_stale, "still_altered": still_altered,
          "still_stale": still_stale, "no_exchange": no_exchange}
