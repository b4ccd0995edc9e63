"""SRCNN training on device meshes (a capability the reference lacks).

The reference ships a frozen checkpoint (reference src/convdata.h) and no
trainer; the original SRCNN recipe (Dong et al. 2014, which that checkpoint
came from) is MSE regression from bicubic-upscaled LR patches to HR patches.
This module provides that recipe in JAX:

* :func:`mse_loss` — pixel MSE in the 0-255 weight domain;
* :func:`make_train_step` — single-device/jit step with any optax optimizer;
* :func:`make_sharded_train_step` — the mesh-parallel step: batch sharded
  over the ``data`` axis AND rows sharded over the ``row`` axis, forward
  through the halo-exchange tiled conv stack (differentiable — ppermute
  transposes to the reverse shift), gradients globally psum-reduced inside
  ``shard_map``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.srcnn import srcnn_y_f32
from ..parallel.tiling import _srcnn_rows_f32
from ..weights import SRCNNWeights


def mse_loss(weights: SRCNNWeights, x, target) -> jax.Array:
    """Mean squared error of the stack on pre-upscaled input ``x``.

    ``x``/``target``: ``[B, H, W]`` in the 0-255 domain (uint8 or float).
    """
    pred = srcnn_y_f32(x, weights)
    return jnp.mean((pred - target.astype(jnp.float32)) ** 2)


def make_train_step(optimizer):
    """Plain jitted train step: (weights, opt_state, x, t) -> updated + loss."""

    @jax.jit
    def step(weights, opt_state, x, t):
        loss, grads = jax.value_and_grad(mse_loss)(weights, x, t)
        updates, opt_state = optimizer.update(grads, opt_state, weights)
        import optax

        weights = optax.apply_updates(weights, updates)
        return weights, opt_state, loss

    return step


def make_sharded_train_step(mesh: Mesh, optimizer):
    """Mesh-parallel train step: dp over ``data``, spatial sp over ``row``.

    The forward runs the tiled conv stack with real halo exchange, so row
    sharding is exact (not an approximation); gradients and the loss are
    psum-reduced over both mesh axes inside shard_map, after which weights
    are updated identically (replicated) on every device.
    """
    axes = ("data", "row")

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P("data", "row", None), P("data", "row", None), P()),
             out_specs=(P(), P()))
    def _grads(weights, x, t, denom):
        def global_loss(w):
            pred = _srcnn_rows_f32(x.astype(jnp.float32), w)
            se = jnp.sum((pred - t.astype(jnp.float32)) ** 2)
            return lax.psum(se, axes) / denom

        # differentiating the psum'd loss wrt the replicated weights yields
        # globally-reduced (replicated) gradients: shard_map's replication
        # tracking inserts the cross-device psum of the cotangents at the
        # replicated-input boundary.  Do NOT psum grads again here.
        return jax.value_and_grad(global_loss)(weights)

    @jax.jit
    def step(weights, opt_state, x, t):
        denom = jnp.asarray(float(x.size), jnp.float32)
        loss, grads = _grads(weights, x, t, denom)
        import optax

        updates, opt_state = optimizer.update(grads, opt_state, weights)
        weights = optax.apply_updates(weights, updates)
        return weights, opt_state, loss

    return step


def shard_batch(mesh: Mesh, x):
    """Place a ``[B, H, W]`` batch sharded (data, row) on the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P("data", "row", None)))
