"""Final pixel quantization matching the reference's IntTrim semantics.

The reference converts the conv3 float output to uint8 by C float->int
conversion (truncation toward zero) followed by a [0,255] clamp
(reference src/srcnn.cpp:238-240, IntTrim at :77-81).  Truncation — not
rounding — is PSNR-visible, so it is preserved here.
"""

from __future__ import annotations

import jax.numpy as jnp


def quantize_trunc_u8(x):
    """float [...,] -> uint8 via truncation toward zero, then clamp [0,255]."""
    return jnp.clip(jnp.trunc(x), 0, 255).astype(jnp.uint8)


def split_hi_lo(x):
    """f32 -> (hi, lo) bf16 pair with hi+lo ~= x to ~2^-16 relative.

    THE one numerically-subtle trick of the split-precision paths, shared
    by the fused kernel, weight packing, and the XLA conv path.  The
    split is computed by integer masking (top 16 bits = exactly the
    bf16-representable truncation), NOT by ``bf16(x)`` roundtrips: XLA
    runs with --xla_allow_excess_precision, which folds
    ``x - f32(bf16(x))`` to zero and silently destroys the compensation
    term.
    """
    import jax.lax as lax

    bits = lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    hi32 = lax.bitcast_convert_type(bits & jnp.uint32(0xFFFF0000),
                                    jnp.float32)
    return hi32.astype(jnp.bfloat16), (x - hi32).astype(jnp.bfloat16)
