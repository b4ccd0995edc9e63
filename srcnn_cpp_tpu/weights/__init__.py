"""Pretrained SRCNN 9-5-5 weights.

The reference framework ships its checkpoint as compile-time C arrays
(the reference's ``src/convdata.h``, 1178 lines).  Here the checkpoint is a
normal on-disk artifact: ``srcnn955.npz``, produced once by
:mod:`srcnn_cpp_tpu.weights.parse_convdata` from the C header, then loaded at
runtime like any other model checkpoint.

Canonical shapes (NCHW filter layout ``[out_c, in_c, kh, kw]``):

==========  ==================  =======================================
array       shape               reference symbol (convdata.h)
==========  ==================  =======================================
conv1_w     (64, 1, 9, 9)       weights_conv1_data  (convdata.h:35)
conv1_b     (64,)               biases_conv1        (convdata.h:19)
conv2_w     (32, 64, 1, 1)      weights_conv2_data  (convdata.h:689)
conv2_b     (32,)               biases_conv2        (convdata.h:679)
conv3_w     (1, 32, 5, 5)       weights_conv3_data  (convdata.h:982)
conv3_b     (1,)                biases_conv3        (convdata.h:980)
==========  ==================  =======================================

Weights are trained for **unnormalized 0-255 pixel inputs** (note the bias
magnitudes, e.g. conv1 bias 177.2564 at convdata.h:21): do not rescale.
"""

from .loader import SRCNNWeights, load_weights, WEIGHTS_NPZ

__all__ = ["SRCNNWeights", "load_weights", "WEIGHTS_NPZ"]
