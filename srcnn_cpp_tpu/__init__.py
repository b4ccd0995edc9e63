"""srcnn_cpp_tpu — a JAX super-resolution framework.

A from-scratch re-design of the capabilities of the reference C++/OpenMP SRCNN
binary (shuwang127/SRCNN_Cpp) for accelerators: JAX/XLA compute path with a
fused Pallas conv kernel for NVIDIA GPUs, pjit/shard_map parallelism over
device meshes, and a small C++ host runtime for timing and host-side
resampling.

Public surface:

* :func:`srcnn_cpp_tpu.upscale_bgr` / :func:`upscale_bgr_batch` — full
  image pipeline (the ``srcnn`` binary equivalent).
* :func:`srcnn_cpp_tpu.process_srcnn` — raw-buffer API (the
  ``ProcessSRCNN`` libsrcnn equivalent, reference src/test.cpp:345).
* :mod:`srcnn_cpp_tpu.models` — the SRCNN model family.
* :mod:`srcnn_cpp_tpu.parallel` — batch DP + 1-D/2-D spatial tile sharding
  with halo exchange over a device mesh; multi-host helpers.
* :mod:`srcnn_cpp_tpu.train` — MSE trainer (data pipeline, steps, driver).
* :mod:`srcnn_cpp_tpu.evaluate` / :mod:`stream` — eval harness, video.
* :mod:`srcnn_cpp_tpu.native` — C++ host runtime bindings.
* :mod:`srcnn_cpp_tpu.cli` — the ``srcnn`` command line.
"""

__version__ = "0.1.0"

from .weights import SRCNNWeights, load_weights  # noqa: F401


def __getattr__(name):
    # Lazy re-exports so that `import srcnn_cpp_tpu` stays cheap (no JAX
    # import) for weights-only consumers like the NumPy oracle tests.
    if name in ("upscale_bgr", "upscale_bgr_batch", "process_srcnn"):
        from . import pipeline

        return getattr(pipeline, name)
    if name == "SRCNN":
        from .models import SRCNN

        return SRCNN
    raise AttributeError(name)
