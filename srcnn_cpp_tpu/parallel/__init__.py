"""Parallelism over device meshes.

The reference's only parallelism is OpenMP row-loops in one process
(SURVEY.md §2 C16-C18).  The counterparts here:

* :mod:`.mesh` — device mesh construction (data x spatial axes).
* :mod:`.tiling` — spatial row-tile sharding of one image across chips with
  bit-exact halo exchange (``lax.ppermute`` inside ``shard_map``),
  the image-domain analogue of sequence/context parallelism.
* batch data-parallelism falls out of the same mesh (batch axis sharded over
  the ``data`` axis).
* :mod:`.distributed` — the multi-process runtime: ``jax.distributed``
  initialization, per-process frame feed, and the pipelined
  :class:`~.distributed.DistributedStream` over a (data, row) mesh.
"""

from .mesh import make_mesh
from .tiling import srcnn_y_tiled, upscale_y_tiled


def __getattr__(name):
    if name == "srcnn_y_gspmd":
        from .gspmd import srcnn_y_gspmd

        return srcnn_y_gspmd
    if name in ("DistributedStream", "frame_mesh", "initialize"):
        from . import distributed

        return getattr(distributed, name)
    if name == "scaling_efficiency":
        from . import multihost

        return multihost.scaling_efficiency
    raise AttributeError(name)


__all__ = ["make_mesh", "srcnn_y_tiled", "upscale_y_tiled",
           "srcnn_y_gspmd",
           "initialize", "scaling_efficiency", "DistributedStream",
           "frame_mesh"]
