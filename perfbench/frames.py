"""Seeded input frames: natural images, cropped, flipped and wrap-padded.

The source images (``data/images.npz``, BGR uint8) are the repository's
evaluation images, kept here so that the inputs cannot change under a later
change of the program.  ``--seed`` picks, for each frame of a pool, the
image, a flip and a crop offset; the frame is the image rolled by that
offset and tiled to the frame size.  Every seed gives frames of the same
shape, so the work of a run does not depend on the seed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

IMAGES = Path(__file__).resolve().parent / "data" / "images.npz"


def source_images(path: Path = IMAGES) -> list[np.ndarray]:
    with np.load(path) as z:
        return [z[k] for k in sorted(z.files)]


def make_frame(rng: np.random.Generator, images: list[np.ndarray],
               hw: tuple[int, int]) -> np.ndarray:
    """One BGR uint8 frame ``[h, w, 3]`` drawn from ``rng``."""
    img = images[int(rng.integers(len(images)))]
    flip = int(rng.integers(4))
    if flip & 1:
        img = img[:, ::-1]
    if flip & 2:
        img = img[::-1]
    oy, ox = int(rng.integers(img.shape[0])), int(rng.integers(img.shape[1]))
    img = np.roll(img, (-oy, -ox), axis=(0, 1))
    h, w = hw
    reps = (-(-h // img.shape[0]), -(-w // img.shape[1]), 1)
    return np.ascontiguousarray(np.tile(img, reps)[:h, :w])


def pool(seed: int, n: int, hw: tuple[int, int],
         images: list[np.ndarray] | None = None) -> np.ndarray:
    """``n`` seeded frames ``[n, h, w, 3]``: the same seed, the same frames."""
    images = source_images() if images is None else images
    rng = np.random.default_rng([int(seed) % 2**64, 0])
    return np.stack([make_frame(rng, images, hw) for _ in range(n)])
