"""Set5/Set14-style evaluation harness (the reference's implied protocol).

The reference documents its evaluation recipe in Pictures/Resize.m: bicubic-
downscale a ground-truth image by 1/scale, super-resolve it back, and compare
— the standard SRCNN protocol (Dong et al. 2014).  The reference never
automates it; this module does, for any directory of images:

    python -m srcnn_cpp_tpu.evaluate --scale=2 [--kernel=auto] <dir-or-image>...

Outputs per-image and mean PSNR/SSIM on the Y channel (the convention SR
papers use), for both plain bicubic and SRCNN, plus the bicubic->SRCNN gain.
Shave border of ``ceil(scale)`` px, as in the original SRCNN evaluation.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

from .imageio import decode_provenance, imread_bgr

#: the decoder that minted the recorded EVAL.md numbers (JPEG decode
#: differs between decoders, shifting PSNR in the 3rd decimal)
EVAL_DECODE_PROVENANCE = {"decoder": "cv2", "version": "5.0.0"}
from .oracle import bgr2ycrcb_u8_ref
from .ops.resize_tables import resize_bicubic_u8_np
from .runtime import KERNELS
from .utils.metrics import psnr, ssim
from .weights import load_weights

_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def _collect(paths) -> list[Path]:
    out = []
    for p in map(Path, paths):
        if p.is_dir():
            out += sorted(q for q in p.iterdir() if q.suffix.lower() in _EXTS)
        elif p.suffix.lower() in _EXTS:
            out.append(p)
    return out


def degrade_bgr(bgr: np.ndarray, scale: float):
    """Resize.m degradation: crop GT + MATLAB-imresize-bicubic downscale.

    Crops so the low-res size recovers the crop exactly under the float
    rule, then downscales each YCrCb plane with the Keys a=-0.5 kernel,
    anti-aliased (MATLAB ``imresize(gnd, 1/scale, 'bicubic')``,
    reference Pictures/Resize.m:1-3).  NOT OpenCV INTER_CUBIC, which skips
    the anti-alias widening — the model was trained on imresize degradation
    and loses its gain under aliased inputs.

    Returns ``(lr_bgr, gt_cropped)``.
    """
    from .oracle import ycrcb2bgr_u8_ref
    from .ops.resize import resize_separable

    h, w = bgr.shape[:2]
    ch = int(math.floor(h / scale) * scale)
    cw = int(math.floor(w / scale) * scale)
    gt = bgr[:ch, :cw]
    lh, lw = int(round(ch / scale)), int(round(cw / scale))
    ycc = bgr2ycrcb_u8_ref(gt)
    lr = np.stack([
        np.clip(np.round(np.asarray(resize_separable(
            ycc[..., i].astype(np.float32), (lh, lw), "cubic_matlab"))),
            0, 255).astype(np.uint8)
        for i in range(3)], axis=-1)
    return ycrcb2bgr_u8_ref(lr), gt


def evaluate_image(bgr: np.ndarray, scale: float, weights=None,
                   kernel: str = "auto") -> dict:
    """One image through the Resize.m protocol; returns Y-channel metrics."""
    from .pipeline import upscale_bgr

    lr_bgr, gt = degrade_bgr(bgr, scale)
    ch, cw = gt.shape[:2]
    ycc = bgr2ycrcb_u8_ref(gt)
    lr = bgr2ycrcb_u8_ref(lr_bgr)

    sr = np.asarray(upscale_bgr(lr_bgr, scale, weights, kernel=kernel))
    sr = sr[:ch, :cw]
    bic = np.stack([resize_bicubic_u8_np(lr[..., i], (ch, cw))
                    for i in range(3)], axis=-1)

    gt_y = ycc[..., 0].astype(np.float64)
    sr_y = bgr2ycrcb_u8_ref(sr)[..., 0].astype(np.float64)
    bic_y = bic[..., 0].astype(np.float64)
    s = int(math.ceil(scale))
    sl = np.s_[s:-s, s:-s]
    return {
        "psnr_bicubic": psnr(gt_y[sl], bic_y[sl]),
        "psnr_srcnn": psnr(gt_y[sl], sr_y[sl]),
        "ssim_bicubic": ssim(gt_y[sl], bic_y[sl]),
        "ssim_srcnn": ssim(gt_y[sl], sr_y[sl]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="srcnn-eval", description=__doc__)
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--scale", type=float, default=2.0)
    # default matches the CLI's production default (cli.parse_args), so the
    # numbers recorded by the harness are the numbers the shipped path makes
    ap.add_argument("--kernel", default="auto", choices=list(KERNELS))
    ap.add_argument("--json", action="store_true", help="machine-readable")
    args = ap.parse_args(argv)

    files = _collect(args.paths)
    if not files:
        print("srcnn-eval: no images found", file=sys.stderr)
        return 1
    prov = decode_provenance()
    if prov != EVAL_DECODE_PROVENANCE:
        print(f"srcnn-eval: WARNING decode provenance {prov} != "
              f"{EVAL_DECODE_PROVENANCE} that minted EVAL.md — JPEG-decode "
              f"differences shift PSNR in the 3rd decimal", file=sys.stderr)
    weights = load_weights()
    rows = []
    for f in files:
        bgr = imread_bgr(f)
        if bgr is None:
            print(f"srcnn-eval: skipping unreadable {f}", file=sys.stderr)
            continue
        m = evaluate_image(bgr, args.scale, weights, args.kernel)
        m["image"] = f.name
        rows.append(m)
        if not args.json:
            print(f"{f.name:28s} x{args.scale:g}  "
                  f"bicubic {m['psnr_bicubic']:.2f} dB / {m['ssim_bicubic']:.4f}"
                  f"  ->  SRCNN {m['psnr_srcnn']:.2f} dB / {m['ssim_srcnn']:.4f}"
                  f"  (+{m['psnr_srcnn'] - m['psnr_bicubic']:.2f} dB)")
    if not rows:
        return 1
    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in ("psnr_bicubic", "psnr_srcnn", "ssim_bicubic", "ssim_srcnn")}
    if args.json:
        print(json.dumps({"scale": args.scale, "images": rows, "mean": mean,
                          "decode": prov}))
    else:
        print(f"{'MEAN':28s} x{args.scale:g}  "
              f"bicubic {mean['psnr_bicubic']:.2f} dB / {mean['ssim_bicubic']:.4f}"
              f"  ->  SRCNN {mean['psnr_srcnn']:.2f} dB / {mean['ssim_srcnn']:.4f}"
              f"  (+{mean['psnr_srcnn'] - mean['psnr_bicubic']:.2f} dB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
