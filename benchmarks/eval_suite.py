"""Reference-binary accuracy gate over the local eval suite.

Runs the full Resize.m protocol (degrade GT -> super-resolve -> PSNR vs GT)
at x1.5/x2/x3 on every image in tests/data/eval AND diffs the framework's
output against the actually-built reference binary's output on the same
degraded input file — the letter of the BASELINE gate ("Set5 (+Set14) PSNR
within 0.05 dB of the reference binary").

Set5/Set14 proper cannot be vendored in this environment (no network
egress and the datasets are not on disk); the suite is every real
photographic image available locally — including ``butterfly``, which IS a
Set5 member (the reference's own demo image, README.md:34-45), plus the
two photographs bundled with scikit-learn (china/flower) — and the gate
compares against the reference binary per image, which is stricter than a
dataset-level PSNR average.  SSIM (Wang 2004, 11x11 sigma=1.5 Gaussian,
valid boundary — the Set5/Set14 reporting standard) is recorded per cell
alongside PSNR.

Usage:
    # build the reference binary first (needs OpenCV4 + OpenMP), from a
    # checkout of shuwang127/SRCNN_Cpp:  make -C <checkout>
    python benchmarks/eval_suite.py --ref-bin=<checkout>/bin/srcnn \
        [--kernel=auto] [--out=EVAL.md]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# self-sufficient invocation: `python benchmarks/eval_suite.py` puts
# benchmarks/ on sys.path, not the repo root the package lives in
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SUITE = REPO / "tests" / "data" / "eval"
SCALES = (1.5, 2.0, 3.0)


def run_one(name, gt_bgr, scale, weights, kernel, ref_bin, tmp):
    from srcnn_cpp_tpu.evaluate import degrade_bgr
    from srcnn_cpp_tpu.imageio import imread_bgr, imwrite_bgr
    from srcnn_cpp_tpu.oracle import bgr2ycrcb_u8_ref
    from srcnn_cpp_tpu.pipeline import upscale_bgr
    from srcnn_cpp_tpu.utils.metrics import psnr, ssim

    lr_bgr, gt = degrade_bgr(gt_bgr, scale)
    ch, cw = gt.shape[:2]
    lr_path = tmp / f"{name}_x{scale:g}_lr.png"
    imwrite_bgr(lr_path, lr_bgr)

    # reference binary on the same input file
    ref_out = tmp / f"{name}_x{scale:g}_ref.png"
    subprocess.run(
        [str(ref_bin), f"--scale={scale:g}", "--noverbose",
         str(lr_path), str(ref_out)],
        capture_output=True, text=True, timeout=600)
    # the binary SIGABRTs in static teardown on this host AFTER writing the
    # output (glibc destructor clash with the static libstdc++ link); the
    # run's success signal is the decodable output file, which is verified
    # byte-identical to the round-1 goldens
    ref = imread_bgr(ref_out)
    assert ref is not None, f"reference binary produced no output for {name}"

    t0 = time.monotonic()
    ours = np.asarray(upscale_bgr(lr_bgr, scale, weights, kernel=kernel))
    dt = time.monotonic() - t0

    n = min(ref.shape[0], ours.shape[0], ch)
    m = min(ref.shape[1], ours.shape[1], cw)
    ours_c, ref_c = ours[:n, :m], ref[:n, :m]
    lsb = int(np.abs(ours_c.astype(int) - ref_c.astype(int)).max())

    gt_y = bgr2ycrcb_u8_ref(gt[:n, :m])[..., 0].astype(np.float64)
    our_y = bgr2ycrcb_u8_ref(ours_c)[..., 0].astype(np.float64)
    ref_y = bgr2ycrcb_u8_ref(ref_c)[..., 0].astype(np.float64)
    s = int(np.ceil(scale))
    sl = np.s_[s:-s, s:-s]
    p_ours = psnr(gt_y[sl], our_y[sl])
    p_ref = psnr(gt_y[sl], ref_y[sl])
    s_ours = ssim(gt_y[sl], our_y[sl])
    s_ref = ssim(gt_y[sl], ref_y[sl])
    return {
        "image": name, "scale": scale, "hw": [n, m],
        "psnr_ours": round(p_ours, 4), "psnr_ref": round(p_ref, 4),
        "delta_psnr": round(p_ours - p_ref, 4),
        "ssim_ours": round(s_ours, 5), "ssim_ref": round(s_ref, 5),
        "delta_ssim": round(s_ours - s_ref, 5), "max_lsb_vs_ref": lsb,
        "seconds": round(dt, 3),
    }


def render_md(rows, kernel, device_kind, out_path) -> None:
    """Write EVAL.md (preserving hand-written sections past the marker)."""
    from srcnn_cpp_tpu.imageio import decode_provenance

    worst_d = max(abs(r["delta_psnr"]) for r in rows)
    worst_s = max(abs(r["delta_ssim"]) for r in rows)
    worst_lsb = max(r["max_lsb_vs_ref"] for r in rows)
    ok = worst_d < 0.05
    lines = [
        "# EVAL — accuracy gate vs the reference binary",
        "",
        "Protocol: Resize.m (MATLAB-imresize bicubic degradation), PSNR",
        "on the Y channel with ceil(scale)-px border shave; the reference",
        "binary was built from /root/reference on this host; framework",
        f"ran kernel={kernel} on [{device_kind}].",
        "",
        f"Decode provenance: every number below was minted with "
        f"**{' '.join(str(v) for v in decode_provenance().values())}**",
        "decode (`imageio.decode_provenance`); JPEG decode differs between",
        "cv2/libjpeg-turbo builds and PIL, shifting PSNR in the 3rd decimal.",
        "`evaluate` warns when run under a different decoder, and",
        "tests/test_eval_stream.py asserts the environment still matches.",
        "",
        "Set5/Set14 proper are not obtainable here (no network egress);",
        "the suite is every local real photograph (incl. the two",
        "sklearn-bundled sample photos, china/flower) — `butterfly` is a",
        "true Set5 member — and the gate diffs against the reference",
        "binary per image (stricter than a suite-mean PSNR). SSIM is the",
        "Set5/Set14 reporting standard (Wang 2004, 11x11 σ=1.5, valid).",
        "",
        "| image | scale | PSNR (ours, dB) | PSNR (ref bin, dB)"
        " | ΔPSNR | SSIM (ours) | ΔSSIM | max LSB diff |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['image']} | x{r['scale']:g} | {r['psnr_ours']:.4f} "
            f"| {r['psnr_ref']:.4f} | {r['delta_psnr']:+.4f} "
            f"| {r['ssim_ours']:.5f} | {r['delta_ssim']:+.5f} "
            f"| {r['max_lsb_vs_ref']} |")
    lines += ["",
              f"**Gate:** max |ΔPSNR| = {worst_d:.4f} dB (< 0.05 "
              f"required), max |ΔSSIM| = {worst_s:.5f}, "
              f"max LSB diff = {worst_lsb} -> "
              f"**{'PASS' if ok else 'FAIL'}**", ""]
    # preserve any hand-written sections after the end marker (e.g. the
    # evaluate.py protocol table and the fine-tuning demonstration)
    marker = "<!-- eval_suite:end -->"
    out_path = Path(out_path)
    tail = ""
    if out_path.exists() and marker in (prev := out_path.read_text()):
        tail = prev[prev.index(marker):]
    out_path.write_text("\n".join(lines) + (("\n" + tail) if tail else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ref-bin", default="/tmp/refbuild/bin/srcnn")
    ap.add_argument("--kernel", default="auto")
    ap.add_argument("--out", default=None, help="write EVAL.md here")
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform pre-init (e.g. cpu)")
    ap.add_argument("--images", default=None,
                    help="comma-separated stem filter (smoke tests)")
    ap.add_argument("--scales", default=None,
                    help="comma-separated scale filter")
    ap.add_argument("--render-from", default=None,
                    help="skip the runs; render --out from this prior "
                         "--json record (device annotated from the JSON)")
    args = ap.parse_args(argv)

    if args.render_from:
        rec = json.loads(Path(args.render_from).read_text())
        if not args.out:
            print("--render-from requires --out", file=sys.stderr)
            return 2
        render_md(rec["rows"], rec["kernel"],
                  rec.get("device_kind", "unknown"), args.out)
        print(f"rendered {args.out} from {args.render_from} "
              f"({len(rec['rows'])} cells)")
        return 0 if rec["pass"] else 1

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from srcnn_cpp_tpu.imageio import imread_bgr
    from srcnn_cpp_tpu.runtime import enable_compilation_cache
    from srcnn_cpp_tpu.weights import load_weights

    enable_compilation_cache()
    ref_bin = Path(args.ref_bin)
    if not ref_bin.exists():
        print(f"reference binary not found at {ref_bin}; build it first "
              "(see module docstring)", file=sys.stderr)
        return 2
    weights = load_weights()
    rows = []
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        only = set(args.images.split(",")) if args.images else None
        scales = tuple(float(s) for s in args.scales.split(",")) \
            if args.scales else SCALES
        for img_path in sorted(SUITE.glob("*.png")):
            if only and img_path.stem not in only:
                continue
            gt = imread_bgr(img_path)
            for scale in scales:
                r = run_one(img_path.stem, gt, scale, weights, args.kernel,
                            ref_bin, tmp)
                rows.append(r)
                print(f"{r['image']:16s} x{r['scale']:<4g} "
                      f"ours {r['psnr_ours']:6.2f} dB  ref {r['psnr_ref']:6.2f} dB  "
                      f"d={r['delta_psnr']:+.4f}  ssim {r['ssim_ours']:.4f} "
                      f"(d={r['delta_ssim']:+.5f})  lsb={r['max_lsb_vs_ref']}",
                      flush=True)

    worst_d = max(abs(r["delta_psnr"]) for r in rows)
    worst_s = max(abs(r["delta_ssim"]) for r in rows)
    worst_lsb = max(r["max_lsb_vs_ref"] for r in rows)
    ok = worst_d < 0.05
    print(f"\ngate: max |dPSNR| = {worst_d:.4f} dB (< 0.05 required) "
          f"max |dSSIM| = {worst_s:.5f}  max LSB = {worst_lsb}  ->  "
          f"{'PASS' if ok else 'FAIL'}")
    import jax

    device_kind = jax.devices()[0].device_kind
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(
            {"rows": rows, "max_abs_delta_psnr": worst_d,
             "max_abs_delta_ssim": worst_s, "max_lsb": worst_lsb,
             "kernel": args.kernel, "device_kind": device_kind, "pass": ok}))
    if args.out:
        render_md(rows, args.kernel, device_kind, args.out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
