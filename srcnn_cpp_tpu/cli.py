"""Command-line driver with the reference binary's exact surface.

Mirrors ``srcnn (options) <source> [output]`` (reference src/srcnn.cpp
parseArgs :331-425, printTitle/printHelp :427-447, pipeline narration
:449-698):

* ``--scale=<float>``   scaling ratio, default 2.0, any value > 0;
* ``--noverbose``       silence the per-stage narration;
* ``--help``            usage text;
* positional source image, optional output image; the default output path is
  ``<name>_resized.<ext>`` next to the source (srcnn.cpp:396-416).

Extensions over the reference (new capabilities, flag-gated so the default
invocation matches):

* ``--kernel=auto|pallas|xla``  conv path (runtime.resolve_kernel);
* ``--resize=auto|exact|fast``  pre-upscale engine;
* ``--repeat=<int>``       re-run the compute span N times and report the best
  (first run includes XLA compilation, as noted in the narration).

Exit codes map the reference's negative codes onto the POSIX-positive
equivalents (utils.debug.EXIT_CODES): 1 = load/scale failure (ref -1),
2 = colorspace failure (ref -2, here: decoded image is not 3-channel BGR),
3 = split/merge failure (ref -3, here: pipeline output is not 3-channel),
10 = empty output (ref -10).  Deviations from the reference surface,
documented: unknown ``--flags`` are rejected with usage (the reference
treats them as a source filename and then fails the load, srcnn.cpp:382);
a malformed value for an extension flag (``--repeat``, ``--kernel``,
``--resize``) is an error rather than silently ignored.
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import __version__
from .imageio import imread_bgr, imwrite_bgr
from .pipeline import upscale_bgr
from .runtime import (KERNELS, RESIZE_MODES, enable_compilation_cache,
                      resolve_kernel)
from .utils.timer import TickTimer
from .weights import load_weights

_PROG = "srcnn"


def print_title(file=sys.stdout) -> None:
    import jax

    print(f"{_PROG} : SRCNN super-resolution, version {__version__}", file=file)
    devs = ", ".join(d.device_kind for d in jax.devices())
    print(f"Using JAX {jax.__version__} on [{devs}]", file=file)


def print_help(file=sys.stdout) -> None:
    print(f"Usage: {_PROG} (options) <source image file> [output image file]", file=file)
    print("Options:", file=file)
    print("  --scale=<float>    scaling ratio, default 2.0 (must be > 0)", file=file)
    print("  --noverbose        run silently", file=file)
    print("  --kernel=<name>    conv path: auto (default: pallas on a GPU, "
          "xla elsewhere), pallas, xla", file=file)
    print("  --resize=<mode>    pre-upscale engine: auto (default: exact), "
          "exact, fast", file=file)
    print("  --repeat=<int>     time the compute span over N runs", file=file)
    print("  --help             this message", file=file)


class UsageError(ValueError):
    """Malformed command line (bad flag value or unknown flag)."""


def parse_args(argv: list[str]):
    """argv (no program name) -> dict of options, or None after --help.

    Raises :class:`UsageError` for unknown ``--flags`` and malformed values
    of the extension flags.  ``--scale=`` keeps the reference's lenient
    semantics (non-positive/unparsable values fall back to the default,
    srcnn.cpp:359-370).
    """
    opts = {
        "scale": 2.0,
        "verbose": True,
        "kernel": "auto",
        "resize": "auto",
        "repeat": 1,
        "src": None,
        "dst": None,
    }
    for arg in argv:
        if arg.startswith("--scale="):
            try:
                v = float(arg.split("=", 1)[1])
            except ValueError:
                v = 0.0
            if v > 0.0:
                opts["scale"] = v
        elif arg == "--noverbose":
            opts["verbose"] = False
        elif arg.startswith("--kernel="):
            v = arg.split("=", 1)[1]
            if v not in KERNELS:
                raise UsageError(f"unknown kernel {v!r} (choose from "
                                 f"{', '.join(KERNELS)})")
            opts["kernel"] = v
        elif arg.startswith("--resize="):
            v = arg.split("=", 1)[1]
            if v not in RESIZE_MODES:
                raise UsageError(f"unknown resize mode {v!r} (choose from "
                                 f"{', '.join(RESIZE_MODES)})")
            opts["resize"] = v
        elif arg.startswith("--repeat="):
            v = arg.split("=", 1)[1]
            try:
                opts["repeat"] = max(1, int(v))
            except ValueError:
                raise UsageError(f"--repeat expects an integer, got {v!r}")
        elif arg == "--help":
            return None
        elif arg.startswith("--"):
            raise UsageError(f"unknown option {arg!r}")
        elif opts["src"] is None:
            opts["src"] = arg
        elif opts["dst"] is None:
            opts["dst"] = arg
    if opts["src"] and not opts["dst"]:
        p = Path(opts["src"])
        opts["dst"] = str(p.with_name(p.stem + "_resized" + p.suffix))
    return opts


def run(opts) -> int:
    verbose = opts["verbose"]

    def say(msg: str) -> None:
        if verbose:
            print(msg, flush=True)

    from .utils.debug import EXIT_CODES

    src, dst = opts["src"], opts["dst"]
    say(f"- Loading image : {src}")
    img = imread_bgr(src)
    if img is None:
        print(f"{_PROG}: cannot load image {src!r}", file=sys.stderr)
        return EXIT_CODES["load_or_scale"]
    if img.ndim != 3 or img.shape[2] != 3:
        # the BGR->YCrCb stage needs 3 channels (reference cvtColor failure,
        # srcnn.cpp:509-526 -> exit -2)
        print(f"{_PROG}: cannot convert colorspace of "
              f"{img.shape}-shaped image", file=sys.stderr)
        return EXIT_CODES["colorspace"]
    h, w = img.shape[:2]
    say(f"- Image size : {w}x{h}")
    try:
        kernel = resolve_kernel(opts["kernel"])
    except ValueError as e:
        print(f"{_PROG}: {e}", file=sys.stderr)
        return EXIT_CODES["load_or_scale"]
    say(f"- Scale : {opts['scale']:g}, kernel : {kernel}")

    weights = load_weights()
    say("- Weights : SRCNN 9-5-5 (pretrained, 0-255 domain)")

    import numpy as np

    best_ms = None
    out_np = None
    for i in range(opts["repeat"]):
        with TickTimer() as t:
            out = upscale_bgr(img, opts["scale"], weights,
                              kernel=kernel, resize=opts["resize"])
            out_np = np.asarray(out)   # the span includes the host fetch
        note = " (includes XLA compile)" if i == 0 else ""
        say(f"- Performance : {t.ms:.1f} ms took.{note}")
        best_ms = t.ms if best_ms is None else min(best_ms, t.ms)
    if out_np.size == 0:
        print(f"{_PROG}: empty output", file=sys.stderr)
        return EXIT_CODES["empty_output"]
    if out_np.ndim != 3 or out_np.shape[2] != 3:
        # merge produced the wrong plane count (reference split/merge
        # failure, srcnn.cpp:540-555 -> exit -3)
        print(f"{_PROG}: merge failure: output shape {out_np.shape}",
              file=sys.stderr)
        return EXIT_CODES["split"]
    oh, ow = out_np.shape[:2]
    say(f"- Output size : {ow}x{oh}")
    if opts["repeat"] > 1:
        mp = (oh * ow) / 1e6
        say(f"- Best : {best_ms:.1f} ms  ({mp / (best_ms / 1e3):.1f} MP/s)")

    say(f"- Writing : {dst}")
    if not imwrite_bgr(dst, out_np):
        print(f"{_PROG}: cannot write {dst!r}", file=sys.stderr)
        return EXIT_CODES["empty_output"]
    say("- Done.")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts = parse_args(argv)
    except UsageError as e:
        print(f"{_PROG}: {e}", file=sys.stderr)
        print_help(file=sys.stderr)
        return 1
    enable_compilation_cache()
    verbose = opts is None or opts["verbose"]
    if verbose:
        print_title()
    if opts is None or opts["src"] is None:
        print_help()
        # bare/helpful invocations exit 0 like the reference binary
        # (srcnn.cpp:711-715); only a genuinely malformed line exits 1
        return 0
    return run(opts)


if __name__ == "__main__":
    sys.exit(main())
