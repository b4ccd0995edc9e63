"""Runs one cell of BENCHMARK.json on the GPUs of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout.  It refuses, with a non-zero exit and
no result, a machine whose JAX finds no GPU or fewer than the cell's chips,
and a GPU missing from ``peaks.json``.  Earlier lines of standard output
give the card's name and power limit and the SM clock sampled through the
run; the last line is the result as one JSON object.  The numbers compared
with the reference, each beside its limit, are the last lines of standard
error and the last key of the result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: JAX's persistent compilation cache, at a fixed path inside the checkout
CACHE = ROOT / ".jax_cache"


class ClockSampler:
    """Samples each card's SM clock and power draw with ``nvidia-smi`` once
    a second in a thread that stays off JAX."""

    QUERY = ["nvidia-smi", "--query-gpu=index,clocks.sm,power.draw",
             "--format=csv,noheader,nounits"]

    def __init__(self):
        self.samples: dict[str, list] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                out = subprocess.run(self.QUERY, capture_output=True,
                                     text=True, timeout=10).stdout
            except (OSError, subprocess.TimeoutExpired):
                return
            for line in out.strip().splitlines():
                idx, mhz, watts = (v.strip() for v in line.split(","))
                self.samples.setdefault(idx, []).append((mhz, watts))
            self._stop.wait(1.0)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def lines(self) -> list[str]:
        out = []
        for idx, rows in sorted(self.samples.items()):
            mhz = [float(m) for m, _ in rows if m.replace(".", "").isdigit()]
            watts = [float(w) for _, w in rows if w.replace(".", "").isdigit()]
            if mhz:
                out.append(f"sm clock gpu{idx}: {len(mhz)} samples, min "
                           f"{min(mhz):g} median {statistics.median(mhz):g} "
                           f"max {max(mhz):g} MHz; power median "
                           f"{statistics.median(watts or [0]):g} W")
        return out


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return [f"card: {line.strip()}" for line in out.strip().splitlines()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(CACHE)
    sys.path.insert(0, str(ROOT))
    import srcnn_cpp_tpu  # noqa: F401  the program under test, from the checkout
    from perfbench import harness, spec

    cell = spec.load_cell(args.workload, bool(args.trace))
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} GPU(s); JAX "
              f"found {len(devs)} {devs[0].platform!r} device(s)",
              file=sys.stderr)
        return 2
    peaks = json.loads((ROOT / spec.PKG / "peaks.json").read_text())
    if devs[0].device_kind not in peaks:
        print(f"perfbench: no peaks for {devs[0].device_kind!r} in "
              f"peaks.json", file=sys.stderr)
        return 2
    for line in card_lines():
        print(line, flush=True)
    with ClockSampler() as clocks:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             T_START, peaks[devs[0].device_kind])
    for line in clocks.lines():
        print(line)
    for name, r in result["checked"].items():
        print(f"check {name}: {r['value']!r} (limit {r['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
