"""The comparison that decides ``correct``.

Each compared answer is a whole output BGR image of the entry that the
window drove, against the plain reference on the same input.  The numbers
compared, each against a limit from the configuration's ``check``:

* ``mismatch_share``: the share of output bytes that differ from the
  reference.  The program's float32-equivalent products round differently
  from the reference's, and a truncating quantizer turns a tiny difference
  next to an integer into one LSB, so a sound run reads a small share, and
  the lower precision of the control reads a large one;
* ``bytes_over_1_lsb``: how many output bytes differ by more than one
  LSB.  A truncation that flips moves Y by one LSB, and the fixed-point
  inverse colour transform adds that Y to each of B, G and R, so a sound
  run differs by at most one LSB anywhere; a larger difference is a fault
  or a lower precision (limit 0);
* ``answers_missing``: sampled answers that never came, and requests that
  raised (limit 0).
"""

from __future__ import annotations

import numpy as np


def compare(pairs) -> dict:
    """``pairs`` of (answer, reference) uint8 arrays -> the numbers."""
    differ = over = total = 0
    for out, ref in pairs:
        out = np.asarray(out)
        if out.shape != ref.shape:
            return {"mismatch_share": 1.0, "bytes_over_1_lsb": ref.size}
        d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
        differ += int(np.count_nonzero(d))
        over += int(np.count_nonzero(d > 1))
        total += d.size
    if total == 0:   # nothing came back to compare
        return {"mismatch_share": 1.0, "bytes_over_1_lsb": 0}
    return {"mismatch_share": differ / total, "bytes_over_1_lsb": over}


def verdict(numbers: dict, limits: dict, missing: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every number compared."""
    report = {name: {"value": numbers[name], "limit": limits[name]}
              for name in ("mismatch_share", "bytes_over_1_lsb")}
    report["answers_missing"] = {"value": missing, "limit": 0}
    ok = all(r["value"] <= r["limit"] for r in report.values())
    return ok, report
