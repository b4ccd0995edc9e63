"""The benchmark of the SRCNN super-resolution pipeline on NVIDIA GPUs.

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``configs/<config>.json`` (the
deployment and the limits of its correctness check), ``traffic/<mix>.json``
(the parameters of the mix, and the driver that reads them),
``drivers/<driver>.py`` (the loop that drives the program's entry, see
:mod:`.loop`) and ``metrics/<metric>.py`` (one reader per metric).  The
yardstick lives here
and imports nothing of the program but its entries: frame generation
(:mod:`.frames`), the plain reference (:mod:`.reference`), the comparison
(:mod:`.check`), operations and bytes (:mod:`.flops`), the peak table
(``peaks.json``) and the reduction of a profiler trace (:mod:`.trace`).
"""
