"""Finds a cell's configuration, traffic, driver and metric readers by name.

``BENCHMARK.json`` names the configuration, the traffic and the metrics, and
the traffic file names its driver; each lives in a file of its own under
this directory, so a new cell, configuration, mix, driver or metric is new
files and new entries, never an edit of a file that is here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

#: the root of the checkout that holds ``BENCHMARK.json``
ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent.name


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json``, resolved to its files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    #: the metric entries of this cell for the run: ``end_to_end`` ones
    #: without a trace, ``per_layer`` ones with
    metrics: tuple
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_cell(name: str, trace: bool, root: Path = ROOT) -> Cell:
    """Resolve the workload ``name``; raises ``KeyError`` if it is unknown."""
    root = Path(root)
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{', '.join(sorted(work))})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / PKG / "traffic" / f"{w['traffic']}.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    metrics = tuple(m for m in bench[kind]
                    if name in m.get("workloads", [name]))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, metrics=metrics, root=root)


def _module(kind: str, name: str, path: Path):
    spec = importlib.util.spec_from_file_location(
        f"{PKG}_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``.

    A metric split by the end-to-end metric it moves, ``<base>.<part>``
    (``step_mfu_pct.host``), is read by ``metrics/<base>.py`` unless it
    has a file of its own.
    """
    path = Path(root) / PKG / "metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(f"{metric.split('.')[0]}.py")
    return _module("metric", metric, path).read


def driver(name: str, root: Path = ROOT):
    """The ``Driver`` class of ``drivers/<name>.py`` (see :mod:`.loop`)."""
    path = Path(root) / PKG / "drivers" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no driver {name!r}: {path} is missing")
    return _module("driver", name, path).Driver
