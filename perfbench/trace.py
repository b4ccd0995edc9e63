"""A traced part of the window, and its reduction to device numbers.

:class:`Capture` starts ``jax.profiler`` part of the way into the window
and stops it a few seconds later, with the span ``bench.traced`` around
exactly that part: the traced window.  :func:`from_profile` reads the
``.xplane.pb`` the profiler wrote into a :class:`Trace`:

* every event of a ``/device:GPU:<n>`` plane, on all its lines (kernels,
  memsets and copies on their streams), is an operation on device ``n``;
* events of the host plane whose names start with ``bench.`` are the spans
  this benchmark placed around its calls into the program
  (``bench.submit``, ``bench.fetch``, ``bench.call``).

Busy time is the union of a device's operation intervals inside the traced
window; the idle share is one less busy over the window.  A device's idle
gaps are named by the benchmark span that overlaps them most.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import re
import shutil
import tempfile
import time

#: the conv kernel's name in a device trace (``pallas_call(name=...)``)
KERNEL = "srcnn_conv12_q"
#: collective operations between cards: NCCL kernels and XLA's collectives
COLLECTIVE = re.compile(
    r"nccl|collective|all-?reduce|all-?gather|all-?to-?all|reduce-?scatter"
    r"|send|recv", re.IGNORECASE)
TRACED = "bench.traced"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start: int   # ns
    end: int     # ns


@dataclasses.dataclass
class Trace:
    #: the traced window, in the events' time base (ns)
    start: int
    stop: int
    #: device ordinal -> its operations
    devices: dict
    #: the benchmark's host spans, ``bench.traced`` excluded
    host: list

    @property
    def window_s(self) -> float:
        return (self.stop - self.start) / 1e9

    def ops(self, device: int) -> list:
        """The device's operations clipped to the traced window."""
        out = []
        for e in self.devices.get(device, ()):
            s, t = max(e.start, self.start), min(e.end, self.stop)
            if t > s:
                out.append(Event(e.name, s, t))
        return out


def from_profile(profile) -> Trace:
    """A :class:`Trace` from a ``jax.profiler.ProfileData``."""
    devices = collections.defaultdict(list)
    host, window = [], None
    for plane in profile.planes:
        if plane.name.startswith("/device:GPU:"):
            dev = int(plane.name.rsplit(":", 1)[1])
            for line in plane.lines:
                devices[dev].extend(
                    Event(e.name, int(e.start_ns), int(e.end_ns))
                    for e in line.events)
        elif plane.name.startswith("/host:CPU"):
            for line in plane.lines:
                for e in line.events:
                    if e.name == TRACED:
                        window = (int(e.start_ns), int(e.end_ns))
                    elif e.name.startswith("bench."):
                        host.append(Event(e.name, int(e.start_ns),
                                          int(e.end_ns)))
    if window is None:
        raise ValueError(f"the trace has no {TRACED!r} span")
    return Trace(window[0], window[1], dict(devices), host)


def load(path: str) -> Trace:
    from jax.profiler import ProfileData

    return from_profile(ProfileData.from_file(path))


def union(events) -> list[tuple[int, int]]:
    """Merged, sorted busy intervals of ``events``."""
    merged = []
    for s, t in sorted((e.start, e.end) for e in events):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_s(trace: Trace, device: int) -> float:
    return sum(t - s for s, t in union(trace.ops(device))) / 1e9


def idle_share(trace: Trace, device: int) -> float:
    """1 - busy / window, as a fraction."""
    return 1.0 - busy_s(trace, device) / trace.window_s


def time_s(trace: Trace, device: int, match) -> float:
    """Summed duration of the device's operations whose name ``match``es."""
    return sum(e.end - e.start for e in trace.ops(device)
               if match(e.name)) / 1e9


def is_kernel(name: str) -> bool:
    return KERNEL in name


def is_collective(name: str) -> bool:
    return COLLECTIVE.search(name) is not None


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def gaps(trace: Trace, device: int) -> list[tuple[int, int]]:
    """The device's idle intervals inside the traced window."""
    out, t = [], trace.start
    for s, e in union(trace.ops(device)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.stop > t:
        out.append((t, trace.stop))
    return out


def idle_by_host_span(trace: Trace, devices) -> list[list]:
    """Idle seconds per device, averaged over ``devices``, summed by the
    benchmark span that overlaps each gap most (``none`` where no span
    does), longest first."""
    total = collections.Counter()
    for dev in devices:
        for s, t in gaps(trace, dev):
            best, name = 0, "none"
            for h in trace.host:
                ov = min(t, h.end) - max(s, h.start)
                if ov > best:
                    best, name = ov, h.name
            total[name] += (t - s) / 1e9 / len(devices)
    return [[n, v] for n, v in total.most_common(10)]


def top_ops(trace: Trace, devices) -> list[list]:
    """Device seconds per operation name, averaged over ``devices``."""
    total = collections.Counter()
    for dev in devices:
        for e in trace.ops(dev):
            total[e.name] += (e.end - e.start) / 1e9 / len(devices)
    return [[n, v] for n, v in total.most_common(10)]


class Capture:
    """Profiles the part of a window between two host-clock instants.

    The driver calls :meth:`poll` with the time once per request; the
    profiler starts at ``start_at``, and the ``bench.traced`` span and the
    profiler end at ``stop_at`` or at :meth:`close`.
    """

    def __init__(self, start_at: float, stop_at: float):
        self.start_at, self.stop_at = start_at, stop_at
        self.dir = tempfile.mkdtemp(prefix="perfbench-trace-")
        self.t_on = self.t_off = None
        self._span = None

    def poll(self, now: float) -> None:
        import jax

        if self.t_on is None and now >= self.start_at:
            opts = jax.profiler.ProfileOptions()
            opts.python_tracer_level = 0
            opts.enable_hlo_proto = False
            jax.profiler.start_trace(self.dir, profiler_options=opts)
            self._span = jax.profiler.TraceAnnotation(TRACED)
            self._span.__enter__()
            self.t_on = time.monotonic()
        elif self._span is not None and now >= self.stop_at:
            self.close()

    def close(self) -> None:
        import jax

        if self._span is not None:
            self.t_off = time.monotonic()
            self._span.__exit__(None, None, None)
            self._span = None
            jax.profiler.stop_trace()

    def read(self) -> Trace | None:
        """The trace, once closed; the profile's files are removed."""
        try:
            paths = glob.glob(f"{self.dir}/**/*.xplane.pb", recursive=True)
            return load(paths[0]) if paths else None
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
