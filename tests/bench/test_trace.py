"""The trace reduction on a small hand-made trace
(perfbench/fixtures/trace_small.pbtxt): two devices, a traced window of
10 us from 1 us, a copy that starts before the window and one that ends
after it, overlapping kernels, one NCCL kernel, and the benchmark's host
spans."""

import dataclasses

import pytest

from perfbench import trace as tr
from perfbench.spec import ROOT

FIXTURE = ROOT / "perfbench" / "fixtures" / "trace_small.pbtxt"


@pytest.fixture(scope="module")
def small():
    from jax.profiler import ProfileData

    return tr.from_profile(ProfileData.from_text_proto(FIXTURE.read_text()))


def test_window_and_spans(small):
    assert (small.start, small.stop) == (1000, 11000)
    assert small.window_s == pytest.approx(1e-5)
    assert sorted(h.name for h in small.host) == [
        "bench.fetch", "bench.submit", "bench.submit"]


def test_busy_is_the_union_clipped_to_the_window(small):
    # GPU:0: copy 1000-1500 (clipped), kernels 2000-6000 (overlapping),
    # nccl 7000-7500, copy 10500-11000 (clipped)
    assert tr.union(small.ops(0)) == [(1000, 1500), (2000, 6000),
                                      (7000, 7500), (10500, 11000)]
    assert tr.busy_s(small, 0) == pytest.approx(5.5e-6)
    assert tr.busy_s(small, 1) == pytest.approx(3e-6)


def test_idle_share(small):
    assert tr.idle_share(small, 0) == pytest.approx(0.45)
    assert tr.idle_share(small, 1) == pytest.approx(0.7)
    assert tr.idle_share(small, 5) == pytest.approx(1.0)   # no operations


def test_kernel_and_collective_matches(small):
    assert tr.time_s(small, 0, tr.is_kernel) == pytest.approx(3e-6)
    assert tr.time_s(small, 1, tr.is_kernel) == pytest.approx(2e-6)
    assert tr.time_s(small, 0, tr.is_collective) == pytest.approx(5e-7)
    assert tr.time_s(small, 1, tr.is_collective) == 0
    assert tr.time_s(small, 0, tr.is_copy) == pytest.approx(1e-6)


@pytest.mark.parametrize("name,kernel,collective", [
    ("srcnn_conv12_q", True, False),
    ("jit_step/srcnn_conv12_q.1", True, False),
    ("ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)",
     False, True),
    ("collective-permute-start", False, True),
    ("all-gather-start.1", False, True),
    ("loop_add_slice_fusion", False, False),
    ("MemcpyD2H", False, False),
])
def test_name_matches(name, kernel, collective):
    assert tr.is_kernel(name) is kernel
    assert tr.is_collective(name) is collective


def test_gaps_named_by_host_span(small):
    assert tr.gaps(small, 0) == [(1500, 2000), (6000, 7000), (7500, 10500)]
    got = dict(tr.idle_by_host_span(small, [0, 1]))
    # averaged over the two devices
    assert got["bench.submit"] == pytest.approx((3500 + 4000) / 2 / 1e9)
    assert got["bench.fetch"] == pytest.approx((1000 + 3000) / 2 / 1e9)


def test_top_ops(small):
    ops = dict(tr.top_ops(small, [0, 1]))
    assert ops["srcnn_conv12_q"] == pytest.approx((3000 + 2000) / 2 / 1e9)


def test_collective_time_per_image_over_the_cards(small):
    """The reader of the row-sharded still cell: collective device time
    per completed image, the mean over the cell's cards."""
    from perfbench import harness, spec

    cell = spec.Cell(name="two", chips=2, config={"out_hw": [1, 2]},
                     traffic={}, metrics=(), root=ROOT)
    reqs = [(0.0, 0.5, 2), (0.5, 0.8, 2), (0.8, 1.5, 2)]   # two in the window
    ctx = harness.Context(cell, reqs, 1.0, None, small, (0.0, 1.0))
    halo = spec.reader("halo_exchange_ms_per_image")
    assert halo(ctx) == pytest.approx(1e3 * (5e-7 + 0) / 2 / 2)
    assert halo(harness.Context(dataclasses.replace(cell, chips=1), reqs,
                                1.0, None, small, (0.0, 1.0))) is None
    assert spec.reader("latency_p95_ms")(ctx) == pytest.approx(700)


def test_a_trace_without_the_window_span_is_refused():
    from jax.profiler import ProfileData

    text = FIXTURE.read_text().replace('"bench.traced"', '"bench.other"')
    with pytest.raises(ValueError, match="bench.traced"):
        tr.from_profile(ProfileData.from_text_proto(text))
