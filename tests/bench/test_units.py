"""The yardstick's arithmetic on the CPU: operations and bytes, the peak
table, the seeded frames, the rate and latency of a window, the reservoir
of answers and the comparison."""

import json

import numpy as np
import pytest

from perfbench import check, flops, frames, loop, stats
from perfbench.spec import ROOT, load_benchmark


@pytest.fixture(scope="module")
def configs():
    bench = load_benchmark()
    return {c["name"]: json.loads((ROOT / c["file"]).read_text())
            for c in bench["configs"]}


def test_conv_work_per_pixel(configs):
    for cfg in configs.values():
        # 9*9*64 + 64*32 + 5*5*32 multiply-adds, 2 operations each
        assert flops.conv_macs_per_px(cfg) == 8032
        assert flops.conv_flop_per_px(cfg) == 16064
        assert flops.conv_bytes_per_px(cfg) == 2


def test_out_pixels(configs):
    assert flops.out_pixels(configs["video_1080p_x2"]) == 3840 * 2160
    assert flops.out_pixels(configs["still_4k_x2"]) == 7680 * 4320


def test_least_time_names_its_roof():
    peak = {"bf16_dense_flop_per_s": 1e15, "hbm_bytes_per_s": 1e12}
    assert flops.least_time_s(16064e6, 2e6, peak) == (
        pytest.approx(16064e6 / 1e15), "compute")
    assert flops.least_time_s(1e6, 1e9, peak) == (
        pytest.approx(1e-3), "memory")


def test_peak_table_has_the_h100_with_its_source():
    peaks = json.loads((ROOT / "perfbench" / "peaks.json").read_text())
    h100 = peaks["NVIDIA H100 80GB HBM3"]
    assert h100["bf16_dense_flop_per_s"] == 989e12
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert "datasheet" in h100["source"]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_same_seed_same_frames(seed):
    a = frames.pool(seed, 3, (36, 50))
    b = frames.pool(seed, 3, (36, 50))
    assert a.shape == (3, 36, 50, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)


def test_other_seed_other_frames():
    a = frames.pool(1, 4, (36, 50))
    b = frames.pool(2, 4, (36, 50))
    assert not np.array_equal(a, b)
    assert a.std() > 10   # natural images, not a constant


def test_frames_wrap_pad_a_source_image():
    # a frame more than twice the size of every source image repeats with
    # the period of the image it was cut from
    shapes = {im.shape[:2] for im in frames.source_images()}
    big = frames.pool(5, 1, (1210, 1540))[0]
    assert any(np.array_equal(big[:h], big[h:2 * h])
               and np.array_equal(big[:, :w], big[:, w:2 * w])
               for h, w in shapes)


def test_rate_is_all_work_over_the_whole_window():
    # first submission at 10 s, last completion at 14 s: 8 MP in 4 s
    reqs = [(10.0, 11.0, 2e6), (11.0, 12.5, 2e6), (12.5, 13.0, 2e6),
            (13.0, 14.0, 2e6)]
    assert stats.window_s(reqs) == pytest.approx(4.0)
    assert stats.throughput_mps(reqs) == pytest.approx(2.0)


def test_latency_tail_covers_every_request():
    reqs = [(float(i), float(i) + (i + 1) / 1000, 1) for i in range(100)]
    assert stats.latency_ms(reqs, 50) == pytest.approx(50)
    assert stats.latency_ms(reqs, 95) == pytest.approx(95)
    assert stats.latency_ms(reqs, 100) == pytest.approx(100)
    assert stats.latency_ms(reqs[:1], 95) == pytest.approx(1)


def test_reservoir_is_seeded_and_uniform():
    def draw(seed):
        r = loop.Reservoir(2, np.random.default_rng(seed))
        for i in range(50):
            r.offer(i)
        return r.items

    assert draw(3) == draw(3)
    counts = np.zeros(50)
    for seed in range(2000):
        for i in draw(seed):
            counts[i] += 1
    assert counts.min() > 40 and counts.max() < 130   # mean 80


def test_compare_counts_bytes_and_the_worst():
    ref = np.zeros((4, 5, 3), np.uint8)
    out = ref.copy()
    out[0, 0, 0], out[1, 1, 1], out[2, 2, 2] = 1, 3, 2
    got = check.compare([(out, ref), (ref, ref)])
    assert got == {"mismatch_share": 3 / 120, "bytes_over_1_lsb": 2}


@pytest.mark.parametrize("pairs", [[], [(np.zeros((2, 2, 3), np.uint8),
                                         np.zeros((4, 4, 3), np.uint8))]])
def test_nothing_to_compare_or_a_wrong_shape_fails(pairs):
    got = check.compare(pairs)
    ok, _ = check.verdict(got, {"mismatch_share": 0.5, "bytes_over_1_lsb": 0},
                          0)
    assert not ok


def test_verdict_reports_each_number_beside_its_limit():
    ok, rep = check.verdict({"mismatch_share": 0.001, "bytes_over_1_lsb": 0},
                            {"mismatch_share": 0.01, "bytes_over_1_lsb": 0}, 0)
    assert ok
    assert rep == {"mismatch_share": {"value": 0.001, "limit": 0.01},
                   "bytes_over_1_lsb": {"value": 0, "limit": 0},
                   "answers_missing": {"value": 0, "limit": 0}}
    ok, rep = check.verdict({"mismatch_share": 0.0, "bytes_over_1_lsb": 0},
                            {"mismatch_share": 0.01, "bytes_over_1_lsb": 0}, 1)
    assert not ok and rep["answers_missing"]["value"] == 1
