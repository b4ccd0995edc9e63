"""A configuration, a traffic mix, a driver and a per-layer metric are added
with new files and new BENCHMARK.json entries only, and a whole run of the
new cell finds and uses them (on the CPU, past the look for a chip)."""

import dataclasses
import json
import shutil
import time

import pytest

from perfbench import harness, spec
from perfbench.spec import ROOT

PEAK = {"bf16_dense_flop_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}

#: a driver of its own: one frame per request, fetched to the host at once
ONE_FRAME = '''
import time

import numpy as np

from perfbench import loop


class Driver:
    def __init__(self, cell, weights, pool, devices, sample):
        from srcnn_cpp_tpu.pipeline import upscale_bgr_batch

        self.call = lambda img: np.asarray(upscale_bgr_batch(
            img[None], float(cell.config["scale"]), weights))[0]
        self.pool, self.sample = pool, sample
        self.px = int(np.prod(cell.config["out_hw"]))

    def warm(self):
        self.call(self.pool[0])

    def run(self, seconds, capture):
        done = []

        def issue(i):
            k, t0 = i % len(self.pool), time.monotonic()
            out = self.call(self.pool[k])
            done.append((t0, time.monotonic(), self.px))
            self.sample.offer((k, out))

        loop.closed_loop(seconds, capture, issue)
        return loop.Window(done, 0)

    def answers(self):
        return list(self.sample.items)
'''


@pytest.fixture()
def checkout(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's files, with one new
    configuration, mix and metric added as files and entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "video_1080p_x2.json").read_text())
    cfg.update(name="tiny_x2", in_hw=[20, 36], out_hw=[40, 72])
    (pb / "configs" / "tiny_x2.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "pairs.json").write_text(json.dumps(
        {"driver": "device_batch", "pool": 4, "batch": 2, "inflight": 2,
         "sample": 1}))
    (pb / "drivers" / "one_frame.py").write_text(ONE_FRAME)
    (pb / "traffic" / "singles.json").write_text(json.dumps(
        {"driver": "one_frame", "pool": 3, "sample": 2}))
    (pb / "metrics" / "requests_traced.py").write_text(
        '"""Requests completed in the traced window."""\n\n'
        "def read(ctx):\n"
        "    return len(ctx.traced_requests())\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_x2", "source": "test",
                             "file": "perfbench/configs/tiny_x2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_x2.pairs", "config": "tiny_x2",
                               "traffic": "pairs", "chips": 1,
                               "why": "test"})
    bench["workloads"].append({"name": "tiny_x2.singles", "config": "tiny_x2",
                               "traffic": "singles", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "throughput_mps":
            m["workloads"] += ["tiny_x2.pairs", "tiny_x2.singles"]
    bench["per_layer"].append({"name": "requests_traced", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "throughput_mps",
                               "workloads": ["tiny_x2.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_new_files_are_found_by_name(checkout):
    cell = spec.load_cell("tiny_x2.pairs", trace=True, root=checkout)
    assert cell.config["in_hw"] == [20, 36]
    assert cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.metrics] == ["requests_traced"]
    e2e = spec.load_cell("tiny_x2.pairs", trace=False, root=checkout)
    assert [m["name"] for m in e2e.metrics] == ["throughput_mps", "setup_s"]
    assert spec.reader("requests_traced", checkout) is not None


def test_a_run_of_the_new_cell_reports_the_new_metric(checkout):
    cell = spec.load_cell("tiny_x2.pairs", trace=True, root=checkout)
    r = harness.run(cell, 12, 0.6, True, time.monotonic(), PEAK)
    assert r["correct"], r["checked"]
    assert r["metrics"]["requests_traced"]["value"] > 0
    assert r["metrics"]["requests_traced"]["unit"] == "count"
    assert r["device"]["window_s"] > 0


def test_without_a_trace_the_end_to_end_metrics_are_reported(checkout):
    cell = spec.load_cell("tiny_x2.pairs", trace=False, root=checkout)
    r = harness.run(cell, 13, 0.3, False, time.monotonic(), None)
    assert set(r["metrics"]) == {"throughput_mps", "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["host_per_request"]) == {"user_ms", "sys_ms"}
    assert r["host_per_request"]["user_ms"] > 0
    assert list(r)[-1] == "checked"


def test_a_new_driver_is_found_by_name_and_drives_its_cell(checkout):
    cell = spec.load_cell("tiny_x2.singles", trace=False, root=checkout)
    assert spec.driver("one_frame", checkout).__module__.endswith(
        "one_frame")
    r = harness.run(cell, 15, 0.3, False, time.monotonic(), None)
    assert r["correct"], r["checked"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"throughput_mps", "setup_s"}


def test_an_unknown_driver_is_an_error(checkout):
    with pytest.raises(KeyError, match="no driver"):
        spec.driver("nothing", checkout)


def test_a_split_metric_is_read_by_its_base_reader():
    assert spec.reader("step_mfu_pct.host").__module__ != \
        spec.reader("latency_p50_ms").__module__
    assert spec.reader("step_mfu_pct.host").__code__.co_filename.endswith(
        "metrics/step_mfu_pct.py")


def test_an_unknown_workload_is_an_error(checkout):
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell("tiny_x2.nothing", trace=False, root=checkout)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.load_cell(w["name"], False).metrics]
        layer = spec.load_cell(w["name"], True).metrics
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in e2e + [m["name"] for m in layer]:
            assert callable(spec.reader(m))


def test_a_cell_resized_in_its_config_drives_the_new_size(checkout):
    cell = spec.load_cell("tiny_x2.pairs", trace=False, root=checkout)
    small = dataclasses.replace(cell, config=dict(cell.config,
                                                  in_hw=[16, 24],
                                                  out_hw=[32, 48]))
    r = harness.run(small, 14, 0.3, False, time.monotonic(), None)
    assert r["correct"]
