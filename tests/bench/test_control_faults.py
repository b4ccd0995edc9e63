"""The check separates a sound run from the control and from faults.

At a size a test run holds, on the CPU: the control (the reference in
bfloat16 put in the program's place) fails the configuration's limits,
and a whole run of each cell, driven past the look for a chip with its
timed path broken underneath, comes out with ``correct`` false, once for
each fault that cell can have.  The same runs unbroken are correct.
"""

import dataclasses
import json
import time

import jax
import numpy as np
import pytest

from perfbench import check, control, faults, frames, harness, reference, \
    spec

SMALL = {"in_hw": [24, 40], "out_hw": [48, 80]}
#: the row-sharded still cell: its traffic file is ready, its entry in
#: BENCHMARK.json is left out until its host-fed numbers hold a bound
MESH4 = "still_4k_x2.mesh4"


def _cell(name):
    if name == MESH4:
        cell = dataclasses.replace(
            spec.load_cell("still_4k_x2.host_single", trace=False),
            name=MESH4, chips=4, traffic=json.loads(
                (spec.ROOT / spec.PKG / "traffic" / "mesh4.json").read_text()))
    else:
        cell = spec.load_cell(name, trace=False)
    return dataclasses.replace(cell, config=dict(cell.config, **SMALL))


def _run(name, seed=21):
    jax.clear_caches()
    try:
        return harness.run(_cell(name), seed, 0.3, False, time.monotonic(),
                           None)
    finally:
        jax.clear_caches()


CELLS = ["video_1080p_x2.device_batch", "still_4k_x2.host_single", MESH4]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checked"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_limits(seed):
    cell = _cell("video_1080p_x2.device_batch")
    nums = control.control_numbers(cell, seed)
    ok, _ = check.verdict(nums, cell.config["check"], 0)
    assert not ok, nums


def test_control_is_the_reference_in_bfloat16():
    img = frames.pool(4, 1, (24, 40))[0]
    w = reference.load_weights()
    hi = reference.upscale(img, 2.0, w)
    lo = reference.upscale(img, 2.0, w, "bfloat16")
    assert hi.shape == lo.shape == (48, 80, 3)
    assert not np.array_equal(hi, lo)


FAULTS = [
    ("video_1080p_x2.device_batch", "answer altered", "batch_altered"),
    ("video_1080p_x2.device_batch", "half the batch left out", "half_batch"),
    ("video_1080p_x2.device_batch", "state unchanged", "batch_stale"),
    ("still_4k_x2.host_single", "answer altered", "still_altered"),
    ("still_4k_x2.host_single", "state unchanged", "still_stale"),
    (MESH4, "exchange left out", "no_exchange"),
    (MESH4, "answer altered", "still_altered"),
]


@pytest.mark.parametrize("name,what,fault", FAULTS,
                         ids=[f"{n}-{w}" for n, w, _ in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, what, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = _run(name)
    assert r["attempted"] > 0
    assert not r["correct"], (what, r["checked"])


def test_every_fault_is_tested():
    assert {f for _, _, f in FAULTS} == set(faults.FAULTS)
