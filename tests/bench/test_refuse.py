"""The benchmark's command refuses to report anything without a GPU, with
too few of them, with a GPU missing from the peak table, or in a directory
that holds only BENCHMARK.json and the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.spec import ROOT

ARGS = ["--workload", "video_1080p_x2.device_batch", "--seed", "1",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, code=None, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    cmd = [sys.executable, "perfbench/run.py", *ARGS] if code is None \
        else [sys.executable, "-c", code]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)


def _no_result(proc):
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_refuses_the_cpu():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert "needs 1 GPU" in proc.stderr
    _no_result(proc)


_FAKE = """
import runpy, sys
import jax

class Dev:
    platform = "gpu"
    device_kind = {kind!r}

jax.devices = lambda *a: [Dev()] * {n}
sys.argv = ["run.py", *{args!r}]
runpy.run_path("perfbench/run.py", run_name="__main__")
"""


def _checkout(tmp_path):
    """BENCHMARK.json with a four-card cell of the row-sharded stills
    added, the benchmark's files and the program."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "still_4k_x2.mesh4", "chips": 4,
                               "config": "still_4k_x2", "traffic": "mesh4",
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "srcnn_cpp_tpu").symlink_to(ROOT / "srcnn_cpp_tpu")
    return tmp_path


@pytest.mark.parametrize("kind,n,workload,message", [
    ("NVIDIA H100 80GB HBM3", 1, "still_4k_x2.mesh4", "needs 4 GPU"),
    ("NVIDIA Imaginary 1GB", 1, "video_1080p_x2.device_batch",
     "no peaks for 'NVIDIA Imaginary 1GB'"),
])
def test_refuses_too_few_or_unknown_gpus(tmp_path, kind, n, workload,
                                         message):
    args = list(ARGS)
    args[1] = workload
    proc = _run(_checkout(tmp_path), _FAKE.format(kind=kind, n=n, args=args))
    assert proc.returncode != 0
    assert message in proc.stderr
    _no_result(proc)


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert "srcnn_cpp_tpu" in proc.stderr
    _no_result(proc)
