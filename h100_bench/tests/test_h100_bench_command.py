"""The command itself: without a card it fails and prints no result; in
a directory holding only BENCHMARK.json and the benchmark's folder it
fails too; on the card (marked ``gpu``) one short run is correct."""

import json
import shutil
import subprocess
import sys

import pytest

from h100_bench import harness

ROOT = harness.HERE.parent
CMD = [sys.executable, "h100_bench/run.py", "--workload", "eight_schools.nuts",
       "--seed", "2147483999", "--seconds", "1", "--trace", "0"]


def _has_card():
    import torch

    return torch.cuda.is_available()


def test_no_card_no_result():
    if _has_card():
        pytest.skip("a card is present: this test is for a machine without one")
    out = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_one_short_run_on_the_card():
    if not _has_card():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
