"""The command as the benchmark is run: it fails without a card, and on one
it prints a correct result line."""

import json
import subprocess
import sys

import pytest

from port_bench import run


def command(workload, seconds, trace=0):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", workload, "--seed", str(2**40 + 9),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=run.ROOT, capture_output=True, text=True, timeout=600)


def test_the_command_fails_without_a_card(no_card):
    out = command("mixed_primitives.e150", 1)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.mark.gpu
def test_the_command_on_the_card(card):
    out = command("mixed_primitives.e150", 5)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
