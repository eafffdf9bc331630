"""One short run of a cell on the card, through the benchmark's command."""

import json
import os
import subprocess
import sys

import pytest

from ugbench import registry


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "-m", "ugbench.run", "--workload", "jpeg1080p-live-loss",
                          "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "0"],
                         cwd=registry.ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": registry.ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
