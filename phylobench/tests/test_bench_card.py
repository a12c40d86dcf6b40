"""On the card: one short run of each cell through the command the driver
runs, its last line of standard output the contract's result."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("cell,trace", [("makona.mh.b64", 0),
                                        ("makona.mh.b64", 1),
                                        ("makona.hmc.b8", 1),
                                        ("codon.mh.b4", 0)])
def test_cell_on_the_card(cuda_device, cell, trace):
    out = subprocess.run(
        [sys.executable, "-m", "phylobench", "--workload", cell, "--seed",
         "2147483999", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
