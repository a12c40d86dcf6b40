"""No module a run loads is JAX's or the JAX package's (whole top-level
names: the program's own name begins with the JAX package's), and the
references import nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BANNED_IN_REFERENCE = {"beast_mcmc_tpu_torch", "beast_mcmc_tpu", "jax",
                       "jaxlib", "flax"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & BANNED_IN_REFERENCE, tops


def test_a_run_loads_no_jax():
    code = (
        "import json, sys, time\n"
        "from phylobench import harness\n"
        "from phylobench.tests._tiny import TINY\n"
        "harness.run('makona.hmc.b8', 5, 0.5, 1, 'cpu', time.perf_counter(),"
        " overrides=TINY['makona.hmc.b8'], log=lambda *a: None)\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names():
    from phylobench import harness

    sys.modules.setdefault("beast_mcmc_tpu_torch_fake_probe", sys)
    try:
        assert "beast_mcmc_tpu_torch_fake_probe" not in (
            harness.forbidden_modules())
    finally:
        del sys.modules["beast_mcmc_tpu_torch_fake_probe"]


def test_no_card_means_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "phylobench", "--workload", "makona.mh.b64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
