"""The PyTorch port imports neither JAX nor any module of the JAX package."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "beast_mcmc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "chex", "beast_mcmc_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_import_every_module_without_jax():
    # every kernel's wrapper, the data modules, the samplers, MC3, the
    # component cache, the joint analysis's modules, the run surface
    # (config, runner, loggers, checkpoint, ancestral draw, the command
    # line), the post-processing apps, the AS91 copy, the XML
    # interpreter and the epoch model, the XML extension modules and their
    # helpers (xml_ext, xml_geo, xml_assert's initial state, xml_hmc,
    # xml_stats's current state, the GMRF block update and elliptical
    # slice sampler, the Sericola series, the stochastic Dollo model, the
    # continuous-trait models, config/xml_traits.py and the BASTA
    # structured coalescent), and the model families outside the XML
    # vocabulary (stochastic mapping, the tip-error, Thorney, constrained
    # and empirical-tree modules, the GLM, geo, MSC, AlloppNet,
    # transmission, case-to-case, clustering, MDS, Hawkes and ARG
    # models), and the multi-process layer with its worker entry are among
    # the modules found
    assert {"beast_mcmc_tpu_torch.apps.makona",
            "beast_mcmc_tpu_torch.parallel",
            "beast_mcmc_tpu_torch.parallel.mesh",
            "beast_mcmc_tpu_torch.parallel.distributed",
            "beast_mcmc_tpu_torch.parallel.__main__",
            *(f"beast_mcmc_tpu_torch.{m}" for m in (
                "ops.markov_jumps", "ops.uniformization", "models.thorney",
                "models.tipstates", "tree.constrained", "tree.empirical",
                "models.regression", "models.geo", "models.msc",
                "models.alloppnet", "models.transmission",
                "models.casetocase", "models.clustering", "models.mds",
                "models.hawkes", "models.arg")),
            "beast_mcmc_tpu_torch.config.xml_ext",
            "beast_mcmc_tpu_torch.config.xml_geo",
            "beast_mcmc_tpu_torch.config.xml_assert",
            "beast_mcmc_tpu_torch.config.xml_hmc",
            "beast_mcmc_tpu_torch.config.xml_stats",
            "beast_mcmc_tpu_torch.inference.gibbs",
            "beast_mcmc_tpu_torch.ops.sericola",
            "beast_mcmc_tpu_torch.models.dollo",
            "beast_mcmc_tpu_torch.models.continuous",
            "beast_mcmc_tpu_torch.models.factor",
            "beast_mcmc_tpu_torch.models.liability",
            "beast_mcmc_tpu_torch.models.basta",
            "beast_mcmc_tpu_torch.config.xml_traits",
            "beast_mcmc_tpu_torch.config.interpreter",
            "beast_mcmc_tpu_torch.models.epoch",
            "beast_mcmc_tpu_torch.__main__",
            "beast_mcmc_tpu_torch.apps.runner",
            "beast_mcmc_tpu_torch.config",
            "beast_mcmc_tpu_torch.config.builder",
            "beast_mcmc_tpu_torch.config.spec",
            "beast_mcmc_tpu_torch.config.xml_import",
            "beast_mcmc_tpu_torch.inference.checkpoint",
            "beast_mcmc_tpu_torch.inference.loggers",
            "beast_mcmc_tpu_torch.inference.operators",
            "beast_mcmc_tpu_torch.inference.trace",
            "beast_mcmc_tpu_torch.models.coalescent",
            "beast_mcmc_tpu_torch.models.priors",
            "beast_mcmc_tpu_torch.models.speciation",
            "beast_mcmc_tpu_torch.ops.ancestral",
            "beast_mcmc_tpu_torch.tree.topology",
            "beast_mcmc_tpu_torch.utils.dtypes",
            "beast_mcmc_tpu_torch.apps.seqgen",
            "beast_mcmc_tpu_torch.inference.tree_operators",
            "beast_mcmc_tpu_torch.models.clock",
            "beast_mcmc_tpu_torch.ops.expm",
            "beast_mcmc_tpu_torch.ops.cuda_stream",
            "beast_mcmc_tpu_torch.ops.cuda_stream2",
            "beast_mcmc_tpu_torch.ops.cuda_mxu",
            "beast_mcmc_tpu_torch.data",
            "beast_mcmc_tpu_torch.data.alignment",
            "beast_mcmc_tpu_torch.data.codons",
            "beast_mcmc_tpu_torch.data.datatype",
            "beast_mcmc_tpu_torch.inference.component_cache",
            "beast_mcmc_tpu_torch.inference.geodesic",
            "beast_mcmc_tpu_torch.inference.mc3",
            "beast_mcmc_tpu_torch.inference.nuts",
            "beast_mcmc_tpu_torch.inference.pdmp",
            "beast_mcmc_tpu_torch.inference.samplers",
            "beast_mcmc_tpu_torch.models.data.aa_matrices",
            "beast_mcmc_tpu_torch.data.io",
            "beast_mcmc_tpu_torch.utils.citations",
            "beast_mcmc_tpu_torch.utils.as91",
            "beast_mcmc_tpu_torch.ops.special",
            "beast_mcmc_tpu_torch.models.sitemodel",
            *(f"beast_mcmc_tpu_torch.apps.{m}" for m in (
                "beastgen", "checkpoint_compat", "coalgen", "convergence",
                "dnds", "loganalyser", "logcombiner", "online", "plugins",
                "profiler", "treeannotator", "treestat"))} <= set(_modules())
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_jax_imports_in_sources():
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
