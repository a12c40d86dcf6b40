"""The Makona-1610 joint analysis from examples/makona_joint.xml.

The inputs of the JAX package's bench.py::measure_makona_joint, made
without JAX: a fixed reader for this one document (scripts/make_makona.py
writes it; the general XML layer is not ported) takes the <taxa> block
(id, date, location), the location states and the model's constants with
xml.etree; the starting tree is a coalescent simulation on the dated tips
(<coalescentTree>, tree/topology.py), and the alignment a simulation of
the document's GTR+Gamma4 relaxed-clock model down that tree
(<beagleSequenceSimulator>, apps/seqgen.py), compressed to patterns. Then
apps/benchmarks.py::build_joint_analysis builds the posterior and the
operators.

    python3 -c "from beast_mcmc_tpu_torch.apps.makona import \\
        build_makona_joint; build_makona_joint(device='cuda')"
"""

from __future__ import annotations

import copy
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from beast_mcmc_tpu_torch.apps.benchmarks import (
    MAKONA_JOINT,
    build_joint_analysis,
    clock_rates,
    gtr_site_model,
    joint_params,
)
from beast_mcmc_tpu_torch.apps.seqgen import (
    compress_patterns,
    one_hot_tips,
    simulate_states,
)
from beast_mcmc_tpu_torch.data import SitePatterns, general_datatype
from beast_mcmc_tpu_torch.models.treelikelihood import (
    branch_transition_matrices,
)
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    simulate_coalescent_tree,
)
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT

# the JAX package's XmlAnalysis seeds its generator with 666 by default and
# draws the <coalescentTree> from it first: the same seed here gives its
# very starting tree
XML_SEED = 666
MAKONA_XML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, os.pardir, "examples",
                          "makona_joint.xml")


def _values(el) -> list:
    """A <parameter>'s initial values, repeated to its dimension."""
    vals = [float(v) for v in (el.get("value") or "").split()]
    dim = int(el.get("dimension", len(vals) or 1))
    return (vals * dim)[:dim] if len(vals) < dim else vals


def read_makona_xml(path: str = MAKONA_XML) -> dict:
    """The taxa, locations and model constants of a Makona joint document:
    {"taxa": [ids], "dates": float64[N] (forward decimal years),
    "locations": [each taxon's location], "location_codes": [the K
    states], "n_sites", "pop_size" (the starting tree's constant
    population), "model" (MAKONA_JOINT's keys, from the document)}."""
    root = ET.parse(path).getroot()
    taxa, dates, locations = [], [], []
    for t in root.find("taxa").findall("taxon"):
        taxa.append(t.get("id"))
        d = t.find("date")
        v = float(d.get("value"))
        dates.append(v if d.get("direction", "backwards") == "forwards"
                     else -v)
        locations.append(next(a.text.strip() for a in t.findall("attr")
                              if a.get("name") == "location"))
    codes = [s.get("code")
             for s in root.find("generalDataType").findall("state")]
    params = {el.get("id"): _values(el) for el in root.iter("parameter")
              if el.get("id") and el.get("value") is not None}
    model = copy.deepcopy(MAKONA_JOINT)
    for name in model["init"]:
        if name in params:
            v = params[name]
            model["init"][name] = v if len(v) > 1 else v[0]
    sky = root.find("gmrfSkyGridLikelihood")
    model["init"]["skygrid.numGridPoints"] = _values(
        sky.find("numGridPoints/parameter"))[0]
    model["init"]["skygrid.cutOff"] = _values(sky.find("cutOff/parameter"))[0]
    model["gamma_categories"] = int(root.find(
        "siteModel/gammaShape").get("gammaCategories"))
    prior = root.find("mcmc/posterior/prior")
    for g in prior.iter("gammaPrior"):
        key = ("precision_prior"
               if g.find("parameter").get("idref") == "skygrid.precision"
               else "rates_prior")
        model[key] = (float(g.get("shape")), float(g.get("scale")))
    model["nonzero_mean"] = float(prior.find("poissonPrior").get("mean"))
    model["ucld_mean_prior"] = float(
        prior.find("exponentialPrior").get("mean"))
    part = root.find("beagleSequenceSimulator/partition")
    n_sites = ((int(part.get("to")) - int(part.get("from")) + 1)
               // int(part.get("every", 1)))
    pop = _values(root.find("constantSize/populationSize/parameter"))[0]
    return {"taxa": taxa, "dates": np.asarray(dates),
            "locations": locations, "location_codes": codes,
            "n_sites": n_sites, "pop_size": pop, "model": model}


def tip_heights(dates: np.ndarray) -> np.ndarray:
    """Ages before the youngest tip from forward dates, as the XML layer
    computes them."""
    h = -np.asarray(dates, np.float64)
    return h - h.min()


def location_rows(cfg: dict) -> np.ndarray:
    """[N, K] partial rows of each taxon's location (attributePatterns
    over the document's general data type)."""
    dt = general_datatype(cfg["location_codes"])
    pats = SitePatterns.from_attribute(cfg["taxa"], cfg["locations"], dt)
    return pats.tip_partials()[:, 0, :]


def starting_tree(cfg: dict, seed: int = XML_SEED):
    """Numpy (parent, children, heights, root) of the <coalescentTree> on
    the dated tips, a constant population of cfg["pop_size"]."""
    return simulate_coalescent_tree(np.random.default_rng(seed),
                                    tip_heights(cfg["dates"]),
                                    cfg["pop_size"])


def simulate_alignment(cfg: dict, tree, seed: int, device=DEFAULT_DEVICE):
    """(tips [N, 4, P] float64, weights [P]) numpy: the document's
    sequence model at its initial values simulated down `tree` (numpy
    parent, children, heights, root) on `device`, then compressed."""
    n_taxa = len(cfg["taxa"])
    tr = make_tree_state(*tree, dtype=torch.float64, device=device)
    p = joint_params(cfg["model"], n_taxa, len(cfg["location_codes"]),
                     torch.float64, device)
    eig, freqs, rates, cat_w = gtr_site_model(
        p, cfg["model"]["gamma_categories"])
    pm = branch_transition_matrices(eig, tr.parent, tr.heights,
                                    clock_rates(p), rates)
    gen = torch.Generator(device=device).manual_seed(seed)
    states = simulate_states(tr.parent, pm, cat_w, freqs, cfg["n_sites"],
                             gen)
    pats, weights = compress_patterns(states[:n_taxa])
    return (one_hot_tips(pats, 4).cpu().numpy(),
            weights.cpu().numpy())


def build_makona_joint(path: str = MAKONA_XML, seed: int = XML_SEED,
                       dtype: torch.dtype = DEFAULT_FLOAT,
                       device=DEFAULT_DEVICE):
    """build_joint_analysis's five-tuple for the document at `path`, its
    starting tree (the JAX package's, at the default seed) and alignment
    simulated from `seed`; aux also holds "config" (the document's
    reading) and "n_patterns" (before padding)."""
    cfg = read_makona_xml(path)
    tree = starting_tree(cfg, seed)
    tips, weights = simulate_alignment(cfg, tree, seed, device)
    out = build_joint_analysis(location_rows(cfg), tips, weights, tree,
                               cfg["model"], dtype, device)
    out[4].update({"config": cfg, "n_patterns": weights.shape[0]})
    return out
