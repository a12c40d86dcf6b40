"""The Makona-1610 joint analysis from examples/makona_joint.xml.

The inputs of the JAX package's bench.py::measure_makona_joint, made
without JAX: a fixed reader for this one document (scripts/make_makona.py
writes it; config/interpreter.py cannot read it yet, since its skygrid,
ancestral and discrete-trait tags are config/xml_ext.py's and
xml_geo.py's, queue items 4e and 4g) takes the <taxa> block
(id, date, location), the location states and the model's constants with
xml.etree; the starting tree is a coalescent simulation on the dated tips
(<coalescentTree>, tree/topology.py), and the alignment a simulation of
the document's GTR+Gamma4 relaxed-clock model down that tree
(<beagleSequenceSimulator>, apps/seqgen.py), compressed to patterns. Then
apps/benchmarks.py::build_joint_analysis builds the posterior and the
operators.

What the document logs (examples/makona_joint.xml:6694-6704, written as
the JAX package's config/interpreter.py:534-660 writes them): a <log> of
five columns (posterior, ucld.mean, siteModel.alpha, nonZeroRates,
treeModel.rootHeight) and a NEXUS <logTree> with every node annotated by a
joint draw of its location (<ancestralTreeLikelihood tagName="location">,
config/xml_ext.py:325-376): run_joint_logged runs the chain through
run_chain(collect_every=, collector=) and writes both. The annotation
draws come from a generator of their own, seeded from the chain's seed and
the tag, never from the chain's: a run that logs trees is the same chain
as one that does not.

    python3 -c "from beast_mcmc_tpu_torch.apps.makona import \\
        build_makona_joint; build_makona_joint(device='cuda')"
"""

from __future__ import annotations

import copy
import os
import time
import xml.etree.ElementTree as ET
import zlib

import numpy as np
import torch

from beast_mcmc_tpu_torch.apps.benchmarks import (
    MAKONA_JOINT,
    build_joint_analysis,
    clock_rates,
    geo_model,
    gtr_site_model,
    joint_params,
)
from beast_mcmc_tpu_torch.apps.seqgen import (
    compress_patterns,
    one_hot_tips,
    simulate_states,
)
from beast_mcmc_tpu_torch.data import SitePatterns, general_datatype
from beast_mcmc_tpu_torch.inference.loggers import write_run_files
from beast_mcmc_tpu_torch.inference.mcmc import run_chain
from beast_mcmc_tpu_torch.models.treelikelihood import (
    branch_lengths,
    branch_transition_matrices,
)
from beast_mcmc_tpu_torch.ops.ancestral import sample_ancestral_states
from beast_mcmc_tpu_torch.ops.expm import transition_probs_expm
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    root_height,
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


def simulate_sites(cfg: dict, tree, seed: int, device=DEFAULT_DEVICE,
                   n_sites=None) -> torch.Tensor:
    """int64[N, n_sites] tip states (0..3 for A, C, G, T) on `device`: the
    document's sequence model at its initial values simulated down `tree`
    (numpy parent, children, heights, root), n_sites the document's by
    default."""
    n_taxa = (len(tree[0]) + 1) // 2
    tr = make_tree_state(*tree, dtype=torch.float64, device=device)
    p = joint_params(cfg["model"], n_taxa, len(cfg["location_codes"]),
                     torch.float64, device)
    eig, freqs, rates, cat_w = gtr_site_model(
        p, cfg["model"]["gamma_categories"])
    pm = branch_transition_matrices(eig, tr.parent, tr.heights,
                                    clock_rates(p), rates)
    gen = torch.Generator(device=device).manual_seed(seed)
    states = simulate_states(tr.parent, pm, cat_w, freqs,
                             n_sites or cfg["n_sites"], gen)
    return states[:n_taxa]


def simulate_alignment(cfg: dict, tree, seed: int, device=DEFAULT_DEVICE):
    """(tips [N, 4, P] float64, weights [P]) numpy: simulate_sites's
    alignment, compressed."""
    pats, weights = compress_patterns(simulate_sites(cfg, tree, seed,
                                                     device))
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


# the document's <log> columns and the <ancestralTreeLikelihood> tag
JOINT_COLUMNS = ("posterior", "ucld.mean", "siteModel.alpha",
                 "nonZeroRates", "treeModel.rootHeight")
LOCATION_TAG = "location"


def joint_columns(state) -> dict:
    """The five <log> columns of a chain state, 0-d device tensors:
    nonZeroRates is the sum of the BSSVS indicators (<sumStatistic>)."""
    p = state.params
    return {"posterior": state.log_posterior,
            "ucld.mean": p["ucld.mean"].reshape(()),
            "siteModel.alpha": p["siteModel.alpha"].reshape(()),
            "nonZeroRates": torch.sum(p["geo.indicators"]),
            "treeModel.rootHeight": root_height(state.tree)}


def location_states(params, tree, geo_tips: torch.Tensor,
                    generator: torch.Generator):
    """(int64[M], site_logl [1]): a joint draw of every node's location
    given the tips' (the first and only pattern), and that pattern's log
    likelihood, as the JAX package's states_fn (config/xml_ext.py:338-359)
    draws them for geoLikelihood: expm matrices of the CTMC (geo_model) on
    the branch lengths, one category. The document's geoLikelihood names no
    <branchRates>, so its clock there is the strict clock at rate 1, as in
    its likelihood (build_joint_analysis's geo_likelihood): site_logl
    equals that component. It peels the 56-state trait by the plain level
    peel: no kernel launch."""
    q, freqs = geo_model(params)
    pm = transition_probs_expm(q, branch_lengths(tree.parent,
                                                 tree.heights)[:, None])
    one = torch.ones(1, dtype=pm.dtype, device=pm.device)
    states, _, site_logl = sample_ancestral_states(
        geo_tips, tree.children, tree.root, pm, freqs, one, generator)
    return states[:, 0], site_logl


def location_annotations(states, labels, tag: str = LOCATION_TAG) -> dict:
    """{node: 'location="<label>"'} of one draw, the state codes named by
    the data type's labels, as config/interpreter.py:635-648 writes them."""
    return {node: f'{tag}="{labels[c] if 0 <= c < len(labels) else c}"'
            for node, c in enumerate(np.asarray(states).tolist())}


def annotation_seed(seed: int, tag: str = LOCATION_TAG) -> int:
    """The annotation generator's seed: the chain's seed folded with the
    tag's CRC, as the JAX package folds the chain's key
    (interpreter.py:591-592)."""
    return (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % 2**63


def run_joint_logged(step, state, n_steps: int, geo_tips: torch.Tensor,
                     taxa, labels, log_file: str, tree_file: str,
                     log_every: int, tree_every: int, seed: int):
    """Run the joint chain n_steps (a multiple of tree_every, itself a
    multiple of log_every) through run_chain(collect_every=log_every,
    collector=joint_columns), a block of tree_every steps at a time, with
    one annotated tree drawn after each block; then write the Tracer log
    and the NEXUS tree file. The collected tensors stay on the device and
    are copied to the host once, after the run. Returns (state, info):
    info["sample_ms"], the host-clock ms of each annotated draw (device
    synchronised), and the numbers of rows and trees."""
    if tree_every % log_every or n_steps % tree_every:
        raise ValueError("n_steps must be a multiple of tree_every, and "
                         "tree_every of log_every")
    dev = state.tree.heights.device
    gen = torch.Generator(device=dev).manual_seed(annotation_seed(seed))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cols, trees, sample_ms = [], [], []
    for _ in range(n_steps // tree_every):
        first = state.step
        state, out = run_chain(step, state, tree_every, log_every,
                               joint_columns)
        cols.append(out)
        sync()
        t0 = time.perf_counter()
        loc, _ = location_states(state.params, state.tree, geo_tips, gen)
        sync()
        sample_ms.append(1e3 * (time.perf_counter() - t0))
        t = state.tree
        trees.append((first, t.parent, t.children, t.heights, t.root, loc))

    table = {k: torch.cat([c[k] for c in cols]).cpu().numpy()
             for k in JOINT_COLUMNS}
    fields = [torch.stack([tr[i] for tr in trees]).cpu().numpy()
              for i in range(1, 6)]
    starts = np.asarray([tr[0] for tr in trees])
    rows = (starts[:, None] + np.arange(log_every, tree_every + 1,
                                        log_every)[None]).reshape(-1)
    write_run_files(taxa, rows, table, starts + tree_every, fields[:4],
                    log_file, tree_file,
                    annotations=[location_annotations(loc, labels)
                                 for loc in fields[4]])
    return state, {"sample_ms": sample_ms, "rows": len(rows),
                   "trees": len(trees)}
