"""XML vocabulary extensions: the skygrid, ancestral and Markov-jump tree
likelihoods, starting trees, priors, parameter views and the rest of the
high-frequency tags.

Counterpart of beast_mcmc_tpu/config/xml_ext.py, every registration of it
(45 element tags, three operator tags), each with the reference parser its
builder follows. Densities are closures over (params, tree) on the
analysis's device; the distance-matrix trees, the reward (Sericola)
branch matrices and the LKJ normaliser are computed on the host at parse
time, as in the JAX package. Where a handler reaches a module of a later
ROADMAP queue item, that branch raises Unsupported naming it: the
gradient reports (config/xml_hmc.py's GradientSpec and
config/xml_assert.py's report strings, items 5b and 5d), and the trait
likelihoods that <traitValidation> and <gaussianProcessFromTree> wrap
(config/xml_traits.py, 4g). The JAX package's loops (lax.scan,
fori_loop) are Python loops over tensors here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    ClockModel,
    CompoundParam,
    DerivedParam,
    LikelihoodFn,
    Param,
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    _child_of,
    _targets_of,
    _text_values,
    _tree_likelihood,
    _tree_model,
    register,
    register_operator,
    unported,
)


def _zero(ax):
    return torch.zeros((), dtype=ax.dtype, device=ax.device)


def _neg_inf_unless(ok, lp):
    return torch.where(ok, lp, torch.full_like(lp, -math.inf))


def _branch_len(tree):
    """Branch lengths above each node, 0 at the root."""
    pidx = tree.parent.clamp_min(0)
    return torch.where(tree.parent >= 0, tree.heights[pidx] - tree.heights,
                       torch.zeros_like(tree.heights))


# ---------------------------------------------------------------------------
# compoundLikelihood
# ---------------------------------------------------------------------------


@register("compoundLikelihood")
def _compound_likelihood(ax: XmlAnalysis, el):
    """The sum of the child likelihoods (CompoundLikelihoodParser.java; its
    threads attribute is an execution hint only)."""
    liks: List[LikelihoodFn] = []
    for c in el:
        obj = ax.build(c)
        if isinstance(obj, LikelihoodFn):
            liks.append(obj)
    if not liks:
        raise XmlError("<compoundLikelihood> with no likelihood children")
    tree_id = next((lk.tree_id for lk in liks if lk.tree_id), None)
    data = tuple(n for lk in liks for n in (lk.data_params or ()))

    def fn(params, tree):
        tot = 0.0
        for lk in liks:
            tot = tot + lk.fn(params, tree)
        return tot

    return LikelihoodFn(fn, tree_id, el.get("id") or "compound", data)


# ---------------------------------------------------------------------------
# LKJ correlation and spherical beta priors
# ---------------------------------------------------------------------------


def _lkj_log_norm(d: int, shape: float) -> float:
    """The Lewandowski-Kurowicka-Joe normalisation
    (AbstractLKJDistribution.computeLogNormalizationConstant)."""
    from scipy.special import gammaln

    if shape == 1.0:
        res = 0.0
        for k in range(1, (d - 1) // 2 + 1):
            res -= gammaln(2.0 * k)
        if d % 2 == 1:
            res -= (0.25 * (d * d - 1) * np.log(np.pi)
                    - 0.25 * (d - 1) ** 2 * np.log(2.0)
                    - (d - 1) * gammaln(0.5 * (d + 1)))
        else:
            res -= (0.25 * d * (d - 2) * np.log(np.pi)
                    + 0.25 * (3 * d * d - 4 * d) * np.log(2.0)
                    + d * gammaln(0.5 * d)
                    - (d - 1) * gammaln(d))
        return float(res)
    res = (d - 1) * gammaln(shape + 0.5 * (d - 1))
    for k in range(1, d):
        res -= 0.5 * k * np.log(np.pi) + gammaln(shape + 0.5 * (d - 1 - k))
    return float(res)


def _upper(x, d: int):
    """[d, d] zeros with the row-major strict upper triangle set to x."""
    iu = torch.triu_indices(d, d, 1, device=x.device)
    return torch.zeros((d, d), dtype=x.dtype, device=x.device).index_put(
        (iu[0], iu[1]), x)


def _corr_from_upper(x, d: int):
    """The symmetric correlation matrix of the row-major upper triangle."""
    r = _upper(x, d)
    return r + r.T + torch.eye(d, dtype=x.dtype, device=x.device)


def _chol_from_upper(x, d: int):
    """The upper-triangular L with unit-norm columns from the free
    off-diagonal entries (WrappedUpperTriangularMatrix.fillDiagonal:
    L[j, j] = sqrt(1 - sum_{i<j} L[i, j]^2), R = L^T L)."""
    lm = _upper(x, d)
    diag = torch.sqrt(torch.clamp(1.0 - torch.sum(lm * lm, dim=0), min=0.0))
    return lm + torch.diag(diag)


@register("LKJCorrelationPrior")
def _lkj_prior(ax: XmlAnalysis, el):
    """MultivariateDistributionLikelihood.java:74 (LKJ_PRIOR) ->
    LKJCorrelationDistribution / LKJCholeskyCorrelationDistribution. With
    cholesky="true" (the default) the data vector holds the free upper
    off-diagonal entries of the unit-column Cholesky factor."""
    shape = _attr(el, "shapeParameter", 1.0, float)
    d = _attr(el, "dimension", None, int)
    data_el = el.find("data")
    if data_el is None:
        raise XmlError("LKJCorrelationPrior without <data>")
    pname = ax.param_from(data_el)
    n_free = int(np.size(ax.value_of(pname)))
    if d is None:
        d = int(round(0.5 * (1 + np.sqrt(1 + 8 * n_free))))
    if n_free != d * (d - 1) // 2:
        raise XmlError(
            f"LKJ data has {n_free} entries, need {d * (d - 1) // 2}")
    log_norm = _lkj_log_norm(d, shape)

    if _attr(el, "cholesky", True, bool):
        def fn(params, tree):
            lm = _chol_from_upper(params[pname].reshape(-1), d)
            diag = torch.diagonal(lm)
            # the density on the Cholesky factor (Stan manual p. 558):
            # sum_{i=1}^{d-1} (d - i - 1 + 2 shape - 2) log L[i, i]
            i = torch.arange(1, d, dtype=diag.dtype, device=diag.device)
            lp = (torch.sum((d - i - 1 + 2.0 * shape - 2.0)
                            * torch.log(diag[1:])) + log_norm)
            return _neg_inf_unless(torch.all(diag > 0), lp)
    else:
        def fn(params, tree):
            x = params[pname].reshape(-1)
            sign, logdet = torch.linalg.slogdet(_corr_from_upper(x, d))
            ok = (sign > 0) & torch.all(torch.abs(x) < 1.0)
            return _neg_inf_unless(ok, (shape - 1.0) * logdet + log_norm)

    return LikelihoodFn(fn, None, el.get("id") or "lkjPrior", (pname,))


@register("sphericalBetaPrior")
def _spherical_beta_prior(ax: XmlAnalysis, el):
    """MultivariateDistributionLikelihood SPHERICAL_BETA_PRIOR ->
    SphericalBetaDistribution: rows x_i on the unit ball, density
    prod (1 - |x_i|^2)^(shape - 1); a matrix's columns are its vectors."""
    shape = _attr(el, "shapeParameter", 1.0, float)
    dim = _attr(el, "dimension", None, int)
    data_el = el.find("data")
    if data_el is None:
        raise XmlError("sphericalBetaPrior without <data>")

    def density(ss):
        lp = torch.sum((shape - 1.0) * torch.log1p(-torch.clamp(ss,
                                                                max=1.0)))
        return _neg_inf_unless(torch.all(ss < 1.0), lp)

    inner = ax.deref(next(iter(data_el)))
    if inner.tag in ("matrixParameter", "compoundSymmetricMatrix"):
        from beast_mcmc_tpu_torch.config.xml_hmc import matrix_param_of

        mp = matrix_param_of(ax, inner)

        def fn(params, tree):
            m = mp.fn(params)
            return density(torch.sum(m * m, dim=0))

        return LikelihoodFn(fn, None, el.get("id") or "sphericalBeta")
    pname = ax.param_from(data_el)
    d = dim or int(np.size(ax.value_of(pname)))

    def fn(params, tree):
        x = params[pname].reshape(-1, d)
        return density(torch.sum(x * x, dim=-1))

    return LikelihoodFn(fn, None, el.get("id") or "sphericalBeta", (pname,))


# ---------------------------------------------------------------------------
# skygrid
# ---------------------------------------------------------------------------


@register("gmrfSkyGridLikelihood", "skyGridLikelihood",
          "skyGridPopSizeLikelihood")
def _skygrid_likelihood(ax: XmlAnalysis, el):
    """GMRFSkyrideLikelihoodParser's SKYGRID_LIKELIHOOD branch: a
    piecewise-constant log N(t) on a fixed grid plus the RW1 GMRF prior
    (models/coalescent.py::skygrid_loglik, gmrf_log_prior)."""
    from beast_mcmc_tpu_torch.models.coalescent import (
        gmrf_log_prior,
        skygrid_loglik,
    )

    pops = ax.param_from(_child_of(el, "populationSizes"))
    prec = ax.param_from(_child_of(el, "precisionParameter"))
    k = int(np.size(ax.value_of(pops)))
    ngp, cut = el.find("numGridPoints"), el.find("cutOff")
    if ngp is not None and cut is not None:
        n_grid = int(float(np.ravel(ax.value_of(ax.param_from(ngp)))[0]))
        cutoff = float(np.ravel(ax.value_of(ax.param_from(cut)))[0])
        cuts = np.linspace(cutoff / n_grid, cutoff, n_grid)
    else:
        gp = el.find("gridPoints")
        if gp is None:
            raise XmlError("skygrid needs numGridPoints+cutOff or gridPoints")
        cuts = np.ravel(ax.value_of(ax.param_from(gp)))
    if len(cuts) != k - 1:
        raise XmlError(f"skygrid: {k} cells but {len(cuts)} cut points")
    trees = []
    pt = el.find("populationTree")
    for t in (pt if pt is not None else ()):
        trees.append(ax.build(ax.deref(t)))
    if not trees:
        raise XmlError("skygrid without populationTree")
    cuts_t = ax.tensor(cuts)

    def fn(params, tree):
        gamma = params[pops].reshape(-1)
        ll = torch.zeros((), dtype=tree.heights.dtype,
                         device=tree.heights.device)
        for tm in trees:
            tr = ax.resolve_tree(tm.tree_id, params, tree)
            ll = ll + skygrid_loglik(tr.heights, len(tm.taxa), gamma,
                                     cuts_t.to(tr.heights.dtype))
        return ll + gmrf_log_prior(gamma, params[prec].reshape(-1)[0])

    return LikelihoodFn(fn, trees[0].tree_id, el.get("id") or "skygrid")


@dataclasses.dataclass
class SkygridGradient:
    """<gmrfSkyrideGradient>: the reportable gradient of the skygrid
    density with respect to its log populations or precision
    (GMRFGradientParser)."""

    lik: LikelihoodFn = None
    wrt: str = ""

    def report(self, ax) -> str:
        raise unported("the report of <gmrfSkyrideGradient> (GradientSpec)",
                       "config/xml_hmc.py")


@dataclasses.dataclass
class CoalescentIntervalGradient:
    """d logL / d interval_i over the sorted coalescent intervals
    (GMRFGradient WrtParameter.COALESCENT_INTERVAL)."""

    lik: LikelihoodFn = None
    tree_id: str = ""

    def report(self, ax) -> str:
        raise unported("the report of a coalescent-interval gradient "
                       "(gradient_report)", "config/xml_assert.py")


@register("gmrfSkyrideGradient")
def _skygrid_gradient(ax: XmlAnalysis, el):
    wrt_attr = el.get("wrtParameter", "logPopulationSizes")
    lik = inner_el = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("gmrfSkyGridLikelihood", "gmrfSkyrideLikelihood",
                      "skyGridLikelihood"):
            inner_el = cc
            lik = ax.build(cc)
    if lik is None:
        raise XmlError("gmrfSkyrideGradient without skygrid likelihood")
    if wrt_attr == "nodeHeight":
        raise unported("<gmrfSkyrideGradient wrtParameter=\"nodeHeight\"> "
                       "(GradientSpec)", "config/xml_hmc.py")
    if wrt_attr == "coalescentInterval":
        return CoalescentIntervalGradient(lik, lik.tree_id)
    if wrt_attr.lower().startswith("prec"):
        wrt = ax.param_from(_child_of(inner_el, "precisionParameter"))
    else:
        wrt = ax.param_from(_child_of(inner_el, "populationSizes"))
    return SkygridGradient(lik, wrt)


# ---------------------------------------------------------------------------
# ancestral-state and Markov-jump tree likelihoods
# ---------------------------------------------------------------------------


@register("ancestralTreeLikelihood", "markovJumpsTreeLikelihood")
def _ancestral_tree_likelihood(ax: XmlAnalysis, el):
    """AncestralStateTreeLikelihoodParser / MarkovJumpsTreeLikelihood
    Parser. The density is the peeled tree likelihood; the joint draw of
    the node states is a posterior annotation that <logTree> writes for
    each sampled tree (XmlAnalysis._run_mcmc), from `states_fn`."""
    lik = _tree_likelihood(ax, el)
    lid = el.get("id") or lik.name
    parts = ax._treelik_parts[lid]

    def states_fn(params, tree, generator):
        """int64[M]: a joint draw of every node's state for the first
        pattern (a discrete trait has exactly one), on the tree's device
        (AncestralStateBeagleTreeLikelihood.traverseSample:274)."""
        from beast_mcmc_tpu_torch.models.treelikelihood import branch_lengths
        from beast_mcmc_tpu_torch.ops.ancestral import (
            sample_ancestral_states,
        )
        from beast_mcmc_tpu_torch.ops.eigen import transition_probs
        from beast_mcmc_tpu_torch.ops.expm import transition_probs_expm

        r, w = parts["rates_weights"](params, parts["dtype"])
        br = parts["clock"].rates(params, tree)
        t = (branch_lengths(tree.parent, tree.heights) * br)[:, None] \
            * r[None, :]
        if parts["site_kind"] == "site_q":
            p_mats = transition_probs_expm(parts["eigen"](params), t)
        else:
            p_mats = transition_probs(parts["eigen"](params), t)
        states, _, _ = sample_ancestral_states(
            parts["tips"], tree.children, tree.root, p_mats,
            parts["freqs_of"](params), w, generator)
        return states[:, 0]

    # the data type's state labels for the annotation strings
    dt_obj = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("patterns", "attributePatterns", "mergePatterns"):
            dt_obj = ax.build(cc).datatype
    ax._ancestral_liks = getattr(ax, "_ancestral_liks", {})
    ax._ancestral_liks[lid] = {
        "lik": lik,
        "tag": el.get("tagName") or el.get("stateTagName") or "states",
        "jumps": el.tag == "markovJumpsTreeLikelihood",
        "states_fn": states_fn,
        "tree_id": parts["tm"].tree_id,
        "labels": (list(dt_obj.code_chars[:dt_obj.state_count])
                   if dt_obj is not None else None),
    }
    return lik


# ---------------------------------------------------------------------------
# distance-matrix starting trees
# ---------------------------------------------------------------------------


def _jc_distance_matrix(ax, el):
    """Pairwise distances from the <distanceMatrix> child
    (dr.evolution.distance.DistanceMatrix / JukesCantorDistanceMatrix)."""
    dm = el.find("distanceMatrix")
    if dm is None:
        raise XmlError(f"<{el.tag}> without <distanceMatrix>")
    correction = dm.get("correction", "none")
    aln = None
    for c in dm:
        cc = ax.deref(c)
        if cc.tag in ("patterns", "alignment"):
            aln = ax.build(cc)
    if aln is None:
        raise XmlError("<distanceMatrix> without alignment/patterns")
    states = np.asarray(aln.states)
    weights = getattr(aln, "weights", np.ones(states.shape[1]))
    k = aln.datatype.state_count
    n = states.shape[0]
    valid = states < k  # unambiguous canonical states only
    d = np.zeros((n, n))
    for i in range(n):
        both = valid[i] & valid
        diff = (states[i] != states) & both
        tot = (both * weights).sum(axis=1)
        p = np.where(tot > 0, (diff * weights).sum(axis=1)
                     / np.maximum(tot, 1), 0.0)
        if correction.upper() == "JC":
            b = (k - 1.0) / k
            p = np.where(p < b, -b * np.log(1.0 - p / b), 10.0)
        d[i] = p
    np.fill_diagonal(d, 0.0)
    return aln, d


def _tree_from_clustering(names, tip_heights, parent, children, heights):
    """The tips at their dated heights and every parent strictly above its
    children (the reference's TreeModel constructor re-validates heights
    against taxon dates)."""
    n = len(names)
    heights = heights.copy()
    heights[:n] = tip_heights
    root = int(np.where(parent < 0)[0][0])
    # bottom-up, children before parents
    stack, post = [root], []
    while stack:
        i = stack.pop()
        post.append(i)
        if children[i, 0] >= 0:
            stack.extend(children[i])
    for i in reversed(post):
        if children[i, 0] >= 0:
            hmax = max(heights[children[i, 0]], heights[children[i, 1]])
            if heights[i] <= hmax:
                heights[i] = hmax + 1e-4
    return (names, np.asarray(tip_heights), parent, children, heights, root)


def _tip_heights_of(aln, n):
    return aln.tip_heights() if hasattr(aln, "tip_heights") else np.zeros(n)


@register("upgmaTree")
def _upgma_tree(ax: XmlAnalysis, el):
    """UPGMATreeParser: a rough starting tree by UPGMA over the
    (JC-corrected) distance matrix, the tip dates imposed afterwards."""
    aln, d = _jc_distance_matrix(ax, el)
    names = list(aln.taxa)
    n = len(names)
    m = 2 * n - 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m)
    active = {i: 1 for i in range(n)}  # node -> cluster size
    dist = {(i, j): d[i, j] for i in range(n) for j in range(i + 1, n)}
    nxt = n
    while len(active) > 1:
        (a, b), dm_ab = min(dist.items(), key=lambda kv: kv[1])
        children[nxt] = (a, b)
        parent[a] = parent[b] = nxt
        heights[nxt] = dm_ab / 2.0
        sa, sb = active.pop(a), active.pop(b)
        new = {}
        for (i, j), v in dist.items():
            if a in (i, j) or b in (i, j):
                other = i if j in (a, b) else j
                if other in (a, b):
                    continue
                va = dist.get((min(other, a), max(other, a)), 0.0)
                vb = dist.get((min(other, b), max(other, b)), 0.0)
                new[(min(other, nxt), max(other, nxt))] = (
                    (sa * va + sb * vb) / (sa + sb))
            else:
                new[(i, j)] = v
        dist = new
        active[nxt] = sa + sb
        nxt += 1
    return _tree_from_clustering(names, _tip_heights_of(aln, n), parent,
                                 children, heights)


@register("neighborJoiningTree")
def _nj_tree(ax: XmlAnalysis, el):
    """NeighborJoiningTreeParser: the NJ topology, node heights from
    midpoint-style clustering (a starting tree; heights re-validated)."""
    aln, d0 = _jc_distance_matrix(ax, el)
    names = list(aln.taxa)
    n = len(names)
    m = 2 * n - 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m)
    nodes = list(range(n))
    d = {(i, j): d0[i, j] for i in range(n) for j in range(i + 1, n)}

    def dd(i, j):
        return d[(min(i, j), max(i, j))]

    nxt = n
    while len(nodes) > 2:
        r = len(nodes)
        sums = {i: sum(dd(i, j) for j in nodes if j != i) for i in nodes}
        best = pair = None
        for ii in range(r):
            for jj in range(ii + 1, r):
                i, j = nodes[ii], nodes[jj]
                qv = (r - 2) * dd(i, j) - sums[i] - sums[j]
                if best is None or qv < best:
                    best, pair = qv, (i, j)
        a, b = pair
        children[nxt] = (a, b)
        parent[a] = parent[b] = nxt
        heights[nxt] = max(heights[a], heights[b]) + dd(a, b) / 2.0
        for k2 in nodes:
            if k2 not in (a, b):
                d[(min(k2, nxt), max(k2, nxt))] = 0.5 * (
                    dd(a, k2) + dd(b, k2) - dd(a, b))
        nodes = [x for x in nodes if x not in (a, b)] + [nxt]
        nxt += 1
    a, b = nodes
    children[nxt] = (a, b)
    parent[a] = parent[b] = nxt
    heights[nxt] = max(heights[a], heights[b]) + dd(a, b) / 2.0
    return _tree_from_clustering(names, _tip_heights_of(aln, n), parent,
                                 children, heights)


# ---------------------------------------------------------------------------
# star tree
# ---------------------------------------------------------------------------


def _star_view(n_taxa):
    """Every internal height read as the root's (StarTreeModel.
    getNodeHeight): a reparameterisation that every likelihood sees."""
    def view(ts, params):
        idx = torch.arange(ts.heights.shape[-1], device=ts.heights.device)
        return ts.replace(heights=torch.where(idx < n_taxa, ts.heights,
                                              ts.heights[ts.root]))

    return view


@register("starTreeModel")
def _star_tree_model(ax: XmlAnalysis, el):
    """StarTreeModelParser: a tree model whose internal node heights read
    as the root height at run time, registered as a tree view applied in
    XmlAnalysis.resolve_tree."""
    tm = _tree_model(ax, el)
    n = len(tm.taxa)
    tm.heights[n:] = tm.heights[tm.root]  # a consistent initial state
    tid = el.get("id")
    if tid:
        ax._tree_views[tid] = _star_view(n)
        ax._star_trees.add(tid)
    return tm


@register("starTreeLikelihood")
def _star_tree_likelihood(ax: XmlAnalysis, el):
    """The peeled likelihood with the star height tie on its tree model
    (registered for the referenced tree even when it is a plain
    <treeModel>, the evident intent of the corpus files that use it)."""
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("treeModel", "starTreeModel"):
            tid = cc.get("id")
            if tid and tid not in ax._tree_views:
                tm = ax.build(cc)
                ax._tree_views[tid] = _star_view(len(tm.taxa))
                ax._star_trees.add(tid)
    return _tree_likelihood(ax, el)


# ---------------------------------------------------------------------------
# <tree>: an explicit nested-node tree
# ---------------------------------------------------------------------------


@register("tree")
def _simple_tree(ax: XmlAnalysis, el):
    """SimpleTreeParser: nested <node height=...> elements with <taxon>
    leaves, as the treeModel source tuple (the contract of <newick> and
    <coalescentTree>)."""
    top = el.find("node")
    if top is None:
        raise XmlError("<tree> without <node>")
    names: List[str] = []
    tip_heights: List[float] = []
    entries = []  # (height, [child slots]) in post-order

    def walk(node):
        h = _attr(node, "height", 0.0, float)
        kids = [c for c in node if c.tag == "node"]
        if not kids:
            tx = node.find("taxon")
            if tx is None:
                raise XmlError("leaf <node> without <taxon>")
            names.append(tx.get("idref") or tx.get("id"))
            tip_heights.append(h)
            return ("tip", len(names) - 1)
        slots = [walk(k) for k in kids]
        if len(slots) != 2:
            raise Unsupported("non-binary <tree> node")
        entries.append((h, slots))
        return ("int", len(entries) - 1)

    root_slot = walk(top)
    n = len(names)
    m = 2 * n - 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m)
    heights[:n] = tip_heights

    def gidx(slot):
        return slot[1] if slot[0] == "tip" else n + slot[1]

    for i, (h, slots) in enumerate(entries):
        heights[n + i] = h
        for k, s in enumerate(slots):
            children[n + i, k] = gidx(s)
            parent[gidx(s)] = n + i
    return (names, np.array(tip_heights), parent, children, heights,
            gidx(root_slot))


# ---------------------------------------------------------------------------
# autocorrelated relaxed clock, ALS (stochastic Dollo), scaled tree length
# ---------------------------------------------------------------------------


@register("ACLikelihood")
def _ac_likelihood(ax: XmlAnalysis, el):
    """oldevomodel/clock/ACLikelihood.java:65-93: per-node rates evolve
    along branches, child ~ logNormal(log parent - var t / 2, var t) (or
    normal); the element is both the branch-rate model and the
    rate-evolution density (`density`, which the compound likelihood
    adds)."""
    dist = el.get("distribution", "logNormal")
    episodic = _attr(el, "episodic", False, bool)
    tm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tm = ax.build(cc)
    rates_n = ax.param_from(_child_of(el, "rates"))
    root_el = el.find("rootRate")
    root_n = ax.param_from(root_el) if root_el is not None else None
    var_n = ax.param_from(_child_of(el, "variance"))
    m = tm.parent.shape[0]
    root = int(tm.root)
    # one rate a non-root node
    p = ax._params[rates_n]
    if np.size(p.value) != m - 1:
        ax._params[rates_n] = dataclasses.replace(p, value=np.full(m - 1,
                                                                   1.0))
    if root_n is not None:
        pr = ax._params[root_n]
        if np.size(pr.value) != 1:
            ax._params[root_n] = dataclasses.replace(pr,
                                                     value=np.asarray(1.0))
    ar = np.arange(m)
    idx = ax.tensor(np.where(ar > root, ar - 1, ar).clip(0, m - 2),
                    torch.long)
    is_root = ax.tensor(ar == root, torch.bool)

    def node_rates(params):
        r = params[rates_n].reshape(-1)[idx]
        rr = (params[root_n].reshape(-1)[0] if root_n
              else torch.ones((), dtype=r.dtype, device=r.device))
        return torch.where(is_root, rr, r)

    def rates(params, tree):
        return node_rates(params)

    def density(params, tree):
        r = node_rates(params)
        dt = tree.heights.dtype
        var0 = params[var_n].reshape(-1)[0].to(dt)
        pidx = tree.parent.clamp_min(0)
        t = _branch_len(tree)
        var = torch.clamp(var0 if episodic else var0 * t, min=1e-300)
        parent_r = r[pidx]
        if dist == "logNormal":
            mu = torch.log(parent_r) - var / 2.0
            lp = (-torch.log(r) - 0.5 * torch.log(2 * math.pi * var)
                  - (torch.log(r) - mu) ** 2 / (2.0 * var))
        else:
            lp = (-0.5 * torch.log(2 * math.pi * var)
                  - (r - parent_r) ** 2 / (2.0 * var))
        return torch.sum(torch.where(tree.parent >= 0, lp,
                                     torch.zeros_like(lp)))

    clock = ClockModel("autocorrelated", tm.tree_id, rates,
                       rate_param=rates_n)
    clock.density = density
    return clock


@register("mutationDeathModel")
def _mutation_death_model(ax: XmlAnalysis, el):
    """MutationDeathModelParser: the death rate and an optional underlying
    alive-state CTMC: ("dollo", death param, mu param or None)."""
    death = ax.param_from(el)
    mu_el = el.find("mutationRate")
    return ("dollo", death, ax.param_from(mu_el) if mu_el is not None
            else None)


@register("alsSiteModel")
def _als_site_model(ax: XmlAnalysis, el):
    """ALSSiteModelParser: the Dollo model and an overall rate."""
    sub = None
    for c in _child_of(el, "substitutionModel"):
        sub = ax.build(ax.deref(c))
    mu_el = el.find("mutationRate")
    mu = ax.param_from(mu_el) if mu_el is not None else None
    if not (isinstance(sub, tuple) and sub[0] == "dollo"):
        raise XmlError("alsSiteModel needs mutationDeathModel")
    return ("dollo_site", sub[1], sub[2], mu)


@register("scaledTreeLengthModel")
def _scaled_tree_length_model(ax: XmlAnalysis, el):
    """ScaledTreeLengthRateModelParser: branch rates such that the total
    scaled tree length equals the scalingFactor parameter."""
    tm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tm = ax.build(cc)
    fac = ax.param_from(_child_of(el, "scalingFactor"))

    def rates(params, tree):
        return params[fac].reshape(-1)[0] / torch.sum(_branch_len(tree))

    return ClockModel("scaled_length", tm.tree_id if tm else None, rates,
                      rate_param=fac)


@register("alsTreeLikelihood")
def _als_tree_likelihood(ax: XmlAnalysis, el):
    """ALSTreeLikelihoodParser (acquisition-loss-switch stochastic Dollo).
    The presence/absence marginal of an MSSD process is a binary
    stochastic Dollo process, so the likelihood is models/dollo.py::
    stochastic_dollo_loglik over the presence projection of the
    patterns."""
    from beast_mcmc_tpu_torch.models.dollo import stochastic_dollo_loglik

    patterns = tm = site = clock = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("patterns", "mergePatterns", "ascertainedPatterns"):
            patterns = ax.build(cc)
        elif cc.tag in ("treeModel", "starTreeModel"):
            tm = ax.build(cc)
        elif cc.tag == "alsSiteModel":
            site = ax.build(cc)
        elif cc.tag == "siteModel":
            # a plain siteModel around a mutationDeathModel: its Dollo
            # pieces read directly
            inner = ax.deref(next(iter(cc.find("substitutionModel"))))
            if inner.tag != "mutationDeathModel":
                raise Unsupported("alsTreeLikelihood site model form")
            dollo = ax.build(inner)
            mu_el = cc.find("mutationRate")
            site = ("dollo_site", dollo[1], dollo[2],
                    ax.param_from(mu_el) if mu_el is not None else None)
        elif cc.tag == "scaledTreeLengthModel":
            clock = ax.build(cc)
    if patterns is None or tm is None or site is None:
        raise XmlError("alsTreeLikelihood needs patterns+tree+siteModel")
    if not (isinstance(site, tuple) and site[0] == "dollo_site"):
        raise Unsupported("alsTreeLikelihood site model form")
    _, death, mu_inner, mu_outer = site
    mu = mu_outer or mu_inner
    # the presence projection: code 0 absent, any other present
    idx = [patterns.taxa.index(t) for t in tm.taxa]
    presence = ax.tensor((np.asarray(patterns.states)[idx] != 0)
                         .astype(np.int8), torch.int8)
    w_t = ax.tensor(patterns.weights)

    def fn(params, tree):
        dt = tree.heights.dtype
        br = (clock.rates(params, tree) if clock is not None
              else torch.ones((), dtype=dt, device=tree.heights.device))
        mu_v = params[mu].reshape(-1)[0] if mu else 1.0
        return stochastic_dollo_loglik(
            presence, tree.parent, tree.children, tree.heights,
            params[death].reshape(-1)[0] * mu_v, branch_rates=br * mu_v,
            pattern_weights=w_t.to(dt), condition_on_observed=True)

    return LikelihoodFn(fn, tm.tree_id, el.get("id") or "alsLikelihood")


@register("exponentialBranchLengthsPrior")
def _exp_branch_lengths_prior(ax: XmlAnalysis, el):
    """ExponentialBranchLengthsPrior: iid Exp(1) branch lengths."""
    tm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tm = ax.build(cc)
    return LikelihoodFn(lambda params, tree: -torch.sum(_branch_len(tree)),
                        tm.tree_id if tm else None,
                        el.get("id") or "branchLengthsPrior")


# ---------------------------------------------------------------------------
# the episodic serially sampled birth-death on a grid
# ---------------------------------------------------------------------------


@register("newBirthDeathSerialSampling")
def _new_bdss(ax: XmlAnalysis, el):
    """NewBirthDeathSerialSamplingModelParser: the episodic BDSS with one
    rate a grid interval of [0, cutOff] (numGridPoints intervals); without
    a grid, one interval over [0, origin]. The speciation likelihood maps
    it onto models/speciation.py::episodic_serial_birth_death_loglik."""
    names = {"birth": ax.param_from(_child_of(el, "birthRate")),
             "death": ax.param_from(_child_of(el, "deathRate")),
             "psi": ax.param_from(_child_of(el, "samplingRate")),
             "origin": ax.param_from(_child_of(el, "origin"))}
    tp = el.find("treatmentProbability")
    if tp is not None:
        names["r"] = ax.param_from(tp)
    sp = el.find("samplingProbability")
    if sp is not None:
        # the first entry is the sampling probability at present (rho)
        inner = ax.deref(next(iter(sp)))
        if inner.tag == "compoundParameter":
            names["rho"] = ax.param_from(ax.deref(next(iter(inner))))
        else:
            names["rho"] = ax.param_from(sp)
    cut, ngp = el.find("cutOff"), el.find("numGridPoints")
    if cut is None or ngp is None:
        names["cutoff"] = None
        names["k"] = 1
    else:
        names["cutoff"] = float(np.ravel(ax.value_of(ax.param_from(cut)))[0])
        names["k"] = int(float(np.ravel(ax.value_of(ax.param_from(ngp)))[0]))
    return ("spec", "bdss_grid", names)


# ---------------------------------------------------------------------------
# grid-based branch rates
# ---------------------------------------------------------------------------


class GridClock(ClockModel):
    """gridBasedBranchRateModel's clock; its report (the reference's
    intersections matrix) needs config/xml_assert.py's vector format."""

    def report(self, ax) -> str:
        raise unported("the report of <gridBasedBranchRateModel> (_vec)",
                       "config/xml_assert.py")


@register("gridBasedBranchRateModel")
def _grid_branch_rates(ax: XmlAnalysis, el):
    """GridBasedBranchRateModel.java: a branch's 'rate' is the time
    integral of a piecewise-constant rate function over the branch,
    rate_n = sum_k overlap(branch_n, cell_k) levelRate_k."""
    tm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tm = ax.build(cc)
    rates_n = ax.param_from(_child_of(el, "levelSpecificRates"))
    grid_n = ax.param_from(_child_of(el, "gridPoints"))
    if tm is None:
        raise XmlError("gridBasedBranchRateModel without treeModel")
    cuts = np.ravel(ax.value_of(grid_n))
    lo = ax.tensor(np.concatenate([[-np.inf], cuts]))
    hi = ax.tensor(np.concatenate([cuts, [np.inf]]))

    def rates(params, tree):
        dt = tree.heights.dtype
        par = torch.where(tree.parent >= 0,
                          tree.heights[tree.parent.clamp_min(0)],
                          tree.heights)
        ov = torch.clamp(torch.minimum(par[:, None], hi.to(dt)[None, :])
                         - torch.maximum(tree.heights[:, None],
                                         lo.to(dt)[None, :]), min=0.0)
        vals = ov @ params[rates_n].reshape(-1).to(dt)
        return torch.where(tree.parent >= 0, vals, torch.zeros_like(vals))

    return GridClock("grid", tm.tree_id, rates, rate_param=rates_n)


# ---------------------------------------------------------------------------
# priors and parameter views
# ---------------------------------------------------------------------------


@register("cachedPrior")
def _cached_prior(ax: XmlAnalysis, el):
    """CachedDistributionLikelihoodParser: caching is an execution detail
    (the component cache keeps a density until its inputs move); the
    element is its inner prior."""
    for c in el:
        obj = ax.build(c)
        if isinstance(obj, LikelihoodFn):
            return obj
    raise XmlError("<cachedPrior> without an inner prior")


@register("binomialLikelihood")
def _binomial_likelihood(ax: XmlAnalysis, el):
    """BinomialLikelihood.java: the sum of Binomial(trials, proportion)
    log masses over the counts (the BSSVS inclusion prior)."""
    prop = ax.param_from(_child_of(el, "proportion"))
    trials = ax.param_from(_child_of(el, "trials"))
    counts = ax.param_from(_child_of(el, "counts"))

    def fn(params, tree):
        p = torch.clamp(params[prop].reshape(-1)[0], 1e-12, 1.0 - 1e-12)
        k = params[counts].reshape(-1).to(p.dtype)
        n = torch.broadcast_to(params[trials].reshape(-1),
                               k.shape).to(p.dtype)
        return torch.sum(torch.lgamma(n + 1) - torch.lgamma(k + 1)
                         - torch.lgamma(n - k + 1) + k * torch.log(p)
                         + (n - k) * torch.log1p(-p))

    return LikelihoodFn(fn, None, el.get("id") or "binomial")


@register("dummyModel")
def _dummy_model(ax: XmlAnalysis, el):
    """DummyModelParser: holds its parameters in the graph; no density."""
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            ax.build(cc)
    return LikelihoodFn(lambda params, tree: _zero(ax), None,
                        el.get("id") or "dummyModel", ())


@register("halfTPrior")
def _half_t_prior(ax: XmlAnalysis, el):
    """PriorParsers HALF_T_PRIOR: a half-Student-t on [0, inf) of the
    given scale and df (HalfTDistribution.java)."""
    scale = _attr(el, "scale", 1.0, float)
    df = _attr(el, "df", 1.0, float)
    readers = _targets_of(ax, el)
    log_c = (math.lgamma(0.5 * (df + 1)) - math.lgamma(0.5 * df)
             - 0.5 * math.log(df * math.pi))

    def fn(params, tree):
        tot = 0.0
        for rd in readers:
            x = rd(params, tree).reshape(-1)
            z = x / scale
            lp = (log_c - 0.5 * (df + 1) * torch.log1p(z * z / df)
                  - math.log(scale) + math.log(2.0))
            tot = tot + torch.sum(_neg_inf_unless(x >= 0, lp))
        return tot

    return LikelihoodFn(fn, None, el.get("id") or "halfT")


@register("halfNormalPrior")
def _half_normal_prior(ax: XmlAnalysis, el):
    """PriorParsers HALF_NORMAL_PRIOR: N(mean, sd) truncated to
    [mean, inf)."""
    mean = _attr(el, "mean", 0.0, float)
    sd = _attr(el, "stdev", 1.0, float)
    readers = _targets_of(ax, el)

    def fn(params, tree):
        tot = 0.0
        for rd in readers:
            x = rd(params, tree).reshape(-1)
            z = (x - mean) / sd
            lp = (-0.5 * z * z - 0.5 * math.log(2 * math.pi) - math.log(sd)
                  + math.log(2.0))
            tot = tot + torch.sum(_neg_inf_unless(x >= mean, lp))
        return tot

    return LikelihoodFn(fn, None, el.get("id") or "halfNormal")


_BUILDERS_VIEW = ("maskedParameter", "transformedParameter",
                  "transformedMultivariateParameter", "productParameter",
                  "multiplicativeParameter")


def _inner_value_fn(ax: XmlAnalysis, el):
    """(fn(params) -> tensor, base parameter name) of a parameter-like
    child: a <parameter> reads itself, a masked or derived view reads
    through its function."""
    cc = ax.deref(el)
    obj = ax.build(cc) if cc.tag in _BUILDERS_VIEW else None
    if isinstance(obj, DerivedParam):
        return obj.fn, (obj.base or obj.name)
    name = ax.param_from(cc)
    return (lambda p, n=name: p[n]), name


def _host_value(x):
    return np.asarray(x.detach().cpu().numpy(), float)


@register("transformedParameter", "transformedMultivariateParameter")
def _transformed_parameter(ax: XmlAnalysis, el):
    """TransformedParameterParser: value = transform(inner), or
    transform.inverse(inner) with inverse="true"
    (TransformedParameter.java:72-84), a DerivedParam injected into the
    params before every density evaluation."""
    from beast_mcmc_tpu_torch.config.xml_hmc import (
        matrix_param_of,
        transform_of_el,
    )
    from beast_mcmc_tpu_torch.config.xml_stats import _current_state
    from beast_mcmc_tpu_torch.utils import transforms as TR

    inverse = (el.get("inverse") or "false").lower() == "true"
    base_fn = base_name = tr = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("transform", "LKJTransform", "inverseTransform"):
            tr = transform_of_el(ax, cc)
        elif cc.tag == "matrixInnerProductTransform":
            # the flattened M^T M of the inner matrix parameter
            # (MatrixInnerProductTransform; the reference wraps the
            # column-major values row-major, so its X X^T is M^T M here)
            mp_in = matrix_param_of(ax, ax.deref(next(iter(cc))))

            def fn_ip(params, _mp=mp_in):
                m_ = _mp.fn(params)
                return (m_.T @ m_).reshape(-1)

            name = el.get("id") or f"innerProduct.{mp_in.name}"
            ax._derived_params[name] = fn_ip
            p0_, _ = _current_state(ax)
            dp = DerivedParam(name, fn_ip, value=_host_value(fn_ip(p0_)))
            ax._built[id(el)] = dp
            return dp
        elif cc.tag == "powerTransform":
            tr = TR.parse_transform("power",
                                    power=float(cc.get("power", 2.0)))
        elif base_fn is None:
            try:
                base_fn, base_name = _inner_value_fn(ax, cc)
            except (XmlError, Unsupported):
                continue
    if base_fn is None:
        raise XmlError(f"<{el.tag}> without inner parameter")

    def fn(params):
        x = base_fn(params)
        if tr is None:
            return x
        return tr.inverse(x) if inverse else tr.forward(x)

    name = el.get("id") or f"transformed.{base_name}"
    dp = DerivedParam(name, fn)
    ax._derived_params[name] = fn
    # the base, so that an operator on this element walks the sampled
    # parameter in transformed space
    ax._transformed_bases = getattr(ax, "_transformed_bases", {})
    ax._transformed_bases[name] = (base_name, tr, inverse)
    return dp


@register("maskedParameter")
def _masked_parameter(ax: XmlAnalysis, el):
    """MaskedParameterParser: a parameter under a 0/1 mask. The full
    parameter stays the sampled object; with a <mask> the element is a
    DerivedParam view of the mask == 1 entries, without one the
    underlying Param."""
    from beast_mcmc_tpu_torch.config.xml_stats import _current_state

    inner_el = el.find("parameter")
    if inner_el is None:
        inner_el = next(c for c in el if ax.deref(c).tag != "mask")
    inner = ax.param_from(inner_el)
    mask_el = el.find("mask")
    if mask_el is None and _attr(el, "build", False, bool):
        # build="true" (isNaMissing="true"): the mask is the NaN positions
        # (else the zeros), and they are filled with the value attribute,
        # cycled (default 0), so the chain starts finite
        # (MaskedParameterParser.java:60-86)
        base = ax._params[inner]
        vals = np.ravel(np.asarray(base.value, float)).copy()
        na = (np.isnan(vals) if _attr(el, "isNaMissing", False, bool)
              else vals == 0.0)
        fill_attr = el.get("value")
        fill = (np.array([float(x) for x in fill_attr.split()])
                if fill_attr else np.array([0.0]))
        vals[na] = np.resize(fill, int(na.sum()))
        base.value = vals.reshape(np.shape(base.value))
        mid = el.get("id") or f"masked{len(ax._derived_params)}.{inner}"
        idx = np.nonzero(na)[0]
        ix = ax.tensor(idx, torch.long)
        fn = lambda p, n=inner, ix=ix: p[n].reshape(-1)[ix]  # noqa: E731
        ax._derived_params[mid] = fn
        return DerivedParam(mid, fn, value=vals[idx], base=inner, idx=idx)
    if mask_el is None:
        return ax._params[inner]
    mid = el.get("id") or f"masked{len(ax._derived_params)}.{inner}"
    complement = _attr(el, "complement", False, bool)
    mvals = np.ravel(_text_values(ax.deref(_child_of(mask_el, "parameter"))))
    idx = np.nonzero((mvals <= 0.5) if complement else (mvals > 0.5))[0]
    if idx.size == mvals.size:
        return ax._params[inner]
    if inner in ax._params:
        inner_val = np.ravel(ax.value_of(inner))
    else:
        # a masked view of a derived parameter: its initial value
        p0_, _ = _current_state(ax)
        inner_val = np.ravel(_host_value(p0_[inner]))
    if idx.size == 1:
        i0 = int(idx[0])
        fn = lambda p, n=inner, i=i0: p[n].reshape(-1)[i]  # noqa: E731
        init = inner_val[i0]
    else:
        ix = ax.tensor(idx, torch.long)
        fn = lambda p, n=inner, ix=ix: p[n].reshape(-1)[ix]  # noqa: E731
        init = inner_val[idx]
    ax._derived_params[mid] = fn
    return DerivedParam(mid, fn, value=init, base=inner, idx=idx)


# ---------------------------------------------------------------------------
# empirical distribution likelihood
# ---------------------------------------------------------------------------


@register("empiricalDistributionLikelihood")
def _empirical_distribution(ax: XmlAnalysis, el):
    """EmpiricalDistributionLikelihoodParser: a log density interpolated
    from (x, log p) pairs, in the document (<grid>) or a file, applied to
    the data parameters."""
    import os

    from beast_mcmc_tpu_torch.models.coalescent import _interp

    grid_el = el.find("grid")
    if grid_el is not None:
        ll_el, v_el = grid_el.find("logLikelihood"), grid_el.find("value")
        if ll_el is None or v_el is None:
            raise XmlError("empirical grid needs logLikelihood + value")
        lps = _text_values(ax.deref(_child_of(ll_el, "parameter")))
        xs = _text_values(ax.deref(_child_of(v_el, "parameter")))
        order = np.argsort(xs)
        xs, lps = xs[order], lps[order]
    else:
        fname = el.get("fileName")
        path = fname
        if path and not os.path.isabs(path):
            for base in (ax.workdir, os.path.dirname(ax.path)):
                cand = os.path.join(base, fname)
                if os.path.exists(cand):
                    path = cand
                    break
        if not path or not os.path.exists(path):
            raise Unsupported(
                f"empiricalDistributionLikelihood file {fname!r} not found")
        xs, lps = [], []
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    try:
                        xs.append(float(parts[0]))
                        lps.append(float(parts[1]))
                    except ValueError:
                        continue
    grid_x, grid_lp = ax.tensor(xs), ax.tensor(lps)
    data_el = el.find("data")
    pname = ax.param_from(data_el if data_el is not None else el)
    inverse = _attr(el, "inverse", False, bool)

    def fn(params, tree):
        lp = _interp(params[pname].reshape(-1), grid_x, grid_lp)
        return torch.sum(-lp if inverse else lp)

    return LikelihoodFn(fn, None, el.get("id") or "empirical", (pname,))


# ---------------------------------------------------------------------------
# operators: the transformed random walk, elliptical slice, MVN walk
# ---------------------------------------------------------------------------


@register_operator("transformedParameterRandomWalkOperator")
def _transformed_rw_operator(ax: XmlAnalysis, el, weight):
    """TransformedParameterRandomWalkOperatorParser: a walk in the
    transformed value space; the sampled base parameter moves through the
    inverse map, the Jacobian in the Hastings ratio."""
    from beast_mcmc_tpu_torch.inference.operators import (
        TransformedRandomWalkOperator,
    )
    from beast_mcmc_tpu_torch.utils import transforms as TR

    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("transformedParameter",
                      "transformedMultivariateParameter"):
            dp = ax.build(cc)
            base, tr, inverse = ax._transformed_bases[dp.name]
            if tr is None:
                tr = TR.NoTransform()
            if inverse:
                # a walk on transform.inverse(x): the transform with its
                # maps swapped
                class _Swapped(TR.Transform):
                    def forward(self, x, _t=tr):
                        return _t.inverse(x)

                    def inverse(self, y, _t=tr):
                        return _t.forward(y)

                tr = _Swapped()
            return TransformedRandomWalkOperator(
                parameter=base, transform=tr,
                window=_attr(el, "windowSize", 1.0, float),
                weight=weight), None
    raise XmlError("transformedParameterRandomWalkOperator without "
                   "transformed parameter child")


@register_operator("ellipticalSliceSampler")
def _ess_operator(ax: XmlAnalysis, el, weight):
    """EllipticalSliceOperatorParser: rejection-free slice moves on the
    ellipse of a multivariateNormalPrior-distributed parameter
    (inference/gibbs.py::EllipticalSliceOperator)."""
    from beast_mcmc_tpu_torch.inference.gibbs import EllipticalSliceOperator

    pname = mean = prec = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter" and pname is None:
            pname = ax.param_from(cc)
        elif cc.tag == "multivariateNormalPrior":
            mean = _text_values(ax.deref(_child_of(
                _child_of(cc, "meanParameter"), "parameter")))
            prec_el = cc.find("precisionMatrix")
            if prec_el is None:
                prec_el = cc.find("precisionParameter")
            for pc in prec_el:
                pcc = ax.deref(pc)
                if pcc.tag == "matrixParameter":
                    prec = np.asarray(ax.build(pcc)).T
    if pname is None or mean is None:
        raise XmlError("ellipticalSliceSampler needs parameter + "
                       "multivariateNormalPrior")
    if prec is None:
        prec = np.eye(mean.size)
    chol = np.linalg.cholesky(np.linalg.inv(prec))
    prec_t = ax.tensor(prec)

    def prior_logpdf(v, mu):
        d = v - mu
        return -0.5 * torch.einsum("...i,ij,...j->...", d,
                                   prec_t.to(v.dtype), d)

    return EllipticalSliceOperator(
        parameter=pname, prior_mean=mean, prior_chol=chol,
        prior_logpdf=prior_logpdf, weight=weight), None


@register_operator("mvnOperator")
def _mvn_operator(ax: XmlAnalysis, el, weight):
    """MVNOperatorParser: the random walk x' = x + sf L z with the
    proposal covariance an explicit <varMatrix> or (X^T X)^-1 of a design
    matrix (formXtXInverse="true"); symmetric."""
    from beast_mcmc_tpu_torch.inference.operators import MvnRandomWalkOperator

    sf = _attr(el, "scaleFactor", 1.0, float)
    form_xtx = _attr(el, "formXtXInverse", False, bool)
    pname = var = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter" and pname is None:
            pname = ax.param_from(cc)
        elif cc.tag == "varMatrix":
            var = np.asarray(ax.value_of(ax.param_from(cc)), float)
    if pname is None or var is None:
        raise XmlError("mvnOperator needs parameter + varMatrix")
    d = int(np.size(ax.value_of(pname)))
    if form_xtx:
        x = var.reshape(-1, d)
        cov = np.linalg.inv(x.T @ x)
    else:
        cov = var.reshape(d, d)
    return MvnRandomWalkOperator(parameter=pname,
                                 chol=np.linalg.cholesky(cov),
                                 scale_factor=sf, weight=weight), None


# ---------------------------------------------------------------------------
# design matrices and product statistics
# ---------------------------------------------------------------------------


@register("designMatrix")
def _design_matrix(ax: XmlAnalysis, el):
    """DesignMatrixParser: a matrix whose columns are the child
    parameters; one child resolves to its Param, several to a constant of
    the concatenated columns."""
    names = [ax.param_from(ax.deref(c)) for c in el
             if ax.deref(c).tag == "parameter"]
    if len(names) == 1:
        return ax._params[names[0]]
    vals = np.concatenate([np.ravel(ax.value_of(n)) for n in names])
    key = el.get("id") or f"design{len(ax._params)}"
    if key not in ax._params:
        ax._params[key] = Param(key, vals)
    return ax._params[key]


@register("productStatistic")
def _product_statistic(ax: XmlAnalysis, el):
    """ProductStatistic: the elementwise product of the child parameters
    (of one dimension), or the product of all elements with
    elementwise="false"."""
    names = [ax.param_from(ax.deref(c)) for c in el
             if ax.deref(c).tag == "parameter"]
    if not names:
        raise XmlError("productStatistic without parameters")
    elementwise = _attr(el, "elementwise", True, bool)
    dims = [int(np.size(ax.value_of(n))) for n in names]
    same = len(set(dims)) == 1

    def col(i):
        def f(s):
            out = torch.ones((), dtype=ax.dtype, device=ax.device)
            for n in names:
                out = out * s.params[n].reshape(-1)[i]
            return out

        return f

    class _Prod:
        columns = None

        def __init__(self):
            if elementwise and same and dims[0] > 1:
                nm = el.get("id") or "product"
                self.columns = [(f"{nm}{i + 1}", col(i))
                                for i in range(dims[0])]

        def __call__(self, s):
            prod = None
            for n in names:
                v = s.params[n].reshape(-1)
                prod = v if prod is None else prod * v
            return prod if elementwise and same else torch.prod(prod)

    return _Prod()


# ---------------------------------------------------------------------------
# transmission history compatibility statistic
# ---------------------------------------------------------------------------


@register("transmissionHistory")
def _transmission_history(ax: XmlAnalysis, el):
    """TransmissionHistoryModel: the ordered host registry (donor then
    recipient per event, first-appearance order,
    TransmissionHistoryModel.java:89-106) and each recipient's
    infection-time parameter."""
    hosts: List[str] = []
    events = []  # (donor id, recipient id, time parameter name)
    for tr in el.findall("transmission"):
        tname = ax.param_from(_child_of(tr, "parameter"))
        donor = (ax.deref(_child_of(tr, "donor").find("taxon")).get("id")
                 or _child_of(tr, "donor").find("taxon").get("idref"))
        recip = (ax.deref(_child_of(tr, "recipient").find("taxon")).get("id")
                 or _child_of(tr, "recipient").find("taxon").get("idref"))
        for h in (donor, recip):
            if h not in hosts:
                hosts.append(h)
        events.append((donor, recip, tname))
    return ("transmission_history", tuple(hosts), tuple(events))


@register("transmissionStatistic")
def _transmission_statistic(ax: XmlAnalysis, el):
    """TransmissionStatistic.java:120-180: per host, whether the virus tree
    is compatible with the transmission history. A post-order pass
    resolves each node's host by walking the donor chain until the
    infection time covers the node's height; sibling hosts in conflict
    mark the younger infection's host incompatible."""
    from beast_mcmc_tpu_torch.ops.peeling import peel_order_from_heights

    hist = tm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "transmissionHistory":
            hist = ax.build(cc)
        elif cc.tag == "parasiteTree":
            tm = ax.build(ax.deref(next(iter(cc))))
        elif cc.tag in ("treeModel", "starTreeModel"):
            tm = ax.build(cc)
    if hist is None or tm is None:
        raise XmlError("transmissionStatistic needs history + parasiteTree")
    _, hosts, events = hist
    h_index = {h: i for i, h in enumerate(hosts)}
    n_hosts = len(hosts)
    donor = np.full(n_hosts, -1, np.int64)
    time_names = [None] * n_hosts
    for d, r, tname in events:
        donor[h_index[r]] = h_index[d]
        time_names[h_index[r]] = tname
    # tip -> host index by the taxon's "host" attribute
    tip_host = np.full(len(tm.taxa), -1, np.int64)
    for i, tx in enumerate(tm.taxa):
        hv = ax._taxon_attrs.get(tx, {}).get("host")
        if hv:
            tip_host[i] = h_index.get(hv[0], -1)
    donor_t = ax.tensor(donor, torch.long)
    tip_host_t = ax.tensor(tip_host, torch.long)
    n_tips = len(tm.taxa)

    def incompatible_mask(s):
        t = ax.resolve_tree(tm.tree_id, s.params, s.tree)
        dt = t.heights.dtype
        times = torch.stack([
            torch.full((), math.inf, dtype=dt, device=t.heights.device)
            if nm is None else (s.params[nm] if nm in s.params
                                else ax.tensor(ax.value_of(nm))
                                ).reshape(()).to(dt)
            for nm in time_names])

        def walk_up(h, height):
            # the donor-chain walk, at most n_hosts steps
            for _ in range(n_hosts):
                h = torch.where(height > times[h], donor_t[h], h)
            return h

        m = t.parent.shape[0]
        host = torch.cat([tip_host_t, torch.full((m - n_tips,), -1,
                                                 dtype=torch.long,
                                                 device=t.parent.device)])
        bad = torch.zeros(n_hosts, dtype=torch.bool, device=t.parent.device)
        ch = t.children
        for node in peel_order_from_heights(t.heights, n_tips,
                                            t.parent).tolist():
            height = t.heights[node]
            h1 = walk_up(host[ch[node, 0]], height)
            h2 = walk_up(host[ch[node, 1]], height)
            differ = h1 != h2
            i1, i2 = h1.clamp_min(0), h2.clamp_min(0)
            mark1 = differ & (times[i1] < times[i2])
            mark2 = differ & ~mark1
            bad = bad.index_put((i1[None],), (bad[i1] | mark1)[None])
            bad = bad.index_put((i2[None],), (bad[i2] | mark2)[None])
            keep = torch.where(differ, torch.where(mark1, h2, h1), h1)
            host = host.index_put((torch.as_tensor([node],
                                                   device=host.device),),
                                  keep[None])
        return bad

    class _Stat:
        columns = [
            (f"transmission("
             f"{hosts[donor[i]] + '->' if donor[i] >= 0 else ''}{hosts[i]})",
             (lambda s, i=i: torch.where(
                 incompatible_mask(s)[i], _zero(ax), _zero(ax) + 1.0)))
            for i in range(n_hosts)
        ]

        def __call__(self, s):
            return 1.0 - incompatible_mask(s).to(ax.dtype)

    return _Stat()


# ---------------------------------------------------------------------------
# trait validation and the Gaussian process from a tree
# ---------------------------------------------------------------------------


@register("traitValidation")
def _trait_validation(ax: XmlAnalysis, el):
    """TraitValidationProvider + CrossValidationProvider (SQUARED_ERROR):
    each missing entry's squared error between the inferred tip trait and
    the supplied true value, and their sum. The inferred value is the
    trait parameter's current entry."""
    tl = true_name = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "traitDataLikelihood":
            ax.build(cc)
            tl = getattr(ax, "_trait_likelihoods", {}).get(cc.get("id"))
        elif cc.tag == "traitParameter":
            true_name = ax.param_from(cc)
    if tl is None or true_name is None:
        raise XmlError("traitValidation needs traitDataLikelihood + "
                       "traitParameter")
    idx = np.nonzero(np.ravel(np.asarray(tl.missing, bool)))[0]
    nm = el.get("id") or "validation"
    ix = ax.tensor(idx, torch.long)
    tparam = tl.trait_param
    truth = ax.tensor(np.ravel(ax.value_of(true_name)))

    def sq_err(s):
        inferred = s.params[tparam].reshape(-1)[ix]
        return (inferred - truth.to(inferred.dtype)[ix]) ** 2

    class _Val:
        columns = ([(f"{nm}.squaredError{i + 1}",
                     lambda s, i=i: sq_err(s)[i]) for i in range(idx.size)]
                   + [(f"{nm}.squaredError.sum",
                       lambda s: torch.sum(sq_err(s)))]
                   if idx.size else
                   [(f"{nm}.squaredError.sum", lambda s: _zero(ax))])

        def __call__(self, s):
            return torch.sum(sq_err(s)) if idx.size else _zero(ax)

    return _Val()


@register("gaussianProcessFromTree")
def _gaussian_process_from_tree(ax: XmlAnalysis, el):
    """GaussianProcessFromTree: a random generator over the tree-trait
    prior, not Loggable in the reference (LoggerParser.java:132-135).
    Builds its inner likelihood; no density and no log columns."""
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "traitDataLikelihood":
            ax.build(cc)

    class _Gp:
        columns = []

        def __call__(self, s):
            return _zero(ax)

    return _Gp()


# ---------------------------------------------------------------------------
# the multivariate OU time-series model
# ---------------------------------------------------------------------------


@register("positiveDefiniteSubstitutionModel")
def _pd_substitution_model(ax: XmlAnalysis, el):
    """PositiveDefiniteSubstitutionModel: transition probabilities are
    expm(distance Q) of a symmetric positive-definite matrix parameter."""
    from beast_mcmc_tpu_torch.config.xml_hmc import matrix_param_of

    return ("pd_subst", matrix_param_of(ax, ax.deref(next(iter(el)))))


@register("multivariateOUModel")
def _multivariate_ou_model(ax: XmlAnalysis, el):
    """inferencexml/distribution/MultivariateOUModel.java:192-330: a
    Gaussian chain over time points, theta_0 ~ N(0, G) and
    theta_t ~ N(W theta_{t-1}, G - W G W^T) with W = expm(-dt Q), all less
    the X beta fixed effects; det(G) < 0.01 gives -inf."""
    from beast_mcmc_tpu_torch.config.xml_hmc import matrix_param_of

    qmp = data_name = times = design = gamma_mp = beta_name = None
    x_cols = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "substitutionModel":
            obj = ax.build(ax.deref(cc))
            qmp = obj[1] if isinstance(obj, tuple) else None
        elif cc.tag == "positiveDefiniteSubstitutionModel":
            qmp = ax.build(cc)[1]
        elif cc.tag == "data":
            data_name = ax.param_from(cc)
        elif cc.tag == "times":
            times = np.ravel(_text_values(ax.deref(_child_of(cc,
                                                             "parameter"))))
        elif cc.tag == "design":
            design = np.ravel(_text_values(ax.deref(_child_of(cc,
                                                              "parameter"))))
        elif cc.tag in ("diagonalMatrix", "matrixParameter",
                        "compoundSymmetricMatrix"):
            gamma_mp = matrix_param_of(ax, cc)
        elif cc.tag == "independentVariables":
            for p in cc:
                pp = ax.deref(p)
                if pp.tag == "parameter":
                    beta_name = ax.param_from(pp)
                elif pp.tag == "designMatrix":
                    for q in pp:
                        qq = ax.deref(q)
                        if qq.tag == "parameter":
                            x_cols.append(np.ravel(_text_values(qq)))
    if qmp is None or data_name is None or times is None or design is None:
        raise XmlError("multivariateOUModel structure")
    k = int(design.max())
    n_total = times.size
    n_points = n_total // k
    dts = np.diff(times.reshape(n_points, k)[:, 0]).tolist()
    x_mat = ax.tensor(np.stack(x_cols, axis=1)) if x_cols else None
    two_pi = 2.0 * math.pi

    def mvn_lp(x, cov):
        _, ld = torch.linalg.slogdet(cov)
        return -0.5 * (k * math.log(two_pi) + ld
                       + x @ torch.linalg.inv(cov) @ x)

    def fn(params, tree):
        theta = params[data_name].reshape(-1)[:n_total].to(ax.dtype)
        if x_mat is not None and beta_name is not None:
            theta = theta - x_mat[:n_total] @ params[beta_name].reshape(
                -1).to(ax.dtype)
        th = theta.reshape(n_points, k)
        g = gamma_mp.fn(params).to(ax.dtype)
        q = qmp.fn(params).to(ax.dtype)
        sign_g, logdet_g = torch.linalg.slogdet(g)
        det_ok = sign_g * torch.exp(logdet_g) >= 0.01
        lp = mvn_lp(th[0], g)  # the first point ~ N(0, G)
        w_eval, w_evec = torch.linalg.eigh(0.5 * (q + q.T))
        for i, dt_i in enumerate(dts):
            w = (w_evec * torch.exp(-dt_i * w_eval)) @ w_evec.T
            lp = lp + mvn_lp(th[i + 1] - w @ th[i], g - w @ g @ w.T)
        return _neg_inf_unless(det_ok, lp)

    return LikelihoodFn(fn, None, el.get("id") or "mvou", (data_name,))


# ---------------------------------------------------------------------------
# node-height transform and coalescent-interval views
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NodeHeightTransformMarker:
    """<nodeHeightTransform>: the heights <-> ratios change of variables
    (tree/transforms.py; the HMC operator NodeHeightHmcOperator applies it
    itself). Logs the current tree's ratios."""

    tree_id: str = ""
    n_tips: int = 0
    columns: list = None


@register("nodeHeightTransform")
def _node_height_transform(ax: XmlAnalysis, el):
    tid = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("tree", "treeModel"):
            tm = ax.build(cc)
            tid = tm.tree_id
            n = len(tm.taxa)
    if tid is None:
        raise XmlError("nodeHeightTransform without tree")
    mk = NodeHeightTransformMarker(tid, n)
    ratios_el = el.find("ratios")
    if ratios_el is not None:
        p = ax.deref(_child_of(ratios_el, "parameter"))
        rid = p.get("id") or p.get("idref")
        if rid:
            from beast_mcmc_tpu_torch.tree.transforms import heights_to_ratios

            def col(i):
                def f(s):
                    t = ax.resolve_tree(tid, s.params, s.tree)
                    r, _ = heights_to_ratios(t.parent, t.children,
                                             t.heights, t.root, n)
                    return r.reshape(-1)[i]

                return f

            ax._built[id(p)] = NodeHeightTransformMarker(
                tid, n, [(f"{rid}{i + 1}", col(i)) for i in range(n - 1)])
    return mk


@register("coalescentIntervals")
def _coalescent_intervals_view(ax: XmlAnalysis, el):
    """CoalescentIntervalProvider / GMRFSkyrideLikelihood intervals: the
    sorted coalescent waiting times of the likelihood's tree, as a
    loggable view."""
    tid = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("gmrfSkyrideLikelihood", "gmrfSkyGridLikelihood",
                      "skyGridLikelihood"):
            tid = ax.build(cc).tree_id
        elif cc.tag in ("treeModel", "starTreeModel"):
            tid = ax.build(cc).tree_id
    if tid is None:
        raise XmlError("coalescentIntervals without tree source")
    n = len(ax._trees[tid].taxa)
    nm = el.get("id") or "intervals"

    def sorted_heights(s):
        return torch.sort(ax.resolve_tree(tid, s.params,
                                          s.tree).heights[n:]).values

    def col(i):
        j = min(i, n - 2)

        def f(s):
            hs = sorted_heights(s)
            return hs[0] if i == 0 else hs[j] - hs[j - 1]

        return f

    class _Intervals:
        tree_id = tid
        n_tips = n
        columns = [(f"{nm}{i + 1}", col(i)) for i in range(n - 1)]

        def __call__(self, s):
            hs = sorted_heights(s)
            return torch.cat([hs[:1], torch.diff(hs)])

    return _Intervals()


@register("nodePosteriorLikelihood")
def _node_posterior_likelihood(ax: XmlAnalysis, el):
    """oldevomodel NodePosteriorTreeLikelihood: the density is the peeled
    tree likelihood (its per-node posterior traits feed only
    avgPosteriorIBDReporter)."""
    return _tree_likelihood(ax, el)


@register("avgPosteriorIBDReporter")
def _avg_posterior_ibd_reporter(ax: XmlAnalysis, el):
    """oldevomodel/ibd/AvgPosteriorIBDReporter: an identity-by-descent
    tree-log annotation with no oracle; the inner likelihood is built,
    the tree logs come out plain."""
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "nodePosteriorLikelihood":
            ax.build(cc)
    return None


# ---------------------------------------------------------------------------
# the rewards-aware branch model (Sericola series)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RewardBranchModel:
    """<rewardsAwareBranchModel>: per-branch Markov-reward transition
    densities W(node), the pdf of (end state, total branch reward)
    (RewardsAwareBranchModel.java:102-130; ops/sericola.py), computed on
    the host at the initial state."""

    w: np.ndarray = None  # [M, S, S] (the root's row the identity)
    freqs: np.ndarray = None
    k: int = 0
    root_row: int = -1

    def report(self, ax) -> str:
        # one header, every branch's matrix concatenated
        vals = []
        for b in range(self.w.shape[0]):
            if b != self.root_row:
                vals.extend(str(v) for v in np.ravel(self.w[b]))
        return "W matrix: " + " ".join(vals) + "\n"


@register("rewardsAwareBranchModel")
def _rewards_aware_branch_model(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state
    from beast_mcmc_tpu_torch.ops.sericola import reward_branch_matrices

    clock = reward_rates = subst = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "arbitraryBranchRates":
            clock = ax.build(cc)
        elif cc.tag == "rewardRates":
            reward_rates = np.ravel(_text_values(ax.deref(_child_of(
                cc, "parameter"))))
        elif cc.tag in ("generalSubstitutionModel",
                        "complexSubstitutionModel"):
            subst = ax.build(cc)
    if clock is None or reward_rates is None or subst is None:
        raise XmlError("rewardsAwareBranchModel structure")
    # the CTMC generator at the initial parameter values
    params0, tree0 = initial_eval_state(ax)
    if subst[0] == "subst_q":
        q = _host_value(subst[1](params0))
    else:
        eig = subst[1](params0)
        q = (_host_value(eig.U) * _host_value(eig.values)[None, :]
             ) @ _host_value(eig.U_inv)
    k = subst[3]
    freqs = _host_value(subst[2](params0))
    # each branch's total reward (the arbitraryBranchRates values) and
    # the parse-time tree's branch lengths
    tm = ax._trees[clock.tree_id]
    m = tm.parent.shape[0]
    br = np.broadcast_to(_host_value(torch.as_tensor(
        clock.rates(params0, tree0))), (m,))
    bl = np.where(tm.parent >= 0,
                  tm.heights[np.maximum(tm.parent, 0)] - tm.heights, 0.0)
    w = np.zeros((m, k, k))
    nz = bl > 0
    w[~nz] = np.eye(k)
    w[nz] = reward_branch_matrices(q, reward_rates, br[nz], bl[nz])
    return RewardBranchModel(w=w, freqs=freqs, k=k, root_row=int(tm.root))


def _reward_aware_tree_likelihood(ax: XmlAnalysis, el, model_el):
    """<treeDataLikelihood useRewardAwareBranchModelDelegate="true">:
    peeling with the reward densities as the per-branch transition
    operands (RewardAwareSubstitutionModelDelegate.java)."""
    from beast_mcmc_tpu_torch.ops.peeling import (
        peel_loglikelihood,
        peel_order_from_heights,
    )

    rm = ax.build(model_el)
    patterns = tm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("patterns", "attributePatterns"):
            patterns = ax.build(cc)
        elif cc.tag in ("treeModel", "starTreeModel"):
            tm = ax.build(cc)
    if patterns is None or tm is None:
        raise XmlError("reward-aware treeDataLikelihood structure")
    idx = [patterns.taxa.index(t) for t in tm.taxa]
    tab = patterns.datatype.ambiguity_table(np.float64)
    tips = ax.tensor(np.ascontiguousarray(np.swapaxes(
        tab[np.asarray(patterns.states)[idx]], 1, 2)))  # [N, S, P]
    weights = ax.tensor(np.asarray(patterns.weights, float))
    w_ops = ax.tensor(rm.w[:, None])  # [M, C = 1, S, S]
    freqs = ax.tensor(rm.freqs)
    cat_w = ax.tensor(np.ones(1))
    n_taxa = len(tm.taxa)

    def fn(params, tree):
        order = peel_order_from_heights(tree.heights, n_taxa, tree.parent)
        return peel_loglikelihood(tips, tree.children, order, tree.root,
                                  w_ops, freqs, cat_w, weights)

    return LikelihoodFn(fn, tm.tree_id, el.get("id") or "rewardTreeLikelihood")


@register("transformedVectorSumTransform")
def _transformed_vector_sum(ax: XmlAnalysis, el):
    """TransformedVectorSumParameter (HMC increment coordinates):
    x_k = g(sum_{i<=k} y_i) over the increments y; g = exp for
    incrementTransformType="log", the scaled logistic for "logit"."""
    from beast_mcmc_tpu_torch.config.xml_stats import _current_state

    kind = el.get("incrementTransformType", "log")
    lo = float(el.get("lower", "0.0"))
    hi = float(el.get("upper", "1.0"))
    comp = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("compoundParameter", "parameter"):
            comp = ax.build(cc)
    if isinstance(comp, CompoundParam):
        names = tuple(comp.names)
    elif isinstance(comp, Param):
        names = (comp.name,)
    else:
        raise XmlError("transformedVectorSumTransform inner parameter")

    def fn(params):
        s = torch.cumsum(torch.cat([torch.as_tensor(params[n]).reshape(-1)
                                    for n in names]), 0)
        if kind == "log":
            return torch.exp(s)
        return lo + (hi - lo) / (1.0 + torch.exp(-s))

    name = el.get("id") or f"vecSum{len(ax._derived_params)}"
    ax._derived_params[name] = fn
    p0, _ = _current_state(ax)
    return DerivedParam(name, fn, value=_host_value(fn(p0)))
