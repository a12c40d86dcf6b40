"""XML vocabulary of discrete phylogeography: general data types,
attribute patterns, general substitution models and sequence simulation.

Counterpart of beast_mcmc_tpu/config/xml_geo.py, its first part (:42-267,
:598-743): the tags the Makona-class document reaches.

  generalDataType             (GeneralDataTypeParser:45)
  attributePatterns           (AttributePatternsParser)
  generalSubstitutionModel    (GeneralSubstitutionModelParser.java:47)
  svsGeneralSubstitutionModel (the same parser's BSSVS branch; its
                              indicator-connectivity prior is
                              svs_connectivity_prior, added where the
                              model sits in a <prior>)
  complexSubstitutionModel    (ComplexSubstitutionModelParser)
  beagleSequenceSimulator, sequenceSimulator
                              (BeagleSequenceSimulatorParser,
                              SequenceSimulatorParser)

A reversible model is ("subst", eigen, freqs, K); a non-reversible or
BSSVS one ("subst_q", q_fn, freqs, K), its Q [K, K] built on the params'
device. The simulator runs on the host in numpy with scipy's expm on the
analysis's numpy generator (`_rng`), drawing the same numbers in the same
order as the JAX package's: the categories, the root states, then one
uniform a site of a node's category in preorder. So a document gives the
JAX package's alignment state for state. The rest of the JAX module (the
GLM and log-rate models, the structured coalescent, the gradients, ...)
stays with ROADMAP queue item 4g, its tags raising Unsupported
(config/interpreter.py EXTENSION_TAGS).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    LikelihoodFn,
    TreeModel,
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    register,
)
from beast_mcmc_tpu_torch.models.substitution import (
    general_complex_q,
    svs_connectivity_logprior,
)


# ---------------------------------------------------------------------------
# general data type and attribute patterns
# ---------------------------------------------------------------------------


@register("generalDataType")
def _general_data_type(ax: XmlAnalysis, el):
    """An explicit state alphabet with optional ambiguities and aliases
    (GeneralDataTypeParser)."""
    from beast_mcmc_tpu_torch.data.datatype import DataType

    codes: List[str] = []
    ambiguities = []  # (code char, tuple of member chars)
    aliases = []  # (alias char, state char)
    for c in el:
        if c.tag == "state":
            codes.append(c.get("code"))
        elif c.tag == "ambiguity":
            ambiguities.append((c.get("code"), tuple(c.get("states") or "")))
        elif c.tag == "alias":
            aliases.append((c.get("code"), c.get("state")))
    if not codes:
        raise XmlError("generalDataType without states")
    k = len(codes)
    char_map = {ch.upper(): i for i, ch in enumerate(codes)}
    state_sets = [(i,) for i in range(k)]
    code_chars = list(codes)
    for ch, st in aliases:
        char_map[ch.upper()] = char_map[st.upper()]
    for ch, members in ambiguities:
        ss = (tuple(sorted(char_map[m.upper()] for m in members)) if members
              else tuple(range(k)))
        char_map[ch.upper()] = len(state_sets)
        state_sets.append(ss)
        code_chars.append(ch)
    # the fully ambiguous code for '?' and '-'
    full = tuple(range(k))
    for ch in ("?", "-"):
        if ch not in char_map:
            char_map[ch] = len(state_sets)
            state_sets.append(full)
            code_chars.append(ch)
    return DataType(name=el.get("id") or "general", state_count=k,
                    char_map=char_map, state_sets=tuple(state_sets),
                    code_chars=tuple(code_chars))


@register("attributePatterns")
def _attribute_patterns(ax: XmlAnalysis, el):
    """One-column patterns from a taxon attribute (AttributePatternsParser:
    the discrete-trait data of location, host, ...)."""
    from beast_mcmc_tpu_torch.data.alignment import SitePatterns

    attr = el.get("attribute")
    dt = taxa = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "generalDataType":
            dt = ax.build(cc)
        elif cc.tag == "taxa":
            taxa = ax.build(cc)
    if dt is None or taxa is None or attr is None:
        raise XmlError("attributePatterns needs attribute + taxa + dataType")
    names = [n for n, _ in taxa]
    states = np.zeros((len(names), 1), np.int16)
    for i, nm in enumerate(names):
        vals = ax._taxon_attrs.get(nm, {}).get(attr)
        if vals is None:
            raise XmlError(f"taxon {nm!r} has no attribute {attr!r}")
        v = " ".join(vals).strip()
        states[i, 0] = (dt.encode(v)[0] if len(v) == 1
                        else dt.char_map.get(v.upper(), dt.unknown_code))
    return SitePatterns(taxa=names, states=states, weights=np.ones(1),
                        datatype=dt, n_sites=1)


# ---------------------------------------------------------------------------
# general substitution models
# ---------------------------------------------------------------------------


def _freq_model_of(ax, el, tag="frequencies"):
    """The frequency parameter's name from a <frequencies> or
    <rootFrequencies> child wrapping a frequencyModel (or a bare
    parameter); None without that child."""
    fq = el.find(tag)
    if fq is None:
        return None
    for c in fq:
        cc = ax.deref(c)
        if cc.tag == "frequencyModel":
            return ax.build(cc)
    return ax.param_from(fq)


def _complex_q_fn(rates_of, fname, k):
    """params -> Q [k, k] in the reference's complex ordering
    (models/substitution.py::general_complex_q, normalised to mean rate 1
    under pi); a K(K-1)/2 rate vector fills both triangles."""
    n_half = k * (k - 1) // 2

    def q_fn(params):
        r = rates_of(params)
        if r.shape[0] == n_half:
            r = torch.cat([r, r])
        return general_complex_q(r, params[fname])

    return q_fn


@register("generalSubstitutionModel", "svsGeneralSubstitutionModel")
def _general_substitution_model(ax: XmlAnalysis, el):
    """A reversible (K(K-1)/2 rates) or non-reversible (K(K-1)) general
    CTMC, with the BSSVS rateIndicator mask (GeneralSubstitutionModelParser,
    SVSGeneralSubstitutionModel)."""
    dt_obj = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "generalDataType":
            dt_obj = ax.build(cc)
    fname = _freq_model_of(ax, el)
    if fname is None:
        fname = _freq_model_of(ax, el, "rootFrequencies")
    if fname is None:
        raise XmlError("generalSubstitutionModel without frequencies")
    k = (dt_obj.state_count if dt_obj is not None
         else int(np.size(ax.value_of(fname))))
    rates_el = el.find("rates")
    if rates_el is None:
        raise XmlError("generalSubstitutionModel without rates")
    if rates_el.get("relativeTo"):
        raise Unsupported("generalSubstitutionModel relativeTo rates")
    rname = ax.param_from(rates_el)
    n_rates = int(np.size(ax.value_of(rname)))
    n_half = k * (k - 1) // 2
    if n_rates not in (n_half, 2 * n_half):
        raise XmlError(
            f"rates dimension {n_rates}, need {n_half} or {2 * n_half}")
    ind_el = el.find("rateIndicator")
    iname = ax.param_from(ind_el) if ind_el is not None else None

    def rates_of(params):
        r = params[rname].reshape(-1)
        if iname is not None:
            r = r * params[iname].reshape(-1)
        return r

    def freqs(params):
        f = params[fname]
        return f / torch.sum(f)

    if iname is not None:
        # the BSSVS bookkeeping of the connectivity prior
        ax._svs_models = getattr(ax, "_svs_models", {})
        ax._svs_models[el.get("id") or "svs"] = (rname, iname, k, n_rates)
    if n_rates == n_half and iname is None:
        from beast_mcmc_tpu_torch.models.substitution import (
            general_reversible_eigen,
        )

        return ("subst",
                lambda params: general_reversible_eigen(rates_of(params),
                                                        freqs(params)),
                freqs, k)
    return ("subst_q", _complex_q_fn(rates_of, fname, k), freqs, k)


def svs_connectivity_prior(ax, el_id: str) -> LikelihoodFn:
    """0 where the BSSVS indicators keep the rate graph connected, else
    -inf (SVSGeneralSubstitutionModel.getLogLikelihood():111-115;
    models/substitution.py::svs_connectivity_logprior). A reversible
    model's K(K-1)/2 indicators open both directions of an edge, so its
    graph is undirected; a non-reversible one must be strongly connected
    (connectedAndWellConditioned rejects a weakly connected
    configuration)."""
    _, iname, k, n_rates = ax._svs_models[el_id]
    n_half = k * (k - 1) // 2

    def fn(params, tree):
        ind = params[iname].reshape(-1)
        if n_rates == n_half:
            ind = torch.cat([ind, ind])
        return svs_connectivity_logprior(ind, k).to(ax.dtype)

    return LikelihoodFn(fn, None, f"{el_id}.connectivity")


@register("complexSubstitutionModel")
def _complex_substitution_model(ax: XmlAnalysis, el):
    """A non-reversible K(K-1)-rate CTMC on the expm path
    (ComplexSubstitutionModelParser)."""
    return _general_substitution_model(ax, el)


# ---------------------------------------------------------------------------
# sequence simulation
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


@register("beagleSequenceSimulator", "sequenceSimulator")
def _sequence_simulator(ax: XmlAnalysis, el):
    """An alignment simulated down the tree under each partition's
    substitution, site and clock models at the initial state, on the host
    with the analysis's numpy generator (BeagleSequenceSimulatorParser,
    SequenceSimulatorParser). The discrete-Gamma rates are the AS91 median
    rates, as the JAX package's eager start state has them."""
    from scipy.linalg import expm

    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state
    from beast_mcmc_tpu_torch.data.alignment import Alignment
    from beast_mcmc_tpu_torch.data.datatype import AMINO_ACIDS, NUCLEOTIDES

    parts = el.findall("partition")
    if not parts:
        # the legacy form (SequenceSimulatorParser): the element is one
        # partition with `replications` sites
        parts = [el]
    cols = []
    taxa_names = None
    datatype = None
    for part in parts:
        tm = site = clock = root_freq_name = None
        for c in part:
            cc = ax.deref(c)
            if cc.tag in ("treeModel", "starTreeModel"):
                tm = ax.build(cc)
            elif cc.tag in ("tree", "newick", "upgmaTree",
                            "neighborJoiningTree"):
                # a bare starting tree: a fixed TreeModel
                tid = cc.get("id") or "simtree"
                if tid in ax._trees:
                    tm = ax._trees[tid]
                else:
                    names, tips, par, ch, hts, root = ax.build(cc)
                    tm = TreeModel(tid, names, tips, par, ch, hts, root)
                    ax._trees[tid] = tm
            elif cc.tag == "siteModel":
                site = ax.build(cc)
            elif cc.tag == "frequencyModel":
                root_freq_name = ax.build(cc)
            elif cc.tag in ("strictClockBranchRates",
                            "discretizedBranchRates",
                            "arbitraryBranchRates"):
                clock = ax.build(cc)
            elif cc.tag.endswith("Model") or cc.tag.endswith("model"):
                try:
                    ax.build(cc)
                except Unsupported:
                    pass
        if site is None or tm is None:
            raise XmlError("simulator partition needs treeModel + siteModel")
        # the snapshot after the partition's models are built (they may
        # register parameters)
        params0, tree0 = initial_eval_state(ax)
        kind, eig_or_q, freqs_of = site[0], site[1], site[2]
        rates_weights = site[4]
        reps = _attr(part, "replications", None, int)
        if reps is not None:
            n_sites = reps
        else:
            frm = _attr(part, "from", 1, int)
            to = _attr(part, "to", frm, int)
            every = _attr(part, "every", 1, int)
            n_sites = max(1, (to - frm + 1) // every)

        tr = ax.resolve_tree(tm.tree_id, params0, tree0)
        heights = _host(tr.heights).astype(np.float64)
        parent = _host(tr.parent)
        root = int(_host(tr.root))
        m = parent.shape[0]
        n_tips = (m + 1) // 2

        # Q at the initial state: the eigen form reassembled, the q form
        # evaluated
        if kind == "site_q":
            q = _host(eig_or_q(params0)).astype(np.float64)
        else:
            eig = eig_or_q(params0)
            q = (_host(eig.U) @ np.diag(_host(eig.values))
                 @ _host(eig.U_inv)).astype(np.float64)
        r, w = rates_weights(params0, torch.float64, exact=True)
        r, w = _host(r).astype(np.float64), _host(w).astype(np.float64)
        pi0 = (np.ravel(_host(params0[root_freq_name])) if root_freq_name
               else _host(freqs_of(params0)))
        pi0 = pi0.astype(np.float64) / pi0.sum()
        br = (np.broadcast_to(np.ravel(_host(clock.rates(params0, tr))),
                              (m,)).astype(np.float64)
              if clock is not None else np.ones(m))

        rng = ax._rng
        cats = rng.choice(len(r), size=n_sites, p=w / w.sum())
        states = np.zeros((m, n_sites), np.int16)
        states[root] = rng.choice(len(pi0), size=n_sites, p=pi0)
        s_count = q.shape[0]
        for node in np.argsort(-heights):  # preorder: parents first
            if node == root:
                continue
            t = heights[parent[node]] - heights[node]
            for ci, rc in enumerate(r):
                pmat = np.clip(expm(q * max(t * br[node], 0.0) * rc), 0.0,
                               None)
                pmat /= pmat.sum(axis=1, keepdims=True)
                sel = np.where(cats == ci)[0]
                if sel.size == 0:
                    continue
                u = rng.random(sel.size)
                cdf = np.cumsum(pmat[states[parent[node], sel]], axis=1)
                states[node, sel] = (u[:, None] > cdf).sum(axis=1)
        cols.append(states[:n_tips])
        taxa_names = tm.taxa
        # the alignment's data type: a declared generalDataType of this
        # state count, else nucleotides or amino acids
        datatype = None
        for d_el in ax.root.iter("generalDataType"):
            cand = ax.build(d_el)
            if cand.state_count == s_count:
                datatype = cand
                break
        if datatype is None:
            datatype = {4: NUCLEOTIDES, 20: AMINO_ACIDS}.get(s_count)
        if datatype is None:
            raise Unsupported(f"simulator output alphabet ({s_count} states)")
    return Alignment(list(taxa_names),
                     np.concatenate(cols, axis=1).astype(np.int16), datatype)
