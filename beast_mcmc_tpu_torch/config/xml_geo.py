"""XML vocabulary of discrete phylogeography: general data types,
attribute patterns, general, log-rate and GLM substitution models, the
structured coalescent, and sequence simulation.

Counterpart of beast_mcmc_tpu/config/xml_geo.py, whole:

  generalDataType             (GeneralDataTypeParser:45)
  attributePatterns           (AttributePatternsParser)
  generalSubstitutionModel    (GeneralSubstitutionModelParser.java:47)
  svsGeneralSubstitutionModel (the same parser's BSSVS branch; its
                              indicator-connectivity prior is
                              svs_connectivity_prior, added where the
                              model sits in a <prior>)
  complexSubstitutionModel    (ComplexSubstitutionModelParser)
  logRateSubstitutionModel    (LogRateSubstitutionModelParser)
  glmModel, glmSubstitutionModel, glmSubstitutionModelGradient
                              (GeneralizedLinearModelParser,
                              GLMSubstitutionModelParser,
                              GlmSubstitutionModelGradientParser)
  instantaneousMixtureSubstitutionModel, stateSet,
  stronglyLumpableCtmcRates, approximateLogCtmcRateGradient
  structuredCoalescent, timeVaryingFrequencies, tipStateOperator,
  structuredCoalescentLikelihoodGradient (BASTA: models/basta.py)
  beagleSequenceSimulator, sequenceSimulator
                              (BeagleSequenceSimulatorParser,
                              SequenceSimulatorParser)

A reversible model is ("subst", eigen, freqs, K); a non-reversible, BSSVS,
log-rate or GLM one ("subst_q", q_fn, freqs, K), its Q [K, K] built on the
params' device. The GLM gradient element reports the interpreter's
first-order surrogate (`_surrogate_liks`), as the reference's provider
does. The simulator runs on the host in numpy with scipy's expm on the
analysis's numpy generator (`_rng`), drawing the same numbers in the same
order as the JAX package's: the categories, the root states, then one
uniform a site of a node's category in preorder. So a document gives the
JAX package's alignment state for state.
"""

from __future__ import annotations

import math
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
    register_operator,
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


def _complex_q_fn(rates_of, fname, k, normalize=True,
                  scale_by_freqs=True):
    """params -> Q [k, k] in the reference's complex ordering
    (models/substitution.py::general_complex_q, normalised to mean rate 1
    under pi unless normalize is false); a K(K-1)/2 rate vector fills
    both triangles."""
    n_half = k * (k - 1) // 2

    def q_fn(params):
        r = rates_of(params)
        if r.shape[0] == n_half:
            r = torch.cat([r, r])
        return general_complex_q(r, params[fname], normalize,
                                 scale_by_freqs)

    return q_fn


def _freqs_of(fname):
    """params -> the normalised frequencies of parameter fname."""
    def freqs(params):
        f = params[fname]
        return f / torch.sum(f)

    return freqs


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

    freqs = _freqs_of(fname)

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


def _q_of(model, params):
    """The generator of a ("subst", eigen, ...) or ("subst_q", q, ...)
    model at params."""
    if model[0] == "subst_q":
        return model[1](params)
    es = model[1](params)
    return es.U @ (es.values[..., None] * es.U_inv)


@register("logRateSubstitutionModel")
def _log_rate_substitution_model(ax: XmlAnalysis, el):
    """LogRateSubstitutionModelParser: rates exp(logRates) in the complex
    order, with the normalize and scaleRatesByFrequencies attributes; or
    the real-space rates of a <rateProvider>
    (LogRateSubstitutionModel.setupRelativeRates:69-71)."""
    from beast_mcmc_tpu_torch.config.interpreter import Param

    fname = _freq_model_of(ax, el, "rootFrequencies")
    if fname is None:
        fname = _freq_model_of(ax, el)
    if fname is None:
        raise XmlError("logRateSubstitutionModel without rootFrequencies")
    k = int(np.size(ax.value_of(fname)))
    normalize = _attr(el, "normalize", True, bool)
    scale_by = _attr(el, "scaleRatesByFrequencies", True, bool)
    lr = el.find("logRates")
    if lr is None:
        rp = el.find("rateProvider")
        if rp is None:
            raise XmlError("logRateSubstitutionModel without logRates")
        provider = ax.build(ax.deref(next(iter(rp))))
        return ("subst_q", _complex_q_fn(provider.rates, fname, k,
                                         normalize, scale_by),
                _freqs_of(fname), k)
    lname = ax.param_from(lr)
    if int(np.size(ax.value_of(lname))) != k * (k - 1):
        # the reference sizes the parameter from the data type
        p = ax._params[lname]
        ax._params[lname] = Param(
            lname, np.resize(np.atleast_1d(p.value), k * (k - 1)),
            p.lower, p.upper)

    def rates_of(params):
        return torch.exp(params[lname].reshape(-1))

    return ("subst_q", _complex_q_fn(rates_of, fname, k, normalize,
                                     scale_by), _freqs_of(fname), k)


# ---------------------------------------------------------------------------
# GLM substitution models
# ---------------------------------------------------------------------------


@register("glmModel")
def _glm_model(ax: XmlAnalysis, el):
    """GeneralizedLinearModelParser. family logLinear (the default): the
    rate builder ("glm", (design [R, P], column names), coefficient names,
    indicator name) of a GLM substitution model, a scalar coefficient
    expanded to its block's columns (GeneralizedLinearModel.
    addIndependentParameter) and each design column live (a
    build="true" maskedParameter fills and samples NA covariates,
    MaskedParameterParser.java:60-86) or static (a mixture model's
    columns, snapshotted at parse, name None). family logNormal: the
    regression likelihood of the dependent variables, log y ~ N(X beta,
    1 / tau) with the indicator-masked coefficients and the scaleVariables
    precision (JAX writes it inline, config/xml_geo.py:425-452)."""
    from beast_mcmc_tpu_torch.config.interpreter import (
        CompoundParam,
        _text_values,
    )

    family = el.get("family") or "logLinear"
    if family not in ("logLinear", "logNormal"):
        raise Unsupported(f"glmModel family {family!r}")
    blocks = el.findall("independentVariables")
    if not blocks:
        raise XmlError("glmModel without independentVariables")
    design_cols, design_names, coefs = [], [], []
    ind = None
    for iv in blocks:
        block_start = len(design_cols)
        coef = None
        for c in iv:
            cc = ax.deref(c)
            if cc.tag == "parameter":
                obj = ax.build(cc)
                coef = obj.name if hasattr(obj, "name") else coef
            elif cc.tag == "designMatrix":
                for p in cc:
                    pp = ax.deref(p)
                    if pp.tag == "parameter":
                        design_names.append(ax.param_from(pp))
                        design_cols.append(_text_values(pp))
            elif cc.tag in ("aminoAcidMixtureModel",
                            "substitutionRateMatrixMixtureModel"):
                # AminoAcidMixture.java:50-66, SubstitutionRateMatrixMixture
                # .java:50-84: one static column a component,
                # [log q_ij - log f_j]_{i<j} then [log q_ji - log f_i]_{i<j}
                # (an empirical amino-acid model's log exchangeabilities
                # in both halves)
                for sm in cc:
                    ss = ax.deref(sm)
                    if ss.tag in ("aminoAcidModel", "empiricalAminoAcidModel"):
                        from beast_mcmc_tpu_torch.models.data.aa_matrices \
                            import AA_MODELS

                        col = np.log(np.asarray(
                            AA_MODELS[ss.get("type").upper()]["rates"],
                            float))
                        design_cols.append(np.concatenate([col, col]))
                        design_names.append(None)
                        continue
                    obj = ax.build(ss)
                    if not (isinstance(obj, tuple) and obj[0] == "subst"):
                        raise Unsupported(f"mixture component <{ss.tag}>")
                    p0 = {p.name: ax.tensor(p.value)
                          for p in ax._params.values()}
                    q0 = _host(_q_of(obj, p0)).astype(float)
                    f0 = _host(obj[2](p0)).astype(float)
                    iu = np.triu_indices(obj[3], 1)
                    design_cols.append(np.concatenate([
                        np.log(q0[iu]) - np.log(f0[iu[1]]),
                        np.log(q0[(iu[1], iu[0])]) - np.log(f0[iu[0]])]))
                    design_names.append(None)
            elif cc.tag == "indicator":
                ind = ax.param_from(cc)
        n_b = len(design_cols) - block_start
        if coef is None or n_b == 0:
            raise XmlError("glmModel needs coefficients + designMatrix")
        if coef in ax._params:
            pv = np.ravel(ax._params[coef].value)
            if pv.size == 1 and n_b > 1:
                ax._params[coef].value = np.full(n_b, pv[0])
        coefs.append(coef)
    design = np.stack(design_cols, axis=1)  # [R, P]
    if family == "logLinear":
        return ("glm", (design, tuple(design_names)), tuple(coefs), ind)
    dv = el.find("dependentVariables")
    if dv is None:
        raise XmlError("glmModel logNormal without dependentVariables")
    dep_obj = ax.build(ax.deref(next(iter(dv))))
    dep_names = (tuple(dep_obj.names) if isinstance(dep_obj, CompoundParam)
                 else (dep_obj.name,))
    sv = el.find("scaleVariables")
    prec_name = ax.param_from(sv) if sv is not None else None
    design_t = ax.tensor(design)

    def fn(params, tree):
        y = torch.cat([params[n].reshape(-1) for n in dep_names])
        beta = torch.cat([params[c].reshape(-1) for c in coefs])
        if ind is not None:
            beta = beta * params[ind].reshape(-1)
        mu = design_t.to(y.dtype) @ beta.to(y.dtype)
        tau = (params[prec_name].reshape(-1)[0] if prec_name
               else torch.ones((), dtype=y.dtype, device=y.device))
        ly = torch.log(y)
        return torch.sum(0.5 * torch.log(tau) - 0.5 * math.log(2 * math.pi)
                         - ly - 0.5 * tau * (ly - mu) ** 2)

    return LikelihoodFn(fn, None, el.get("id") or "glmModel", dep_names)


@register("instantaneousMixtureSubstitutionModel")
def _instantaneous_mixture_subst(ax: XmlAnalysis, el):
    """InstantaneousMixtureSubstitutionModel.java:90-192: relative rates
    the geometric mixture exp(sum_m w_m log r_m) of the components' (upper
    then transposed lower order); a scalar weight is (p, 1 - p). A
    component's raw rates differ from q_ij / f_j by a global scale, which
    the normalisation cancels."""
    w_name = fname = None
    comps = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "mixtureWeights":
            w_name = ax.param_from(cc)
        elif cc.tag == "rootFrequencies":
            continue
        else:
            try:
                obj = ax.build(cc)
            except (Unsupported, XmlError):
                continue
            if isinstance(obj, tuple) and obj[0] in ("subst", "subst_q"):
                comps.append(obj)
    fname = _freq_model_of(ax, el, "rootFrequencies")
    if w_name is None or not comps or fname is None:
        raise XmlError("instantaneousMixtureSubstitutionModel structure")
    k = int(np.size(ax.value_of(fname)))
    iu = np.triu_indices(k, 1)

    def comp_log_rates(obj, params):
        q, f = _q_of(obj, params), obj[2](params)
        upper = q[iu] / f[iu[1]]
        lower = q[(iu[1], iu[0])] / f[iu[0]]
        return torch.log(torch.cat([upper, lower]))

    def rates_of(params):
        w = params[w_name].reshape(-1)
        if w.shape[0] == 1 and len(comps) == 2:
            w = torch.cat([w, 1.0 - w])
        logr = torch.stack([comp_log_rates(o, params) for o in comps])
        return torch.exp(torch.einsum("m,mr->r", w.to(logr.dtype), logr))

    return ("subst_q", _complex_q_fn(rates_of, fname, k), _freqs_of(fname),
            k)


@register("glmSubstitutionModel", "oldGLMSubstitutionModel")
def _glm_substitution_model(ax: XmlAnalysis, el):
    """GLMSubstitutionModelParser: a CTMC whose off-diagonal rates are
    exp(X beta) in the complex order (upper, then transposed lower), its
    root frequencies the frequencyModel's."""
    dt_obj = glm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "generalDataType":
            dt_obj = ax.build(cc)
        elif cc.tag == "glmModel":
            glm = ax.build(cc)
    fname = _freq_model_of(ax, el, "rootFrequencies")
    if fname is None:
        fname = _freq_model_of(ax, el)
    if fname is None or glm is None:
        raise XmlError("glmSubstitutionModel needs rootFrequencies+glmModel")
    k = (dt_obj.state_count if dt_obj is not None
         else int(np.size(ax.value_of(fname))))
    _, (design, design_names), coefs, ind = glm
    normalize = _attr(el, "normalize", True, bool)
    n_rates = design.shape[0]
    design0 = ax.tensor(design)

    def rates_of(params):
        beta = torch.cat([params[c].reshape(-1) for c in coefs])
        if ind is not None:
            beta = beta * params[ind].reshape(-1)
        # a live column reads its parameter; a static one (name None) the
        # parse-time design
        cols = [params[n].reshape(-1)[:n_rates].to(beta.dtype)
                if n is not None else design0[:, i].to(beta.dtype)
                for i, n in enumerate(design_names)]
        return torch.exp(torch.stack(cols, dim=1) @ beta)

    out = ("subst_q", _complex_q_fn(rates_of, fname, k, normalize, True),
           _freqs_of(fname), k)
    ax._glm_subst = getattr(ax, "_glm_subst", {})
    ax._glm_subst[el.get("id") or "glm"] = (out, coefs)
    return out


@register("glmSubstitutionModelGradient", "substitutionGeneratorGradient")
def _glm_substitution_gradient(ax: XmlAnalysis, el):
    """GlmSubstitutionModelGradientParser: the tree likelihood's gradient
    in the GLM coefficients as the reference provider reports it, the
    first-order generator surrogate (the interpreter's
    `_surrogate_liks`). An HMC operator that names it steps on the exact
    posterior's gradient all the same (config/xml_hmc.py)."""
    from beast_mcmc_tpu_torch.config.xml_hmc import GradientSpec

    lik = coef = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("treeDataLikelihood", "treeLikelihood"):
            lik = ax.build(cc)
            sur = getattr(ax, "_surrogate_liks", {}).get(cc.get("id"))
            if sur is not None:
                lik = sur
        elif cc.tag == "glmSubstitutionModel":
            ax.build(cc)
            _, coef = getattr(ax, "_glm_subst", {}).get(
                cc.get("id") or "glm", (None, None))
    if lik is None or coef is None:
        raise XmlError(
            "glmSubstitutionModelGradient needs likelihood + glm model")
    return GradientSpec(tuple(coef), (lik,))


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


# ---------------------------------------------------------------------------
# the structured coalescent (BASTA)
# ---------------------------------------------------------------------------


@register("structuredCoalescent")
def _structured_coalescent(ax: XmlAnalysis, el):
    """StructuredCoalescentLikelihood type="BASTA": the approximate
    structured-coalescent density of the tree and its tip demes under a
    migration matrix (the substitution model's Q times the strict clock's
    rate) and the demes' population sizes (models/basta.py). One tip's deme
    may be sampled (<timeVaryingFrequencies>, <tipStateOperator>): the
    closure reads ax._sampled_tip_state when it is called, so the order of
    registration does not matter."""
    from beast_mcmc_tpu_torch.models.basta import basta_loglikelihood

    patterns = tm = subst = clock = pops = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("attributePatterns", "patterns"):
            patterns = ax.build(cc)
        elif cc.tag in ("treeModel", "starTreeModel"):
            tm = ax.build(cc)
        elif cc.tag in ("generalSubstitutionModel", "glmSubstitutionModel",
                        "complexSubstitutionModel",
                        "svsGeneralSubstitutionModel"):
            subst = ax.build(cc)
        elif cc.tag == "strictClockBranchRates":
            clock = ax.build(cc)
        elif cc.tag == "parameter":
            pops = ax.param_from(cc)
    if patterns is None or tm is None or subst is None or pops is None:
        raise XmlError("structuredCoalescent needs patterns + treeModel + "
                       "substitutionModel + popSizes")
    k = subst[3]
    # the tips' deme rows (an ambiguity code spreads the mass)
    amb = patterns.datatype.ambiguity_table()
    tip_rows = amb[np.ravel(np.asarray(patterns.states))[:len(tm.taxa)]]
    tip_rows = tip_rows / tip_rows.sum(axis=1, keepdims=True)
    tip_rows_t = ax.tensor(tip_rows)
    lid = el.get("id") or "structuredCoalescent"
    rate_param = getattr(clock, "rate_param", None) if clock else None

    def fn(params, tree):
        dt = tree.heights.dtype
        q = _q_of(subst, params).to(dt)
        if rate_param is not None:
            q = q * params[rate_param].reshape(()).to(dt)
        tip_p = tip_rows_t.to(dt)
        sts = getattr(ax, "_sampled_tip_state", {}).get(lid)
        if sts is not None:
            tip_idx, pname, _ = sts
            state = torch.clamp(torch.round(params[pname].reshape(())), 0,
                                k - 1).long()
            tip_p = tip_p.index_copy(
                0, torch.tensor([tip_idx], device=tip_p.device),
                torch.nn.functional.one_hot(state, k).to(dt)[None])
        return basta_loglikelihood(tip_p, tree.parent, tree.children,
                                   tree.heights, q,
                                   params[pops].reshape(-1).to(dt))

    return LikelihoodFn(fn, tm.tree_id, lid, (pops,))


@register("timeVaryingFrequencies", "timeVaryingFrequences")
def _time_varying_frequencies(ax: XmlAnalysis, el):
    """TimeVaryingFrequenciesModel:116-150: a prior on one taxon's sampled
    tip state, log p[state]. The state parameter is registered here and
    read by the structuredCoalescent closure and the <tipStateOperator>."""
    from beast_mcmc_tpu_torch.config.interpreter import Param

    taxon = lik_id = dt_obj = probs_name = tid = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "taxon":
            taxon = cc.get("id") or cc.get("idref")
        elif cc.tag == "structuredCoalescent":
            lik_id = cc.get("id") or "structuredCoalescent"
        elif cc.tag == "generalDataType":
            dt_obj = ax.build(cc)
        elif cc.tag == "parameter":
            probs_name = ax.param_from(cc)
        elif cc.tag in ("treeModel", "starTreeModel"):
            tid = ax.build(cc).tree_id
    if taxon is None or lik_id is None or probs_name is None:
        raise XmlError("timeVaryingFrequencies structure")
    k = (dt_obj.state_count if dt_obj
         else int(np.size(ax.value_of(probs_name))))
    tm = ax._trees[tid] if tid else None
    tip_idx = tm.taxa.index(taxon) if tm else 0
    sname = f"tipState.{taxon}"
    if sname not in ax._params:
        ax._params[sname] = Param(sname, np.asarray(0.0))
    ax._sampled_tip_state = getattr(ax, "_sampled_tip_state", {})
    ax._sampled_tip_state[lik_id] = (tip_idx, sname, k)
    ax._tip_state_params = getattr(ax, "_tip_state_params", {})
    ax._tip_state_params[el.get("id") or "tvf"] = (sname, k)

    def fn(params, tree):
        p = params[probs_name].reshape(-1).to(tree.heights.dtype)
        p = p / torch.sum(p)
        state = torch.clamp(torch.round(params[sname].reshape(())), 0,
                            k - 1).long()
        return torch.log(p[state])

    return LikelihoodFn(fn, tid, el.get("id") or "tvf", (sname, probs_name))


@register_operator("tipStateOperator")
def _tip_state_operator(ax: XmlAnalysis, el, weight):
    """TipStateOperator: a uniform redraw of the sampled tip state
    (symmetric; the timeVaryingFrequencies prior and the structured
    coalescent weigh its acceptance)."""
    from beast_mcmc_tpu_torch.inference.operators import (
        UniformIntegerOperator,
    )

    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("timeVaryingFrequencies", "timeVaryingFrequences"):
            ax.build(cc)
            sname, k = ax._tip_state_params[cc.get("id") or "tvf"]
            return UniformIntegerOperator(parameter=sname, lower=0,
                                          upper=k - 1, weight=weight), None
    raise XmlError("tipStateOperator without timeVaryingFrequencies")


@register("structuredCoalescentLikelihoodGradient")
def _structured_coalescent_gradient(ax: XmlAnalysis, el):
    """BastaLikelihoodGradient: the BASTA density's gradient in the
    population sizes or the migration rates (the substitution model's
    rates, or its GLM coefficients)."""
    from beast_mcmc_tpu_torch.config.xml_hmc import GradientSpec

    wrt = el.get("wrtParameter", "migrationRate")
    lik = subst_el = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "structuredCoalescent":
            lik = ax.build(cc)
        elif cc.tag in ("glmSubstitutionModel", "generalSubstitutionModel"):
            subst_el = cc
    if lik is None:
        raise XmlError("structuredCoalescentLikelihoodGradient structure")
    if wrt == "populationSize":
        return GradientSpec(tuple(lik.data_params), (lik,))
    names = []
    if subst_el is not None:
        glm = getattr(ax, "_glm_subst", {}).get(subst_el.get("id") or "glm")
        if glm is not None:
            names.extend(glm[1])
        else:
            r_el = subst_el.find("rates")
            if r_el is not None:
                names.append(ax.param_from(r_el))
    if not names:
        return GradientSpec(tuple(lik.data_params), (lik,))
    return GradientSpec(tuple(names), (lik,))


# ---------------------------------------------------------------------------
# strongly lumpable CTMC rates (StronglyLumpableCtmcRates.java)
# ---------------------------------------------------------------------------


def _lump_build_map(n: int) -> np.ndarray:
    """StronglyLumpableCtmcRates.buildMap: the upper triangle numbered
    row-major first, then the lower triangle column-major; -1 on the
    diagonal."""
    m = -np.ones((n, n), int)
    off = 0
    for i in range(n):
        for j in range(i + 1, n):
            m[i, j] = off
            off += 1
    for j in range(n):
        for i in range(j + 1, n):
            m[i, j] = off
            off += 1
    return m


@register("stateSet")
def _state_set(ax: XmlAnalysis, el):
    """StateSetParser: a named subset of a generalDataType's states."""
    dt_obj, states = None, []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "generalDataType":
            dt_obj = ax.build(cc)
        elif cc.tag == "state":
            states.append(dt_obj.char_map[cc.get("code").upper()])
    return ("stateSet", tuple(states))


class _LumpableRates:
    """A rate provider whose K(K-1) rates (complex order) gather the
    within-lump rate parameters and the across-lump rate x proportion
    products (StronglyLumpableCtmcRates SuperInfo.getRate:419-430)."""

    def __init__(self, specs, k):
        self.specs = specs
        self.k = k

    def rates(self, params):
        vals = []
        for s in self.specs:
            if s[0] == "within":
                _, name, idx = s
                vals.append(params[name].reshape(-1)[idx])
            else:
                _, pname, pidx, aname, aidx = s
                vals.append(params[pname].reshape(-1)[pidx]
                            * params[aname].reshape(-1)[aidx])
        return torch.stack(vals)

    def report(self, ax) -> str:
        from beast_mcmc_tpu_torch.config.xml_assert import _vec
        from beast_mcmc_tpu_torch.config.xml_stats import _current_state

        p0, _ = _current_state(ax)
        return _vec(_host(self.rates(p0))) + "\n"


@register("stronglyLumpableCtmcRates")
def _strongly_lumpable_rates(ax: XmlAnalysis, el):
    dt_obj = across_name = None
    lumps = []  # (declared states, within-rates name, [(state, name)])
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "generalDataType":
            dt_obj = ax.build(cc)
        elif cc.tag == "rates":
            across_name = ax.param_from(cc)
        elif cc.tag == "lump":
            states, wr, props = None, None, []
            for d in cc:
                dd = ax.deref(d)
                if dd.tag == "stateSet":
                    states = ax.build(dd)[1]
                elif dd.tag == "rates":
                    wr = ax.param_from(dd)
                elif dd.tag == "proportions":
                    src = pn = None
                    for e in dd:
                        ee = ax.deref(e)
                        if ee.tag == "state":
                            src = dt_obj.char_map[ee.get("code").upper()]
                        elif ee.tag == "parameter":
                            pn = ax.param_from(ee)
                    props.append((src, pn))
            lumps.append((tuple(states), wr, props))
    if dt_obj is None or across_name is None:
        raise XmlError("stronglyLumpableCtmcRates structure")
    k = dt_obj.state_count
    n_lumps = len(lumps)
    lump_map = _lump_build_map(n_lumps)

    def lump_index(state):
        """(lump, index in the sorted lump, declared index, lump size)."""
        for a, (declared, _, _) in enumerate(lumps):
            if state in declared:
                srt = sorted(declared)
                return (a, srt.index(state), declared.index(state),
                        len(declared))
        raise XmlError(f"state {state} in no lump")

    def super_spec(i, j):
        a, ii, io, ca = lump_index(i)
        b, jj, _, _ = lump_index(j)
        if a == b:
            return ("within", lumps[a][1], int(_lump_build_map(ca)[ii, jj]))
        prop_index = b if a < b else b + 1
        pname = lumps[a][2][io * (n_lumps - 1) + prop_index - 1][1]
        return ("across", pname, jj, across_name, int(lump_map[a, b]))

    specs = [super_spec(i, j) for i in range(k) for j in range(i + 1, k)]
    specs += [super_spec(i, j) for j in range(k) for i in range(j + 1, k)]
    return _LumpableRates(tuple(specs), k)


@register("approximateLogCtmcRateGradient", "logCtmcRateGradient")
def _approx_log_ctmc_rate_gradient(ax: XmlAnalysis, el):
    """ApproximateLogCtmcRateGradientParser, LumpableCtmcRateGradient: the
    discrete-trait likelihood's gradient in the rate parameters of its
    lumpable or log-additive generator, exact by torch.autograd through
    the expm path (the reference's linear-in-time form is its shortcut),
    as JAX's jax.grad."""
    from beast_mcmc_tpu_torch.config.interpreter import CompoundParam
    from beast_mcmc_tpu_torch.config.xml_hmc import GradientSpec

    lik, names = None, []
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("treeDataLikelihood", "treeLikelihood",
                      "ancestralTreeLikelihood"):
            lik = ax.build(cc)
        elif cc.tag in ("compoundParameter", "parameter"):
            obj = ax.build(cc)
            if isinstance(obj, CompoundParam):
                names.extend(obj.names)
            else:
                names.append(obj.name)
    if lik is None or not names:
        raise XmlError("approximateLogCtmcRateGradient structure")
    return GradientSpec(tuple(names), (lik,))


def _log_rate_subst_report(ax, el):
    """The generator's report (LogRateSubstitutionModel inherits
    ComplexSubstitutionModel.getReport: the infinitesimal matrix)."""
    from beast_mcmc_tpu_torch.config.xml_stats import _current_state

    kind = ax.build(el)
    p0, _ = _current_state(ax)
    q = _host(kind[1](p0))
    rows = "\n".join(" ".join(str(v) for v in r) for r in q)
    return f"Infinitesimal rate matrix:\n{rows}\n"


def _register_reports():
    from beast_mcmc_tpu_torch.config.xml_hmc import OP_REPORTS

    OP_REPORTS["logRateSubstitutionModel"] = _log_rate_subst_report


_register_reports()
