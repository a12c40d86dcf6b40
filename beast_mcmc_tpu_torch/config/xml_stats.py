"""XML vocabulary: statistics, report elements and the debug operator.

Counterpart of beast_mcmc_tpu/config/xml_stats.py, its registrations whose
inputs the port builds:

  - <parameterValues> (ParameterValuesReport.java);
  - <multiplicativeParameter> (MultiplicativeProcessTransform.java: the
    cumulative-product view; setting the view inverts it by successive
    ratios);
  - <fireParameterChanged value=...> (FireParameterOperatorParser.java:
    a debug operator that sets parameter values, always accepted);
  - <svdStatistic> (SVDStatistic.java);
  - <sequenceDistanceStatistic> (SequenceDistanceStatistic.java): the ML
    branch length (or its log-likelihood) between each putative taxon's
    sequence and the MAP root states, by scipy's bounded Brent search for
    the report and by a 1,024-point grid on the device for a log column;
  - <ancestralTrait> (AncestralTraitParser): the root's sampled state code;
  - <property> (PropertyParser): a named property (the mean, a trace
    analysis's correlation statistics);
  - <cladeRelationshipStatistic> (CladeRelationshipStatistic.java:105-128);
  - <blombergsK> (BlombergKStatistic.java:82-153), over a trait likelihood
    of config/xml_traits.py, on the host in float64 as in the JAX package;
  - <continuousDiffusionStatistic> and
    <traitDataContinuousDiffusionStatistic>: the dispersal rate, the sum
    of branch displacements (Euclidean, or great-circle on latitude and
    longitude) over the sum of branch times, of the conditional-mean node
    reconstruction, which a collector row shares with the traitLogger's
    columns (config/xml_traits.py::TraitLikelihood.conditional_means).

Statistics are read at the document's current state on the analysis's
device (`_current_state`, the derived parameters overlaid) and reported
in the reference's formats. <property name="wishartStatistics"> reads
config/xml_factor.py's statistic (its scale matrix, flattened).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Optional, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    DerivedParam,
    Param,
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    annotation_seed,
    register,
    register_operator,
)
from beast_mcmc_tpu_torch.inference.operators import Operator


def _current_state(ax: XmlAnalysis):
    """(params, tree) at the document's current values, the derived
    parameters injected."""
    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state

    params0, tree0 = initial_eval_state(ax)
    return ax.inject_derived(params0), tree0


# ---------------------------------------------------------------------------
# parameterValues / multiplicativeParameter / fireParameterChanged
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ValuesReport:
    name: str

    def report(self, ax) -> str:
        params, _ = _current_state(ax)
        vals = params[self.name].detach().reshape(-1).double().cpu().numpy()
        return " ".join(repr(float(v)) for v in vals) + " "


@register("parameterValues")
def _parameter_values(ax: XmlAnalysis, el):
    cc = ax.deref(next(iter(el)))
    obj = ax.build(cc)
    if isinstance(obj, (Param, DerivedParam)):
        return _ValuesReport(obj.name)
    return _ValuesReport(ax.param_from(cc))


def _successive_ratios(vals):
    """The inverse of the cumulative product: (v_0, v_1 / v_0, ...)."""
    vals = np.ravel(vals)
    return np.concatenate([vals[:1], vals[1:] / vals[:-1]])


@register("multiplicativeParameter")
def _multiplicative_parameter(ax: XmlAnalysis, el):
    name = el.get("id") or f"mult{len(ax._derived_params)}"
    inner = ax.param_from(next(iter(el)))

    def fn(params, _n=inner):
        return torch.cumprod(params[_n].reshape(-1), 0)

    ax._derived_params[name] = fn
    dp = DerivedParam(name, fn,
                      value=np.cumprod(np.ravel(ax.value_of(inner))),
                      base=inner)
    ax._params_views = getattr(ax, "_params_views", {})
    ax._params_views[name] = (inner, _successive_ratios)
    ax._built[id(el)] = dp
    return dp


@dataclasses.dataclass
class FireParameterOperator(Operator):
    """Sets parameter values (a debug move, always accepted): `values`, or
    the current values of `copy_from`, split across `targets` in order."""

    targets: Tuple[str, ...] = ()
    values: Tuple[float, ...] = ()
    copy_from: Optional[str] = None

    @property
    def modifies_params(self):
        return tuple(self.targets)

    def propose(self, params, tree, gen, tuning):
        if self.copy_from is not None:
            v = params[self.copy_from].reshape(-1)
        else:
            v = torch.as_tensor(self.values, dtype=tree.heights.dtype,
                                device=tree.heights.device)
        out, off = dict(params), 0
        for t in self.targets:
            old = params[t]
            n = old.numel()
            out[t] = v[off:off + n].to(old.dtype).reshape(old.shape)
            off += n
        return out, tree, torch.full((), float("inf"),
                                     dtype=tree.heights.dtype,
                                     device=tree.heights.device)


@register_operator("fireParameterChanged")
def _fire_parameter_changed(ax: XmlAnalysis, el, weight):
    values = None
    if el.get("value"):
        values = tuple(float(x) for x in el.get("value").split())
    copy_from = None
    cf = el.find("copyFrom")
    if cf is not None:
        inner_cf = ax.deref(next(iter(cf)))
        if inner_cf.tag in ("dataFromTreeTips", "dataAndMissingFromTreeTips"):
            copy_from = ax.build(inner_cf).trait_param
        else:
            copy_from = ax.param_from(inner_cf)
    targets = ()
    for c in el:
        cc = ax.deref(c)
        if c.tag == "copyFrom":
            continue
        if cc.tag in ("compoundParameter", "CompoundParameter"):
            targets = tuple(ax.build(cc).names)
            break
        if cc.tag in ("matrixParameter", "fastMatrixParameter",
                      "scaledMatrixParameter"):
            from beast_mcmc_tpu_torch.config.xml_hmc import matrix_param_of

            # flat values are column-major: one chunk a column parameter
            targets = tuple(matrix_param_of(ax, cc).names)
            break
        if cc.tag in ("parameter", "multiplicativeParameter"):
            obj = ax.build(cc)
            if isinstance(obj, DerivedParam):
                # firing on a transformed view sets the underlying values
                # through the view's inverse
                # (TransformedMultivariateParameter.setParameterValue)
                views = getattr(ax, "_params_views", {})
                if obj.name in views:
                    base, inv = views[obj.name]
                    if values is not None:
                        values = tuple(float(x) for x in inv(
                            np.asarray(values, np.float64)))
                    targets = (base,)
                else:
                    targets = (obj.base,)
            elif isinstance(obj, Param):
                targets = (obj.name,)
            break
    if not targets:
        raise XmlError("fireParameterChanged without a parameter")
    return FireParameterOperator(targets=targets, values=values or (),
                                 copy_from=copy_from, weight=weight), None


# ---------------------------------------------------------------------------
# svdStatistic
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _SvdReport:
    mp: object  # config/xml_hmc.py::MatrixParam
    name: str

    def _compute(self, ax):
        params, _ = _current_state(ax)
        mat = self.mp.fn(params).detach().double().cpu().numpy()  # (p, k)
        p, k = mat.shape
        u, s, _vt = np.linalg.svd(mat, full_matrices=False)
        # SVDStatistic.enforceConstraints: descending singular values, the
        # first element of each V row non-negative
        order = np.argsort(-s)
        s, u = s[order], u[:, order]
        v = u.T.copy()  # (k, p): the left singular vectors as rows
        for i in range(k):
            if v[i, 0] < 0:
                v[i] = -v[i]
        return s, v, p, k

    def report(self, ax) -> str:
        s, v, p, k = self._compute(ax)
        names = [f"{self.name}.sv{i + 1}" for i in range(k)] + [
            f"{self.name}.V{r + 1}{c + 1}"
            for r in range(k) for c in range(p)]
        vals = np.concatenate([s, np.ravel(v)])
        return (f"svdStatistic Report\n\n"
                f"dimension names: {' '.join(names)}\n\n"
                f"values: [ {', '.join(repr(float(x)) for x in vals)} ]\n\n")


@register("svdStatistic")
def _svd_statistic(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.config.xml_hmc import matrix_param_of

    return _SvdReport(matrix_param_of(ax, next(iter(el))),
                      el.get("id") or "svd")


# ---------------------------------------------------------------------------
# blombergsK
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _BlombergK:
    """Blomberg's K phylogenetic-signal statistic (BlombergKStatistic.java:
    82-153): L from V = L L^T, contrasts L^-1 (x - mu), expectedRatio =
    (tr V - n/|L^-1 1|^2)/(n - 1), K = (sum (x - mu)^2 / sum c^2) /
    expectedRatio, mu the GLS mean under V. The tree variance of the
    parse-time tree, on the host."""

    tid: str = ""
    trait_param: str = ""
    dim: int = 1
    name: str = "kstat"

    def _tree_variance(self, ax):
        tm = ax._trees[self.tid]
        parent = np.asarray(tm.parent)
        heights = np.asarray(tm.heights, float)
        root = int(tm.root)
        n_tips = (parent.shape[0] + 1) // 2

        def path(i):
            out = []
            while i != root:
                out.append(i)
                i = int(parent[i])
            return set(out)

        paths = [path(i) for i in range(n_tips)]
        v = np.zeros((n_tips, n_tips))
        for i in range(n_tips):
            for j in range(i, n_tips):
                v[i, j] = v[j, i] = sum(heights[int(parent[k])] - heights[k]
                                        for k in paths[i] & paths[j])
        return v, n_tips

    def values(self, ax):
        params, _ = _current_state(ax)
        v, n = self._tree_variance(ax)
        x_all = params[self.trait_param].detach().double().cpu().numpy() \
            .reshape((n, self.dim))
        l_inv = np.linalg.inv(np.linalg.cholesky(v))
        l_vec = l_inv @ np.ones(n)
        expected_ratio = (np.trace(v) - n / float(l_vec @ l_vec)) / (n - 1)
        v_inv = np.linalg.inv(v)
        ones = np.ones(n)
        ks = []
        for t in range(self.dim):
            x = x_all[:, t]
            mu = float(ones @ v_inv @ x) / float(ones @ v_inv @ ones)
            dv = x - mu
            c = l_inv @ dv
            ks.append(float(dv @ dv) / float(c @ c) / expected_ratio)
        return ks

    def report(self, ax) -> str:
        return "".join(f"{self.name}{t + 1}:  {float(k)!r}\n"
                       for t, k in enumerate(self.values(ax)))


@register("blombergsK")
def _blombergs_k(ax: XmlAnalysis, el):
    lik_el = ax.deref(next(iter(el)))
    ax.build(lik_el)
    tl = getattr(ax, "_trait_likelihoods", {}).get(lik_el.get("id"))
    if tl is None:
        raise Unsupported("blombergsK without a trait likelihood")
    return _BlombergK(tid=tl.tree_id, trait_param=tl.trait_param,
                      dim=tl.dim, name=el.get("id") or "kstat")


@register("continuousDiffusionStatistic",
          "traitDataContinuousDiffusionStatistic")
def _continuous_diffusion_statistic(ax: XmlAnalysis, el):
    """ContinuousDiffusionStatistic / TraitDataContinuousDiffusion
    Statistic: the dispersal rate sum dist_b / sum t_b over the branches
    of the conditional-mean node reconstruction; displacementScheme
    greatCircleDistance takes the haversine distance (km, Earth radius
    6371) on (latitude, longitude) traits in degrees."""
    import math

    from beast_mcmc_tpu_torch.config.xml_hmc import _trait_likelihood_of

    gcd = (el.get("greatCircleDistance", "false").lower() == "true"
           or el.get("displacementScheme", "linear")
           == "greatCircleDistance")
    tl = _trait_likelihood_of(ax, el)
    if tl is None or tl.channels is None:
        raise Unsupported("continuousDiffusionStatistic without trait "
                          "likelihood")

    def col_fn(s):
        means = tl.conditional_means(s)
        tree = ax.resolve_tree(tl.tree_id, s.params, s.tree)
        pidx = torch.clamp_min(tree.parent, 0)
        has_parent = tree.parent >= 0
        t_b = torch.where(has_parent, tree.heights[pidx] - tree.heights,
                          torch.zeros_like(tree.heights))
        if gcd:
            rad = math.pi / 180.0
            la1, lo1 = means[:, 0] * rad, means[:, 1] * rad
            la2, lo2 = means[pidx, 0] * rad, means[pidx, 1] * rad
            a = (torch.sin((la2 - la1) / 2) ** 2
                 + torch.cos(la1) * torch.cos(la2)
                 * torch.sin((lo2 - lo1) / 2) ** 2)
            dist = 6371.0 * 2 * torch.arcsin(torch.sqrt(torch.clamp(
                a, 0.0, 1.0)))
        else:
            dist = torch.sqrt(torch.sum((means - means[pidx]) ** 2, dim=1))
        mask = has_parent.to(t_b.dtype)
        return torch.sum(dist * mask) / torch.clamp_min(
            torch.sum(t_b * mask), 1e-30)

    nm = el.get("id") or "diffusionRate"

    class _Col:
        columns = [(nm, col_fn)]

        def report(self, ax_):
            from beast_mcmc_tpu_torch.config.interpreter import _StateShim

            return f"{float(col_fn(_StateShim(*_current_state(ax_))))!r}\n"

    return _Col()


# ---------------------------------------------------------------------------
# sequenceDistanceStatistic
# ---------------------------------------------------------------------------


def _tip_partials(codes: np.ndarray, k: int) -> np.ndarray:
    """[N, k, L] one-hot partials of state codes (an ambiguous code, >= k,
    is all ones)."""
    n, length = codes.shape
    tips = np.zeros((n, k, length))
    for i in range(n):
        for j in range(length):
            st = codes[i, j]
            if st < k:
                tips[i, st, j] = 1.0
            else:
                tips[i, :, j] = 1.0
    return tips


def _root_map_states(parts, params, tree, tree_states) -> torch.Tensor:
    """int64 [L]: the marginal MAP state of the root at each site, from the
    plain peel's partials over the tree likelihood's model."""
    from beast_mcmc_tpu_torch.models.treelikelihood import branch_lengths
    from beast_mcmc_tpu_torch.ops.eigen import transition_probs
    from beast_mcmc_tpu_torch.ops.expm import transition_probs_expm
    from beast_mcmc_tpu_torch.ops.peeling import (
        _peel_forward,
        peel_order_from_heights,
    )

    r, w = parts["rates_weights"](params, parts["dtype"])
    br = parts["clock"].rates(params, tree)
    t = (branch_lengths(tree.parent, tree.heights) * br)[:, None] * r[None, :]
    if parts["site_kind"] == "site_q":
        p_mats = transition_probs_expm(parts["eigen"](params), t)
    else:
        p_mats = transition_probs(parts["eigen"](params), t)
    n = tree_states.shape[0]
    tips = torch.as_tensor(_tip_partials(tree_states, p_mats.shape[-1]),
                           dtype=p_mats.dtype, device=p_mats.device)
    order = peel_order_from_heights(tree.heights, n, tree.parent)
    _, post = _peel_forward(tips, tree.children, order, tree.root, p_mats,
                            parts["freqs_of"](params), w)
    root_post = torch.einsum("c,csp,s->sp", w, post[tree.root],
                             parts["freqs_of"](params))
    return torch.argmax(root_post, dim=0)


@dataclasses.dataclass
class _SequenceDistance:
    """Per putative taxon, the ML CTMC branch length between its sequence
    and the MAP root states of the tree likelihood `asr_id`;
    reportDistance="likelihood" reports the optimised log-likelihood. The
    root states are the marginal MAP reconstruction (the reference's joint
    draw concentrates on the same states in the corpus files, which assert
    the optimised distances to 1e-6)."""

    asr_id: str = ""
    tree_states: np.ndarray = None  # (n_tree_taxa, L) tip state codes
    put_states: np.ndarray = None  # (T, L) putative taxa's codes
    put_names: Tuple[str, ...] = ()
    model: tuple = None  # ("subst" | "subst_q", fn, freqs_fn, k)
    kind: str = "distance"  # or "likelihood"
    name: str = "SDS"
    columns: list = None

    def values(self, ax):
        from scipy.linalg import expm
        from scipy.optimize import minimize_scalar

        from beast_mcmc_tpu_torch.tree.topology import make_tree_state

        params, _ = _current_state(ax)
        parts = ax._treelik_parts[self.asr_id]
        tm = parts["tm"]
        tree = make_tree_state(tm.parent, tm.children, tm.heights, tm.root,
                               torch.float64, ax.device)
        node_states = _root_map_states(parts, params, tree,
                                       self.tree_states).cpu().numpy()
        kind_tag, fn, freqs_fn, k = self.model

        def tpm_of(d):
            if kind_tag == "subst_q":
                return expm(fn(params).detach().double().cpu().numpy() * d)
            es = fn(params)
            u = es.U.detach().double().cpu().numpy()
            vals = es.values.detach().double().cpu().numpy()
            ui = es.U_inv.detach().double().cpu().numpy()
            return (u * np.exp(vals * d)[None, :]) @ ui

        pi = freqs_fn(params).detach().double().cpu().numpy()
        out = []
        for ts in self.put_states:
            def neg_lnl(d, ts=ts):
                tpm = np.maximum(tpm_of(max(d, 0.0)), 1e-300)
                lnl = 0.0
                for sidx in range(ts.shape[0]):
                    a, b2 = ts[sidx], node_states[sidx]
                    lnl += (np.log(tpm[a, b2]) if a < k
                            else np.log(float(pi @ tpm[:, b2])))
                return -lnl

            res = minimize_scalar(neg_lnl, bounds=(0.0, 10.0),
                                  method="bounded",
                                  options={"xatol": 1e-10})
            out.append(-res.fun if self.kind == "likelihood" else res.x)
        return out

    def report(self, ax) -> str:
        names = [f"{self.name}.{nm}" for nm in self.put_names]
        vs = ", ".join(repr(float(v)) for v in self.values(ax))
        return (f"sequenceDistanceStatistic Report\n\n"
                f"dimension names: {' '.join(names)}\n\n"
                f"values: [ {vs} ]\n\n")


@register("sequenceDistanceStatistic")
def _sequence_distance_statistic(ax: XmlAnalysis, el):
    asr_id = model = put = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("ancestralTreeLikelihood",
                      "markovJumpsTreeLikelihood"):
            ax.build(cc)
            asr_id = cc.get("id")
        elif cc.tag == "alignment":
            put = ax.build(cc)
        elif cc.tag.endswith("Model") or cc.tag in (
                "glmSubstitutionModel", "generalSubstitutionModel"):
            try:
                maybe = ax.build(cc)
            except (Unsupported, XmlError):
                continue
            if isinstance(maybe, tuple) and maybe[0] in ("subst", "subst_q"):
                model = maybe
    if asr_id is None or model is None or put is None:
        raise Unsupported("sequenceDistanceStatistic structure")
    tm = ax._treelik_parts[asr_id]["tm"]
    # the tree taxa's state codes from the alignment that holds them
    tree_aln = None
    for el2 in ax.root.iter("alignment"):
        obj2 = ax.build(el2)
        if hasattr(obj2, "taxa") and set(tm.taxa) <= set(obj2.taxa):
            tree_aln = obj2
            break
    if tree_aln is None:
        raise Unsupported("sequenceDistanceStatistic: no tree alignment")
    idx = [tree_aln.taxa.index(nm) for nm in tm.taxa]
    sds = _SequenceDistance(
        asr_id, np.asarray(tree_aln.states)[idx], np.asarray(put.states),
        tuple(put.taxa), model, el.get("reportDistance", "distance"),
        el.get("id") or "SDS")
    sds.columns = _sds_chain_columns(ax, sds)
    return sds


SDS_GRID = 1024  # branch lengths of a log column's grid search, on (0, 10]


def _sds_chain_columns(ax, sds: _SequenceDistance):
    """The log columns of the distance statistic: a grid search over the
    branch length on the device (a column needs about four digits; the
    report takes the Brent optimum)."""
    parts = ax._treelik_parts[sds.asr_id]
    kind_tag, fnm, freqs_fn, kk = sds.model

    def make_fn(t_i):
        def fn(s):
            params = ax.inject_derived(s.params)
            node_states = _root_map_states(parts, params, s.tree,
                                           sds.tree_states)
            dt, dev = s.tree.heights.dtype, s.tree.heights.device
            grid = torch.linspace(1e-6, 10.0, SDS_GRID, dtype=dt,
                                  device=dev)
            if kind_tag == "subst_q":
                pg = torch.linalg.matrix_exp(fnm(params)[None]
                                             * grid[:, None, None])
            else:
                es = fnm(params)
                pg = (es.U[None] * torch.exp(es.values[None]
                                             * grid[:, None])[:, None, :]
                      ) @ es.U_inv
            pg = torch.clamp_min(pg, 1e-300)
            ts = torch.as_tensor(sds.put_states[t_i], device=dev).long()
            amb = ts >= kk
            ts_c = torch.clamp_max(ts, kk - 1)
            site_l = torch.where(
                amb[None, :],
                torch.log(torch.einsum("s,gst->gt", freqs_fn(params),
                                       pg))[:, node_states],
                torch.log(pg[:, ts_c, node_states]))
            lnl = torch.sum(site_l, dim=1)  # [G]
            best = torch.argmax(lnl)
            return lnl[best] if sds.kind == "likelihood" else grid[best]

        return fn

    return [(f"{sds.name}.{nm}", make_fn(i))
            for i, nm in enumerate(sds.put_names)]


# ---------------------------------------------------------------------------
# ancestralTrait / property / cladeRelationshipStatistic
# ---------------------------------------------------------------------------


@register("ancestralTrait")
def _ancestral_trait(ax: XmlAnalysis, el):
    """AncestralTraitParser: the root's sampled state code of the first
    pattern's joint draw, a log column (the reference logs the sequence
    string). The draw comes from a generator of the column's own, seeded
    by the analysis's seed folded with the column's name."""
    rec = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("ancestralTreeLikelihood",
                      "markovJumpsTreeLikelihood"):
            ax.build(cc)
            rec = getattr(ax, "_ancestral_liks", {}).get(cc.get("id"))
    if rec is None:
        raise Unsupported("ancestralTrait without ancestral likelihood")
    name = el.get("name", "ancestralTrait")
    gens = {}

    def col_fn(s):
        tr = ax.resolve_tree(rec["tree_id"], s.params, s.tree)
        dev = tr.heights.device
        if dev not in gens:
            gens[dev] = torch.Generator(device=dev).manual_seed(
                annotation_seed(ax.seed, f"ancestralTrait:{name}"))
        states = rec["states_fn"](ax.inject_derived(s.params), tr, gens[dev])
        return states[tr.root].to(tr.heights.dtype)

    class _Column:
        columns = [(name, col_fn)]

    return _Column()


@register("property")
def _property_report(ax: XmlAnalysis, el):
    """PropertyParser: a named property of an object, reported (the
    old-versus-new tester files read a trace analysis's column means and
    correlation statistics this way)."""
    name = el.get("name")
    index = _attr(el, "index", None, int)

    def inner_value(ax_):
        inner = next(iter(el))
        if inner.tag == "object":
            return ax_.deref(inner)  # the target element itself
        cc = ax_.deref(inner)
        if cc.tag == "property":
            # nested: the inner property resolves first (correlation
            # statistics of a trace analysis, then their mean)
            return ax_.build(cc).resolve(ax_)
        return ax_.build(cc)

    def value(ax_, val):
        if name == "mean" and not isinstance(val, ET.Element):
            return float(np.mean(np.asarray(val, float)))
        if (name == "correlationStatistics" and isinstance(val, ET.Element)
                and val.tag == "traceAnalysis"):
            from beast_mcmc_tpu_torch.config.xml_mle import _read_log

            names, rows = _read_log(ax_, val.get("fileName"))
            data_cols = [i for i, nm in enumerate(names)
                         if nm.lower() not in ("state", "states")]
            return rows[:, data_cols[index or 0]]
        if name == "wishartStatistics":
            if isinstance(val, ET.Element):
                val = ax_.build(val)  # config/xml_factor.py's
            return np.ravel(val.scale_matrix(ax_))
        if name == "mean":
            return float(np.mean(np.asarray(val, float)))
        raise Unsupported(f"property {name!r}")

    class _Prop:
        def report(self, ax_):
            v = value(ax_, inner_value(ax_))
            if np.ndim(v) == 0:
                return f"{float(v)!r}\n"
            arr = np.ravel(np.asarray(v, float))
            return "[" + ", ".join(str(float(x)) for x in arr) + "]\n"

        def resolve(self, ax_):
            return value(ax_, inner_value(ax_))

    return _Prop()


@register("cladeRelationshipStatistic")
def _clade_relationship_statistic(ax: XmlAnalysis, el):
    """CladeRelationshipStatistic.java:105-128: 1.0 iff taxaA's MRCA is
    sister to taxaB's ('sister'), or iff A's MRCA lies inside B's clade
    ('aInB'), on the tree at parse time."""
    rel = el.get("relationshipType", "sister")
    tree_id, sets = None, {}
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tree_id = ax.build(cc).tree_id
        elif cc.tag in ("taxaA", "taxaB"):
            sets[cc.tag] = [t_el.get("idref") or t_el.get("id")
                            for t_el in cc.iter("taxon")]
    tm = ax._trees[tree_id]
    parent = np.asarray(tm.parent)
    heights = np.asarray(tm.heights, float)
    root = int(tm.root)

    def mrca(tips):
        common = None
        for t in tips:
            path = [t]
            while path[-1] != root:
                path.append(int(parent[path[-1]]))
            common = set(path) if common is None else common & set(path)
        return min(common, key=lambda nd: heights[nd])

    m_a = mrca([tm.taxa.index(nm) for nm in sets["taxaA"]])
    m_b = mrca([tm.taxa.index(nm) for nm in sets["taxaB"]])
    sister = (m_a != root and m_b != root
              and int(parent[m_a]) == int(parent[m_b]))
    a_in_b = (not sister) and mrca([m_a, m_b]) == m_b
    val = 1.0 if (sister if rel == "sister" else a_in_b) else 0.0
    nm = el.get("id") or "cladeRelationship"

    class _Relationship:
        def report(self, ax_):
            return f"{nm}: {val!r}\n"

        columns = [(nm, lambda s: torch.tensor(val, dtype=ax.dtype,
                                               device=ax.device))]

    return _Relationship()
