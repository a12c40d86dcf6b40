"""XML vocabulary: the marginal-likelihood estimation pipeline.

Counterpart of beast_mcmc_tpu/config/xml_mle.py, every registration of it:

  - <normalReferencePrior> and <logTransformedNormalReferencePrior>
    (WorkingPriorParsers.java): working priors fitted to an earlier
    chain's log file, a normal on the value or on its log;
  - <marginalLikelihoodEstimator> (MarginalLikelihoodEstimator.java:
    55-185): one tempered chain a path step, which XmlAnalysis.run executes
    (`run_marginal_likelihood_estimator`), writing the pathLikelihood's
    theta, source and destination columns to its <log>;
  - <pathSamplingAnalysis>, <steppingStoneSamplingAnalysis> and
    <generalizedSteppingStoneSamplingAnalysis> (trace/*SamplingAnalysis
    .java): the estimators over that log, as report strings for
    <assertEqual> (config/xml_assert.py).

The ladder is the JAX package's, rung for rung: theta on the beta-quantile
schedule, each rung `max(int(chainLength scale), min(chainLength, 1024))`
states from the state the last one ended in, its posterior re-evaluated
under the new theta first; every `logEvery scale` states a log row
evaluates the source and the destination. At the Makona shape each step,
each re-evaluation and each row's source is one peel_stream launch.

As in the JAX package, <pathSamplingAnalysis> and
<steppingStoneSamplingAnalysis> read the column `pathLikelihood.delta` by
default, which the estimator's log never writes: without a
<likelihoodColumn> naming a column of the file they raise Unsupported
(ROADMAP reference caveat 8).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import List

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    LikelihoodFn,
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    _chains_of,
    register,
)


def _read_log(ax: XmlAnalysis, fname: str):
    """A tab log written earlier in this run: (column names, rows [T, C])."""
    with open(os.path.join(ax.workdir, fname)) as fh:
        lines = [ln.rstrip("\n") for ln in fh
                 if ln.strip() and not ln.startswith("#")]
    names = lines[0].split("\t")
    rows = np.array([[float(x) for x in ln.split("\t")] for ln in lines[1:]])
    return names, rows


def _ref_prior(ax: XmlAnalysis, el, log_space: bool):
    """A working prior, normal on the value (or on its log where
    `log_space`), with the mean and sd [D] of its log file's column (and
    numbered columns) past `burnin` states."""
    pname = ax.param_from(el)
    fname = el.get("fileName")
    burnin = _attr(el, "burnin", 0, int)
    col = el.get("parameterColumn")
    names, rows = _read_log(ax, fname)
    states = rows[:, 0] if names[0].lower() in ("state", "states") else None
    cols = [i for i, nm in enumerate(names)
            if nm == col or (nm.startswith(col) and nm[len(col):].isdigit())]
    if not cols:
        raise Unsupported(f"reference prior column {col!r} not in {fname}")
    data = rows[:, cols]
    if states is not None and burnin > 0:
        keep = states > burnin * ax.scale
        if keep.sum() >= 2:
            data = data[keep]
    fit = np.log(np.maximum(data, 1e-300)) if log_space else data
    mu = fit.mean(axis=0)
    sd = np.maximum(fit.std(axis=0, ddof=1), 1e-8)
    half_log_2pi = 0.5 * math.log(2 * math.pi)

    def fn(params, tree):
        x = params[pname].reshape(-1)
        m = torch.as_tensor(mu, dtype=x.dtype, device=x.device)
        s = torch.as_tensor(sd, dtype=x.dtype, device=x.device)
        if log_space:
            lx = torch.log(x)
            return torch.sum(-half_log_2pi - torch.log(s)
                             - 0.5 * torch.square((lx - m) / s) - lx)
        return torch.sum(-half_log_2pi - torch.log(s)
                         - 0.5 * torch.square((x - m) / s))

    return LikelihoodFn(fn, None, el.get("id") or "workingPrior", (pname,))


@register("normalReferencePrior")
def _normal_reference_prior(ax: XmlAnalysis, el):
    return _ref_prior(ax, el, log_space=False)


@register("logTransformedNormalReferencePrior")
def _log_normal_reference_prior(ax: XmlAnalysis, el):
    return _ref_prior(ax, el, log_space=True)


def estimator_parts(ax: XmlAnalysis, el):
    """The pieces of a <marginalLikelihoodEstimator>: {"betas",
    "chain_length", "log_every", "fname", "plid", "operators", "source",
    "destination"}, with the per-rung chain length and logEvery as JAX's
    scale them."""
    from beast_mcmc_tpu_torch.inference.marginal_likelihood import (
        beta_quantile_schedule,
    )

    cl_decl = _attr(el, "chainLength", 1000, int)
    # rung chains are short by design; small ones run in full so that the
    # bridging estimates converge (the corpus asserts 1e-1)
    chain_length = max(int(cl_decl * ax.scale), min(cl_decl, 1024))
    path_steps = _attr(el, "pathSteps", 11, int)
    alpha = _attr(el, "alpha", 0.3, float)

    samplers = el.find("samplers")
    if samplers is None or not len(samplers):
        raise XmlError("marginalLikelihoodEstimator without <samplers>")
    mcmc_el = ax.deref(next(iter(samplers)))
    ax._posterior_of(mcmc_el)  # built as JAX builds it, for its side effects
    operators, _ = ax.build(ax.deref(mcmc_el.find("operators")))

    pl_el = el.find("pathLikelihood")
    if pl_el is None:
        raise XmlError("marginalLikelihoodEstimator without pathLikelihood")
    src = ax.build(ax.deref(next(iter(pl_el.find("source")))))
    dest_parts: List[LikelihoodFn] = []
    for c in pl_el.find("destination"):
        cc = ax.deref(c)
        if cc.tag == "workingPrior":
            dest_parts.extend(ax.build(ax.deref(d)) for d in cc)
        else:
            dest_parts.append(ax.build(cc))
    if not dest_parts:
        raise XmlError("pathLikelihood without destination")

    def dest_fn(params, tree):
        return sum(p.fn(params, tree) for p in dest_parts)

    fname, log_every = None, 1
    for lg in el.findall("log"):
        if lg.get("fileName"):
            fname = lg.get("fileName")
            log_every = max(1, int(_attr(lg, "logEvery", 500, int)
                                   * ax.scale))
    return {"betas": beta_quantile_schedule(path_steps, alpha),
            "chain_length": chain_length, "log_every": log_every,
            "fname": fname, "plid": pl_el.get("id") or "pathLikelihood",
            "operators": operators, "source": src.fn, "destination": dest_fn}


def run_marginal_likelihood_estimator(ax: XmlAnalysis, el):
    """Execute <marginalLikelihoodEstimator>: one tempered chain a path
    step from the document's current state, in order, the state handed
    down; write the pathLikelihood trace (theta, source, destination) and
    keep its rows in ax._mle_rows[file name or pathLikelihood id]. Each
    rung ends on a log row, whose fresh source and destination give its
    target at the final state: the carried posterior must lie within the
    full-evaluation tolerance of it (0.1 in float64). The ladder's steps,
    seconds and largest such deviation go to ax.runs, as an <mcmc>'s do."""
    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state,
        make_mcmc_step,
        run_chain,
    )
    from beast_mcmc_tpu_torch.utils.accum import accum_dtype

    parts = estimator_parts(ax, el)
    src, dest_fn = parts["source"], parts["destination"]
    operators, log_every = parts["operators"], parts["log_every"]
    n_blocks = max(1, parts["chain_length"] // log_every)
    params0, tree0 = initial_eval_state(ax)

    def collector(s):
        return {"src": src(s.params, s.tree).reshape(()),
                "dst": dest_fn(s.params, s.tree).reshape(())}

    rows, deviations = [], []
    gen = torch.Generator(device=ax.device).manual_seed(ax.seed)
    sync = ((lambda: torch.cuda.synchronize(ax.device))
            if ax.device.type == "cuda" else (lambda: None))
    sync()
    t0 = time.perf_counter()
    state = None
    for b in parts["betas"]:
        bb = float(b)

        def lp(params, tree, _b=bb):
            return _b * src(params, tree) + (1.0 - _b) * dest_fn(params,
                                                                 tree)

        # the Gibbs tree moves score their candidates with the rung's
        # target over a chain axis, one evaluation a candidate
        for op in operators:
            if hasattr(op, "bind_log_posterior_chains"):
                op.bind_log_posterior_chains(_chains_of(lp))
        step = make_mcmc_step(lp, operators)
        if state is None:
            state = init_mcmc_state(params0, tree0, gen, operators, lp,
                                    dtype=ax.dtype)
        else:
            state = state.replace(log_posterior=lp(
                state.params, state.tree).to(accum_dtype()))
        state, trace = run_chain(step, state, n_blocks * log_every,
                                 log_every, collector)
        src_v = trace["src"].cpu().numpy().astype(float)
        dst_v = trace["dst"].cpu().numpy().astype(float)
        rows.extend((bb, sv, dv) for sv, dv in zip(src_v, dst_v))
        # the rung ends on a log row: its fresh source and destination
        # against the carried posterior
        deviations.append(abs(float(state.log_posterior)
                              - (bb * src_v[-1] + (1.0 - bb) * dst_v[-1])))
    sync()
    seconds = time.perf_counter() - t0
    dev = max(deviations)
    tol = 0.1 if ax.dtype == torch.float64 else 1e-4 * max(
        1.0, abs(float(state.log_posterior)))
    if not dev <= tol:
        raise AssertionError(f"marginal likelihood estimator: carried "
                             f"posterior {dev} off a fresh one (> {tol})")
    ax.runs.append({"steps": len(parts["betas"]) * n_blocks * log_every,
                    "seconds": seconds, "full_eval_steps": 0,
                    "full_eval_deviation": dev, "rungs": len(deviations),
                    "rung_deviations": deviations})

    fname, plid = parts["fname"], parts["plid"]
    if fname:
        with open(os.path.join(ax.workdir, fname), "w") as fh:
            fh.write(f"state\t{plid}.theta\t{plid}.source\t"
                     f"{plid}.destination\n")
            for i, (th, sv, dv) in enumerate(rows):
                fh.write(f"{i}\t{float(th)!r}\t{float(sv)!r}\t"
                         f"{float(dv)!r}\n")
    ax._mle_rows = getattr(ax, "_mle_rows", {})
    ax._mle_rows[fname or plid] = rows
    ax._mcmc_ran = True


@dataclasses.dataclass
class _MlAnalysis:
    kind: str = "gss"  # gss | ps | ss
    fname: str = ""
    theta_col: str = ""
    source_col: str = ""
    dest_col: str = ""
    lik_col: str = ""

    def estimate(self, ax) -> float:
        from beast_mcmc_tpu_torch.inference.marginal_likelihood import (
            generalized_stepping_stone_logml,
            path_sampling_logml,
            stepping_stone_logml,
        )

        names, rows = _read_log(ax, self.fname)

        def col(cname):
            if cname in names:
                return rows[:, names.index(cname)]
            raise Unsupported(f"column {cname!r} not in {self.fname}")

        theta = col(self.theta_col)
        uniq = sorted(set(theta.tolist()))
        if self.kind == "gss":
            src, dst = col(self.source_col), col(self.dest_col)
            lr = np.stack([src[theta == t] - dst[theta == t] for t in uniq])
            return generalized_stepping_stone_logml(lr, uniq)
        lik = col(self.lik_col)
        ll = np.stack([lik[theta == t] for t in uniq])
        if self.kind == "ps":
            return path_sampling_logml(ll, uniq)
        return stepping_stone_logml(ll, uniq)

    def report(self, ax) -> str:
        label = {"gss": "generalized stepping stone sampling",
                 "ps": "path sampling",
                 "ss": "stepping stone sampling"}[self.kind]
        return (f"log marginal likelihood (using {label}) = "
                f"{float(self.estimate(ax))!r}\n")


def _colname(el, tag, default):
    c = el.find(tag)
    return c.get("name") if c is not None else default


@register("generalizedSteppingStoneSamplingAnalysis")
def _gss_analysis(ax: XmlAnalysis, el):
    return _MlAnalysis(
        "gss", el.get("fileName"), _colname(el, "thetaColumn", "theta"),
        _colname(el, "sourceColumn", "source"),
        _colname(el, "destinationColumn", "destination"))


@register("pathSamplingAnalysis", "steppingStoneSamplingAnalysis")
def _ps_analysis(ax: XmlAnalysis, el):
    return _MlAnalysis(
        "ps" if el.tag.startswith("path") else "ss", el.get("fileName"),
        _colname(el, "thetaColumn", "pathLikelihood.theta"), "", "",
        _colname(el, "likelihoodColumn", "pathLikelihood.delta"))
