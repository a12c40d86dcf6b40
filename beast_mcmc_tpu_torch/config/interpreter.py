"""The XML interpreter: execute BEAST XML analyses end to end.

Counterpart of beast_mcmc_tpu/config/interpreter.py, its core and the 79
registrations of its base registry (91 tag names). The reference's public
API is its XML vocabulary, a registry of per-tag parsers that assembles the
runtime object graph (XMLParser.java:131-220, the id/idref store;
release_parsers.properties, BeastParser.java:97-112). Here a registry of
per-tag builders (`_BUILDERS`) assembles log-density closures over
(params, tree), operator specs and loggers from the same XML, then runs
each <mcmc> block through the port's chain (inference/mcmc.py) on the
analysis's device, and executes the file's own embedded checks:

  - <traceAnalysis><expectation name value>: posterior-mean oracles held
    within k standard errors of the run's own trace
    (TraceAnalysisParser.java:81-107);
  - completion without error, and the full-evaluation self-check (0.1 log
    units in float64), for files without expectations.

Chains may be shortened by `scale`. Every tensor lives on `device` (cuda
by default; the tests pass cpu). The tree likelihood goes through
models/treelikelihood.py, so on the card through ops/cuda_peeling.py::
peel_route to the ported peel kernels (a 1,610-taxon nucleotide partition:
one peel_stream launch an evaluation).

Where the JAX package jits the chain with a collector, the port runs it
eagerly: the collector's log columns are gathered on the device every
logEvery states and copied to the host once, after the run. JAX's random
streams cannot be matched, so chains agree in law; every starting value
drawn from the analysis's numpy generator (`_rng`, the coalescent start
tree among them) is drawn the same way and equal.

All nine extension modules (config/xml_{assert,ext,factor,field,geo,
hmc,mle,stats,traits}.py) are ported whole: xml_hmc.py's gradient and HMC
vocabulary, xml_geo.py's discrete phylogeography with the GLM and the
structured coalescent, the continuous traits of xml_traits.py, the
factor analysis of xml_factor.py and the random fields of xml_field.py
among them. A tree likelihood
registers beside itself its first-order surrogate (`_surrogate_liks`:
models/treelikelihood.py::tree_loglikelihood_q_approx_grad, the
generator reassembled from an eigen model), which the approximate
CTMC-rate gradient elements report. <marginalLikelihoodEstimator> runs
its ladder of tempered chains in document order (config/xml_mle.py), and
<assertEqual> its comparison (config/xml_assert.py), which warns and
skips where the state came from a random stream (after an <mcmc>, or on
a simulated start tree), as JAX's does. A tag without a builder raises
`Unsupported`; no tag is skipped silently.

<logTree> annotates each sampled tree with the joint ancestral-state draw
of its <ancestralTreeLikelihood> children, drawn on the device inside the
collector from a generator of its own: the chain's seed folded with the
tag's CRC (JAX folds the chain's key so). The law is JAX's; the stream
cannot be.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
import xml.etree.ElementTree as ET
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.operators import Operator, _uniform
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, default_float


class Unsupported(NotImplementedError):
    pass


class XmlError(ValueError):
    pass


# ---------------------------------------------------------------------------
# small XML helpers
# ---------------------------------------------------------------------------


def _attr(el, name, default=None, cast=str):
    v = el.get(name)
    if v is None:
        return default
    if cast is bool:
        return v.lower() == "true"
    return cast(v)


def _text_values(el) -> np.ndarray:
    # "NA" parses as NaN (XMLObject.java:46 missingValue)
    return np.array([
        float("nan") if x.upper() == "NA" else float(x)
        for x in (el.get("value") or "").split()
    ])


# ---------------------------------------------------------------------------
# runtime object kinds
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Param:
    """A real (or integer) parameter registered in the chain's params."""

    name: str
    value: np.ndarray
    lower: float = -np.inf
    upper: float = np.inf
    integer: bool = False


@dataclasses.dataclass
class DerivedParam:
    """A parameter that is a function of the sampled params
    (TransformedParameterParser: transform(inner), never sampled), injected
    into the params dict before every density and logger evaluation
    (XmlAnalysis.inject_derived)."""

    name: str
    fn: Callable  # params -> tensor
    value: np.ndarray = None  # initial value (column headers)
    base: str = None  # the sampled param operators move
    idx: object = None  # flat indices into base for masked index views


@dataclasses.dataclass
class TreeAlias:
    """A <parameter> that is a view of the tree state (the rootHeight,
    nodeHeights and leafHeight blocks of <treeModel>,
    TreeModelParser.java)."""

    kind: str  # "root_height" | "internal_heights" | "all_heights" | "leaf_height"
    tree_id: str
    tip_index: int = -1


@dataclasses.dataclass
class Demographic:
    kind: str
    params: Dict[str, str]  # role -> param name
    # loglik(tree_heights, n_taxa, params) -> 0-d tensor
    loglik: Callable = None
    # a population size for the host-side start-tree simulation
    sim_pop: float = 1.0


@dataclasses.dataclass
class TreeModel:
    tree_id: str
    taxa: List[str]
    tip_heights: np.ndarray
    parent: np.ndarray
    children: np.ndarray
    heights: np.ndarray
    root: int
    sampled_tips: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ClockModel:
    kind: str
    tree_id: str
    # rates(params, tree) -> [M] branch rates (the branch above each node)
    rates: Callable = None
    rate_param: Optional[str] = None


@dataclasses.dataclass
class LikelihoodFn:
    fn: Callable  # (params, tree) -> 0-d tensor
    tree_id: Optional[str] = None
    name: str = ""
    # the sampled data parameters this density scores
    data_params: Tuple[str, ...] = ()


@dataclasses.dataclass
class CompoundParam:
    names: List[str]


@dataclasses.dataclass
class JointTipAlias:
    """<jointParameter> over leaf-height views of several trees."""

    targets: tuple = ()  # (tree_id, tip_index)


def per_state(fn):
    """fn(s) computed once a state: the log columns of one collector row
    are handed the same state object and share one evaluation (JAX's jit
    merges such duplicate calls; eager PyTorch would repeat them)."""
    memo = {"s": None, "v": None}

    def wrapped(s):
        if memo["s"] is not s:
            memo["v"] = fn(s)
            memo["s"] = s
        return memo["v"]

    return wrapped


class _StateShim:
    """A state-like view (params, tree) for statistic callables."""

    def __init__(self, params, tree):
        self.params = params
        self.tree = tree


def annotation_seed(seed: int, tag: str) -> int:
    """The seed of a <logTree> annotation's generator: the chain's seed
    folded with the tag's CRC, as the JAX package folds the chain's key
    (interpreter.py:589-592)."""
    return (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % 2**63


def _node_annotations(anns, i):
    """{node: 'tag="label",...'} of sample i of each annotation (tag,
    states [samples, M], labels), or None without annotations; a state
    code past the labels is written as its number."""
    if not anns:
        return None
    out = {}
    for tag, states, labels in anns:
        for node, code in enumerate(states[i].tolist()):
            lab = (labels[code] if labels and 0 <= code < len(labels)
                   else str(code))
            entry = f'{tag}="{lab}"'
            out[node] = f"{out[node]},{entry}" if node in out else entry
    return out


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


class XmlAnalysis:
    """Parse and execute one BEAST XML file on `device`."""

    def __init__(self, path: str, scale: float = 1.0, workdir: str = ".",
                 seed: int = 666, dtype=None, max_states: int = 200_000,
                 strict_expectations: bool = True, device=DEFAULT_DEVICE):
        self.path = path
        self.scale = scale
        self.workdir = workdir
        self.seed = seed
        self.max_states = max_states
        self.strict_expectations = strict_expectations
        self.dtype = dtype or default_float()
        self.device = torch.device(device)
        self.root = ET.parse(path).getroot()
        if self.root.tag != "beast":
            raise XmlError(f"root element <{self.root.tag}>, expected <beast>")
        self._ids: Dict[str, ET.Element] = {}
        for el in self.root.iter():
            if el.get("id"):
                self._ids[el.get("id")] = el
        self._built: Dict[int, object] = {}
        self._tree_binding: Dict[str, str] = {}  # tid -> "state"|"params"
        self._tree_views: Dict[str, object] = {}  # tid -> TreeState view fn
        self._star_trees: set = set()
        self._derived_params: Dict[str, Callable] = {}  # name -> fn(params)
        self._params: Dict[str, Param] = {}
        self._aliases: Dict[str, TreeAlias] = {}
        self._trees: Dict[str, TreeModel] = {}
        self._rng = np.random.default_rng(seed)
        self.results: Dict[str, Dict[str, np.ndarray]] = {}
        self.assertions: List[Tuple[str, str, float, float, float]] = []
        # what each <mcmc> run measured: steps, seconds, the
        # full-evaluation deviation
        self.runs: List[Dict[str, float]] = []
        # taxon attributes: taxon id -> {attr name: [raw string values]},
        # collected over the whole document (AttributeParser via
        # TaxonParser)
        self._taxon_attrs: Dict[str, Dict[str, List[str]]] = {}
        for t in self.root.iter("taxon"):
            name = t.get("id")
            if name is None:
                continue
            for a in t.findall("attr"):
                vals = (a.text or "").split()
                if not vals:
                    vals = [c.get("idref") or c.get("id")
                            for c in a if c.get("idref") or c.get("id")]
                self._taxon_attrs.setdefault(name, {})[a.get("name")] = vals
        self._traits: Dict[Tuple[str, str], Dict] = {}

    # -- tensors on the analysis's device -----------------------------------
    def tensor(self, value, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value), dtype=dtype or self.dtype,
                               device=self.device)

    def as_lp(self, v) -> torch.Tensor:
        """A density's value as a tensor (0.0 where nothing was added)."""
        if isinstance(v, torch.Tensor):
            return v
        return torch.tensor(float(v), dtype=self.dtype, device=self.device)

    # -- multi-tree support: one tree rides MCMCState.tree; further gene
    # trees (multilocus and EBSP analyses) live in the params under
    # __tree__<id>__* keys, moved by lifted operators, and every tree-bound
    # closure resolves its tree through this binding --------------------
    @staticmethod
    def tree_key(tid: str, field: str) -> str:
        return f"__tree__{tid}__{field}"

    def resolve_tree(self, tid, params, tree):
        if self._tree_binding.get(tid, "state") == "state":
            out = tree
        else:
            from beast_mcmc_tpu_torch.tree.topology import TreeState

            out = TreeState(
                parent=params[self.tree_key(tid, "parent")],
                children=params[self.tree_key(tid, "children")],
                heights=params[self.tree_key(tid, "heights")],
                root=params[self.tree_key(tid, "root")],
            )
        view = self._tree_views.get(tid)
        return view(out, params) if view is not None else out

    # -- id/idref resolution (the XMLParser id/idref object store) ---------
    def deref(self, el: ET.Element) -> ET.Element:
        r = el.get("idref")
        if r is None:
            return el
        if r not in self._ids:
            raise XmlError(f"unresolved idref {r!r} on <{el.tag}>")
        return self._ids[r]

    def build(self, el: ET.Element):
        el = self.deref(el)
        key = id(el)
        if key in self._built:
            return self._built[key]
        builder = _BUILDERS.get(el.tag)
        if builder is None:
            raise Unsupported(f"<{el.tag}> has no registered builder")
        obj = builder(self, el)
        if (isinstance(obj, LikelihoodFn)
                and el.tag not in ("posterior", "prior", "likelihood",
                                   "joint", "booleanLikelihood")):
            inner, tid = obj.fn, obj.tree_id
            if tid:
                fn = (lambda p, t, _f=inner, _tid=tid: self.as_lp(_f(
                    self.inject_derived(p), self.resolve_tree(_tid, p, t))))
            else:
                fn = (lambda p, t, _f=inner: self.as_lp(
                    _f(self.inject_derived(p), t)))
            wrapped = LikelihoodFn(fn, obj.tree_id, obj.name,
                                   obj.data_params)
            # builder-attached extras survive the rewrap
            for k_attr, v_attr in vars(obj).items():
                if k_attr not in ("fn", "tree_id", "name", "data_params"):
                    setattr(wrapped, k_attr, v_attr)
            obj = wrapped
        self._built[key] = obj
        return obj

    # -- parameters ---------------------------------------------------------
    def param_from(self, el: ET.Element, default=None, dim=None,
                   prefix="anon") -> str:
        """Build or locate the <parameter> beneath (or at) el; its name."""
        el = self.deref(el)
        if el.tag in ("maskedParameter", "transformedParameter",
                      "transformedMultivariateParameter"):
            obj = self.build(el)
            return obj.name
        if el.tag != "parameter":
            p = el.find("parameter")
            if p is None:
                for c in el:
                    cc = self.deref(c)
                    if cc.tag in ("parameter", "compoundParameter",
                                  "maskedParameter", "transformedParameter",
                                  "productParameter",
                                  "multiplicativeParameter",
                                  "transformedMultivariateParameter"):
                        p = cc
                        break
            if p is None:
                # a bare numeric body ("<shape>1</shape>") is a constant
                txt = (el.text or "").split()
                try:
                    vals = np.array([float(x) for x in txt])
                except ValueError:
                    vals = np.array([])
                if vals.size:
                    name = f"const{len(self._params)}"
                    self._params[name] = Param(
                        name,
                        vals if vals.size > 1
                        else np.asarray(float(vals[0])))
                    return name
                raise XmlError(f"no <parameter> under <{el.tag}>")
            el = self.deref(p)
        obj = self.build(el)
        if isinstance(obj, DerivedParam):
            return obj.name
        if isinstance(obj, TreeAlias):
            raise XmlError("tree-view parameter where real parameter expected")
        if isinstance(obj, CompoundParam):
            # the concatenation as a parse-time constant
            name = el.get("id") or f"compound{len(self._params)}"
            key = f"__materialized__{name}"
            if key not in self._params:
                vals = np.concatenate([
                    np.atleast_1d(self._params[n].value)
                    for n in obj.names])
                self._params[key] = Param(key, vals)
            return key
        return obj.name

    def value_of(self, name: str) -> np.ndarray:
        return self._params[name].value

    def inject_derived(self, params):
        """Overlay the derived (transformed, masked-view) parameter values
        on the sampled params, in declaration order."""
        if not self._derived_params:
            return params
        out = dict(params)
        for name, fn in self._derived_params.items():
            out[name] = fn(out)
        return out

    # -- running ------------------------------------------------------------
    def run(self, tolerance_se: float = 3.0, full_eval_steps: int = 100):
        """Execute every <mcmc> and <traceAnalysis> in document order.
        Returns the (file, column, mean, expected, se) assertion tuples;
        raises AssertionError on a failed expectation."""
        # tree models first, so that their rootHeight/nodeHeights/
        # leafHeight <parameter> children register as tree views before
        # any other element builds them as real parameters
        for el in self.root.iter("treeModel"):
            if el.get("id"):
                self.build(el)
        for el in self.root.iter("nodeHeightTransform"):
            try:
                self.build(el)
            except (Unsupported, XmlError):
                pass
        for el in self.root:
            if el.tag == "mcmc":
                self._run_mcmc(el, full_eval_steps)
            elif el.tag == "marginalLikelihoodEstimator":
                from beast_mcmc_tpu_torch.config.xml_mle import (
                    run_marginal_likelihood_estimator,
                )

                run_marginal_likelihood_estimator(self, el)
            elif el.tag == "traceAnalysis":
                self._run_trace_analysis(el, tolerance_se)
            elif el.tag == "assertEqual":
                self.build(el)()
            elif el.tag in ("report", "treeTraceAnalysis", "CSVexport",
                            "VDAnalysis", "marginalLikelihoodAnalysis"):
                continue  # post-hoc reporting, not part of the assertions
            else:
                continue  # model definitions build lazily from <mcmc>
        return self.assertions

    # -- mcmc ---------------------------------------------------------------
    def _posterior_of(self, el) -> LikelihoodFn:
        """The first child of <mcmc> that is a likelihood-like element."""
        for c in el:
            if c.tag in ("log", "logTree", "operators"):
                continue
            obj = self.build(c)
            if isinstance(obj, LikelihoodFn):
                return obj
        raise XmlError("<mcmc> has no posterior/likelihood child")

    def prepare_chain(self, el=None):
        """The chain of the <mcmc> element `el` (the document's first by
        default) as _run_mcmc runs it: {"posterior", "operators", "step",
        "state" (initialised, its log posterior finite), "chain_length",
        "tree_ids", "primary"}. Trees past the first ride the params,
        their operators lifted."""
        from beast_mcmc_tpu_torch.inference.mcmc import (
            init_mcmc_state,
            make_mcmc_step,
        )
        from beast_mcmc_tpu_torch.inference.samplers import make_post_update
        from beast_mcmc_tpu_torch.tree.topology import make_tree_state

        if el is None:
            for t in self.root.iter("treeModel"):
                if t.get("id"):
                    self.build(t)
            el = self.root.find("mcmc")
        post = self._posterior_of(el)
        ops_el = el.find("operators")
        if ops_el is None:
            raise XmlError("<mcmc> without <operators>")
        operators, op_tree_ids = self.build(self.deref(ops_el))

        tree_ids = sorted(
            {t for t in op_tree_ids if t}
            | ({post.tree_id} if post.tree_id else set()))
        # the first tree rides MCMCState.tree; the rest live in params and
        # their operators are lifted (multilocus and EBSP analyses)
        primary = tree_ids[0] if tree_ids else None
        self._tree_binding = {t: "params" for t in tree_ids[1:]}
        if primary is not None:
            self._tree_binding[primary] = "state"
            tm = self._trees[primary]
        else:
            tm = TreeModel("_dummy", ["A", "B"], np.zeros(2),
                           np.array([2, 2, -1]),
                           np.array([[-1, -1], [-1, -1], [0, 1]]),
                           np.array([0.0, 0.0, 1.0]), 2)
        tree0 = make_tree_state(tm.parent, tm.children, tm.heights, tm.root,
                                self.dtype, self.device)
        params0 = {
            p.name: self.tensor(p.value,
                                torch.int32 if p.integer else self.dtype)
            for p in self._params.values()
        }
        for tid in tree_ids[1:]:
            t = self._trees[tid]
            params0[self.tree_key(tid, "parent")] = self.tensor(
                t.parent, torch.long)
            params0[self.tree_key(tid, "children")] = self.tensor(
                t.children, torch.long)
            params0[self.tree_key(tid, "heights")] = self.tensor(t.heights)
            params0[self.tree_key(tid, "root")] = self.tensor(t.root,
                                                              torch.long)
        operators = [
            op if (tid is None or tid == primary)
            else ParamsTreeOperator(
                inner=op,
                keys=tuple(self.tree_key(tid, f)
                           for f in ("parent", "children", "heights",
                                     "root")),
                weight=op.weight,
                target_acceptance=op.target_acceptance,
                adaptable=op.adaptable,
            )
            for op, tid in zip(operators, op_tree_ids)
        ]
        # the Gibbs tree moves score candidate trees with a chain-axis
        # posterior: here one evaluation a candidate tree
        for op in operators:
            if hasattr(op, "bind_log_posterior_chains"):
                op.bind_log_posterior_chains(_chains_of(post.fn))

        cl_decl = _attr(el, "chainLength", 10000, int)
        # scale cuts long chains; tiny debug chains (<= 64 states) always
        # run in full
        chain_length = max(int(cl_decl * self.scale), min(cl_decl, 64))
        chain_length = min(chain_length, self.max_states)

        step = make_mcmc_step(post.fn, operators,
                              post_update=make_post_update(operators))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        state = init_mcmc_state(params0, tree0, gen, operators, post.fn,
                                dtype=self.dtype)
        lp0 = float(state.log_posterior)
        if not np.isfinite(lp0):
            raise XmlError(f"initial posterior not finite: {lp0}")
        return {"posterior": post, "operators": operators, "step": step,
                "state": state, "chain_length": chain_length,
                "tree_ids": tree_ids, "primary": primary}

    def _run_mcmc(self, el, full_eval_steps):
        import time

        self._mcmc_ran = True  # state-dependent assertions downgrade after

        from beast_mcmc_tpu_torch.inference.mcmc import (
            full_evaluation_check,
            run_chain,
        )

        chain = self.prepare_chain(el)
        lp_fn, operators = chain["posterior"].fn, chain["operators"]
        step, state = chain["step"], chain["state"]
        chain_length = chain["chain_length"]
        tree_ids, primary = chain["tree_ids"], chain["primary"]

        dev = float("nan")
        if full_eval_steps:
            # the reference's in-chain sanitizer for the first steps
            state, dev_t = full_evaluation_check(step, lp_fn, state,
                                                 full_eval_steps)
            dev = float(dev_t)
            tol = 0.1 if self.dtype == torch.float64 else 1e-4 * max(
                1.0, abs(float(state.log_posterior)))
            if not dev <= tol:
                raise AssertionError(
                    f"full-evaluation self-check deviation {dev} > {tol}")

        # one collector entry per <log fileName>; screen logs are skipped
        logs = []
        for lg in el.findall("log"):
            fname = lg.get("fileName")
            if fname is None:
                continue
            log_every = max(1, int(_attr(lg, "logEvery", 1000, int)
                                   * self.scale))
            logs.append((fname, log_every, self._log_columns(lg)))
        tree_logs = []
        for lg in el.findall("logTree"):
            fname = lg.get("fileName")
            if fname is None:
                continue
            t_every = max(1, int(_attr(lg, "logEvery", 1000, int)
                                 * self.scale))
            t_tid = None
            # the ancestral-state children annotate every node (TreeLogger
            # + AncestralStateBeagleTreeLikelihood:274): (tag, states_fn,
            # labels, generator)
            annotators = []
            for c in lg:
                cc = self.deref(c)
                if cc.tag in ("treeModel", "starTreeModel"):
                    t_tid = self.build(cc).tree_id
                elif cc.tag in ("ancestralTreeLikelihood",
                                "markovJumpsTreeLikelihood"):
                    self.build(cc)
                    rec = getattr(self, "_ancestral_liks", {}).get(
                        cc.get("id"))
                    if rec is not None and rec.get("states_fn"):
                        annotators.append((
                            rec["tag"], rec["states_fn"], rec["labels"],
                            torch.Generator(device=self.device).manual_seed(
                                annotation_seed(self.seed, rec["tag"]))))
            if t_tid is not None:
                tree_logs.append((fname, t_every, t_tid, annotators))
        if logs or tree_logs:
            base_every = min([le for _, le, _ in logs]
                             + [te for _, te, _, _ in tree_logs])
        else:
            base_every = max(1, chain_length // 1000)

        # the tree logs' rows are gathered apart, and only on the rows each
        # keeps (every stride-th collector row): the annotation draw costs
        # tens of milliseconds of host time at the Makona shape
        tree_rows = {fname: [] for fname, _, _, _ in tree_logs}
        row = [0]

        def collector(s):
            out = {}
            for fname, _, cols in logs:
                for cname, fn in cols:
                    out[f"{fname}\x00{cname}"] = torch.as_tensor(
                        fn(s), device=self.device).reshape(())
            for fname, t_every, tid, annotators in tree_logs:
                if row[0] % max(1, t_every // base_every):
                    continue
                tr = self.resolve_tree(tid, s.params, s.tree)
                rec = {"parent": tr.parent, "children": tr.children,
                       "heights": tr.heights, "root": tr.root}
                for tag, states_fn, _, ann_gen in annotators:
                    rec[f"ann_{tag}"] = states_fn(s.params, tr, ann_gen)
                tree_rows[fname].append(rec)
            row[0] += 1
            return out

        n_blocks = max(1, chain_length // base_every)
        sync = ((lambda: torch.cuda.synchronize(self.device))
                if self.device.type == "cuda" else (lambda: None))
        sync()
        t0 = time.perf_counter()
        state, trace = run_chain(step, state, n_blocks * base_every,
                                 base_every, collector)
        sync()
        seconds = time.perf_counter() - t0
        trace = {k: v.cpu().numpy() for k, v in (trace or {}).items()}
        lp = float(state.log_posterior)
        if not np.isfinite(lp):
            raise AssertionError(f"chain ended with non-finite posterior {lp}")
        self.runs.append({"steps": n_blocks * base_every, "seconds": seconds,
                          "full_eval_steps": full_eval_steps,
                          "full_eval_deviation": dev})

        from beast_mcmc_tpu_torch.inference.loggers import (
            NexusTreeLogger,
            TabLogger,
        )

        for fname, log_every, cols in logs:
            stride = max(1, log_every // base_every)
            table = {}
            for cname, _ in cols:
                table[cname] = np.asarray(trace[f"{fname}\x00{cname}"],
                                          np.float64)[::stride]
            table["_states_per_sample"] = np.array([log_every])
            self.results[fname] = table
            names = [c for c, _ in cols]
            with open(os.path.join(self.workdir, fname), "w") as fh:
                tl = TabLogger(names, fh)
                n_rows = len(table[names[0]]) if names else 0
                for i in range(n_rows):
                    tl.log((i + 1) * log_every,
                           {c: table[c][i] for c in names})
        for fname, t_every, tid, annotators in tree_logs:
            rows = tree_rows[fname]
            tcols = {k: torch.stack([r[k] for r in rows]).cpu().numpy()
                     for k in (rows[0] if rows else ())}
            anns = [(tag, tcols[f"ann_{tag}"], labels)
                    for tag, _, labels, _ in annotators] if rows else []
            with open(os.path.join(self.workdir, fname), "w") as fh:
                tl = NexusTreeLogger(self._trees[tid].taxa, fh)
                for i in range(len(rows)):
                    tl.log_tree(int((i + 1) * t_every), tcols["parent"][i],
                                tcols["children"][i], tcols["heights"][i],
                                tcols["root"][i],
                                annotations=_node_annotations(anns, i))
                tl.close()

        # the final chain state back into the parse-time store, so that
        # post-<mcmc> reports and asserts see the current model state
        for name, p in self._params.items():
            if name in state.params:
                v = state.params[name].cpu().numpy()
                p.value = (v.astype(np.int64) if p.integer
                           else v.astype(np.float64))
        if primary is not None:
            tm_w = self._trees[primary]
            tm_w.parent = state.tree.parent.cpu().numpy()
            tm_w.children = state.tree.children.cpu().numpy()
            tm_w.heights = state.tree.heights.cpu().numpy().astype(np.float64)
            tm_w.root = int(state.tree.root)
        for tid in tree_ids[1:]:
            tm_w = self._trees[tid]
            tm_w.parent = state.params[self.tree_key(tid, "parent")].cpu() \
                .numpy()
            tm_w.children = state.params[
                self.tree_key(tid, "children")].cpu().numpy()
            tm_w.heights = state.params[
                self.tree_key(tid, "heights")].cpu().numpy() \
                .astype(np.float64)
            tm_w.root = int(state.params[self.tree_key(tid, "root")])

    def _log_columns(self, lg) -> List[Tuple[str, Callable]]:
        cols = []
        for c in lg:
            if c.tag == "column":
                for cc in c:
                    cols.extend(self._column_of(cc))
            else:
                cols.extend(self._column_of(c))
        return cols

    def _column_of(self, el) -> List[Tuple[str, Callable]]:
        ref_name = el.get("idref")
        el2 = self.deref(el)
        if el2.tag == "matrixParameter":
            from beast_mcmc_tpu_torch.config.xml_hmc import matrix_param_of

            mp = matrix_param_of(self, el2)
            nm = ref_name or el2.get("id") or "matrix"
            return [(f"{nm}{i + 1}{j + 1}",
                     lambda s, i=i, j=j: mp.fn(s.params)[i, j])
                    for i in range(mp.dim) for j in range(len(mp.names))]
        if el2.tag == "parameter":
            obj = self.build(el2)
            if isinstance(obj, TreeAlias):
                nm_a = ref_name or el2.get("id")
                if obj.kind in ("internal_heights", "all_heights"):
                    # one column per internal node height
                    tm_a = self._trees[obj.tree_id]
                    sel = list(range(len(tm_a.taxa), tm_a.parent.shape[0]))
                    return [
                        (f"{nm_a}{k + 1}",
                         lambda s, i=i, t=obj.tree_id: self.resolve_tree(
                             t, s.params, s.tree).heights[i])
                        for k, i in enumerate(sel)
                    ]
                return [(nm_a, self._alias_reader(obj))]
            if getattr(obj, "columns", None) is not None:
                return list(obj.columns)  # a live view (the height ratios)
            if isinstance(obj, DerivedParam):
                return self._log_columns_derived(ref_name or el2.get("id"),
                                                 obj)
            name = obj.name
            # vector parameters: one column per element; read the current
            # registration (the skyride and EBSP resize theirs)
            val = self._params[name].value
            if np.size(val) == 1:
                return [(name, lambda s, n=name: s.params[n].reshape(()))]
            return [
                (f"{name}{i + 1}",
                 lambda s, n=name, i=i: s.params[n].reshape(-1)[i])
                for i in range(np.size(val))
            ]
        obj = self.build(el2)
        nm = ref_name or el2.get("id") or el2.tag
        if isinstance(obj, LikelihoodFn):
            return [(nm, lambda s, f=obj.fn: f(s.params, s.tree))]
        if isinstance(obj, ClockModel):
            # a branch-rate model logs its (zero) density
            return [(nm, lambda s: torch.zeros((), dtype=self.dtype,
                                               device=self.device))]
        if isinstance(obj, CompoundParam):
            return [(n, lambda s, n=n: s.params[n].reshape(()))
                    for n in obj.names]
        if getattr(obj, "columns", None) is not None:
            return list(obj.columns)  # a statistic of several columns
        if hasattr(obj, "fn") and hasattr(obj, "dim") and hasattr(obj,
                                                                  "names"):
            # a matrix view (config/xml_hmc.py::MatrixParam)
            return [(f"{nm}{i + 1}{j + 1}",
                     lambda s, i=i, j=j, o=obj: o.fn(s.params)[i, j])
                    for i in range(obj.dim) for j in range(obj.dim)]
        if type(obj).__name__ == "GradientSpec":
            # the live analytic gradient (GradientWrtParameterProvider is
            # Loggable)
            cols = self._gradient_columns(nm, obj)
            if cols is not None:
                return cols
        if isinstance(obj, DerivedParam):
            return self._log_columns_derived(nm, obj)
        if isinstance(obj, JointTipAlias):
            tid0, tip0 = obj.targets[0]
            return [(nm, lambda s, t=tid0, i=tip0: self.resolve_tree(
                t, s.params, s.tree).heights[i])]
        if type(obj).__name__ == "IntegratedFactorModel":
            # its density is counted inside the companion traitDataLikelihood
            return [(nm, lambda s: torch.zeros((), dtype=self.dtype,
                                               device=self.device))]
        if isinstance(obj, Param):
            val = np.atleast_1d(np.asarray(obj.value))
            if val.size == 1:
                return [(nm, lambda s, n=obj.name: s.params[n].reshape(()))]
            return [
                (f"{nm}{i + 1}",
                 lambda s, n=obj.name, i=i: s.params[n].reshape(-1)[i])
                for i in range(val.size)
            ]
        if callable(obj):  # statistics
            return [(nm, obj)]
        raise Unsupported(f"cannot log <{el2.tag}>")

    def _log_columns_derived(self, nm, obj):
        val0 = (np.atleast_1d(np.asarray(obj.value))
                if obj.value is not None else None)
        if val0 is not None and val0.size > 1:
            return [
                (f"{nm}{i + 1}",
                 lambda s, i=i, f=obj.fn: f(
                     self.inject_derived(s.params)).reshape(-1)[i])
                for i in range(val0.size)
            ]
        return [(nm, lambda s, f=obj.fn: f(
            self.inject_derived(s.params)).reshape(()))]

    def _gradient_columns(self, nm, spec):
        """Live gradient columns of a config/xml_hmc.py GradientSpec (its
        parameter targets, then the internal node heights), one
        torch.autograd pass a collector row shared by its columns."""
        names = list(spec.target_names())
        height_tid = getattr(spec, "height_tid", None)
        if not names and height_tid is None:
            return None
        sizes = [int(np.asarray(self._params[n].value).size) for n in names]

        @per_state
        def grad_flat(s):
            p = self.inject_derived(s.params)
            t = s.tree
            n_tips = (t.heights.shape[0] + 1) // 2
            xs = [p[n].detach().clone().requires_grad_(True) for n in names]
            pp = dict(p)
            pp.update(zip(names, xs))
            if height_tid is not None:
                h = t.heights[n_tips:].detach().clone().requires_grad_(True)
                xs.append(h)
                t = t.replace(heights=torch.cat([t.heights[:n_tips], h]))
            with torch.enable_grad():
                dens = sum(lk.fn(pp, t) for lk in spec.likelihoods)
                grads = torch.autograd.grad(dens, xs)
            return torch.cat([g.reshape(-1) for g in grads])

        n_h = 0
        if height_tid is not None:
            n_h = len(self.build(self._ids[height_tid]).taxa) - 1
        return [(f"{nm}{i + 1}", lambda s, i=i: grad_flat(s)[i])
                for i in range(sum(sizes) + n_h)]

    def _alias_reader(self, a: TreeAlias):
        def tr(s):
            return self.resolve_tree(a.tree_id, s.params, s.tree)

        if a.kind == "root_height":
            return lambda s: tr(s).heights[tr(s).root]
        if a.kind == "leaf_height":
            return lambda s, i=a.tip_index: tr(s).heights[i]
        raise Unsupported(f"cannot log alias kind {a.kind}")

    # -- traceAnalysis ------------------------------------------------------
    @staticmethod
    def _read_log_table(path):
        """A Tracer-format tab log from disk as the in-memory table
        (TraceAnalysisParser.java:70 reads the named file)."""
        header = None
        rows = []
        with open(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                parts = line.split("\t")
                if header is None:
                    header = parts
                    continue
                try:
                    rows.append([float(x) for x in parts])
                except ValueError:
                    continue
        if header is None or not rows:
            raise XmlError(f"empty or headerless log file {path!r}")
        arr = np.asarray(rows, np.float64)
        table = {name: arr[:, j] for j, name in enumerate(header)}
        states = table.pop("state", table.pop(header[0], None))
        sps = int(states[1] - states[0]) if states is not None and len(
            states) > 1 else 1
        table["_states_per_sample"] = np.array([max(1, sps)])
        return table

    def _run_trace_analysis(self, el, tolerance_se):
        from beast_mcmc_tpu_torch.inference.trace import analyze

        fname = el.get("fileName")
        if fname not in self.results:
            # a sibling file's log: read it from the working directory,
            # warn and skip where the sibling run has not made it
            path = os.path.join(self.workdir, fname)
            if os.path.exists(path):
                table = self._read_log_table(path)
            else:
                warnings.warn(
                    f"traceAnalysis log {fname!r} is not this run's output "
                    f"and does not exist on disk (skipped)")
                return None
        else:
            table = self.results[fname]
        states_per_sample = int(table["_states_per_sample"][0])
        burn_states = int(_attr(el, "burnIn", -1, int) * self.scale)
        if burn_states < 0:
            # the reference's default: 10% of the chain
            n0 = len(next(v for k, v in table.items() if k[0] != "_"))
            burn = n0 // 10
        else:
            burn = burn_states // states_per_sample
        for exp in el.findall("expectation"):
            name = exp.get("name")
            expected = float(exp.get("value"))
            if name not in table:
                # the reference skips an expectation that names no trace
                # (TraceAnalysisParser.java:86-90)
                warnings.warn(
                    f"expectation {name!r} matches no column in {fname} "
                    f"(skipped, reference semantics)")
                continue
            samples = table[name][burn:]
            st = analyze(samples)
            err = abs(st.mean - expected)
            tol = tolerance_se * max(st.std_error_of_mean, 1e-12)
            self.assertions.append((fname, name, st.mean, expected,
                                    st.std_error_of_mean))
            if not err <= tol:
                msg = (
                    f"{os.path.basename(self.path)}: E[{name}] = {st.mean:.6g}"
                    f" vs expected {expected:.6g} (|diff| {err:.3g} >"
                    f" {tolerance_se} SE = {tol:.3g}, n={samples.size})"
                )
                if self.strict_expectations:
                    raise AssertionError(msg)
                warnings.warn("WARNING (reference semantics): " + msg)


def _chains_of(log_posterior):
    """A chain-axis form of a one-chain posterior (params [B, ...], a
    [B, M] tree): one evaluation a chain, stacked to [B]."""
    from beast_mcmc_tpu_torch.tree.topology import TreeState

    def lp_chains(params, tree):
        return torch.stack([
            log_posterior({k: v[b] for k, v in params.items()},
                          TreeState(tree.parent[b], tree.children[b],
                                    tree.heights[b], tree.root[b]))
            for b in range(tree.parent.shape[0])])

    return lp_chains


# ---------------------------------------------------------------------------
# lifted operators for params-resident trees
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParamsTreeOperator:
    """A tree operator lifted to a params-resident tree (a further gene
    tree of a multilocus analysis): the TreeState is rebuilt from the
    params, the inner proposal runs, the fields are written back. The
    inner operator's adaptation is delegated."""

    inner: object = None
    keys: tuple = ()  # (parent, children, heights, root) params keys
    weight: float = 1.0
    target_acceptance: float = 0.234
    adaptable: bool = False

    def modified_params(self):
        base = self.inner.modified_params()
        return tuple(base or ()) + self.keys

    def initial_adapt(self):
        return self.inner.initial_adapt()

    def tuning(self, adapt_value):
        return self.inner.tuning(adapt_value)

    def bind_log_posterior(self, lp):
        if hasattr(self.inner, "bind_log_posterior"):
            self.inner.bind_log_posterior(lp)

    def propose(self, params, tree, gen, tuning):
        from beast_mcmc_tpu_torch.tree.topology import TreeState

        kp, kc, kh, kr = self.keys
        t2 = TreeState(parent=params[kp], children=params[kc],
                       heights=params[kh], root=params[kr])
        out = self.inner.propose(params, t2, gen, tuning)
        p2, t2n, logh = out[0], out[1], out[2]
        p2 = {**p2, kp: t2n.parent, kc: t2n.children, kh: t2n.heights,
              kr: t2n.root}
        return (p2, tree, logh) + tuple(out[3:])


# ---------------------------------------------------------------------------
# builders (the parser registry)
# ---------------------------------------------------------------------------

_BUILDERS: Dict[str, Callable] = {}

# the operator-tag extension registry: (ax, el, weight) -> (operator or
# [operators], tree_id), filled by the ported extension modules
_OP_EXT: Dict[str, Callable] = {}


def register(*tags):
    def deco(fn):
        for t in tags:
            _BUILDERS[t] = fn
        return fn

    return deco


def register_operator(*tags):
    def deco(fn):
        for t in tags:
            _OP_EXT[t] = fn
        return fn

    return deco


# -- data -------------------------------------------------------------------


def _date_value(d) -> float:
    """Decimal-year value of a <date> (dr.evolution.util.Date: a number or
    a dd/MM/yyyy calendar string)."""
    v = d.get("value")
    try:
        return float(v)
    except ValueError:
        pass
    parts = v.replace("-", "/").split("/")
    if len(parts) == 3:
        day, month, year = (int(parts[0]), int(parts[1]), int(parts[2]))
        if day > 31:  # yyyy/MM/dd
            day, year = year, day
        import datetime

        dt0 = datetime.date(year, month, day)
        start = datetime.date(year, 1, 1)
        length = (datetime.date(year + 1, 1, 1) - start).days
        return year + (dt0 - start).days / length
    raise XmlError(f"cannot parse date value {v!r}")


@register("taxa")
def _taxa(ax: XmlAnalysis, el):
    taxa = []
    for t in el:
        t = ax.deref(t)
        if t.tag != "taxon":
            continue
        name = t.get("id")
        height = 0.0
        d = t.find("date")
        if d is not None:
            d = ax.deref(d)
            v = _date_value(d)
            height = v if d.get("direction", "backwards") == "backwards" \
                else -v
        for a in t.findall("attr"):
            ax._taxon_attrs.setdefault(name, {})[a.get("name")] = (
                (a.text or "").split())
        taxa.append((name, height))
    # heights are ages relative to the youngest tip
    if taxa:
        m = min(h for _, h in taxa)
        taxa = [(n, h - m) for n, h in taxa]
    return taxa


@register("date")
def _date(ax, el):
    return el


@register("alignment")
def _alignment(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.data.alignment import Alignment
    from beast_mcmc_tpu_torch.data.datatype import (
        AMINO_ACIDS,
        BINARY,
        NUCLEOTIDES,
    )

    dt = el.get("dataType", "nucleotide")
    datatype = {"nucleotide": NUCLEOTIDES, "amino acid": AMINO_ACIDS,
                "binary": BINARY, "twoStates": BINARY}.get(dt)
    if datatype is None:
        for d_el in ax.root.iter("generalDataType"):
            if d_el.get("id") == dt:
                datatype = ax.build(d_el)
                break
    if datatype is None:
        raise Unsupported(f"alignment dataType {dt!r}")
    taxa, seqs, dates = [], [], {}
    for s in el.findall("sequence"):
        tx = ax.deref(s.find("taxon"))
        name = tx.get("id")
        seq = "".join((s.text or "").split())
        for sub in s:
            if sub.tail:
                seq += "".join(sub.tail.split())
        seq = seq.upper()
        if dt in ("binary", "twoStates"):
            seq = "".join(ch for ch in seq if ch in datatype.char_map)
        taxa.append(name)
        seqs.append(seq)
        d = tx.find("date")
        if d is not None:
            d = ax.deref(d)
            v = _date_value(d)
            dates[name] = -v if d.get("direction",
                                      "backwards") == "backwards" else v
    return Alignment.from_sequences(taxa, seqs, datatype,
                                    dates=dates or None)


@register("patterns")
def _patterns(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.data.alignment import Alignment, SitePatterns

    src = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("alignment", "beagleSequenceSimulator",
                      "sequenceSimulator", "convert"):
            built = ax.build(cc)
            if isinstance(built, Alignment):
                src = built
    if src is None:
        raise XmlError("<patterns> without <alignment>")
    frm = _attr(el, "from", 1, int) - 1
    to = _attr(el, "to", -1, int)
    to = to - 1 if to and to > 0 else -1
    every = _attr(el, "every", 1, int)
    pats = SitePatterns.from_alignment(src, site_range=(frm, to),
                                       every=every)
    if not _attr(el, "unique", True, bool):
        # site order kept (SitePatternsParser UNIQUE=false)
        lo, hi = frm, (src.n_sites if to < 0 else to + 1)
        states = src.states[:, lo:hi:every]
        pats = SitePatterns(
            taxa=pats.taxa, states=states,
            weights=np.ones(states.shape[1]), datatype=pats.datatype,
            n_sites=states.shape[1])
    return pats


@register("ascertainedPatterns")
def _ascertained_patterns(ax: XmlAnalysis, el):
    """AscertainedSitePatternsParser: the data patterns with the
    include/exclude correction columns; the likelihood renormalises each
    site by P(ascertainable)."""
    from beast_mcmc_tpu_torch.data.alignment import SitePatterns

    src = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "alignment":
            src = ax.build(cc)
    if src is None:
        raise XmlError("<ascertainedPatterns> without <alignment>")
    frm = _attr(el, "from", 1, int) - 1
    to = _attr(el, "to", -1, int)
    to = to - 1 if to and to > 0 else -1
    pats = SitePatterns.from_alignment(src, site_range=(frm, to))
    cols = []
    for tag in ("excludePatterns", "includePatterns"):
        for sub in el.findall(tag):
            a = _attr(sub, "from", 1, int) - 1
            b = _attr(sub, "to", a + 1, int)
            cols.append(src.states[:, a:b])
    if cols:
        pats.ascertain_excluded = np.concatenate(cols, axis=1)
        pats.ascertain_include = el.find("includePatterns") is not None
    return pats


@register("mergePatterns")
def _merge_patterns(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.data.alignment import SitePatterns

    parts = [ax.build(c) for c in el if ax.deref(c).tag == "patterns"]
    if not parts:
        raise XmlError("<mergePatterns> without <patterns>")
    base = parts[0]
    return SitePatterns(
        taxa=base.taxa,
        states=np.concatenate([p.states for p in parts], axis=1),
        weights=np.concatenate([p.weights for p in parts]),
        datatype=base.datatype, n_sites=sum(p.n_sites for p in parts))


@register("parameter")
def _parameter(ax: XmlAnalysis, el):
    name = el.get("id")
    if name is None:
        name = f"param{len(ax._params)}"
    if name in ax._aliases:
        return ax._aliases[name]
    if name in ax._params:
        return ax._params[name]
    vals = _text_values(el)
    dim = _attr(el, "dimension", None, int)
    if vals.size == 0:
        # ParameterParser.java:140-149: with a dimension the values
        # default to zeros; a bare <parameter/> is one 1.0
        vals = np.zeros(dim) if dim else np.ones(1)
    elif dim and vals.size == 1:
        vals = np.full(dim, vals[0])

    def bound(attr, default):
        v = el.get(attr)
        return default if v is None else float(v.split()[0])

    lo = bound("lower", -np.inf)
    hi = bound("upper", np.inf)
    # ParameterParser.java:218-226: parse-time values clamped to bounds
    vals = np.clip(vals, lo, hi)
    p = Param(name=name,
              value=vals if vals.size > 1 else np.asarray(float(vals[0])),
              lower=lo, upper=hi)
    ax._params[name] = p
    return p


@register("matrixParameter")
def _matrix_parameter(ax: XmlAnalysis, el):
    """A constant design matrix from row <parameter> values
    (MatrixParameter; covariate matrices are fixed data here)."""
    rows = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            rows.append(_text_values(cc))
    return np.stack(rows, axis=1)  # [n_field, P]


@register("multivariateNormalPrior")
def _mvn_prior(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.priors import multivariate_normal_logpdf

    mean = _text_values(ax.deref(_child_of(_child_of(el, "meanParameter"),
                                           "parameter")))
    prec_el = el.find("precisionMatrix")
    if prec_el is None:
        prec_el = el.find("precisionParameter")
    prec = None
    if prec_el is not None:
        for c in prec_el:
            cc = ax.deref(c)
            if cc.tag == "matrixParameter":
                prec = ax.build(cc).T
    if prec is None:
        prec = np.eye(mean.size)
    data_el = el.find("data")
    targets = _targets_of(ax, data_el if data_el is not None else el)
    m_t, prec_t = ax.tensor(mean), ax.tensor(prec)

    def fn(params, tree):
        tot = 0.0
        for t in targets:
            v = t(params, tree).reshape(-1)
            # a target whose length is a multiple of the mean's is scored
            # row by row (MultivariateDistributionLikelihood)
            for r in v.reshape(-1, m_t.shape[0]):
                tot = tot + multivariate_normal_logpdf(
                    r, m_t.to(v.dtype), precision=prec_t.to(v.dtype))
        return tot

    return LikelihoodFn(fn, None, "multivariateNormalPrior")


@register("jointParameter")
def _joint_parameter(ax: XmlAnalysis, el):
    """JointParameterParser: one value mirrored across several parameters,
    here the shared tip age (leaf-height views of unlinked gene trees)."""
    targets = []
    for c in el:
        obj = ax.build(ax.deref(c))
        if isinstance(obj, TreeAlias) and obj.kind == "leaf_height":
            targets.append((obj.tree_id, obj.tip_index))
        else:
            raise Unsupported("jointParameter over non-tip parameters")
    return JointTipAlias(tuple(dict.fromkeys(targets)))


@register("compoundParameter", "CompoundParameter")
def _compound_parameter(ax, el):
    names = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            names.append(ax.build(cc).name)
    return CompoundParam(names)


# -- demographics -----------------------------------------------------------


def _child_of(el, tag):
    c = el.find(tag)
    if c is None:
        raise XmlError(f"<{el.tag}> missing <{tag}>")
    return c


def _sim_pop(ax, name, log_space=False) -> float:
    v = float(np.ravel(ax.value_of(name))[0])
    return float(np.exp(v)) if log_space else v


def _rate_of(ax, el, tag):
    """params -> growth rate, from <growthRate> or <doublingTime>."""
    gr, dbl = el.find("growthRate"), el.find("doublingTime")
    if gr is not None:
        gname = ax.param_from(gr)
        return lambda params: params[gname]
    if dbl is not None:
        dname = ax.param_from(dbl)
        return lambda params: math.log(2.0) / params[dname]
    raise XmlError(f"{tag} without growthRate/doublingTime")


@register("constantSize")
def _constant_size(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.coalescent import (
        constant_coalescent_loglik)

    pname = ax.param_from(_child_of(el, "populationSize"))

    def ll(heights, n_taxa, params):
        return constant_coalescent_loglik(heights, n_taxa, params[pname])

    return Demographic("constant", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("exponentialGrowth")
def _exponential_growth(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.coalescent import (
        exponential_growth_loglik)

    pname = ax.param_from(_child_of(el, "populationSize"))
    rate_of = _rate_of(ax, el, "exponentialGrowth")

    def ll(heights, n_taxa, params):
        return exponential_growth_loglik(heights, n_taxa, params[pname],
                                         rate_of(params))

    return Demographic("exponential", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("expansion")
def _expansion(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.coalescent import expansion_loglik

    pname = ax.param_from(_child_of(el, "populationSize"))
    aname = ax.param_from(_child_of(el, "ancestralPopulationProportion"))
    rate_of = _rate_of(ax, el, "expansion")

    def ll(heights, n_taxa, params):
        return expansion_loglik(heights, n_taxa, params[pname],
                                params[aname], rate_of(params))

    return Demographic("expansion", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("piecewisePopulation")
def _piecewise_population(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.coalescent import (
        piecewise_exponential_loglik)

    pname = ax.param_from(_child_of(el, "populationSize"))
    gr = el.find("growthRates")
    if gr is None:
        raise Unsupported("piecewisePopulation without growthRates")
    gname = ax.param_from(gr)
    widths = ax.tensor([float(x) for x in
                        _child_of(el, "epochWidths").get("widths").split()])

    def ll(heights, n_taxa, params):
        return piecewise_exponential_loglik(heights, n_taxa, params[pname],
                                            params[gname], widths)

    return Demographic("piecewise", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("cataclysm")
def _cataclysm(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.coalescent import cataclysm_loglik

    pname = ax.param_from(_child_of(el, "populationSize"))
    gname = ax.param_from(_child_of(el, "growthRate"))
    sname = ax.param_from(_child_of(el, "spikeFactor"))
    tname = ax.param_from(_child_of(el, "timeOfCataclysm"))

    def ll(heights, n_taxa, params):
        return cataclysm_loglik(heights, n_taxa, params[pname],
                                params[gname], params[sname], params[tname])

    return Demographic("cataclysm", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("constantExponential")
def _constant_exponential(ax: XmlAnalysis, el):
    """ConstantExponentialModelParser, ConstantExponentialModel.java:93-104:
    N1 = N0 exp(-time * r)."""
    from beast_mcmc_tpu_torch.models.coalescent import (
        const_exponential_loglik)

    pname = ax.param_from(_child_of(el, "populationSize"))
    tname = ax.param_from(_child_of(el, "growthPhaseStartTime"))
    rate_of = _rate_of(ax, el, "constantExponential")

    def ll(heights, n_taxa, params):
        r = rate_of(params)
        n0 = params[pname]
        return const_exponential_loglik(heights, n_taxa, n0,
                                        n0 * torch.exp(-params[tname] * r), r)

    return Demographic("constantExponential", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("exponentialConstant")
def _exponential_constant(ax: XmlAnalysis, el):
    """ExponentialConstantModelParser, ExpConstant.java."""
    from beast_mcmc_tpu_torch.models.coalescent import exp_constant_loglik

    pname = ax.param_from(_child_of(el, "populationSize"))
    gname = ax.param_from(_child_of(el, "growthRate"))
    tname = ax.param_from(_child_of(el, "transitionTime"))

    def ll(heights, n_taxa, params):
        return exp_constant_loglik(heights, n_taxa, params[pname],
                                   params[gname], params[tname])

    return Demographic("exponentialConstant", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("constantLogistic")
def _constant_logistic(ax: XmlAnalysis, el):
    """ConstantLogisticModelParser, ConstLogistic.java. The XML <shape> is
    a time; c = (1 - alpha) exp(-r shape) / alpha with the required alpha
    attribute (ConstantLogisticModel.java:106)."""
    from beast_mcmc_tpu_torch.models.coalescent import const_logistic_loglik

    pname = ax.param_from(_child_of(el, "populationSize"))
    aname = ax.param_from(_child_of(el, "ancestralPopulationSize"))
    gname = ax.param_from(_child_of(el, "growthRate"))
    sname = ax.param_from(_child_of(el, "shape"))
    alpha = _attr(el, "alpha", None, float)
    if alpha is None:
        raise Unsupported(
            "<constantLogistic> without required alpha attribute")

    def ll(heights, n_taxa, params):
        r = params[gname]
        c = (1.0 - alpha) * torch.exp(-r * params[sname]) / alpha
        return const_logistic_loglik(heights, n_taxa, params[pname],
                                     params[aname], r, c)

    return Demographic("constantLogistic", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("exponentialExponential")
def _exponential_exponential(ax: XmlAnalysis, el):
    """ExponentialExponentialModelParser: two growth phases with a
    transition time (multiEpochExponential with K = 2)."""
    from beast_mcmc_tpu_torch.models.coalescent import (
        multi_epoch_exponential_loglik)

    pname = ax.param_from(_child_of(el, "populationSize"))
    gname = ax.param_from(_child_of(el, "growthRate"))
    aname = ax.param_from(_child_of(el, "ancestralGrowthRate"))
    tname = ax.param_from(_child_of(el, "transitionTime"))

    def ll(heights, n_taxa, params):
        rates = torch.stack([params[gname].reshape(-1)[0],
                             params[aname].reshape(-1)[0]])
        return multi_epoch_exponential_loglik(
            heights, n_taxa, params[pname], rates,
            params[tname].reshape(-1)[:1])

    return Demographic("exponentialExponential", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("multiEpochExponential")
def _multi_epoch_exponential(ax: XmlAnalysis, el):
    """MultiEpochExponentialModelParser, MultiEpochExponential.java."""
    from beast_mcmc_tpu_torch.models.coalescent import (
        multi_epoch_exponential_loglik)

    pname = ax.param_from(_child_of(el, "populationSize"))
    gname = ax.param_from(_child_of(el, "growthRate"))
    tname = ax.param_from(_child_of(el, "transitionTime"))

    def ll(heights, n_taxa, params):
        return multi_epoch_exponential_loglik(
            heights, n_taxa, params[pname], params[gname], params[tname])

    return Demographic("multiEpochExponential", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("exponentialSawtooth")
def _exponential_sawtooth(ax: XmlAnalysis, el):
    """ExponentialSawtoothModelParser, ExponentialSawtooth.java."""
    from beast_mcmc_tpu_torch.models.coalescent import (
        exponential_sawtooth_loglik)

    pname = ax.param_from(_child_of(el, "populationSize"))
    gname = ax.param_from(_child_of(el, "growthRate"))
    wname = ax.param_from(_child_of(el, "wavelength"))
    oname = ax.param_from(_child_of(el, "offset"))

    def ll(heights, n_taxa, params):
        return exponential_sawtooth_loglik(
            heights, n_taxa, params[pname], params[gname], params[wname],
            params[oname])

    return Demographic("exponentialSawtooth", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("exponentialLogistic")
def _exponential_logistic(ax: XmlAnalysis, el):
    """ExponentialLogisticModelParser, ExponentialLogistic.java."""
    from beast_mcmc_tpu_torch.models.coalescent import (
        exponential_logistic_loglik)

    pname = ax.param_from(_child_of(el, "populationSize"))
    lg = ax.param_from(_child_of(el, "logisticGrowthRate"))
    ls = ax.param_from(_child_of(el, "logisticShape"))
    eg = ax.param_from(_child_of(el, "exponentialGrowthRate"))
    tt = ax.param_from(_child_of(el, "transitionTime"))

    def ll(heights, n_taxa, params):
        return exponential_logistic_loglik(
            heights, n_taxa, params[pname], params[lg], params[ls],
            params[eg], params[tt])

    return Demographic("exponentialLogistic", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("linearGrowth")
def _linear_growth(ax: XmlAnalysis, el):
    """LinearGrowthModelParser (the slope vocabulary)."""
    from beast_mcmc_tpu_torch.models.coalescent import linear_growth_loglik

    sname = ax.param_from(_child_of(el, "slope"))

    def ll(heights, n_taxa, params):
        return linear_growth_loglik(heights, n_taxa, params[sname])

    return Demographic("linearGrowth", {"pop": sname}, ll,
                       sim_pop=_sim_pop(ax, sname))


@register("powerLawGrowth")
def _power_law_growth(ax: XmlAnalysis, el):
    """PowerLawGrowthModelParser, PowerLawGrowth.java."""
    from beast_mcmc_tpu_torch.models.coalescent import (
        power_law_growth_loglik)

    pname = ax.param_from(_child_of(el, "populationSize"))
    rname = ax.param_from(_child_of(el, "power"))

    def ll(heights, n_taxa, params):
        return power_law_growth_loglik(heights, n_taxa, params[pname],
                                       params[rname])

    return Demographic("powerLawGrowth", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname))


@register("piecewisePopulationSize")
def _piecewise_pop_size_model(ax: XmlAnalysis, el):
    """The log-space piecewise model (PiecewisePopulationSizeModel): N(0) =
    exp(logN0), chained exponential epochs of given durations."""
    from beast_mcmc_tpu_torch.models.coalescent import (
        piecewise_exponential_loglik)

    pname = ax.param_from(_child_of(el, "logPopulationSize"))
    rate_names = []
    for ep in _child_of(el, "epochs"):
        epc = ax.deref(ep)
        if epc.tag == "exponentialPopulationSize":
            rate_names.append(ax.param_from(_child_of(epc, "growthRate")))
    dname = ax.param_from(_child_of(el, "epochDurations"))
    k = len(rate_names)

    def ll(heights, n_taxa, params):
        lams = torch.stack([params[r].reshape(()) for r in rate_names])
        widths = params[dname].reshape(-1).expand(k - 1)
        return piecewise_exponential_loglik(
            heights, n_taxa, torch.exp(params[pname]).reshape(1), lams,
            widths)

    return Demographic("piecewise_log", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname, True))


@register("constantPopulationSize")
def _constant_pop_size_model(ax: XmlAnalysis, el):
    """The log-space constant-size model (ConstantPopulationSizeModel: the
    parameter is log N)."""
    from beast_mcmc_tpu_torch.models.coalescent import (
        constant_coalescent_loglik)

    pname = ax.param_from(_child_of(el, "logPopulationSize"))

    def ll(heights, n_taxa, params):
        return constant_coalescent_loglik(heights, n_taxa,
                                          torch.exp(params[pname]))

    return Demographic("constant_log", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname, True))


@register("exponentialPopulationSize")
def _exponential_pop_size_model(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.coalescent import (
        exponential_growth_loglik)

    pname = ax.param_from(_child_of(el, "logPopulationSize"))
    gname = ax.param_from(_child_of(el, "growthRate"))

    def ll(heights, n_taxa, params):
        return exponential_growth_loglik(heights, n_taxa,
                                         torch.exp(params[pname]),
                                         params[gname])

    return Demographic("exponential_log", {"pop": pname}, ll,
                       sim_pop=_sim_pop(ax, pname, True))


# -- trees ------------------------------------------------------------------

_DEMOGRAPHIC_TAGS = ("constantSize", "exponentialGrowth", "expansion",
                     "piecewisePopulation", "cataclysm",
                     "constantPopulationSize", "exponentialPopulationSize",
                     "piecewisePopulationSize")


def _scale_start_tree(n_tips, parent, heights, root, root_height):
    """Scale the internal heights so that the root lands at root_height,
    then push any internal node below its tallest child back up
    (CoalescentSimulator.attemptToScaleTree:132-142,
    correctHeightsForTips), by a strictly positive epsilon."""
    s = root_height / heights[root]
    heights[n_tips:] *= s
    eps = 1e-6 * root_height
    for _ in range(len(heights)):  # bottom-up fixpoint on the host
        changed = False
        for i in range(len(heights)):
            p = parent[i]
            if p >= 0 and heights[p] < heights[i] + eps:
                heights[p] = heights[i] + eps
                changed = True
        if not changed:
            break
    return heights


@register("coalescentTree", "coalescentSimulator")
def _coalescent_tree(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    ax._rng_used = True  # a seeded draw: see config/xml_assert.py
    taxa, demo, subtrees = None, None, []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "taxa":
            taxa = ax.build(cc)
        elif cc.tag in _DEMOGRAPHIC_TAGS:
            demo = ax.build(cc)
        elif cc.tag in ("coalescentTree", "coalescentSimulator"):
            subtrees.append(ax.build(cc))
    if taxa is None and not subtrees:
        raise XmlError(f"<{el.tag}> without <taxa>")
    pop = demo.sim_pop if demo else 1.0
    if not subtrees:
        names = [n for n, _ in taxa]
        tips = np.array([h for _, h in taxa])
        parent, children, heights, root = simulate_coalescent_tree(
            ax._rng, tips, pop_size=pop)
        rh = _attr(el, "rootHeight", -1.0, float)
        if rh > 0:
            heights = _scale_start_tree(len(tips), parent, heights, root, rh)
        return (names, tips, parent, children, heights, root)
    # nested constrained simulation (CoalescentSimulator.java:simulateTree
    # over subtree roots): each nested clade, then its root and the
    # leftover taxa coalesced above it
    sub_names = [n for s in subtrees for n in s[0]]
    free = [(n, h) for n, h in (taxa or []) if n not in sub_names]
    names = sub_names + [n for n, _ in free]
    n_total = len(names)
    m_total = 2 * n_total - 1
    parent = np.full(m_total, -1, np.int32)
    children = np.full((m_total, 2), -1, np.int32)
    heights = np.zeros(m_total)
    name_to_idx = {n: i for i, n in enumerate(names)}
    next_internal = n_total
    unit_roots = []  # (global node id, height) of each coalescing unit
    for s in subtrees:
        snames, stips, sparent, schildren, sheights, sroot = s
        n_s = len(snames)
        mapping = {}
        for li, n in enumerate(snames):
            mapping[li] = name_to_idx[n]
            heights[name_to_idx[n]] = sheights[li]
        for li in range(n_s, 2 * n_s - 1):
            mapping[li] = next_internal
            heights[next_internal] = sheights[li]
            next_internal += 1
        for li in range(2 * n_s - 1):
            gi = mapping[li]
            if sparent[li] >= 0:
                parent[gi] = mapping[int(sparent[li])]
            for k in range(2):
                if schildren[li, k] >= 0:
                    children[gi, k] = mapping[int(schildren[li, k])]
        unit_roots.append((mapping[int(sroot)], float(sheights[int(sroot)])))
    for n, h in free:
        heights[name_to_idx[n]] = h
        unit_roots.append((name_to_idx[n], h))
    unit_tips = np.array([h for _, h in unit_roots])
    up, uc, uh, ur = simulate_coalescent_tree(ax._rng, unit_tips,
                                              pop_size=pop)
    n_u = len(unit_roots)
    umap = {ui: unit_roots[ui][0] for ui in range(n_u)}
    for ui in range(n_u, 2 * n_u - 1):
        umap[ui] = next_internal
        heights[next_internal] = uh[ui]
        next_internal += 1
    for ui in range(2 * n_u - 1):
        gi = umap[ui]
        if up[ui] >= 0:
            parent[gi] = umap[int(up[ui])]
        if ui >= n_u:
            for k in range(2):
                children[gi, k] = umap[int(uc[ui, k])]
    root = umap[int(ur)]
    rh = _attr(el, "rootHeight", -1.0, float)
    if rh > 0:
        heights = _scale_start_tree(n_total, parent, heights, root, rh)
    return (names, heights[:n_total].copy(), parent, children, heights, root)


def _binarize_newick(text: str) -> str:
    """Resolve multifurcations with zero-length internal branches (the
    pulley principle keeps reversible likelihoods equal)."""
    pos = 0

    def parse_node():
        nonlocal pos
        if text[pos] == "(":
            pos += 1
            kids = [parse_node()]
            while text[pos] == ",":
                pos += 1
                kids.append(parse_node())
            assert text[pos] == ")"
            pos += 1
            label = ""
            while pos < len(text) and text[pos] not in ",();":
                label += text[pos]
                pos += 1
            while len(kids) > 2:
                kids = [f"({kids[0]},{kids[1]}):0.0"] + kids[2:]
            return f"({','.join(kids)}){label}"
        label = ""
        while pos < len(text) and text[pos] not in ",();":
            label += text[pos]
            pos += 1
        return label

    return parse_node() + ";"


@register("newick")
def _newick(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.tree.topology import parse_newick

    text = (el.text or "").strip()
    for sub in el:
        if sub.tail:
            text += sub.tail.strip()
    if "'" not in text and '"' not in text:
        text = _binarize_newick("".join(text.split()))
    parent, children, heights, root, names = parse_newick(text)
    n_tips = (parent.shape[0] + 1) // 2
    return (names, heights[:n_tips], parent, children, heights, root)


@register("treeModel")
def _tree_model(ax: XmlAnalysis, el):
    tree_id = el.get("id") or f"tree{len(ax._trees)}"
    src = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("coalescentTree", "coalescentSimulator", "newick",
                      "tree", "upgmaTree", "neighborJoiningTree",
                      "rescaledTree"):
            src = ax.build(cc)
            break
    if src is None:
        raise XmlError("<treeModel> without a starting tree")
    names, tips, parent, children, heights, root = src
    tm = TreeModel(tree_id, names, tips, parent, children, heights, root)
    ax._trees[tree_id] = tm
    # the tree-view parameter aliases
    for c in el:
        if c.tag == "rootHeight":
            p = ax.deref(_child_of(c, "parameter"))
            ax._aliases[p.get("id")] = TreeAlias("root_height", tree_id)
        elif c.tag == "nodeHeights":
            p = ax.deref(_child_of(c, "parameter"))
            kind = ("all_heights" if _attr(c, "rootNode", False, bool)
                    else "internal_heights")
            ax._aliases[p.get("id")] = TreeAlias(kind, tree_id)
        elif c.tag == "leafHeight":
            taxon = c.get("taxon")
            p = ax.deref(_child_of(c, "parameter"))
            idx = names.index(taxon)
            ax._aliases[p.get("id")] = TreeAlias("leaf_height", tree_id, idx)
            tm.sampled_tips[taxon] = idx
        elif c.tag == "nodeTraits":
            _node_traits(ax, c, tree_id, names, root)
    return tm


def _node_traits(ax: XmlAnalysis, c, tree_id, names, root):
    """A continuous trait over the tree's nodes from taxon attributes
    (TreeModelParser NODE_TRAITS)."""
    tname = c.get("name") or "trait"
    d = _attr(c, "traitDimension", 1, int)
    leaf = _attr(c, "leafNodes", False, bool)
    internal = _attr(c, "internalNodes", False, bool)
    root_too = _attr(c, "rootNode", False, bool)
    p = ax.deref(_child_of(c, "parameter"))
    pname = p.get("id") or f"{tree_id}.{tname}"
    init = None
    if c.get("initialValue"):
        init = np.array([float(x) for x in c.get("initialValue").split()])
    if leaf and internal and root_too:
        # every node's trait, [M, d] in node order, tips from the taxon
        # attributes; later nodeTraits of the same trait are index views
        n = len(names)
        vals = np.zeros((2 * n - 1, d))
        for i, nm in enumerate(names):
            raw = ax._taxon_attrs.get(nm, {}).get(tname)
            if raw is not None:
                vals[i] = [0.0 if s.upper() in ("NA", "?") else float(s)
                           for s in raw[:d]]
        ax._params[pname] = Param(name=pname, value=vals.reshape(-1))
        ax._built[id(p)] = ax._params[pname]
        ax._traits[(tree_id, tname)] = {
            "param": pname, "dim": d, "missing": np.zeros((n, d), bool),
            "n_tips": n, "layout": "all_nodes", "root": int(root)}
        return
    store = ax._traits.get((tree_id, tname))
    if store is not None and store.get("layout") == "all_nodes":
        n = store["n_tips"]
        rt = store["root"]
        sel = []
        for node in range(2 * n - 1):
            is_tip, is_root = node < n, node == rt
            if ((is_tip and leaf) or (is_root and root_too)
                    or (not is_tip and not is_root and internal)):
                sel.extend(range(node * d, (node + 1) * d))
        idx = np.asarray(sel, np.int64)
        base = store["param"]
        tidx = ax.tensor(idx, torch.long)

        def fn(prms, nb=base, ix=tidx):
            return prms[nb].reshape(-1)[ix]

        ax._derived_params[pname] = fn
        ax._built[id(p)] = DerivedParam(
            pname, fn, value=np.ravel(ax._params[base].value)[idx],
            base=base, idx=idx)
        return
    if not leaf:
        # internal/root storage: a free parameter, one row a selected node
        n_sel = (len(names) - 1 if internal else 0) + (1 if root_too else 0)
        vals0 = np.zeros(max(n_sel, 1) * d)
        if init is not None:
            vals0 = np.resize(init, vals0.shape)
        ax._params[pname] = Param(name=pname, value=vals0)
        ax._built[id(p)] = ax._params[pname]
        return
    # the data's width wins over the declared traitDimension
    first = next((ax._taxon_attrs.get(nm, {}).get(tname) for nm in names
                  if ax._taxon_attrs.get(nm, {}).get(tname)), None)
    if first is not None and len(first) != d:
        d = len(first)
    vals = np.zeros((len(names), d))
    mask = np.zeros((len(names), d), bool)
    for i, nm in enumerate(names):
        raw = ax._taxon_attrs.get(nm, {}).get(tname)
        if raw is None and "." in tname:
            raw = ax._taxon_attrs.get(nm, {}).get(tname.split(".")[-1])
        if raw is None:
            if init is not None:
                vals[i] = np.resize(init, d)
            continue
        if len(raw) != d:
            raise XmlError(f"attr {tname!r} of {nm!r} has {len(raw)} values, "
                           f"traitDimension={d}")
        for j, s in enumerate(raw):
            if s.upper() in ("NA", "?"):
                mask[i, j] = True
            else:
                vals[i, j] = float(s)
    ax._params[pname] = Param(name=pname, value=vals.reshape(-1))
    ax._traits[(tree_id, tname)] = {"param": pname, "dim": d,
                                    "missing": mask, "n_tips": len(names)}
    ax._built[id(p)] = ax._params[pname]


# -- substitution, site and clock models ------------------------------------


@register("frequencyModel")
def _frequency_model(ax: XmlAnalysis, el):
    """With an <alignment> child and a value-less parameter the frequencies
    start at the alignment's empirical composition
    (FrequencyModelParser.java getEmpiricalStateFrequencies)."""
    f = el.find("frequencies")
    if f is None:
        raise XmlError("frequencyModel without frequencies")
    aln = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "alignment":
            aln = ax.build(cc)
    pel = ax.deref(_child_of(f, "parameter"))
    explicit = pel.get("value") is not None
    pname = ax.param_from(f)
    if aln is not None and not explicit:
        states = aln.states
        k = aln.datatype.state_count
        counts = np.array([np.sum(states == s) for s in range(k)],
                          np.float64)
        ax._params[pname] = Param(pname, counts / counts.sum(), lower=0.0,
                                  upper=1.0)
    elif _attr(el, "normalize", False, bool):
        # FrequencyModelParser.java:169-179: normalised at parse time, an
        # all-zero vector uniform
        p = ax._params[pname]
        v = np.atleast_1d(np.asarray(p.value, float))
        tot = v.sum()
        v = v / tot if tot != 0 else np.full(v.size, 1.0 / v.size)
        ax._params[pname] = Param(pname, v, p.lower, p.upper)
    return pname


def _freqs_name(ax, el):
    fq = _child_of(el, "frequencies")
    fm = None
    for c in fq:
        cc = ax.deref(c)
        if cc.tag == "frequencyModel":
            fm = ax.build(cc)
    return fm if fm is not None else ax.param_from(fq)


@register("HKYModel", "hkyModel")
def _hky_model(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.substitution import hky_eigen

    fm = _freqs_name(ax, el)
    kname = ax.param_from(_child_of(el, "kappa"))

    def freqs(params):
        f = params[fm]
        return f / torch.sum(f)

    def eigen(params):
        return hky_eigen(params[kname], freqs(params))

    return ("subst", eigen, freqs, 4)


@register("jcModel")
def _jc_model(ax: XmlAnalysis, el):
    """JC69: equal rates and frequencies."""
    from beast_mcmc_tpu_torch.models.substitution import hky_eigen

    f0 = torch.full((4,), 0.25, dtype=ax.dtype, device=ax.device)

    def freqs(params):
        return f0

    def eigen(params):
        return hky_eigen(torch.ones((), dtype=ax.dtype, device=ax.device),
                         f0)

    return ("subst", eigen, freqs, 4)


@register("taxon")
def _taxon_standalone(ax: XmlAnalysis, el):
    """TaxonParser: a standalone taxon is its id."""
    return el.get("id") or el.get("idref")


@register("sequence")
def _sequence_standalone(ax: XmlAnalysis, el):
    """SequenceParser: (taxon id, character string)."""
    tx = el.find("taxon")
    name = ax.deref(tx).get("id") if tx is not None else None
    return (name, "".join("".join(el.itertext()).split()))


@register("gtrModel")
def _gtr_model(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.substitution import gtr_eigen

    fm = _freqs_name(ax, el)
    roles = ("rateAC", "rateAG", "rateAT", "rateCG", "rateCT", "rateGT")
    names = {}
    for role in roles:
        c = el.find(role)
        if c is not None:
            names[role] = ax.param_from(c)
    # one 6-vector <rates> (GTRParser RATES, the BEAUti form)
    vec_name = None
    if not names:
        rt = el.find("rates")
        if rt is not None:
            vec_name = ax.param_from(rt)

    def freqs(params):
        f = params[fm]
        return f / torch.sum(f)

    def eigen(params):
        if vec_name is not None:
            return gtr_eigen(params[vec_name].reshape(-1), freqs(params))
        one = torch.ones((), dtype=params[fm].dtype, device=ax.device)
        return gtr_eigen(torch.stack([
            (params[names[k]] if k in names else one).reshape(())
            for k in roles]), freqs(params))

    return ("subst", eigen, freqs, 4)


class BranchModelSpec:
    """A per-branch substitution-model assignment (EpochBranchModel.java:47,
    BranchSpecificSubstitutionBranchModel): p_mats(params, tree, cat_rates,
    branch_rates) -> [M, C, S, S]."""

    def __init__(self, p_mats, freqs_of, k, root_subst=None):
        self.p_mats = p_mats
        self.freqs_of = freqs_of
        self.k = k
        self.root_subst = root_subst  # the root (oldest) model's tuple


def _scalar_of(ax, params, v):
    """A stem weight or an epoch time: a parameter's name or a number."""
    if isinstance(v, str):
        return params[v].reshape(())
    return torch.tensor(float(v), dtype=ax.dtype, device=ax.device)


@register("epochBranchModel")
def _epoch_branch_model(ax: XmlAnalysis, el):
    """EpochBranchModelParser: <epoch transitionTime="t"> children (young to
    old) and one final ancestral model; a branch across boundaries gets the
    oldest-first product of its epochs' matrices
    (models/epoch.py::epoch_branch_matrices)."""
    models, times = [], []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "epoch":
            t_attr = cc.get("transitionTime")
            times.append(float(t_attr) if t_attr is not None
                         else ax.param_from(cc))
            inner = None
            for d in cc:
                dd = ax.deref(d)
                if dd.tag == "parameter":
                    continue
                inner = ax.build(dd)
            models.append(inner)
        elif cc.tag in ("treeModel", "starTreeModel"):
            ax.build(cc)
        else:
            try:
                obj = ax.build(cc)
            except (Unsupported, XmlError):
                continue
            if isinstance(obj, tuple) and obj[0] in ("subst", "subst_q"):
                models.append(obj)
    if len(models) < 2 or len(times) != len(models) - 1:
        raise XmlError("epochBranchModel needs epochs + ancestral model")
    k = models[-1][3]

    def p_mats(params, tree, cat_rates, branch_rates):
        from beast_mcmc_tpu_torch.models.epoch import epoch_branch_matrices

        bounds = torch.stack([_scalar_of(ax, params, t) for t in times]) \
            .to(tree.heights.dtype)
        return epoch_branch_matrices([m[1](params) for m in models], bounds,
                                     tree.parent, tree.heights, branch_rates,
                                     cat_rates)

    # the root frequencies are the ancestral (oldest) model's
    return BranchModelSpec(p_mats, models[-1][2], k, models[-1])


@register("branchSpecificSubstitutionModel",
          "estimableStemWeightBranchSpecificSubstitutionModel")
def _branch_specific_subst_model(ax: XmlAnalysis, el):
    """BranchSpecificBranchModelParser, setupNodeMaps:240-366: the base
    model on every branch, each <clade>'s MRCA subtree the clade model, the
    stem P_base((1-w) L) @ P_clade(w L) with stemWeight w (an attribute, or
    a <stemWeight> parameter); the MRCA and descendant masks on the device
    (models/epoch.py::clade_branch_matrices)."""
    base = tm = None
    clades = []  # (taxa, model tuple, weight as a number or param name)
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("treeModel", "starTreeModel"):
            tm = ax.build(cc)
        elif cc.tag in ("clade", "externalBranches"):
            w = cc.get("stemWeight")
            w = float(w) if w is not None else 0.0
            model = taxa = None
            for d in cc:
                dd = ax.deref(d)
                if dd.tag == "stemWeight":
                    w = ax.param_from(dd)
                elif dd.tag == "taxa":
                    taxa = ax.build(dd)
                else:
                    try:
                        obj = ax.build(dd)
                    except (Unsupported, XmlError):
                        continue
                    if isinstance(obj, tuple) and obj[0] in ("subst",
                                                             "subst_q"):
                        model = obj
            if model is None or taxa is None:
                raise XmlError(f"<{cc.tag}> needs taxa + model")
            clades.append((taxa, model, w))
        else:
            try:
                obj = ax.build(cc)
            except (Unsupported, XmlError):
                continue
            if isinstance(obj, tuple) and obj[0] in ("subst", "subst_q"):
                base = obj
    if base is None or tm is None:
        raise XmlError("branchSpecificSubstitutionModel needs tree + model")
    n = len(tm.taxa)
    specs = []
    for taxa, model, w in clades:
        mask = np.zeros(n, bool)
        for nm_t, _h in taxa:
            mask[tm.taxa.index(nm_t)] = True
        specs.append((ax.tensor(mask), model, w))

    def p_mats(params, tree, cat_rates, branch_rates):
        from beast_mcmc_tpu_torch.models.epoch import clade_branch_matrices

        built = [(mask, model[1](params), _scalar_of(ax, params, w))
                 for mask, model, w in specs]
        return clade_branch_matrices(base[1](params), built, tree.parent,
                                     tree.heights, tree.root, branch_rates,
                                     cat_rates)

    return BranchModelSpec(p_mats, base[2], base[3], base)


@register("aminoAcidModel", "empiricalAminoAcidModel")
def _amino_acid_model(ax: XmlAnalysis, el):
    """EmpiricalAminoAcidModelParser: a named empirical replacement matrix,
    with an optional <frequencies> override (+F)."""
    from beast_mcmc_tpu_torch.models.data.aa_matrices import AA_MODELS
    from beast_mcmc_tpu_torch.models.substitution import empirical_aa_eigen

    typ = el.get("type")
    fname = None
    fq = el.find("frequencies")
    if fq is not None:
        for c in fq:
            cc = ax.deref(c)
            if cc.tag == "frequencyModel":
                fname = ax.build(cc)
    f_model = ax.tensor(AA_MODELS[typ.upper()]["frequencies"])

    def freqs(params):
        if fname is not None:
            f = params[fname]
            return f / torch.sum(f)
        return f_model

    def eigen(params):
        f = freqs(params) if fname is not None else None
        return empirical_aa_eigen(typ, f, dtype=ax.dtype, device=ax.device)

    return ("subst", eigen, freqs, 20)


@register("siteModel")
def _site_model(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.sitemodel import (
        discrete_gamma_rates,
        invariant_only_rates,
        single_rate,
    )

    sub = None
    sm_el = el.find("substitutionModel")
    if sm_el is not None:
        for c in sm_el:
            sub = ax.build(ax.deref(c))
    else:
        # <branchSubstitutionModel> wraps a per-branch model
        # (GammaSiteRateModelParser); branch models may also sit directly
        # under <siteModel>
        bsm = el.find("branchSubstitutionModel")
        if bsm is not None:
            for c in bsm:
                sub = ax.build(ax.deref(c))
        else:
            for c in el:
                cc = ax.deref(c)
                if cc.tag in ("epochBranchModel",
                              "branchSpecificSubstitutionModel",
                              "estimableStemWeight"
                              "BranchSpecificSubstitutionModel"):
                    sub = ax.build(cc)
    if isinstance(sub, BranchModelSpec):
        sub = ("branch", sub, sub.freqs_of, sub.k)
    if sub is None or sub[0] not in ("subst", "subst_q", "branch"):
        raise XmlError("<siteModel> missing <substitutionModel>")
    kind, eigen, freqs_of, s = sub

    gs = el.find("gammaShape")
    mu = el.find("mutationRate") or el.find("relativeRate")
    pinv = el.find("proportionInvariant")
    n_cat = int(gs.get("gammaCategories", "4")) if gs is not None else 1
    gname = ax.param_from(gs) if gs is not None else None
    mname = ax.param_from(mu) if mu is not None else None
    iname = ax.param_from(pinv) if pinv is not None else None

    def rates_weights(params, dtype, exact=False):
        # the JAX package asks for exact_quantiles, which takes effect only
        # for a concrete alpha: under its chain's jit alpha never is, and
        # the chain takes the smooth quantiles, as here (no host read);
        # its eager parse-time evaluations (the sequence simulator) take
        # AS91's, as exact=True does
        if gname is not None:
            r, w = discrete_gamma_rates(
                params[gname], n_cat,
                p_invariant=params[iname] if iname else None, dtype=dtype,
                exact_quantiles=exact)
        elif iname is not None:
            r, w = invariant_only_rates(params[iname])
            r, w = r.to(dtype), w.to(dtype)
        else:
            r, w = single_rate(dtype=dtype, device=ax.device)
        if mname is not None:
            r = r * params[mname]
        return r, w

    return ({"subst": "site", "subst_q": "site_q",
             "branch": "site_branch"}[kind],
            eigen, freqs_of, s, rates_weights)


def _quantile_model(ax: XmlAnalysis, dist_el):
    """q -> rate, the quantile function of the relaxed clock's rate
    distribution (logNormal, gamma or exponential distribution model, as
    DiscretizedBranchRates uses them)."""
    from beast_mcmc_tpu_torch.models.clock import lognormal_quantile

    for c in dist_el:
        cc = ax.deref(c)
        if cc.tag == "logNormalDistributionModel":
            mreal = _attr(cc, "meanInRealSpace", False, bool)
            mname = ax.param_from(_child_of(cc, "mean"))
            sname = ax.param_from(_child_of(cc, "stdev"))
            return lambda params, q: lognormal_quantile(
                q, params[mname], params[sname], mreal)
        if cc.tag == "gammaDistributionModel":
            from beast_mcmc_tpu_torch.ops.special import gamma_quantile

            shname = ax.param_from(cc.find("shape"))
            mean_el = cc.find("mean")
            if mean_el is not None:
                mname = ax.param_from(mean_el)
                return lambda params, q: gamma_quantile(
                    q, params[shname], params[mname] / params[shname])
            scname = ax.param_from(cc.find("scale"))
            return lambda params, q: gamma_quantile(q, params[shname],
                                                    params[scname])
        if cc.tag == "exponentialDistributionModel":
            mname = ax.param_from(_child_of(cc, "mean"))
            return lambda params, q: -params[mname] * torch.log1p(-q)
    raise Unsupported(
        f"relaxed-clock distribution <{[ax.deref(c).tag for c in dist_el]}>")


@register("strictClockBranchRates")
def _strict_clock(ax: XmlAnalysis, el):
    rname = ax.param_from(_child_of(el, "rate"))
    return ClockModel("strict", None, lambda params, tree: params[rname],
                      rate_param=rname)


@register("discretizedBranchRates")
def _discretized_clock(ax: XmlAnalysis, el):
    tm = ax.build(_child_of(el, "treeModel"))
    qf = _quantile_model(ax, _child_of(el, "distribution"))
    cats_el = ax.deref(_child_of(_child_of(el, "rateCategories"),
                                 "parameter"))
    cname = cats_el.get("id")
    m = tm.parent.shape[0]
    n_cat = m - 1  # one category slot a branch (the reference's default)
    ax._params[cname] = Param(cname, np.arange(m) % n_cat, integer=True)

    def rates(params, tree):
        q = (params[cname].to(tree.heights.dtype) + 0.5) / n_cat
        return qf(params, q)

    return ClockModel("discretized", tm.tree_id, rates)


@register("continuousBranchRates")
def _continuous_clock(ax: XmlAnalysis, el):
    tm = ax.build(_child_of(el, "treeModel"))
    qf = _quantile_model(ax, _child_of(el, "distribution"))
    q_el = ax.deref(_child_of(_child_of(el, "rateCategoryQuantiles"),
                              "parameter"))
    qname = q_el.get("id")
    ax._params[qname] = Param(qname, np.full(tm.parent.shape[0], 0.5),
                              lower=1e-9, upper=1 - 1e-9)
    return ClockModel("continuous_quantile", tm.tree_id,
                      lambda params, tree: qf(params, params[qname]))


@register("localClockModel")
def _local_clock(ax: XmlAnalysis, el):
    """Fixed local clocks on named clades (LocalClockModel.java): the
    branches inside each clade (and its stem, where asked) take the
    clade's rate, the rest the background rate. The clade is found in the
    current topology every evaluation (the MRCA and descendant masks by
    pointer doubling), so topology moves stay valid."""
    from beast_mcmc_tpu_torch.models.clock import ancestor_or_self_mask
    from beast_mcmc_tpu_torch.models.speciation import mrca_node

    tm = ax.build(_child_of(el, "treeModel"))
    rname = ax.param_from(_child_of(el, "rate"))
    m = tm.parent.shape[0]
    ar = torch.arange(m, device=ax.device)
    clades = []
    for c in el.findall("clade"):
        crate = ax.param_from(c)
        taxa = None
        for t in c:
            tt = ax.deref(t)
            if tt.tag == "taxa":
                taxa = ax.build(tt)
        tip_set = np.zeros(m, bool)
        for n, _ in taxa:
            tip_set[tm.taxa.index(n)] = True
        clades.append((crate, ax.tensor(tip_set, torch.bool),
                       _attr(c, "includeStem", False, bool)))

    def rates(params, tree):
        r = torch.zeros(m, dtype=tree.heights.dtype,
                        device=ax.device) + params[rname]
        for crate, tip_set, include_stem in clades:
            node = mrca_node(tree.parent, tree.heights, tip_set)
            # nodes with `node` as ancestor-or-self; the branch above node
            # is the stem
            mask = ancestor_or_self_mask(tree.parent, node)
            if not include_stem:
                mask = mask & (ar != node)
            r = torch.where(mask, params[crate], r)
        return r

    return ClockModel("local", tm.tree_id, rates)


@register("randomLocalClockModel")
def _random_local_clock(ax: XmlAnalysis, el):
    """Random local clocks (RandomLocalClockModel.java): per-node change
    indicators and rates; a branch's rate is that of its nearest selected
    ancestor-or-self, by pointer doubling
    (models/clock.py::random_local_clock_rates)."""
    from beast_mcmc_tpu_torch.models.clock import random_local_clock_rates

    tm = ax.build(_child_of(el, "treeModel"))
    m = tm.parent.shape[0]
    rates_el = ax.deref(_child_of(_child_of(el, "rates"), "parameter"))
    ind_el = ax.deref(_child_of(_child_of(el, "rateIndicator"), "parameter"))
    clock_el = el.find("clockRate")
    cname = ax.param_from(clock_el) if clock_el is not None else None
    rn, iname = rates_el.get("id"), ind_el.get("id")
    ax._params[rn] = Param(rn, np.ones(m), lower=0.0)
    ax._params[iname] = Param(iname, np.zeros(m), integer=True)

    def rates(params, tree):
        dt = tree.heights.dtype
        r = random_local_clock_rates(tree.parent, tree.heights,
                                     params[iname].to(dt),
                                     params[rn].to(dt))
        return r * params[cname] if cname else r

    return ClockModel("random_local", tm.tree_id, rates)


def _tip_set(ax, tm, taxa) -> torch.Tensor:
    tip_set = np.zeros(tm.parent.shape[0], bool)
    for n, _ in taxa:
        tip_set[tm.taxa.index(n)] = True
    return ax.tensor(tip_set, torch.bool)


@register("monophylyStatistic")
def _monophyly_statistic(ax: XmlAnalysis, el):
    """1 where the clade is monophyletic in the current tree
    (MonophylyStatistic.java)."""
    from beast_mcmc_tpu_torch.models.clock import ancestor_or_self_mask
    from beast_mcmc_tpu_torch.models.speciation import mrca_node

    tm = taxa = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tm = ax.build(cc)
        elif cc.tag == "mrca":
            for t in cc:
                taxa = ax.build(ax.deref(t))
        elif cc.tag == "taxa":
            taxa = ax.build(cc)
    n_taxa = len(tm.taxa)
    tip_set = _tip_set(ax, tm, taxa)
    size = int(tip_set.sum())

    def stat(s, tid=tm.tree_id):
        t = ax.resolve_tree(tid, s.params, s.tree)
        node = mrca_node(t.parent, t.heights, tip_set)
        n_below = torch.sum(ancestor_or_self_mask(t.parent, node)[:n_taxa])
        return (n_below == size).to(t.heights.dtype)

    return stat


@register("booleanLikelihood")
def _boolean_likelihood(ax: XmlAnalysis, el):
    """-inf unless every child boolean statistic is true
    (BooleanLikelihood.java)."""
    stats = [ax.build(c) for c in el]

    def fn(params, tree):
        s = _StateShim(params, tree)
        ok = ax.as_lp(1.0)
        for st in stats:
            ok = ok * st(s)
        return torch.where(ok > 0, ax.as_lp(0.0), ax.as_lp(-math.inf))

    return LikelihoodFn(fn, None, "booleanLikelihood")


# -- likelihoods -------------------------------------------------------------


@register("coalescentLikelihood")
def _coalescent_likelihood(ax: XmlAnalysis, el):
    demo = tm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "model":
            for d in cc:
                demo = ax.build(ax.deref(d))
        elif cc.tag == "populationTree":
            for t in cc:
                tm = ax.build(ax.deref(t))
        elif cc.tag in _DEMOGRAPHIC_TAGS:
            demo = ax.build(cc)
        elif cc.tag == "treeModel":
            tm = ax.build(cc)
    if isinstance(demo, VariableDemographic):
        from beast_mcmc_tpu_torch.models.coalescent import (
            ebsp_coalescent_loglik)

        vd = demo
        n_taxas = [len(ax._trees[t].taxa) for t in vd.tree_ids]

        def fn(params, tree):
            hs = [ax.resolve_tree(t, params, tree).heights
                  for t in vd.tree_ids]
            return ebsp_coalescent_loglik(hs, n_taxas, vd.ploidies,
                                          params[vd.pop_param],
                                          params[vd.ind_param],
                                          vd.use_midpoints)

        # no tree_id: the trees resolve inside (a multi-tree likelihood)
        return LikelihoodFn(fn, None, el.get("id") or "coalescent")
    if demo is None or tm is None:
        raise XmlError("coalescentLikelihood needs model + populationTree")
    n_taxa = len(tm.taxa)

    def fn(params, tree):
        return demo.loglik(tree.heights, n_taxa, params)

    return LikelihoodFn(fn, tm.tree_id, el.get("id") or "coalescent")


def _default_groups(n_taxa: int, k: int) -> np.ndarray:
    """n_taxa - 1 coalescent events spread over k groups, the first ones a
    larger by one."""
    base = (n_taxa - 1) // k
    g = np.full(k, base)
    g[: (n_taxa - 1) - base * k] += 1
    return g


@register("generalizedSkyLineLikelihood")
def _bsp_likelihood(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.coalescent import (
        bayesian_skyline_linear_loglik,
        bayesian_skyline_loglik,
    )

    pops = ax.param_from(_child_of(el, "populationSizes"))
    gs_el = ax.deref(_child_of(_child_of(el, "groupSizes"), "parameter"))
    pt = el.find("populationTree")
    if pt is not None:
        for t in pt:
            tm = ax.build(ax.deref(t))
    else:
        tm = ax.build(_child_of(el, "treeModel"))
    n_taxa = len(tm.taxa)
    k = ax._params[pops].value.size if ax._params[pops].value.ndim else 1
    linear = _attr(el, "linear", False, bool)
    if linear:
        k = k - 1  # the linear skyline: K + 1 boundary sizes, K groups
    gname = gs_el.get("id")
    gvals = _text_values(gs_el)
    if gvals.size == 0:
        gdim = int(gs_el.get("dimension", str(k)))
        k = min(k, gdim) if gdim else k
        gvals = _default_groups(n_taxa, k)
    ax._params[gname] = Param(gname, gvals.astype(np.float64), integer=True)
    loglik = (bayesian_skyline_linear_loglik if linear
              else bayesian_skyline_loglik)

    def fn(params, tree):
        return loglik(tree.heights, n_taxa, params[pops], params[gname])

    return LikelihoodFn(fn, tm.tree_id, el.get("id") or "skyline")


@register("gmrfSkyrideLikelihood", "gmrfSkylineLikelihood",
          "gmrfSkyLineLikelihood")
def _skyride_likelihood(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.coalescent import (
        gmrf_skyride_loglik,
        gmrf_skyride_time_aware_prior,
        gmrf_skyride_uniform_prior,
        grouped_skyride_gmrf_prior,
        grouped_skyride_loglik,
    )

    pops = ax.param_from(_child_of(el, "populationSizes"))
    prec = ax.param_from(_child_of(el, "precisionParameter"))
    tm = None
    pt = el.find("populationTree")
    if pt is not None:
        for t in pt:
            tm = ax.build(ax.deref(t))
    n_taxa = len(tm.taxa)
    time_aware = _attr(el, "timeAwareSmoothing", True, bool)

    # optional fixed effects (covariates, beta, lambda mixing)
    cov = beta = lname = None
    cm = el.find("covariateMatrix")
    if cm is not None:
        for c in cm:
            cc = ax.deref(c)
            if cc.tag == "matrixParameter":
                cov = ax.tensor(ax.build(cc))
        beta = ax.param_from(_child_of(el, "betaParameter"))
    lam_el = el.find("lambdaParameter")
    if lam_el is not None:
        lname = ax.param_from(lam_el)

    gs = el.find("groupSizes")
    gel = ax.deref(_child_of(gs, "parameter")) if gs is not None else None
    gdim = int(gel.get("dimension", "0")) if gel is not None else 0
    p = ax._params[pops]
    n_field = np.atleast_1d(p.value).size
    if gdim and gdim == n_field and gdim <= n_taxa - 1:
        # a grouped field: n - 1 events over the declared groups
        gname = gel.get("id")
        ax._params[gname] = Param(
            gname, _default_groups(n_taxa, gdim).astype(np.float64),
            integer=True)

        def fn(params, tree):
            gg = params[gname]
            ll = grouped_skyride_loglik(tree.heights, n_taxa, params[pops],
                                        gg)
            lam = params[lname] if lname else (1.0 if time_aware else 0.0)
            return ll + grouped_skyride_gmrf_prior(
                tree.heights, n_taxa, params[pops], gg, params[prec],
                covariates=(cov.to(tree.heights.dtype)
                            if cov is not None else None),
                beta=(params[beta] if beta else None), lam=lam)

        return LikelihoodFn(fn, tm.tree_id, el.get("id") or "skyride")

    if gel is not None:
        gname = gel.get("id")
        if gname and gname not in ax._params:
            ax._params[gname] = Param(gname, np.ones(max(gdim, 1)))
    if cov is not None:
        raise Unsupported("covariates on an ungrouped skyride")
    # ungrouped: the field resized to n - 1 (the reference sizes it from
    # the tree)
    ax._params[pops] = Param(pops, np.resize(np.atleast_1d(p.value),
                                             n_taxa - 1), p.lower, p.upper)

    def fn(params, tree):
        ll = gmrf_skyride_loglik(tree.heights, n_taxa, params[pops])
        if time_aware:
            return ll + gmrf_skyride_time_aware_prior(
                tree.heights, n_taxa, params[pops], params[prec])
        return ll + gmrf_skyride_uniform_prior(params[pops], params[prec])

    return LikelihoodFn(fn, tm.tree_id, el.get("id") or "skyride")


@register("yuleModel")
def _yule_model(ax: XmlAnalysis, el):
    return ("speciation", "yule",
            {"birth": ax.param_from(_child_of(el, "birthRate"))})


@register("birthDeathModel")
def _birth_death_model(ax: XmlAnalysis, el):
    bmd = el.find("birthMinusDeathRate")
    rel = el.find("relativeDeathRate")
    if bmd is None:
        raise Unsupported("birthDeathModel parameterization")
    return ("speciation", "birth_death",
            {"bmd": ax.param_from(bmd),
             "rel": ax.param_from(rel) if rel is not None else None})


@register("speciationLikelihood")
def _speciation_likelihood(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.speciation import (
        birth_death_loglik,
        episodic_serial_birth_death_loglik,
        yule_loglik,
    )

    model = tm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "model":
            for d in cc:
                model = ax.build(ax.deref(d))
        elif cc.tag == "speciesTree":
            for t in cc:
                tm = ax.build(ax.deref(t))
    if model is None or tm is None:
        raise XmlError("speciationLikelihood needs model + speciesTree")
    _, sub, names = model
    n_taxa = len(tm.taxa)

    if sub == "bdss_grid":
        def fn(params, tree):
            rho_c = (params[names["rho"]].reshape(-1)[0]
                     if names.get("rho") else 0.0)
            x0 = params[names["origin"]].reshape(-1)[0]
            return episodic_serial_birth_death_loglik(
                tree.heights, n_taxa, x0,
                params[names["birth"]].reshape(-1),
                params[names["death"]].reshape(-1),
                params[names["psi"]].reshape(-1),
                treatment_probs=(params[names["r"]].reshape(-1)
                                 if names.get("r") else 1.0),
                rho_present=rho_c,
                grid_end=x0 if names["cutoff"] is None else names["cutoff"],
                num_intervals=names["k"])
    elif sub == "yule":
        def fn(params, tree):
            return yule_loglik(tree.heights, n_taxa, tree.root,
                               params[names["birth"]])
    else:
        def fn(params, tree):
            rel = params[names["rel"]] if names["rel"] else 0.0
            return birth_death_loglik(tree.heights, n_taxa, tree.root,
                                      params[names["bmd"]], rel)

    return LikelihoodFn(fn, tm.tree_id, el.get("id") or "speciation")


_CLOCK_TAGS = ("strictClockBranchRates", "discretizedBranchRates",
               "continuousBranchRates", "localClockModel",
               "randomLocalClockModel", "arbitraryBranchRates",
               "gridBasedBranchRateModel", "locationScaledBranchRateModel",
               "scaledByTreeTimeBranchRates", "timeIncrementBranchRateModel")


def _tips_of(ax, patterns, tm):
    """(tip partials [N, S, P], weights [P]) in the tree's taxon order on
    the device, padded to a multiple of 128 from 32 patterns; a smaller
    pattern set stays unpadded (ops/peeling.py's level peel)."""
    from beast_mcmc_tpu_torch.ops.peeling import pad_patterns

    idx = [patterns.taxa.index(t) for t in tm.taxa]
    tips = np.swapaxes(patterns.tip_partials(np.float64)[idx], 1, 2)
    return pad_patterns(ax.tensor(np.ascontiguousarray(tips)),
                        ax.tensor(patterns.weights),
                        128 if len(patterns.weights) >= 32 else 1)


@register("treeLikelihood", "treeDataLikelihood")
def _tree_likelihood(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.treelikelihood import (
        ascertained_loglik,
        branch_lengths,
        tree_loglikelihood,
        tree_loglikelihood_pmats,
        tree_loglikelihood_q,
    )

    for c in el:
        if ax.deref(c).tag == "rewardsAwareBranchModel":
            from beast_mcmc_tpu_torch.config.xml_ext import (
                _reward_aware_tree_likelihood,
            )

            return _reward_aware_tree_likelihood(ax, el, ax.deref(c))
    patterns = tm = site = clock = None
    partitions = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("patterns", "mergePatterns", "attributePatterns",
                      "ascertainedPatterns"):
            patterns = ax.build(cc)
        elif cc.tag == "alignment" and patterns is None:
            # a bare <alignment> child is a PatternList of its sites
            from beast_mcmc_tpu_torch.data.alignment import SitePatterns

            patterns = SitePatterns.from_alignment(ax.build(cc))
        elif cc.tag in ("treeModel", "starTreeModel"):
            tm = ax.build(cc)
        elif cc.tag == "siteModel":
            site = ax.build(cc)
        elif cc.tag in _CLOCK_TAGS:
            clock = ax.build(cc)
        elif cc.tag == "partition":
            pp = ps = None
            for d in cc:
                dd = ax.deref(d)
                if dd.tag in ("patterns", "mergePatterns"):
                    pp = ax.build(dd)
                elif dd.tag == "siteModel":
                    ps = ax.build(dd)
            if pp is None or ps is None:
                raise XmlError("<partition> needs patterns + siteModel")
            partitions.append((pp, ps))
    extra_partitions = []
    if partitions and patterns is None:
        (patterns, site), extra_partitions = partitions[0], partitions[1:]
    if patterns is None or tm is None or site is None:
        raise XmlError("treeLikelihood needs patterns+treeModel+siteModel")
    if clock is None:
        clock = ClockModel("strict_unit", tm.tree_id,
                           lambda params, tree: 1.0)
    site_kind, eigen, freqs_of, s, rates_weights = site
    dtype = ax.dtype
    tips_t, w_t = _tips_of(ax, patterns, tm)
    # further <partition>s share the tree and clock
    # (MultiPartitionDataLikelihoodDelegate.java:64), each its own peel
    extra = []
    for pp, ps in extra_partitions:
        _, eig_k, fr_k, _s_k, rw_k = ps
        extra.append((eig_k, fr_k, rw_k) + _tips_of(ax, pp, tm))

    # ascertainment correction columns (AscertainedSitePatterns)
    excl_t = None
    if getattr(patterns, "ascertain_excluded", None) is not None:
        idx = [patterns.taxa.index(t) for t in tm.taxa]
        tab = patterns.datatype.ambiguity_table(np.float64)
        ex = tab[patterns.ascertain_excluded[idx]]  # [N, E, S]
        excl_t = ax.tensor(np.ascontiguousarray(np.swapaxes(ex, 1, 2)))
        ascertain_include = getattr(patterns, "ascertain_include", False)

    def fn(params, tree):
        r, w = rates_weights(params, dtype)
        br = clock.rates(params, tree)
        if site_kind == "site_branch":
            tot = tree_loglikelihood_pmats(
                tips_t, w_t, tree.children, tree.heights, tree.root,
                tree.parent, eigen.p_mats(params, tree, r, br),
                freqs_of(params), w)
        elif site_kind == "site_q":
            tot = tree_loglikelihood_q(
                tips_t, w_t, tree.parent, tree.children, tree.heights,
                tree.root, eigen(params), freqs_of(params), r, w, br)
        elif excl_t is not None:
            from beast_mcmc_tpu_torch.ops.eigen import transition_probs
            from beast_mcmc_tpu_torch.ops.peeling import (
                peel_order_from_heights,
                peel_site_loglik,
            )
            from beast_mcmc_tpu_torch.utils.accum import stable_dot

            bl = branch_lengths(tree.parent, tree.heights) * br
            p_mats = transition_probs(eigen(params), bl[:, None] * r[None, :])
            order = peel_order_from_heights(tree.heights, len(tm.taxa),
                                            tree.parent)
            fr = freqs_of(params)
            sl_data = peel_site_loglik(tips_t, tree.children, order,
                                       tree.root, p_mats, fr, w)
            sl_excl = peel_site_loglik(excl_t, tree.children, order,
                                       tree.root, p_mats, fr, w)
            if ascertain_include:
                # only the listed patterns are observable
                tot = stable_dot(w_t, sl_data - torch.logsumexp(sl_excl, 0))
            else:
                tot = ascertained_loglik(sl_data, w_t, sl_excl)
        else:
            tot = tree_loglikelihood(
                tips_t, w_t, tree.parent, tree.children, tree.heights,
                tree.root, eigen(params), freqs_of(params), r, w, br)
        for eig_k, fr_k, rw_k, tk_t, wk_t in extra:
            rk, wk = rw_k(params, dtype)
            tot = tot + tree_loglikelihood(
                tk_t, wk_t, tree.parent, tree.children, tree.heights,
                tree.root, eig_k(params), fr_k(params), rk, wk, br)
        return tot

    # the pieces the ancestral-state and Markov-jump handlers read
    # (config/xml_ext.py)
    ax._treelik_parts = getattr(ax, "_treelik_parts", {})
    ax._treelik_parts[el.get("id") or "treeLikelihood"] = dict(
        tips=tips_t, w=w_t, site_kind=site_kind, eigen=eigen,
        freqs_of=freqs_of, rates_weights=rates_weights, clock=clock, tm=tm,
        dtype=dtype, n_taxa=len(tm.taxa))

    # the same value with the reference's first-order generator gradient,
    # which the approximate CTMC-rate gradient elements report
    # (config/xml_geo.py, xml_hmc.py); an eigen model's generator is
    # reassembled as Q = U diag(lambda) U^-1
    def fn_approx(params, tree):
        from beast_mcmc_tpu_torch.models.treelikelihood import (
            tree_loglikelihood_q_approx_grad,
        )

        r, w = rates_weights(params, dtype)
        es = eigen(params)
        q_mat = es if site_kind == "site_q" else (
            es.U @ (es.values[..., None] * es.U_inv))
        return tree_loglikelihood_q_approx_grad(
            tips_t, w_t, tree.parent, tree.children, tree.heights,
            tree.root, q_mat, freqs_of(params), r, w,
            clock.rates(params, tree))

    ax._surrogate_liks = getattr(ax, "_surrogate_liks", {})
    ax._surrogate_liks[el.get("id") or "treeLikelihood"] = LikelihoodFn(
        fn_approx, tm.tree_id, el.get("id") or "treeLikelihood")
    return LikelihoodFn(fn, tm.tree_id, el.get("id") or "treeLikelihood")


# -- priors -------------------------------------------------------------------


def _targets_of(ax, el) -> List:
    """Readers (params, tree) -> value of the parameters or statistics a
    prior applies to. An unrecognised or empty target raises: a prior
    dropped silently would change the posterior."""
    outs = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            obj = ax.build(cc)
            if isinstance(obj, TreeAlias):
                outs.append(_alias_value_reader(ax, obj))
            elif isinstance(obj, DerivedParam):
                outs.append(lambda params, tree, f=obj.fn: f(params))
            else:
                outs.append(lambda params, tree, n=obj.name: params[n])
        elif cc.tag in ("matrixParameter", "compoundSymmetricMatrix",
                        "diagonalMatrix", "transposedMatrix",
                        "diagonalContrainedMatrixView"):
            from beast_mcmc_tpu_torch.config.xml_hmc import matrix_param_of

            outs.append(lambda params, tree, mp=matrix_param_of(ax, cc):
                        mp.fn(params).reshape(-1))
        else:
            obj = ax.build(cc)
            if isinstance(obj, CompoundParam):
                outs.append(
                    lambda params, tree, ns=tuple(obj.names): torch.cat(
                        [params[n].reshape(-1) for n in ns]))
            elif isinstance(obj, Param):
                outs.append(lambda params, tree, n=obj.name: params[n])
            elif isinstance(obj, DerivedParam):
                outs.append(lambda params, tree, f=obj.fn: f(params))
            elif (hasattr(obj, "fn") and hasattr(obj, "names")
                  and hasattr(obj, "dim")):
                # a matrix view: the prior scores the flattened matrix
                outs.append(lambda params, tree, mp=obj:
                            mp.fn(params).reshape(-1))
            elif callable(obj) and not isinstance(obj, LikelihoodFn):
                outs.append(lambda params, tree, f=obj: f(
                    _StateShim(params, tree)))
            else:
                raise Unsupported(f"prior target <{cc.tag}>")
    if not outs:
        raise XmlError(f"prior <{el.tag}> names no target")
    return outs


def _alias_value_reader(ax, a: TreeAlias):
    def tr(params, tree):
        return ax.resolve_tree(a.tree_id, params, tree)

    if a.kind == "root_height":
        def read(params, tree):
            t = tr(params, tree)
            return t.heights[t.root]

        return read
    if a.kind in ("internal_heights", "all_heights"):
        def read(params, tree):
            t = tr(params, tree)
            m = t.parent.shape[0]
            ar = torch.arange(m, device=t.parent.device)
            mask = ar >= (m + 1) // 2
            if a.kind == "internal_heights":
                mask = mask & (ar != t.root)
            return t.heights, mask

        return read
    if a.kind == "leaf_height":
        return lambda params, tree, i=a.tip_index: tr(params, tree).heights[i]
    raise Unsupported(a.kind)


def _masked_sum(val, pdf):
    """pdf over val's elements, summed; val may be (values, mask) for a
    tree view, then each element's density is taken on its own (the
    library densities sum their argument) before the mask. An integer
    value (an indicator sum) is scored as float64."""
    if isinstance(val, tuple):
        v, mask = val
        elem = torch.func.vmap(pdf)(v.reshape(-1))
        return torch.sum(torch.where(mask.reshape(-1), elem,
                                     torch.zeros_like(elem)))
    val = torch.as_tensor(val)
    if not val.is_floating_point():
        val = val.to(torch.float64)
    return torch.sum(pdf(val))


def _simple_prior(pdf_factory):
    def build(ax, el):
        targets = _targets_of(ax, el)
        pdf = pdf_factory(ax, el)

        def fn(params, tree):
            tot = 0.0
            for t in targets:
                tot = tot + _masked_sum(t(params, tree), pdf)
            return tot

        return LikelihoodFn(fn, None, el.tag)

    return build


@register("logNormalPrior")
def _lognormal_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import lognormal_logpdf

    mean = _attr(el, "mean", _attr(el, "mu", 0.0, float), float)
    stdev = _attr(el, "stdev", _attr(el, "sigma", 1.0, float), float)
    offset = _attr(el, "offset", 0.0, float)
    mu = (math.log(mean) - 0.5 * stdev ** 2
          if _attr(el, "meanInRealSpace", False, bool) else mean)
    return _simple_prior(lambda ax_, el_: lambda x: lognormal_logpdf(
        x - offset, mu, stdev))(ax, el)


@register("normalPrior")
def _normal_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import normal_logpdf

    mean = _attr(el, "mean", 0.0, float)
    stdev = _attr(el, "stdev", 1.0, float)
    return _simple_prior(lambda ax_, el_: lambda x: normal_logpdf(
        x, mean, stdev))(ax, el)


@register("exponentialPrior")
def _exponential_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import exponential_logpdf

    mean = _attr(el, "mean", 1.0, float)
    offset = _attr(el, "offset", 0.0, float)
    return _simple_prior(lambda ax_, el_: lambda x: exponential_logpdf(
        x - offset, mean))(ax, el)


@register("gammaPrior")
def _gamma_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import gamma_logpdf

    shape = _attr(el, "shape", 1.0, float)
    scale = _attr(el, "scale", 1.0, float)
    offset = _attr(el, "offset", 0.0, float)
    return _simple_prior(lambda ax_, el_: lambda x: gamma_logpdf(
        x - offset, shape, scale))(ax, el)


@register("inverseGammaPrior")
def _inverse_gamma_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import inverse_gamma_logpdf

    shape = _attr(el, "shape", 1.0, float)
    scale = _attr(el, "scale", 1.0, float)
    return _simple_prior(lambda ax_, el_: lambda x: inverse_gamma_logpdf(
        x, shape, scale))(ax, el)


@register("laplacePrior")
def _laplace_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import laplace_logpdf

    mean = _attr(el, "mean", 0.0, float)
    scale = _attr(el, "scale", 1.0, float)
    return _simple_prior(lambda ax_, el_: lambda x: laplace_logpdf(
        x, mean, scale))(ax, el)


@register("uniformPrior")
def _uniform_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import uniform_logpdf

    lower = _attr(el, "lower", 0.0, float)
    upper = _attr(el, "upper", 1.0, float)
    return _simple_prior(lambda ax_, el_: lambda x: uniform_logpdf(
        x, lower, upper))(ax, el)


@register("oneOnXPrior", "jeffreysPrior")
def _one_on_x_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import one_on_x_logpdf

    return _simple_prior(lambda ax_, el_: one_on_x_logpdf)(ax, el)


@register("poissonPrior")
def _poisson_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import poisson_logpmf

    mean = _attr(el, "mean", 1.0, float)
    return _simple_prior(lambda ax_, el_: lambda x: poisson_logpmf(
        x, mean))(ax, el)


@register("dirichletPrior")
def _dirichlet_prior(ax, el):
    from beast_mcmc_tpu_torch.models.priors import dirichlet_logpdf

    alpha = _attr(el, "alpha", 1.0, float)
    targets = _targets_of(ax, el)

    def fn(params, tree):
        tot = 0.0
        for t in targets:
            v = t(params, tree)
            tot = tot + dirichlet_logpdf(v / torch.sum(v),
                                         torch.full_like(v, alpha))
        return tot

    return LikelihoodFn(fn, None, "dirichletPrior")


@register("ctmcScalePrior")
def _ctmc_scale_prior(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.priors import ctmc_scale_logpdf

    rate = ax.param_from(_child_of(el, "ctmcScale"))
    tm = ax.build(_child_of(el, "treeModel"))

    def fn(params, tree):
        bl = tree.heights[tree.parent] - tree.heights
        tl = torch.sum(torch.where(tree.parent >= 0, bl,
                                   torch.zeros_like(bl)))
        return torch.sum(ctmc_scale_logpdf(params[rate], tl))

    return LikelihoodFn(fn, tm.tree_id, "ctmcScalePrior")


@register("exponentialMarkovLikelihood")
def _exp_markov(ax: XmlAnalysis, el):
    """ExponentialMarkovModel.java: x_k ~ Exp(mean x_{k-1}); jeffreys puts
    1/x on the first element."""
    cp = el.find("chainParameter")
    pname = ax.param_from(cp if cp is not None else el)
    jeffreys = _attr(el, "jeffreys", False, bool)

    def fn(params, tree):
        x = torch.atleast_1d(params[pname])
        tot = torch.sum(-torch.log(x[:-1]) - x[1:] / x[:-1])
        return tot - torch.log(x[0]) if jeffreys else tot

    return LikelihoodFn(fn, None, "exponentialMarkov")


@register("exponentialDistributionModel")
def _exp_dist_model(ax: XmlAnalysis, el):
    return ("dist", "exponential", ax.param_from(_child_of(el, "mean")))


@dataclasses.dataclass
class VariableDemographic:
    tree_ids: List[str]
    ploidies: List[float]
    pop_param: str
    ind_param: str
    use_midpoints: bool


@register("variableDemographic")
def _variable_demographic(ax: XmlAnalysis, el):
    """The EBSP field over several gene trees (VariableDemographicModel
    .java; models/coalescent.py::ebsp_coalescent_loglik)."""
    pop_el = ax.deref(_child_of(_child_of(el, "populationSizes"),
                                "parameter"))
    ind_el = ax.deref(_child_of(_child_of(el, "indicators"), "parameter"))
    tree_ids, ploidies = [], []
    for pt in _child_of(el, "trees"):
        ptc = ax.deref(pt)
        if ptc.tag != "ptree":
            continue
        tm = ax.build(_child_of(ptc, "treeModel"))
        tree_ids.append(tm.tree_id)
        ploidies.append(_attr(ptc, "ploidy", 1.0, float))
    n_events = sum(len(ax._trees[t].taxa) - 1 for t in tree_ids)
    pname, iname = pop_el.get("id"), ind_el.get("id")
    pop0 = _text_values(pop_el)
    fill = float(pop0[0]) if pop0.size else 1.0
    ax._params[pname] = Param(pname, np.full(n_events, fill), lower=0.0)
    ax._params[iname] = Param(iname, np.zeros(n_events - 1))
    return VariableDemographic(tree_ids, ploidies, pname, iname,
                               _attr(el, "useMidpoints", False, bool))


@register("mixedDistributionLikelihood")
def _mixed_distribution(ax: XmlAnalysis, el):
    """MixedDistributionLikelihood.java: element i under distribution0
    where indicator i is 0, distribution1 otherwise (the EBSP prior on the
    (in)active sizes; knot 0 is always active)."""
    from beast_mcmc_tpu_torch.models.priors import exponential_logpdf

    d0 = ax.build(ax.deref(next(iter(_child_of(el, "distribution0")))))
    d1 = ax.build(ax.deref(next(iter(_child_of(el, "distribution1")))))
    data = ax.param_from(_child_of(el, "data"))
    inds = ax.param_from(_child_of(el, "indicators"))

    def mean_of(d):
        if d[1] != "exponential":
            raise Unsupported(f"mixedDistribution over {d[1]}")
        return d[2]

    m0, m1 = mean_of(d0), mean_of(d1)

    def fn(params, tree):
        x = params[data]
        ind = params[inds]
        full_ind = torch.cat([torch.ones(1, dtype=ind.dtype,
                                         device=ind.device), ind])
        # as the JAX package: each element takes its distribution's summed
        # density over all of x
        return torch.sum(torch.where(
            full_ind > 0.5, exponential_logpdf(x, params[m1]),
            exponential_logpdf(x, params[m0])))

    return LikelihoodFn(fn, None, "mixedDistribution")


# -- operators of the EBSP and multi-tree analyses --------------------------


@dataclasses.dataclass
class SampleNonActiveOperator(Operator):
    """Gibbs-resamples the inactive EBSP population sizes from their
    exponential prior, their full conditional (SampleNonActiveGibbsOperator
    .java); always accepted."""

    mean_param: str = ""
    data_param: str = ""
    ind_param: str = ""

    def modified_params(self):
        return (self.data_param,)

    def propose(self, params, tree, gen, tuning):
        x = params[self.data_param]
        ind = params[self.ind_param]
        full_ind = torch.cat([torch.ones(1, dtype=ind.dtype,
                                         device=ind.device), ind])
        u = torch.rand(x.shape, generator=gen, dtype=x.dtype,
                       device=x.device)
        draw = -torch.log1p(-u) * params[self.mean_param]
        new = torch.where(full_ind > 0.5, x, draw)
        dt = tree.heights.dtype
        return ({**params, self.data_param: new}, tree,
                torch.full((), math.inf, dtype=dt, device=x.device),
                torch.ones((), dtype=dt, device=x.device))


@dataclasses.dataclass
class ActiveEntryScaleOperator(Operator):
    """Scales one population-size entry chosen uniformly among the active
    knots (<scaleOperator><indicators pickoneprob="1">, ScaleOperator.java
    pickoneprob); log Hastings -log s."""

    data_param: str = ""
    ind_param: str = ""
    scale_factor: float = 0.5
    adaptable: bool = True

    def modified_params(self):
        return (self.data_param,)

    def initial_adapt(self):
        return math.log(1.0 / self.scale_factor - 1.0)

    def tuning(self, adapt_value):
        return 1.0 / (torch.exp(adapt_value) + 1.0)

    def propose(self, params, tree, gen, tuning):
        from beast_mcmc_tpu_torch.inference.tree_operators import (
            sample_masked)

        x = params[self.data_param]
        ind = params[self.ind_param]
        active = torch.cat([torch.ones(1, dtype=torch.bool,
                                       device=ind.device), ind > 0.5])
        i, _ = sample_masked(_uniform(gen, x), active)
        u = _uniform(gen, x)
        s = tuning + u * (1.0 / tuning - tuning)
        new = x.index_put((i,), x[i] * s)
        return ({**params, self.data_param: new}, tree,
                (-torch.log(s)).to(tree.heights.dtype))


@dataclasses.dataclass
class JointTipHeightOperator(Operator):
    """A uniform move of one tip age shared by several trees (JointParameter
    over leafHeight parameters): U(0, the lowest of the tip's parent
    heights), written into every tree."""

    ax: object = None
    targets: tuple = ()  # (tree_id, tip_index)

    def modified_params(self):
        return tuple(self.ax.tree_key(tid, "heights")
                     for tid, _ in self.targets)

    def propose(self, params, tree, gen, tuning):
        upper = None
        for tid, tip in self.targets:
            t = self.ax.resolve_tree(tid, params, tree)
            ph = t.heights[t.parent[tip]]
            upper = ph if upper is None else torch.minimum(upper, ph)
        new_h = _uniform(gen, tree.heights) * upper
        for tid, tip in self.targets:
            t = self.ax.resolve_tree(tid, params, tree)
            heights = t.heights.index_put(
                (torch.tensor([tip], device=new_h.device),), new_h)
            if self.ax._tree_binding.get(tid, "state") == "state":
                tree = tree.replace(heights=heights)
            else:
                params = {**params,
                          self.ax.tree_key(tid, "heights"): heights}
        return params, tree, torch.zeros((), dtype=tree.heights.dtype,
                                          device=tree.heights.device)


@dataclasses.dataclass
class MultiTreeUpDownOperator(Operator):
    """upDown over parameters and the internal heights of several trees
    (state- or params-resident), the EBSP/multilocus form of
    UpDownOperator.java; log Hastings (nUp - nDown - 2) log s."""

    ax: object = None
    up_params: tuple = ()
    down_params: tuple = ()
    up_trees: tuple = ()
    down_trees: tuple = ()
    scale_factor: float = 0.75
    adaptable: bool = True

    def modified_params(self):
        keys = list(self.up_params) + list(self.down_params)
        for tid in tuple(self.up_trees) + tuple(self.down_trees):
            keys.append(self.ax.tree_key(tid, "heights"))
        return tuple(keys)

    def initial_adapt(self):
        return math.log(1.0 / self.scale_factor - 1.0)

    def tuning(self, adapt_value):
        return 1.0 / (torch.exp(adapt_value) + 1.0)

    def _scale_tree(self, params, tree, tid, s):
        t = self.ax.resolve_tree(tid, params, tree)
        m = t.parent.shape[0]
        n_taxa = (m + 1) // 2
        internal = torch.arange(m, device=t.parent.device) >= n_taxa
        heights = torch.where(internal, t.heights * s, t.heights)
        pidx = torch.clamp_min(t.parent, 0)
        ok = torch.all((t.parent < 0) | (heights[pidx] > heights))
        if self.ax._tree_binding.get(tid, "state") == "state":
            tree = tree.replace(heights=heights)
        else:
            params = {**params, self.ax.tree_key(tid, "heights"): heights}
        return params, tree, n_taxa - 1, ok

    def propose(self, params, tree, gen, tuning):
        u = _uniform(gen, tree.heights)
        s = tuning + u * (1.0 / tuning - tuning)
        n_up = n_down = 0
        ok = torch.ones((), dtype=torch.bool, device=tree.heights.device)
        for name in self.up_params:
            params = {**params, name: params[name] * s}
            n_up += max(params[name].numel(), 1)
            ok = ok & torch.all(params[name] > 0)
        for name in self.down_params:
            params = {**params, name: params[name] / s}
            n_down += max(params[name].numel(), 1)
            ok = ok & torch.all(params[name] > 0)
        for tid in self.up_trees:
            params, tree, n, o = self._scale_tree(params, tree, tid, s)
            n_up += n
            ok = ok & o
        for tid in self.down_trees:
            params, tree, n, o = self._scale_tree(params, tree, tid, 1.0 / s)
            n_down += n
            ok = ok & o
        logh = ((n_up - n_down - 2) * torch.log(s)).to(tree.heights.dtype)
        return params, tree, torch.where(ok, logh,
                                         torch.full_like(logh, -math.inf))


@register("posterior", "prior", "likelihood", "joint")
def _compound_likelihood(ax: XmlAnalysis, el):
    parts: List[LikelihoodFn] = []
    tree_id = None
    for c in el:
        obj = ax.build(c)
        if isinstance(obj, ClockModel):
            # a branch-rate model adds its rate-evolution density if it has
            # one (ACLikelihood), else nothing
            dens = getattr(obj, "density", None)
            if dens is not None:
                parts.append(LikelihoodFn(dens, obj.tree_id,
                                          ax.deref(c).get("id") or "ac"))
                tree_id = tree_id or obj.tree_id
            continue
        if isinstance(obj, JointTipAlias):
            continue  # a mirrored tip-height view is a reparameterisation
        if type(obj).__name__ == "IntegratedFactorModel":
            # its density is inside the companion traitDataLikelihood's
            # integrated marginal (config/xml_traits.py)
            continue
        if isinstance(obj, tuple) and obj and obj[0] in ("subst", "subst_q"):
            # an SVS substitution model inside <prior> adds its
            # indicator-connectivity density
            # (SVSGeneralSubstitutionModel.getLogLikelihood():111-115)
            cid = ax.deref(c).get("id")
            if cid and cid in getattr(ax, "_svs_models", {}):
                from beast_mcmc_tpu_torch.config.xml_geo import (
                    svs_connectivity_prior,
                )

                parts.append(svs_connectivity_prior(ax, cid))
            continue
        if not isinstance(obj, LikelihoodFn):
            raise Unsupported(f"<{el.tag}> child <{ax.deref(c).tag}>")
        parts.append(obj)
        tree_id = tree_id or obj.tree_id

    def fn(params, tree):
        tot = 0.0
        for p in parts:
            tot = tot + p.fn(params, tree)
        return ax.as_lp(tot)

    out = LikelihoodFn(fn, tree_id, el.get("id") or el.tag)
    # the addends, for component-cached stepping
    out.parts = tuple(parts)
    return out


# -- statistics ---------------------------------------------------------------


@register("treeLengthStatistic")
def _tree_length_statistic(ax: XmlAnalysis, el):
    tm = ax.build(_child_of(el, "treeModel"))

    def stat(s, tid=tm.tree_id):
        t = ax.resolve_tree(tid, s.params, s.tree)
        bl = t.heights[t.parent] - t.heights
        return torch.sum(torch.where(t.parent >= 0, bl, torch.zeros_like(bl)))

    return stat


@register("tmrcaStatistic")
def _tmrca_statistic(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.models.speciation import mrca_node

    tm = taxa = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tm = ax.build(cc)
        elif cc.tag == "mrca":
            for t in cc:
                taxa = ax.build(ax.deref(t))
    if tm is None:
        raise XmlError("tmrcaStatistic needs treeModel")
    if taxa is None:
        # no mrca clade: the root's age
        return lambda s: s.tree.heights[s.tree.root]
    tip_set = _tip_set(ax, tm, taxa)

    def stat(s, tid=tm.tree_id):
        t = ax.resolve_tree(tid, s.params, s.tree)
        return t.heights[mrca_node(t.parent, t.heights, tip_set)]

    return stat


def _clock_of(ax, el, what):
    clock = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("treeModel", "starTreeModel"):
            continue
        obj = ax.build(cc)
        if isinstance(obj, ClockModel):
            clock = obj
    if clock is None:
        raise XmlError(f"{what} without a branch-rate model")
    return clock


def _branch_rates(ax, clock, s):
    t = (ax.resolve_tree(clock.tree_id, s.params, s.tree)
         if clock.tree_id else s.tree)
    r = torch.as_tensor(clock.rates(s.params, t), dtype=t.heights.dtype,
                        device=t.heights.device)
    return t, r.expand(t.parent.shape)


@register("rateStatistic")
def _rate_statistic(ax: XmlAnalysis, el):
    mode = _attr(el, "mode", "mean")
    clock = _clock_of(ax, el, "rateStatistic")

    def stat(s):
        t, r = _branch_rates(ax, clock, s)
        mask = t.parent >= 0
        n = torch.sum(mask)
        mean = torch.sum(torch.where(mask, r, torch.zeros_like(r))) / n
        if mode == "mean":
            return mean
        var = torch.sum(torch.where(mask, (r - mean) ** 2,
                                    torch.zeros_like(r))) / (n - 1)
        return torch.sqrt(var) / mean  # the coefficient of variation

    return stat


@register("rateCovarianceStatistic")
def _rate_covariance_statistic(ax: XmlAnalysis, el):
    clock = _clock_of(ax, el, "rateCovarianceStatistic")

    def stat(s):
        # the correlation of parent and child branch rates
        t, r = _branch_rates(ax, clock, s)
        pidx = torch.clamp_min(t.parent, 0)
        mask = (t.parent >= 0) & (t.parent[pidx] >= 0)
        rp = r[pidx]
        zero = torch.zeros_like(r)
        n = torch.sum(mask)
        mx = torch.sum(torch.where(mask, r, zero)) / n
        my = torch.sum(torch.where(mask, rp, zero)) / n
        cov = torch.sum(torch.where(mask, (r - mx) * (rp - my), zero)) / (
            n - 1)
        sx = torch.sqrt(torch.sum(torch.where(mask, (r - mx) ** 2, zero))
                        / (n - 1))
        sy = torch.sqrt(torch.sum(torch.where(mask, (rp - my) ** 2, zero))
                        / (n - 1))
        return cov / (sx * sy)

    return stat


@register("statistic")
def _generic_statistic(ax: XmlAnalysis, el):
    """<statistic> views: N0 of a log-space demographic model, or a plain
    parameter (dr.inference.model.Statistic parsers)."""
    for c in el:
        obj = ax.build(ax.deref(c))
        if isinstance(obj, Demographic):
            pname = obj.params["pop"]
            if obj.kind.endswith("_log"):
                return lambda s, n=pname: torch.exp(torch.mean(s.params[n]))
            return lambda s, n=pname: torch.mean(s.params[n])
        if isinstance(obj, Param):
            return lambda s, n=obj.name: s.params[n].reshape(())
    raise Unsupported("<statistic> contents")


@register("sumStatistic")
def _sum_statistic(ax: XmlAnalysis, el):
    names = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            names.append(ax.build(cc).name)

    def stat(s):
        return sum(torch.sum(s.params[n]) for n in names)

    return stat


# -- operators ----------------------------------------------------------------


@register("operators")
def _operators(ax: XmlAnalysis, el):
    ops, tree_ids = [], []
    for c in el:
        built = _build_operator(ax, c)
        if built is None:
            continue
        op, tid = built
        if isinstance(op, list):
            ops.extend(op)
            tree_ids.extend([tid] * len(op))
        else:
            ops.append(op)
            tree_ids.append(tid)
    if not ops:
        raise XmlError("<operators> produced no operators")
    return ops, tree_ids


def _op_target(ax, el):
    """(kind, payload, tree_id) of the parameter or tree an operator moves.
    A view whose element is not ported raises its Unsupported where no
    other target is found."""
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("treeModel", "starTreeModel"):
            return ("tree", None, ax.build(cc).tree_id)
        if cc.tag == "parameter":
            obj = ax.build(cc)
            if isinstance(obj, TreeAlias):
                return ("alias", obj, obj.tree_id)
            if isinstance(obj, DerivedParam):
                if obj.idx is not None:
                    return ("masked", obj, None)
                return ("param", ax._params[obj.base], None)
            return ("param", obj, None)
        if cc.tag == "compoundParameter":
            return ("compound", ax.build(cc), None)
        if cc.tag in ("matrixParameter", "compoundSymmetricMatrix"):
            from beast_mcmc_tpu_torch.config.xml_hmc import matrix_param_of

            return ("compound",
                    CompoundParam(list(matrix_param_of(ax, cc).names)), None)
    # a parameter-view element (maskedParameter and the like)
    missing = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in _BUILDERS:
            try:
                obj = ax.build(cc)
            except (Unsupported, XmlError) as e:
                if isinstance(e, Unsupported) and missing is None:
                    missing = e
                continue
            if isinstance(obj, Param):
                return ("param", obj, None)
            if isinstance(obj, DerivedParam) and obj.base:
                return ("param", ax._params[obj.base], None)
            if isinstance(obj, TreeAlias):
                return ("alias", obj, obj.tree_id)
    if missing is not None:
        raise missing
    raise XmlError(f"operator <{el.tag}> has no target")


def _build_operator(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.inference import operators as O
    from beast_mcmc_tpu_torch.inference import tree_operators as T

    w = _attr(el, "weight", 1.0, float)
    tag = el.tag

    if tag in _OP_EXT:
        return _OP_EXT[tag](ax, el, w)

    if tag == "subtreeSlide":
        _, _, tid = _op_target(ax, el)
        return T.SubtreeSlideOperator(
            weight=w, size=_attr(el, "size", 1.0, float),
            gaussian=_attr(el, "gaussian", True, bool)), tid
    if tag == "subtreeLeap":
        _, _, tid = _op_target(ax, el)
        return T.SubtreeLeapOperator(
            weight=w, size=_attr(el, "size", 1.0, float)), tid
    if tag == "subtreeJump":
        _, _, tid = _op_target(ax, el)
        return T.SubtreeJumpOperator(
            weight=w, size=_attr(el, "size", 1.0, float),
            uniform=_attr(el, "uniform", False, bool)), tid
    if tag in ("GibbsPruneAndRegraft", "gibbsPruneAndRegraft"):
        _, _, tid = _op_target(ax, el)
        return T.GibbsPruneAndRegraftOperator(weight=w), tid
    if tag == "narrowExchange":
        _, _, tid = _op_target(ax, el)
        return O.NarrowExchangeOperator(weight=w), tid
    if tag == "wideExchange":
        _, _, tid = _op_target(ax, el)
        return O.WideExchangeOperator(weight=w), tid
    if tag == "wilsonBalding":
        _, _, tid = _op_target(ax, el)
        return O.WilsonBaldingOperator(weight=w), tid

    if tag == "scaleOperator":
        sf = _attr(el, "scaleFactor", 0.75, float)
        ind_el = el.find("indicators")
        if ind_el is not None:
            return ActiveEntryScaleOperator(
                data_param=ax.param_from(el), ind_param=ax.param_from(ind_el),
                scale_factor=sf, weight=w), None
        kind, obj, tid = _op_target(ax, el)
        if kind == "alias":
            if obj.kind == "root_height":
                if tid in ax._star_trees:
                    n = len(ax.build(ax._ids[tid]).taxa)
                    return O.StarRootHeightScaleOperator(
                        weight=w, scale_factor=sf, n_taxa=n), tid
                return O.RootHeightScaleOperator(weight=w,
                                                 scale_factor=sf), tid
            if obj.kind in ("internal_heights", "all_heights"):
                return T.ScaleNodeHeightOperator(weight=w,
                                                 scale_factor=sf), tid
            if obj.kind == "leaf_height":
                return T.TipHeightScaleOperator(
                    weight=w, scale_factor=sf, tip=obj.tip_index), tid
            raise Unsupported(f"scaleOperator on {obj.kind}")
        mode = "all" if _attr(el, "scaleAll", False, bool) else "random"
        if kind == "compound":
            return [O.ScaleOperator(parameter=n, weight=w / len(obj.names),
                                    scale_factor=sf, mode=mode, lower=0.0)
                    for n in obj.names], None
        return O.ScaleOperator(parameter=obj.name, weight=w, scale_factor=sf,
                               mode=mode, lower=max(obj.lower, 0.0),
                               upper=obj.upper), tid

    if tag == "randomWalkOperator":
        window = _attr(el, "windowSize", 1.0, float)
        # a masked view walks only the entries of the base it shows
        for c in el:
            cc2 = ax.deref(c)
            if cc2.tag == "maskedParameter":
                mobj = ax.build(cc2)
                if isinstance(mobj, DerivedParam) and mobj.idx is not None:
                    return O.SubsetRandomWalkOperator(
                        parameter=mobj.base,
                        indices=tuple(int(i) for i in mobj.idx), weight=w,
                        window=window), None
        kind, obj, tid = _op_target(ax, el)
        if kind == "masked":
            return O.SubsetRandomWalkOperator(
                parameter=obj.base, indices=tuple(int(i) for i in obj.idx),
                weight=w, window=window), None
        if kind == "alias":
            if obj.kind == "leaf_height":
                return T.TipHeightRandomWalkOperator(
                    weight=w, window=window, tip=obj.tip_index), tid
            raise Unsupported(f"randomWalk on {obj.kind}")
        if kind == "compound":
            return [O.RandomWalkOperator(parameter=n,
                                         weight=w / len(obj.names),
                                         window=window)
                    for n in obj.names], None
        return O.RandomWalkOperator(
            parameter=obj.name, weight=w, window=window, lower=obj.lower,
            upper=obj.upper,
            reflect=_attr(el, "boundaryCondition", "") == "reflecting"), tid

    if tag == "randomWalkIntegerOperator":
        _, obj, tid = _op_target(ax, el)
        lo = 0 if not np.isfinite(obj.lower) else int(obj.lower)
        hi = (np.size(obj.value) if not np.isfinite(obj.upper)
              else int(obj.upper))
        return O.UniformIntegerOperator(parameter=obj.name, weight=w,
                                        lower=lo, upper=hi), tid

    if tag == "uniformOperator":
        for c in el:
            cc = ax.deref(c)
            if cc.tag == "jointParameter":
                ja = ax.build(cc)
                return JointTipHeightOperator(
                    ax=ax, targets=ja.targets, weight=w), ja.targets[0][0]
        kind, obj, tid = _op_target(ax, el)
        if kind == "alias" and obj.kind in ("internal_heights",
                                            "all_heights"):
            return O.UniformNodeHeightOperator(weight=w), tid
        if kind == "alias" and obj.kind == "leaf_height":
            return T.TipHeightUniformOperator(weight=w,
                                              tip=obj.tip_index), tid
        if kind == "param":
            lo = obj.lower if np.isfinite(obj.lower) else 0.0
            hi = obj.upper if np.isfinite(obj.upper) else 1.0
            return O.UniformRealOperator(parameter=obj.name, weight=w,
                                         lower=lo, upper=hi), tid
        raise Unsupported(f"uniformOperator on {kind}")

    if tag == "uniformIntegerOperator":
        _, obj, tid = _op_target(ax, el)
        lo = int(_attr(el, "lower", 0, float))
        hi = int(_attr(el, "upper", np.size(obj.value) - 1, float))
        return O.UniformIntegerOperator(parameter=obj.name, weight=w,
                                        lower=lo, upper=hi), tid

    if tag == "swapOperator":
        _, obj, tid = _op_target(ax, el)
        return O.SwapOperator(parameter=obj.name, weight=w), tid

    if tag == "centeredScale":
        # CenteredScaleOperator, as the JAX package substitutes it: a
        # windowed random walk (same support, a valid MH move)
        kind, obj, tid = _op_target(ax, el)
        if kind == "compound":
            return [O.RandomWalkOperator(parameter=n,
                                         weight=w / len(obj.names),
                                         window=0.2)
                    for n in obj.names], None
        return O.RandomWalkOperator(parameter=obj.name, weight=w,
                                    window=0.2), tid

    if tag == "compoundPrecisionOperator":
        # CompoundPrecisionOperator: the wrapped operators, weight shared
        inner_ops = []
        for c in el:
            for d in c:
                built_i = _build_operator(ax, ax.deref(d))
                if built_i is not None:
                    op_i, _ = built_i
                    inner_ops.extend(op_i if isinstance(op_i, list)
                                     else [op_i])
        if not inner_ops:
            raise Unsupported("compoundPrecisionOperator structure")
        for op_i in inner_ops:
            op_i.weight = w / len(inner_ops)
        return inner_ops, None

    if tag in ("regressionGibbsEffectOperator",
               "regressionGibbsPrecisionOperator",
               "regressionMetropolizedIndicatorOperator"):
        # as the JAX package substitutes the GLM blocks' conjugate draws:
        # posterior-preserving walk, scale and flip moves
        _, obj, tid = _op_target(ax, el)
        if tag.endswith("PrecisionOperator"):
            return O.ScaleOperator(parameter=obj.name, weight=w,
                                   scale_factor=0.75), tid
        if tag.endswith("IndicatorOperator"):
            return O.BitFlipOperator(parameter=obj.name, weight=w), tid
        return O.RandomWalkOperator(parameter=obj.name, weight=w,
                                    window=0.3), tid

    if tag in ("fireParameterChanged", "patternWeightIncrementOperator"):
        # FireParameterChangedOperator (a model-graph cache poke) and
        # PatternWeightIncrementOperator (online data arrival; the chain
        # scores the full data from the start, the same target at the
        # end): the chain re-evaluates every step, so a no-op accept
        from beast_mcmc_tpu_torch.config.xml_hmc import _IdentityOperator

        return _IdentityOperator(weight=w), None

    if tag == "deltaMixOperator":
        # DeltaMixOperator, as the JAX package substitutes it: the additive
        # delta exchange (same invariant sum and support)
        _, obj, tid = _op_target(ax, el)
        return O.DeltaExchangeOperator(
            parameter=obj.name, weight=w,
            delta=_attr(el, "delta", 0.02, float),
            adaptable=_attr(el, "autoOptimize", True, bool)), tid

    if tag == "deltaExchange":
        kind, obj, tid = _op_target(ax, el)
        delta = _attr(el, "delta", 0.02, float)
        if kind == "compound":
            pw = [float(x) for x in
                  (el.get("parameterWeights") or "").split()] or None
            return O.CompoundWeightedDeltaOperator(
                parameters=tuple(obj.names),
                parameter_weights=tuple(pw) if pw else (),
                delta=delta, weight=w), tid
        return O.DeltaExchangeOperator(
            parameter=obj.name, weight=w, delta=delta,
            integer=_attr(el, "integer", False, bool),
            adaptable=_attr(el, "autoOptimize", True, bool)), tid

    if tag == "upDownOperator":
        up, down, up_trees, down_trees = [], [], [], []
        tid = None
        for c in el:
            if c.tag not in ("up", "down"):
                continue
            for cc in c:
                obj = ax.build(ax.deref(cc))
                if isinstance(obj, TreeAlias):
                    tid = obj.tree_id
                    (up_trees if c.tag == "up" else down_trees).append(
                        obj.tree_id)
                elif isinstance(obj, CompoundParam):
                    (up if c.tag == "up" else down).extend(obj.names)
                else:
                    (up if c.tag == "up" else down).append(obj.name)
        sf = _attr(el, "scaleFactor", 0.75, float)
        if len(set(up_trees + down_trees)) > 1:
            return MultiTreeUpDownOperator(
                ax=ax, up_params=tuple(up), down_params=tuple(down),
                up_trees=tuple(dict.fromkeys(up_trees)),
                down_trees=tuple(dict.fromkeys(down_trees)), weight=w,
                scale_factor=sf), None
        return O.UpDownOperator(
            up=tuple(up + [O.TREE_HEIGHTS] * len(up_trees)),
            down=tuple(down + [O.TREE_HEIGHTS] * len(down_trees)),
            weight=w, scale_factor=sf), tid

    if tag == "bitFlipOperator":
        _, obj, tid = _op_target(ax, el)
        return O.BitFlipOperator(parameter=obj.name, weight=w), tid

    if tag == "bitFlipInSubstitutionModelOperator":
        # BitFlipInSubstitutionModelOperator flips an SVS indicator and
        # rescales mu; as the JAX package substitutes it, the plain
        # posterior-preserving bit flip on the SVS model's indicators (mu
        # has its own scale operator)
        for c in el:
            cc = ax.deref(c)
            if cc.tag in ("svsGeneralSubstitutionModel",
                          "generalSubstitutionModel"):
                ax.build(cc)
                rec = getattr(ax, "_svs_models", {}).get(cc.get("id"))
                if rec is not None:
                    return O.BitFlipOperator(parameter=rec[1], weight=w), None
        raise Unsupported("bitFlipInSubstitutionModelOperator structure")

    if tag in ("gmrfBlockUpdateOperator", "gmrfGridBlockUpdateOperator"):
        # the conditioned-Gaussian block update of an ungrouped field
        # (GMRFSkyrideBlockUpdateOperator.java:245-345) is
        # inference/gibbs.py's; a grouped field keeps the JAX package's
        # posterior-preserving scale and walk
        pops = prec = sky_el = None
        for c in el:
            cc = ax.deref(c)
            if cc.tag in ("gmrfSkyrideLikelihood", "gmrfSkylineLikelihood",
                          "gmrfSkyLineLikelihood", "gmrfSkyGridLikelihood",
                          "skyGridLikelihood"):
                sky_el = cc
                for sub in cc:
                    if sub.tag == "populationSizes":
                        pops = ax.param_from(sub)
                    elif sub.tag == "precisionParameter":
                        prec = ax.param_from(sub)
        if pops is None:
            raise Unsupported("gmrfBlockUpdateOperator structure")
        ax.build(sky_el)  # sizes the field from the tree
        tm_b = None
        pt = sky_el.find("populationTree")
        if pt is not None:
            for t in pt:
                tm_b = ax.build(ax.deref(t))
        n_field = int(np.size(ax._params[pops].value))
        grouped = sky_el.find("groupSizes") is not None and (
            n_field != (len(tm_b.taxa) - 1 if tm_b else -1))
        is_grid = sky_el.tag in ("gmrfSkyGridLikelihood", "skyGridLikelihood")
        cuts = None
        ngp, cut = sky_el.find("numGridPoints"), sky_el.find("cutOff")
        if is_grid and ngp is not None and cut is not None:
            n_grid = int(float(np.ravel(ax.value_of(ax.param_from(ngp)))[0]))
            cutoff = float(np.ravel(ax.value_of(ax.param_from(cut)))[0])
            cuts = tuple(np.linspace(cutoff / n_grid, cutoff, n_grid))
        if tm_b is not None and not grouped:
            from beast_mcmc_tpu_torch.inference.gibbs import (
                GmrfBlockUpdateOperator,
            )

            return GmrfBlockUpdateOperator(
                field=pops, precision=prec, n_taxa=len(tm_b.taxa), weight=w,
                scale_factor=_attr(el, "scaleFactor", 2.0, float),
                time_aware=(_attr(sky_el, "timeAwareSmoothing", True, bool)
                            and not is_grid),
                cut_points=cuts), tm_b.tree_id
        return [
            O.ScaleOperator(parameter=prec, weight=w / 2, scale_factor=0.75),
            O.RandomWalkOperator(parameter=pops, weight=w / 2, window=0.5),
        ], None

    if tag == "sampleNonActiveOperator":
        dist = None
        for c in _child_of(el, "distribution"):
            dist = ax.build(ax.deref(c))
        if not (isinstance(dist, tuple) and dist[0] == "dist"
                and dist[1] == "exponential"):
            raise Unsupported("sampleNonActiveOperator distribution")
        return SampleNonActiveOperator(
            mean_param=dist[2], data_param=ax.param_from(_child_of(el,
                                                                   "data")),
            ind_param=ax.param_from(_child_of(el, "indicators")),
            weight=w), None

    if tag == "gmrfFixedEffectsGibbsOperator":
        # as the JAX package substitutes the conjugate draw: a random walk
        # on the fixed effects
        bname = None
        for c in el.iter("parameter"):
            if c.get("idref"):
                obj = ax.build(ax.deref(c))
                if isinstance(obj, Param):
                    bname = obj.name
                    break
        if bname is None:
            raise Unsupported("gmrfFixedEffectsGibbsOperator target")
        return O.RandomWalkOperator(parameter=bname, weight=w,
                                    window=0.3), None

    raise Unsupported(f"operator <{tag}>")


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def run_testxml(path: str, scale: float = 1.0, seed: int = 666,
                tolerance_se: float = 3.0, max_states: int = 200_000,
                full_eval_steps: int = 100,
                strict_expectations: bool = True, device=DEFAULT_DEVICE):
    """Execute one TestXML file on `device`; the assertion tuples. Raises
    AssertionError on a failed expectation (unless strict_expectations is
    off: the reference itself only warns, TraceAnalysisParser.java:
    108-112) and Unsupported for vocabulary outside the registry."""
    ax = XmlAnalysis(path, scale=scale, seed=seed, max_states=max_states,
                     strict_expectations=strict_expectations, device=device)
    return ax.run(tolerance_se=tolerance_se, full_eval_steps=full_eval_steps)


# -- distributionLikelihood ---------------------------------------------------
# (DistributionLikelihoodParser.java: a parametric distribution model over
# data parameters or statistics, whose own parameters may be estimated)


def _dist_model_logpdf(ax: XmlAnalysis, el):
    """(params, x) -> the summed log density of a distribution-model
    element."""
    from beast_mcmc_tpu_torch.models import priors as P

    cc = ax.deref(el)
    tag = cc.tag
    if tag == "normalDistributionModel":
        mname = ax.param_from(_child_of(cc, "mean"))
        prec_el = cc.find("precision")
        if prec_el is not None:
            pname = ax.param_from(prec_el)
            return lambda params, x: P.normal_logpdf(
                x, params[mname], 1.0 / torch.sqrt(params[pname]))
        sname = ax.param_from(_child_of(cc, "stdev"))
        return lambda params, x: P.normal_logpdf(x, params[mname],
                                                 params[sname])
    if tag == "logNormalDistributionModel":
        offset = _attr(cc, "offset", 0.0, float)
        mreal = _attr(cc, "meanInRealSpace", False, bool)
        mu_el, mean_el = cc.find("mu"), cc.find("mean")
        sig_el, sd_el = cc.find("sigma"), cc.find("stdev")
        prec_el = cc.find("precision")
        loc = ax.param_from(mu_el if mu_el is not None else mean_el)
        if sig_el is not None or sd_el is not None:
            sc = ax.param_from(sig_el if sig_el is not None else sd_el)

            def scale_of(params):
                return params[sc]
        elif prec_el is not None:
            sc = ax.param_from(prec_el)

            def scale_of(params):
                return 1.0 / torch.sqrt(params[sc])
        else:
            raise XmlError("logNormalDistributionModel without scale")

        def lp(params, x):
            s = scale_of(params)
            m = params[loc]
            mu = torch.log(m) - 0.5 * s * s if mreal else m
            return P.lognormal_logpdf(x - offset, mu, s)

        return lp
    if tag == "gammaDistributionModel":
        offset = _attr(cc, "offset", 0.0, float)
        shname = ax.param_from(_child_of(cc, "shape"))
        rate_el = cc.find("rate")
        if rate_el is not None:
            rname = ax.param_from(rate_el)
            return lambda params, x: P.gamma_logpdf(
                x - offset, params[shname], 1.0 / params[rname])
        scname = ax.param_from(_child_of(cc, "scale"))
        return lambda params, x: P.gamma_logpdf(x - offset, params[shname],
                                                params[scname])
    if tag == "exponentialDistributionModel":
        mname = ax.param_from(_child_of(cc, "mean"))
        return lambda params, x: P.exponential_logpdf(x, params[mname])
    if tag == "inverseGammaDistributionModel":
        shname = ax.param_from(_child_of(cc, "shape"))
        scname = ax.param_from(_child_of(cc, "scale"))
        return lambda params, x: P.inverse_gamma_logpdf(x, params[shname],
                                                        params[scname])
    if tag == "betaDistributionModel":
        aname = ax.param_from(_child_of(cc, "alpha"))
        bname = ax.param_from(_child_of(cc, "beta"))
        return lambda params, x: P.beta_logpdf(x, params[aname],
                                               params[bname])
    if tag == "uniformDistributionModel":
        lname = ax.param_from(_child_of(cc, "lower"))
        uname = ax.param_from(_child_of(cc, "upper"))
        return lambda params, x: P.uniform_logpdf(x, params[lname],
                                                  params[uname])
    raise Unsupported(f"distribution model <{tag}>")


@register("distributionLikelihood")
def _distribution_likelihood(ax: XmlAnalysis, el):
    dist_el = el.find("distribution")
    if dist_el is not None:
        model_el = next(iter(dist_el))
    else:
        cands = [c for c in el if c.tag != "data"]
        if not cands:
            raise XmlError("distributionLikelihood without distribution")
        model_el = cands[0]
    pdf = _dist_model_logpdf(ax, model_el)
    data_el = el.find("data")
    if data_el is None:
        raise XmlError("distributionLikelihood without data")
    targets = _targets_of(ax, data_el)

    def fn(params, tree):
        tot = 0.0
        for t in targets:
            tot = tot + _masked_sum(t(params, tree),
                                    lambda x: pdf(params, x))
        return tot

    dnames = []
    for c in data_el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            obj = ax.build(cc)
            if isinstance(obj, Param):
                dnames.append(obj.name)
    return LikelihoodFn(fn, None, el.get("id") or "distributionLikelihood",
                        tuple(dnames))


# ---------------------------------------------------------------------------
# the ported extension vocabularies (they register into _BUILDERS and
# _OP_EXT on import)
# ---------------------------------------------------------------------------

from beast_mcmc_tpu_torch.config import xml_assert as _xml_assert  # noqa: E402,F401
from beast_mcmc_tpu_torch.config import xml_ext as _xml_ext  # noqa: E402,F401
from beast_mcmc_tpu_torch.config import xml_geo as _xml_geo  # noqa: E402,F401
from beast_mcmc_tpu_torch.config import xml_mle as _xml_mle  # noqa: E402,F401
from beast_mcmc_tpu_torch.config import xml_stats as _xml_stats  # noqa: E402,F401
from beast_mcmc_tpu_torch.config import xml_hmc as _xml_hmc  # noqa: E402,F401
from beast_mcmc_tpu_torch.config import xml_traits as _xml_traits  # noqa: E402,F401
from beast_mcmc_tpu_torch.config import xml_field as _xml_field  # noqa: E402,F401
from beast_mcmc_tpu_torch.config import xml_factor as _xml_factor  # noqa: E402,F401
