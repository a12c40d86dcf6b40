"""The benchmark's run: one cell, one seed, one window.

A cell of BENCHMARK.json names a configuration and a traffic mix; the
harness finds everything else by those names:

  configs/<config>.json    the configuration's sizes, source, cuts, limits
  configs/<config>.py      build(cfg, seed, device): the program's analysis
  reference/<config>.py    its plain reference
  traffic/<traffic>.json   the chain batch and the operators it adds
  counts/<kernel>.py       the peel kernel's trace names and count
  metrics/<metric>.py      a per-layer metric's reader

The loop is closed: the window calls the program's chain-batch step
(`inference/mcmc.py::make_multichain_step`, its `given_op` with the
operator `schedule` draws from the seed) back to back, as `run_chain`
does, and records one CUDA event after each batch step without
synchronising; the events are read once the window has closed.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
PROGRAM = "beast_mcmc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "beast_mcmc_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    """(the cell, its configuration's entry) of BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, conf


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Clock:
    """Step-end marks: CUDA events on the card, read after the window;
    the host clock elsewhere (a CPU rehearsal)."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.device = device

    def mark(self):
        import torch

        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


class TracedWindow:
    """What the per-layer readers see of a traced window."""

    def __init__(self, trace, steps, host_s, step_spans, launches,
                 gradient_spans, shape, chains, kernel, dtype):
        self.trace, self.steps, self.host_s = trace, steps, host_s
        self.step_spans = step_spans
        self.launches, self.gradient_spans = launches, gradient_spans
        self.gradients = len(gradient_spans)
        self.shape, self.chains = shape, chains
        self.kernel, self.dtype = kernel, dtype
        self.itemsize = 8 if dtype == "float64" else 4


def _launches() -> int:
    """The program's peel launches so far, over its four kernel wrappers."""
    from beast_mcmc_tpu_torch.ops import (
        cuda_mxu, cuda_peeling, cuda_stream, cuda_stream2)

    return sum(m.launches for m in (cuda_mxu, cuda_peeling, cuda_stream,
                                    cuda_stream2))


class GradientSpans:
    """The host spans of the program's gradients (`torch.autograd.grad`,
    which HMC's `value_and_grad` calls once a gradient, its backward run
    by the autograd engine before it returns), on the clock of the
    profiler's host events (`time.time_ns`), while the `with` lasts."""

    def __init__(self):
        self.spans = []

    def __enter__(self):
        import torch

        real = self.real = torch.autograd.grad

        def timed(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return real(*args, **kwargs)
            finally:
                self.spans.append((t0, time.time_ns()))

        torch.autograd.grad = timed
        return self

    def __exit__(self, *exc):
        import torch

        torch.autograd.grad = self.real


def _operators(base, traffic):
    """The configuration's operators, then those the traffic adds, each
    named by its module in the program and its class."""
    return list(base) + [
        getattr(importlib.import_module(f"{PROGRAM}.{extra['module']}"),
                extra["class"])(**extra["args"])
        for extra in traffic["extra_operators"]]


def schedule(weights, extra_every, seed):
    """The operator of each batch step, drawn from the seed, with the same
    work whatever the seed: every W steps of the configuration's operators
    (W the sum of their weights, whole numbers) hold each
    operator exactly its weight's number of times, in an order drawn from
    the seed; every block of L steps (L the largest of `extra_every`)
    holds each added operator L / every times, at places drawn from the
    seed, and the configuration's operators in the rest. So an operator
    far costlier than the others (an eigendecomposition, an HMC proposal)
    takes the same share of every window, not a binomial one."""
    import numpy as np

    rng = np.random.default_rng([seed, 0x6f70])
    n_base = len(weights)
    counts = [int(w) for w in weights]
    if counts != list(weights):
        raise ValueError(f"operator weights {weights} are not whole numbers")
    block = max(extra_every, default=1)

    def base():
        quota = np.repeat(np.arange(n_base), counts)
        while True:
            yield from rng.permutation(quota)

    drawn = base()
    extras = [n_base + i for i, every in enumerate(extra_every)
              for _ in range(block // every)]
    while True:
        places = dict(zip(rng.permutation(block)[:len(extras)].tolist(),
                          extras))
        for k in range(block):
            yield int(places[k]) if k in places else int(next(drawn))


def _p95(values):
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def _program_gradient(log_posterior_chains, params, tree):
    """d log posterior / d heights [B, M] of the program at these states,
    through its own entry (the kernel's forward and its level adjoint)."""
    import torch

    h = tree.heights.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        lp = log_posterior_chains(params, tree.replace(heights=h))
    return torch.autograd.grad(lp.sum(), h)[0]


def rel_gaps(got, ref):
    """Per chain: max |got - ref| over max |ref| (over a chain's entries,
    or |got - ref| / |ref| for one value a chain)."""
    d = (got - ref).abs().reshape(got.shape[0], -1).amax(-1)
    return d / ref.abs().reshape(ref.shape[0], -1).amax(-1)


def judge(gaps, unmoved, limits):
    """(correct, failing chains, the checks with their limits) of the
    gaps [B] of each number and the chains that accepted nothing."""
    import torch

    failing = unmoved.clone()
    checks = {}
    for name, per_chain in gaps.items():
        failing |= ~(per_chain <= limits[name])  # NaN fails
        checks[name] = {"value": float(per_chain.max()),
                        "limit": limits[name]}
    checks["chains_unmoved"] = {"value": int(unmoved.sum()),
                                "limit": limits["chains_unmoved"]}
    correct = (not bool(failing.any())
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return correct, failing, checks


def run(cell_name, seed, seconds, trace, device, t0, bench=None,
        overrides=None, log=None, control=None):
    """One run of a cell on `device`. Returns the result line's dict
    (with "checks" last) and the lines for standard error. `control`, a
    dtype, also reads the control: the reference computed in that
    precision against the float64 one at the same states, under the
    result's "readings" with the program's own, and the verdict the
    limits give the control put in the program's place (control.py; the
    benchmark's runs never do)."""
    import torch

    from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, make_multichain_step)

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench = bench or load_json(CHECKOUT / "BENCHMARK.json")
    cell, conf = find_cell(bench, cell_name)
    cfg = load_json(CHECKOUT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    for key, value in (overrides or {}).items():
        (traffic if key in traffic else cfg)[key] = value
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = importlib.import_module(f"phylobench.configs.{cell['config']}")
    kernel = importlib.import_module(f"phylobench.counts.{cfg['kernel']}")
    clock = Clock(device)
    chains = traffic["chains"]

    # ---- set-up: the analysis, the batch, every operator drawn once -----
    log(f"set-up: torch and the card ready at "
        f"{time.perf_counter() - t0:.3f} s")
    setup = config.build(cfg, seed, device)
    clock.sync()
    log(f"set-up: analysis built at {time.perf_counter() - t0:.3f} s")
    operators = _operators(setup["operators"], traffic)
    step = make_multichain_step(setup["log_posterior_chains"], operators,
                                derived=setup["derived"])
    gen = torch.Generator(device=device).manual_seed(seed)
    states = replicate_state(init_mcmc_state(
        setup["params0"], setup["tree0"], gen, operators), chains, gen)
    states = states.replace(log_posterior=setup["log_posterior_chains"](
        states.params, states.tree).to(torch.float64))
    for i in range(len(operators)):
        states = step.given_op(states, i)
    every = [extra["every"] for extra in traffic["extra_operators"]]
    draws = schedule([op.weight for op in setup["operators"]], every, seed)
    block = max(every, default=1)  # the window ends on a whole block
    clock.sync()
    accepted0 = states.op_accept.sum(-1).clone()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s ({len(operators)} operators, {chains} "
        f"chains)")

    # ---- the window -------------------------------------------------------
    profiler = grads = None
    if trace:
        from phylobench.trace import Profiler

        profiler = Profiler(clock.cuda)
        grads = GradientSpans().__enter__()
    host_s, spans, marks, traced = [], [], [], None
    launches0 = _launches()
    if profiler:
        profiler.start()
        t_traced = time.time_ns()
    first = clock.mark()
    start = time.perf_counter()
    while True:
        h0, n0 = time.perf_counter(), time.time_ns()
        states = step.given_op(states, next(draws))
        h1 = time.perf_counter()
        if traced is None and profiler:  # the span on the profiler's clock
            spans.append((n0, time.time_ns()))
        host_s.append(h1 - h0)
        marks.append(clock.mark())
        done = h1 - start >= seconds and len(marks) % block == 0
        if profiler and traced is None and (
                len(marks) == traffic["trace_steps"] or done):
            clock.sync()
            traced = (Profiler.stop(), len(marks), list(host_s), spans,
                      _launches() - launches0, grads.spans)
            grads.__exit__()
        if done:
            break
    clock.sync()
    n_steps = len(marks)
    step_ms = [clock.ms(a, b) for a, b in zip([first] + marks[:-1], marks)]
    window_ms = clock.ms(first, marks[-1])
    memory_peak = (torch.cuda.max_memory_allocated(device) if clock.cuda
                   else 0)

    # ---- what the window produced, then the program's state freed --------
    accepted = (states.op_accept.sum(-1) - accepted0).cpu()
    prog_lp = states.log_posterior.detach().to(torch.float64).cpu()
    prog_grad = pick = None
    if traffic["gradient_chains"]:  # a sample of the chains, from the seed
        import numpy as np

        pick = torch.as_tensor(np.sort(np.random.default_rng(
            [seed, 0x67]).choice(chains, traffic["gradient_chains"],
                                 replace=False)))
        prog_grad = _program_gradient(setup["log_posterior_chains"],
                                      states.params, states.tree)
        prog_grad = prog_grad[pick.to(prog_grad.device)].cpu()
    params = {k: v.detach().clone() for k, v in states.params.items()
              if isinstance(v, torch.Tensor)}
    tree = {f: getattr(states.tree, f).detach().clone()
            for f in ("parent", "children", "heights", "root")}
    inputs = setup["inputs"]
    shape = setup["shape"]
    del states, step, setup, operators
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()

    # ---- the reference ------------------------------------------------------
    reference = importlib.import_module(
        f"phylobench.reference.{cell['config']}")
    t_ref = time.perf_counter()
    ref_lp = reference.log_posterior(cfg, inputs, params, tree,
                                     torch.float64, device).cpu()
    gaps = {"lp_rel_gap": rel_gaps(prog_lp, ref_lp)}
    if pick is not None:
        n = (prog_grad.shape[1] + 1) // 2  # internal nodes' rows
        sample = ({k: v[pick.to(v.device)] for k, v in params.items()},
                  {k: v[pick.to(v.device)] for k, v in tree.items()})
        ref_grad = reference.grad_heights(cfg, inputs, *sample,
                                          torch.float64, device).cpu()
        gaps["grad_rel_gap"] = torch.zeros(chains, dtype=torch.float64
                                           ).index_copy(0, pick, rel_gaps(
                                               prog_grad[:, n:],
                                               ref_grad[:, n:]))
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    limits = cfg["limits"]
    unmoved = accepted == 0
    correct, failing, checks = judge(gaps, unmoved, limits)
    if control is not None:
        low = {"lp_rel_gap": rel_gaps(reference.log_posterior(
            cfg, inputs, params, tree, control, device).cpu().double(),
            ref_lp)}
        if pick is not None:
            low["grad_rel_gap"] = torch.zeros(
                chains, dtype=torch.float64).index_copy(0, pick, rel_gaps(
                    reference.grad_heights(cfg, inputs, *sample, control,
                                           device).cpu().double()[:, n:],
                    ref_grad[:, n:]))
        readings = {
            side: {k: (v[pick] if k == "grad_rel_gap" else v).tolist()
                   for k, v in g.items()}
            for side, g in (("program", gaps), ("control", low))}
        readings["control_correct"] = judge(low, unmoved, limits)[0]
    result = {"correct": correct, "attempted": chains,
              "failed": int(failing.sum())}
    if trace:
        from phylobench.trace import Trace

        events, t_steps, t_host, t_step_spans, t_launch, t_spans = traced
        ctx = TracedWindow(Trace(events), t_steps, t_host, t_step_spans,
                           t_launch, t_spans, shape, chains, kernel,
                           cfg["dtype"])
        log(f"traced {t_steps} steps, {t_launch} peel launches, "
            f"{ctx.gradients} gradients, {len(events)} events; the first "
            f"host call {(ctx.trace.start - t_traced) * 1e-6:.3f} ms after "
            "the window's start by time_ns")
        metrics = {}
        for m in bench["per_layer"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            # a metric split by cells (`name.hmc`) shares its reader
            reader = importlib.import_module(
                f"phylobench.metrics.{m['name'].split('.')[0]}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        busy = {"busy_s": ctx.trace.busy_s, "window_s": ctx.trace.window_s}
        result["breakdown"] = ctx.trace.breakdown()
    else:
        values = {"states_per_s": chains * n_steps / (window_ms * 1e-3),
                  "step_ms_p95": _p95(step_ms), "setup_s": setup_s}
        result["metrics"] = {
            m["name"]: {"value": values[m["name"].split(".")[0]],
                        "unit": m["unit"]}
            for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])}
        busy = {}
    result["device"] = _device(device, memory_peak, busy)
    log(f"window {window_ms * 1e-3:.3f} s, {n_steps} steps, median step "
        f"{statistics.median(step_ms):.3f} ms")
    if control is not None:
        result["readings"] = readings
    result["checks"] = checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return result, lines


def _device(device, memory_peak, busy) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0, **busy}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": memory_peak, **busy}
