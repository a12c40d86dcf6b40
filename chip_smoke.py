#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit: `python3 chip_smoke.py`. The peel kernels build into build/
at first use. Phases, each of which fails the run (non-zero exit, no
result line):

  1. build both kernels (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, and time both; hold the card's
     log posterior against the CPU's on a small analysis;
  3. the f64 GTR+Gamma4 chain at the benchmark2 shape (62 taxa, 5,565
     patterns) through the resident kernel, with the full-evaluation
     self-check (< 0.1);
  4. the same model at the Makona shape (1,610 taxa, 2,048 patterns)
     through the streaming kernel, with the same check.

It prints the card's name and power limit, one {"kernels": [...]} line,
and last {"ok": true, "device": {...}}. It imports nothing of JAX and
nothing of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# per site, relative to max(|site logL|, 1): padded patterns have logL 0
F64_REL_TOL = 1e-10
F32_ABS_TOL = 5e-5  # per site, absolute (as tests/test_pallas_stream.py)
FULL_EVAL_TOL = 0.1  # MarkovChain.java:55
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}  # data sheet, no tensor cores

B2 = (62, 5565)
MAKONA = (1610, 2048)
SMALL = (12, 130)
B2_STEPS, B2_CHECK = 3000, 200
MAK_STEPS, MAK_CHECK = 200, 50


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps):
    """Median milliseconds of `reps` calls, CUDA events around each."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(tensors_in, out, n_int, c, s, p, dtype_name):
    """Least time for the peel: inputs read once and output written once
    over HBM bandwidth, against the peel's operations (bench.py's count,
    4S^2 + 3S per node, category and pattern, plus the root) over the
    card's non-tensor-core peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors_in)
    nbytes += out.numel() * out.element_size()
    flops = n_int * c * p * (4 * s * s + 3 * s) + 2 * c * s * p
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
    from beast_mcmc_tpu_torch.inference.mcmc import (
        full_evaluation_check, init_mcmc_state, make_mcmc_step,
        operator_report, run_chain)
    from beast_mcmc_tpu_torch.models.treelikelihood import (
        branch_transition_matrices)
    from beast_mcmc_tpu_torch.ops import _build, cuda_peeling, cuda_stream
    from beast_mcmc_tpu_torch.ops import peeling as plain
    from beast_mcmc_tpu_torch.ops.peeling import peel_order_from_heights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind}")

    # -- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all(["peel_resident", "peel_stream"])
    log(f"[build] {time.perf_counter() - t0:.2f} s wall, per source "
        f"{json.dumps({k: round(v, 2) for k, v in built.items()})}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- set-up: the two analyses of the main path ---------------------
    t0 = time.perf_counter()
    analyses = {shape: build_analysis(*shape, model="gtr_gamma", device=dev,
                                      dtype=torch.float64)
                for shape in (B2, MAKONA, SMALL)}
    torch.cuda.synchronize()
    log(f"[setup] analyses built in {time.perf_counter() - t0:.2f} s")

    def peel_inputs(shape, dtype):
        _, _, p0, t0_, aux = analyses[shape]
        rates, cw = p0["site.rates"]
        pm = branch_transition_matrices(p0["eig"], t0_.parent, t0_.heights,
                                        p0["clock.rate"], rates)
        order = peel_order_from_heights(t0_.heights, shape[0], t0_.parent)
        return (aux["tips"].to(dtype).contiguous(), t0_.children, order,
                t0_.root, pm.to(dtype).contiguous(), aux["freqs"].to(dtype),
                cw.to(dtype))

    # -- phase 2: kernel vs plain on the card -------------------------
    checks = {"peel_resident": [], "peel_stream": []}

    def check(kname, label, shape, dtype, reps, plain_reps):
        tips, ch, order, root, pm, fr, cw = peel_inputs(shape, dtype)
        n_int = tips.shape[0] - 1
        c, s, p = pm.shape[1], pm.shape[2], tips.shape[2]
        if kname == "peel_resident":
            call = cuda_peeling.prepare_resident(tips, ch, order, pm, fr, cw)
            plain_fn = lambda: plain.peel_site_loglik(  # noqa: E731
                tips, ch, order, root, pm, fr, cw)
            ins = [tips, pm, ch, order, fr, cw]
        else:
            lr_ids, lr_pos, pm_ord = cuda_stream.stream_schedule(ch, order, pm)
            call = cuda_stream.prepare_stream(tips, lr_ids, lr_pos, pm_ord,
                                              fr, cw)
            wcs = cw[:, None] * fr[None, :]
            plain_fn = lambda: cuda_stream._stream_plain(  # noqa: E731
                tips, lr_ids, lr_pos, pm_ord, wcs)
            ins = [tips, pm_ord, lr_ids, lr_pos, fr, cw]
        got = call.launch().clone()
        ref = plain_fn()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        max_abs = err.max().item()
        max_rel = (err / ref.abs().clamp_min(1.0)).max().item()
        finite = bool(torch.isfinite(got).all())
        if dtype == torch.float64:
            ok, tol = max_rel < F64_REL_TOL, f"rel<{F64_REL_TOL}"
        else:
            ok, tol = max_abs < F32_ABS_TOL, f"abs<{F32_ABS_TOL}"
        ms = time_ms(call.launch, reps)
        plain_ms = time_ms(plain_fn, plain_reps)
        dname = str(dtype).replace("torch.", "")
        # int inputs counted as the int32 the kernel reads
        b_ms, b_by, nbytes, flops = bound_ms(
            [t for t in ins if t.is_floating_point()]
            + [t.to(torch.int32) for t in ins if not t.is_floating_point()],
            got, n_int, c, s, p, dname)
        rec = {"label": label, "shape": [tips.shape[0], c, s, p],
               "dtype": dname, "max_abs_err": max_abs, "max_rel_err": max_rel,
               "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "bytes": nbytes, "flops": flops}
        log(f"[kernel] {kname} {json.dumps(rec)}")
        if not (ok and finite):
            raise AssertionError(f"{kname} {label}: kernel disagrees with its "
                                 f"plain version ({tol}): {rec}")
        checks[kname].append(rec)

    check("peel_resident", "benchmark2 f64", B2, torch.float64, 50, 5)
    check("peel_resident", "benchmark2 f32", B2, torch.float32, 50, 5)
    check("peel_stream", "makona f64", MAKONA, torch.float64, 20, 2)
    check("peel_stream", "small forced stream f64", SMALL, torch.float64, 50, 5)
    check("peel_stream", "small forced stream f32", SMALL, torch.float32, 50, 5)

    # the card's log posterior against the CPU's plain path, small input
    lp_s, _, p_s, t_s, _ = analyses[SMALL]
    lp_cpu, _, p_c, t_c, _ = build_analysis(*SMALL, model="gtr_gamma",
                                            device="cpu", dtype=torch.float64)
    a, b = float(lp_s(p_s, t_s)), float(lp_cpu(p_c, t_c))
    log(f"[logpost] card {a!r} cpu {b!r} rel {abs(a - b) / abs(b):.3e}")
    if not abs(a - b) <= 1e-10 * abs(b):
        raise AssertionError("card and CPU log posteriors disagree")

    # -- phases 3 and 4: the chain ------------------------------------
    def chain(shape, n_steps, n_check, expect, other, seed):
        log_post, ops, p0, tr0, aux = analyses[shape]
        lpc = aux["log_post_cached"]
        step = make_mcmc_step(lpc, ops, derived=aux["derived"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_mcmc_state(p0, tr0, gen, ops, lpc)
        state, _ = run_chain(step, state, 20)  # warm-up
        torch.cuda.synchronize()
        cuda_peeling.launches = 0
        cuda_stream.launches = 0
        t0 = time.perf_counter()
        state, _ = run_chain(step, state, n_steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"peel_resident": cuda_peeling.launches,
                  "peel_stream": cuda_stream.launches}
        lp = float(state.log_posterior)
        log(f"[chain {shape}] {n_steps} steps in {dt:.3f} s = "
            f"{n_steps / dt:.2f} states/s; log posterior {lp!r}; "
            f"launches {json.dumps(counts)}")
        log(operator_report(ops, state))
        if counts[expect] != n_steps or counts[other] != 0:
            raise AssertionError(f"expected {n_steps} {expect} launches and no "
                                 f"{other} launches, got {counts}")
        if lp != lp or lp == float("inf") or lp == -float("inf"):
            raise AssertionError(f"posterior not finite: {lp}")
        t0 = time.perf_counter()
        state, dev_max = full_evaluation_check(step, log_post, state, n_check,
                                               derived=aux["derived"])
        dev_max = float(dev_max)
        log(f"[chain {shape}] full-evaluation max deviation over {n_check} "
            f"steps: {dev_max!r} (tolerance {FULL_EVAL_TOL}) in "
            f"{time.perf_counter() - t0:.2f} s")
        if not dev_max < FULL_EVAL_TOL:
            raise AssertionError(f"full-evaluation deviation {dev_max}")
        return counts[expect], n_steps / dt, step, state, lpc

    res_launches, b2_rate, b2_step, b2_state, _ = chain(
        B2, B2_STEPS, B2_CHECK, "peel_resident", "peel_stream", 0)
    mak_launches, mak_rate, mak_step, mak_state, _ = chain(
        MAKONA, MAK_STEPS, MAK_CHECK, "peel_stream", "peel_resident", 1)

    # where the time of a step goes: a profiler window over the chain
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def where_time_goes(label, step, state, n_steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = run_chain(step, state, n_steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only (kernels, copies): an operator's own
        # entry would count its kernels' time a second time
        kern = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in kern) / 1e6
        if busy <= 0:
            log(f"[profile {label}] device time not measured by the profiler")
            return
        log(f"[profile {label}] {n_steps} steps, wall {wall:.4f} s "
            f"(profiled), device busy {busy:.4f} s = "
            f"{100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%, "
            f"{sum(e.count for e in kern) / n_steps:.1f} device events/step")
        for e in kern[:8]:
            log(f"[profile {label}]   {e.self_device_time_total / 1e3:9.3f} ms"
                f"  {e.count:6d}x  {e.key[:70]}")

    where_time_goes("benchmark2", b2_step, b2_state, 200)
    where_time_goes("makona", mak_step, mak_state, 50)

    # -- phase 5: summary ---------------------------------------------
    def entry(kname, source, replaces, launches, rec):
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                "checks": checks[kname]}

    log(f"[summary] benchmark2 {b2_rate:.2f} states/s, makona "
        f"{mak_rate:.2f} states/s, on {smi_line}")
    log(smi_line)
    print(json.dumps({"kernels": [
        entry("peel_resident", "beast_mcmc_tpu_torch/csrc/peel_resident.cu",
              "beast_mcmc_tpu/ops/pallas_peeling.py:52", res_launches,
              checks["peel_resident"][0]),
        entry("peel_stream", "beast_mcmc_tpu_torch/csrc/peel_stream.cu",
              "beast_mcmc_tpu/ops/pallas_stream2.py:64", mak_launches,
              checks["peel_stream"][0]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
