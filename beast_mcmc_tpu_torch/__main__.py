"""The `beast`-equivalent command line of the port.

    python -m beast_mcmc_tpu_torch run analysis.xml [-seed N]
        [-chain_length N] [-save_state FILE] [-load_state FILE]
        [-log FILE] [-trees FILE] [-overwrite] [-device cuda|cpu]
        [-mc3_chains N] [-mc3_delta D] [-mc3_temperatures T1,T2,...]
        [-mc3_swap K] [-particles DIR] [-testxml] [-scale F]
    python -m beast_mcmc_tpu_torch loganalyser|logcombiner|treeannotator|
        seqgen|treestat ...

Counterpart of beast_mcmc_tpu/__main__.py, BeastMain's flag surface
(BeastMain.java:370-460: -seed, -save_state/-load_state, -overwrite; the
XML file is the analysis). `run` has two routes, as in the JAX package:

  - the declarative importer: config/xml_import.py -> AnalysisSpec ->
    apps/runner.py::run_analysis, which writes a Tracer-compatible tab log
    and a NEXUS tree log (by default <xml base name>.log and .trees in the
    working directory). -mc3_chains N > 1 runs N Metropolis-coupled chains
    (BeastMain.java:436-440) as one chain batch: the ladder 1 / (1 + delta
    k), or 1 followed by -mc3_temperatures; a swap attempt every -mc3_swap
    states; the cold chain's log only. -particles DIR (SMC.java,
    BeastMain.java:527-532) loads every checkpoint of DIR as one chain
    batch (inference/smc.py), advances it -chain_length states, one
    chain-axis posterior a step, and writes DIR.out/particleNNNN;
  - a document outside the importer's vocabulary runs through the XML
    interpreter (config/interpreter.py), which writes the logs its own
    <log fileName> and <logTree fileName> elements name in the working
    directory; -testxml sends a document there straight and runs it
    strictly (a failed <traceAnalysis> expectation fails the run). Both
    print a line a chain on stderr (each <mcmc> and each
    <marginalLikelihoodEstimator>'s ladder: states/s and the
    full-evaluation deviation). On this route -scale scales each chain's
    length and each log's logEvery, as -testxml does; the JAX package's
    run route ignores it.

-device picks the card (cuda, the default) or the CPU for both. A tag of
a JAX extension module that is not ported yet, or a document the
interpreter cannot read, stops the run with a message (naming the module)
and a non-zero code. -particles needs a document of the importer's
vocabulary: on the interpreter route, where the JAX package ignores the
flag, it is refused with a message and a non-zero code.

The sub-tools keep the reference's app names (LogAnalyser.java,
LogCombiner.java, TreeAnnotator.java, SeqGen.java, TreeStatApp) and run
the port's apps/ modules of the same names.

An unknown command returns 2.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

SUB_TOOLS = ("loganalyser", "logcombiner", "treeannotator", "seqgen",
             "treestat")


def _cmd_run(argv) -> int:
    p = argparse.ArgumentParser(
        prog="beast_mcmc_tpu_torch run",
        description="Run a BEAST XML analysis (BeastMain role)")
    p.add_argument("xml", help="BEAST XML analysis file")
    p.add_argument("-seed", type=int, default=None)
    p.add_argument("-chain_length", type=int, default=None,
                   help="override <mcmc chainLength>")
    p.add_argument("-save_state", default=None, metavar="FILE")
    p.add_argument("-load_state", default=None, metavar="FILE")
    p.add_argument("-particles", default=None, metavar="DIR",
                   help="folder of particle checkpoints to advance")
    p.add_argument("-log", default=None, help="parameter log file")
    p.add_argument("-trees", default=None, help="NEXUS tree log file")
    p.add_argument("-overwrite", action="store_true")
    p.add_argument("-mc3_chains", type=int, default=1,
                   help="number of Metropolis-coupled chains")
    p.add_argument("-mc3_delta", type=float, default=None,
                   help="temperature increment parameter")
    p.add_argument("-mc3_temperatures", default=None,
                   help="comma-separated hot-chain temperatures")
    p.add_argument("-mc3_swap", type=int, default=100,
                   help="states between chain swap attempts")
    p.add_argument("-testxml", action="store_true",
                   help="run through the TestXML interpreter "
                        "(multi-mcmc blocks + embedded assertions)")
    p.add_argument("-scale", type=float, default=1.0,
                   help="chain-length and logEvery scale factor (testxml "
                        "mode and the interpreter route)")
    p.add_argument("-device", default="cuda",
                   help="torch device of the chain: cuda (default) or cpu")
    args = p.parse_args(argv)

    for f in (args.log, args.trees):
        if f and os.path.exists(f) and not args.overwrite:
            p.error(f"{f} exists (use -overwrite)")
    from beast_mcmc_tpu_torch.config.interpreter import Unsupported, XmlError

    if args.testxml:
        from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis

        try:
            # as config/interpreter.py::run_testxml runs it
            ax = XmlAnalysis(args.xml, scale=args.scale,
                             seed=args.seed or 666,
                             max_states=args.chain_length or 10**9,
                             device=args.device)
            res = ax.run()
        except (Unsupported, XmlError) as e:
            print(f"{args.xml}: {e}", file=sys.stderr)
            return 1
        _print_runs(ax)
        for fname, name, mean, exp, se in res:
            print(f"E[{name}] = {mean:.6g} (expected {exp:.6g}, "
                  f"SE {se:.3g}) OK")
        print(f"{args.xml}: all embedded checks passed")
        return 0

    from beast_mcmc_tpu_torch.apps.runner import run_analysis
    from beast_mcmc_tpu_torch.config.xml_import import (
        XmlImportError,
        parse_beast_xml,
    )

    with open(args.xml) as f:
        text = f.read()
    try:
        spec = parse_beast_xml(text)
    except (NotImplementedError, XmlImportError) as e:
        # one vocabulary, two engines: past the importer's subset the
        # document runs through the interpreter registry
        if args.particles:
            print(f"{args.xml}: -particles (inference/smc.py) advances the "
                  f"particles of an importer document; this one is outside "
                  f"the importer's vocabulary ({e})", file=sys.stderr)
            return 1
        print(f"[importer: {e}; running through the interpreter registry]")
        from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis

        try:
            ax = XmlAnalysis(
                args.xml, scale=args.scale, seed=args.seed or 666,
                max_states=args.chain_length or 10**9, workdir=os.getcwd(),
                # the reference only warns on a failed trace expectation
                # (TraceAnalysisParser.java:108-112); -testxml is strict
                strict_expectations=False, device=args.device)
            ax.run()
        except (Unsupported, XmlError) as e:
            print(f"{args.xml}: {e}", file=sys.stderr)
            return 1
        _print_runs(ax)
        print(f"{args.xml}: analysis complete "
              f"(logs written beside the XML's fileName attributes)")
        return 0
    if args.seed is not None:
        spec.mcmc.seed = args.seed
    if args.chain_length is not None:
        spec.mcmc.chain_length = args.chain_length

    if args.particles:
        return _run_particles(spec, args.particles, args.device)

    base = os.path.splitext(os.path.basename(args.xml))[0]
    log_file = args.log or f"{base}.log"
    tree_file = args.trees or f"{base}.trees"
    mc3_temps = (None if args.mc3_temperatures is None else
                 [float(x) for x in args.mc3_temperatures.split(",")])
    result = run_analysis(
        spec, log_file=log_file, tree_file=tree_file,
        checkpoint_file=args.save_state, load_state=args.load_state,
        mc3_chains=args.mc3_chains, mc3_delta=args.mc3_delta,
        mc3_temperatures=mc3_temps, mc3_swap=args.mc3_swap,
        device=args.device)
    print(result.report)
    print(f"{result.states_per_sec:.1f} states/sec; logs: {log_file}, "
          f"{tree_file}")
    return 0


def _print_runs(ax) -> None:
    """One line on stderr a chain the interpreter ran (each <mcmc>, each
    <marginalLikelihoodEstimator>'s ladder): states, seconds, states/s and
    its full-evaluation deviation."""
    for r in ax.runs:
        print(f"{r['steps']} states in {r['seconds']:.1f}s = "
              f"{r['steps'] / max(r['seconds'], 1e-9):.1f} states/sec; "
              f"full-evaluation deviation {r['full_eval_deviation']:.3g}",
              file=sys.stderr)


def _run_particles(spec, folder: str, device) -> int:
    """-particles: build, a template state, load the folder's checkpoints
    as one batch, advance it chain_length states and write folder.out. A
    folder that is missing or holds no checkpoint returns 1."""
    import torch

    from beast_mcmc_tpu_torch.config.builder import build
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state,
        make_multichain_step,
    )
    from beast_mcmc_tpu_torch.inference.smc import (
        load_particles,
        run_particles,
    )

    if not os.path.isdir(folder):
        print(f"-particles: no folder {folder}", file=sys.stderr)
        return 1
    analysis = build(spec, device=device)
    step = make_multichain_step(analysis.log_posterior_chains,
                                analysis.operators)
    template = init_mcmc_state(
        analysis.params0, analysis.tree0,
        torch.Generator(device=analysis.tree0.heights.device).manual_seed(
            spec.mcmc.seed),
        analysis.operators, analysis.log_posterior)
    try:
        particles = load_particles(folder, template)
    except ValueError as e:  # no checkpoint in the folder
        print(f"-particles: {e}", file=sys.stderr)
        return 1
    out = run_particles(step, particles, spec.mcmc.chain_length,
                        out_folder=folder + ".out")
    print(f"advanced {out.log_posterior.shape[0]} particles by "
          f"{spec.mcmc.chain_length} states -> {folder}.out")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "run":
        return _cmd_run(rest)
    if cmd in SUB_TOOLS:
        tool = importlib.import_module(f"beast_mcmc_tpu_torch.apps.{cmd}")
        try:
            return tool.main(rest) or 0
        except OSError as e:  # a missing or unreadable input or output
            print(f"{cmd}: {e}", file=sys.stderr)
            return 1
    print(f"unknown command {cmd!r}; try: run, {', '.join(SUB_TOOLS)}",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
