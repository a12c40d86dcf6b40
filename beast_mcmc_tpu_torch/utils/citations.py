"""Citation registry — models declare the papers they implement; a run
writes a citations file (ref: src/dr/util/Citable.java / Citation.java and
the -citations_file flag, src/dr/app/beast/BeastMain.java:452).

The port's own copy of beast_mcmc_tpu/utils/citations.py: host-side numpy
over this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

# model/component key -> citation strings
CITATIONS: Dict[str, List[str]] = {
    "framework": [
        "Suchard MA, Lemey P, Baele G, Ayres DL, Drummond AJ, Rambaut A "
        "(2018) Bayesian phylogenetic and phylodynamic data integration "
        "using BEAST 1.10. Virus Evolution 4: vey016.",
    ],
    "hky": ["Hasegawa M, Kishino H, Yano T (1985) Dating of the human-ape "
            "splitting by a molecular clock of mitochondrial DNA. "
            "J Mol Evol 22:160-174."],
    "gtr": ["Tavare S (1986) Some probabilistic and statistical problems in "
            "the analysis of DNA sequences. Lect Math Life Sci 17:57-86."],
    "tn93": ["Tamura K, Nei M (1993) Estimation of the number of nucleotide "
             "substitutions... Mol Biol Evol 10:512-526."],
    "gy94": ["Goldman N, Yang Z (1994) A codon-based model of nucleotide "
             "substitution for protein-coding DNA. Mol Biol Evol 11:725-736."],
    "mg94": ["Muse SV, Gaut BS (1994) A likelihood approach for comparing "
             "synonymous and nonsynonymous substitution rates. "
             "Mol Biol Evol 11:715-724."],
    "gamma_sites": ["Yang Z (1994) Maximum likelihood phylogenetic estimation "
                    "from DNA sequences with variable rates over sites. "
                    "J Mol Evol 39:306-314."],
    "relaxed_clock_lognormal": [
        "Drummond AJ, Ho SYW, Phillips MJ, Rambaut A (2006) Relaxed "
        "phylogenetics and dating with confidence. PLoS Biol 4:e88."],
    "random_local_clock": [
        "Drummond AJ, Suchard MA (2010) Bayesian random local clocks, or one "
        "rate to rule them all. BMC Biology 8:114."],
    "coalescent": ["Kingman JFC (1982) The coalescent. Stoch Proc Appl "
                   "13:235-248."],
    "skyline": ["Drummond AJ, Rambaut A, Shapiro B, Pybus OG (2005) Bayesian "
                "coalescent inference of past population dynamics. "
                "Mol Biol Evol 22:1185-1192."],
    "skygrid": ["Gill MS, Lemey P, Faria NR, Rambaut A, Shapiro B, Suchard MA "
                "(2013) Improving Bayesian population dynamics inference: a "
                "coalescent-based model for multiple loci. "
                "Mol Biol Evol 30:713-724."],
    "birth_death": ["Gernhard T (2008) The conditioned reconstructed process. "
                    "J Theor Biol 253:769-778."],
    "serial_birth_death": ["Stadler T (2010) Sampling-through-time in "
                           "birth-death trees. J Theor Biol 267:396-404."],
    "episodic_birth_death": ["Stadler T, Kuhnert D, Bonhoeffer S, Drummond AJ "
                             "(2013) Birth-death skyline plot reveals temporal "
                             "changes of epidemic spread. PNAS 110:228-233."],
    "basta": ["De Maio N, Wu C-H, O'Reilly KM, Wilson D (2015) New routes to "
              "phylogeography: a Bayesian structured coalescent "
              "approximation. PLoS Genet 11:e1005421."],
    "bssvs": ["Lemey P, Rambaut A, Drummond AJ, Suchard MA (2009) Bayesian "
              "phylogeography finds its roots. PLoS Comput Biol 5:e1000520."],
    "markov_jumps": ["Minin VN, Suchard MA (2008) Counting labeled "
                     "transitions in continuous-time Markov models of "
                     "evolution. J Math Biol 56:391-412."],
    "hmc": ["Neal RM (2011) MCMC using Hamiltonian dynamics. Handbook of "
            "Markov Chain Monte Carlo, ch. 5."],
    "nuts": ["Hoffman MD, Gelman A (2014) The No-U-Turn Sampler. "
             "JMLR 15:1593-1623."],
    "zigzag": ["Bierkens J, Fearnhead P, Roberts G (2019) The Zig-Zag process "
               "and super-efficient sampling for Bayesian analysis of big "
               "data. Ann Statist 47:1288-1320."],
    "mc3": ["Altekar G, Dwarkadas S, Huelsenbeck JP, Ronquist F (2004) "
            "Parallel Metropolis coupled MCMC for Bayesian phylogenetic "
            "inference. Bioinformatics 20:407-415."],
    "path_sampling": ["Baele G, Lemey P, Bedford T, Rambaut A, Suchard MA, "
                      "Alekseyenko AV (2012) Improving the accuracy of "
                      "demographic and molecular clock model comparison. "
                      "Mol Biol Evol 29:2157-2167."],
    "thorney": ["Didelot X, Croucher NJ, Bentley SD, Harris SR, Wilson DJ "
                "(2018) Bayesian inference of ancestral dates on bacterial "
                "phylogenetic trees. Nucleic Acids Res 46:e134."],
    "mds": ["Bedford T, Suchard MA, Lemey P, et al. (2014) Integrating "
            "influenza antigenic dynamics with molecular evolution. "
            "eLife 3:e01914."],
}


def citations_for(keys: Iterable[str]) -> List[str]:
    out: List[str] = []
    seen = set()
    for k in ["framework", *keys]:
        for c in CITATIONS.get(k, ()):  # unknown keys are silently skipped
            if c not in seen:
                seen.add(c)
                out.append(c)
    return out


def write_citations_file(path: str, keys: Iterable[str]) -> None:
    with open(path, "w") as fh:
        fh.write("Citations for models used in this analysis:\n\n")
        for c in citations_for(keys):
            fh.write(c + "\n\n")
