"""The port's amino-acid and codon slice against the JAX package's.

The numpy-only modules of the port (data types, alignments, codon tables,
amino-acid matrices) are its own copies and must equal the JAX package's
exactly. The substitution models are compared through transition_probs
(rtol 1e-10 with atol 1e-13 for entries that are round-off themselves;
eigenvectors are not compared: GY94 with uniform frequencies has repeated
eigenvalues). The site-model additions are the same float64 arithmetic (rtol
1e-12). Tree likelihoods and the log posteriors of the two analyses of
chip_smoke.py are held against the same posterior assembled from the JAX
functions at rtol 1e-10 (float64, summed in other orders). JAX runs as
tests/conftest.py sets it up (CPU, x64); the port runs on the CPU in float64
through the plain versions of its kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu import native as jnative
from beast_mcmc_tpu.data import alignment as jalign
from beast_mcmc_tpu.data import codons as jcodons
from beast_mcmc_tpu.data import datatype as jdatatype
from beast_mcmc_tpu.models import sitemodel as jsite
from beast_mcmc_tpu.models import substitution as jsub
from beast_mcmc_tpu.models.coalescent import (
    constant_coalescent_loglik as j_coalescent,
)
from beast_mcmc_tpu.models.data import aa_matrices as jaa
from beast_mcmc_tpu.models.priors import (
    lognormal_logpdf as j_lognormal,
    one_on_x_logpdf as j_one_on_x,
)
from beast_mcmc_tpu.models.treelikelihood import (
    tree_loglikelihood as j_tree_loglikelihood,
)
from beast_mcmc_tpu.ops.eigen import transition_probs as j_transition_probs
from beast_mcmc_tpu.tree.topology import parse_newick

from beast_mcmc_tpu_torch.convert import params_from_numpy, tree_from_numpy
from beast_mcmc_tpu_torch.data import alignment as talign
from beast_mcmc_tpu_torch.data import codons as tcodons
from beast_mcmc_tpu_torch.data import datatype as tdatatype
from beast_mcmc_tpu_torch.inference.mcmc import (
    full_evaluation_check,
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.models import sitemodel as tsite
from beast_mcmc_tpu_torch.models import substitution as tsub
from beast_mcmc_tpu_torch.models.data import aa_matrices as taa
from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
from beast_mcmc_tpu_torch.ops.eigen import transition_probs

from chip_smoke import codon_analysis, protein_analysis

T64 = torch.float64
TIMES = [0.0, 0.01, 0.3, 2.0, 50.0]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(x):
    return torch.tensor(np.asarray(x), dtype=T64)


def _same_datatype(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    np.testing.assert_array_equal(a.ambiguity_table(), b.ambiguity_table())


# -- the numpy-only copies -------------------------------------------------

def test_aa_models_equal():
    assert taa.AA_ORDER == jaa.AA_ORDER
    assert taa.AA_MODELS == jaa.AA_MODELS
    assert {"WAG", "LG", "JTT", "DAYHOFF", "BLOSUM62", "CPREV", "MTREV",
            "FLU"} <= set(taa.AA_MODELS)


@pytest.mark.parametrize("name", ["NUCLEOTIDES", "AMINO_ACIDS", "BINARY"])
def test_datatypes_equal(name):
    _same_datatype(getattr(tdatatype, name), getattr(jdatatype, name))
    seq = "ACGTURYN?-XZB*acgt01"
    np.testing.assert_array_equal(getattr(tdatatype, name).encode(seq),
                                  getattr(jdatatype, name).encode(seq))


def test_general_datatype_equal():
    args = (["x", "y", "z"], {"w": ["x", "z"]})
    _same_datatype(tdatatype.general_datatype(*args),
                   jdatatype.general_datatype(*args))


def test_codon_tables_equal():
    assert tcodons.UNIVERSAL_CODE == jcodons.UNIVERSAL_CODE
    assert tcodons.sense_codons() == jcodons.sense_codons()
    assert len(tcodons.sense_codons()) == 61
    _same_datatype(tcodons.codon_datatype(), jcodons.codon_datatype())
    for got, ref in zip(tcodons.codon_structure(), jcodons.codon_structure()):
        np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(0)
    nuc = rng.integers(0, 4, size=(5, 60)).astype(np.int16)
    nuc[rng.random(nuc.shape) < 0.05] = 16  # gaps
    nuc[0, 3:6] = [3, 0, 0]  # TAA, a stop codon
    got = tcodons.encode_codon_alignment(nuc)
    np.testing.assert_array_equal(got, jcodons.encode_codon_alignment(nuc))
    assert got[0, 1] == 61 and (got == 61).sum() > 1
    with pytest.raises(ValueError):
        tcodons.encode_codon_alignment(nuc[:, :59])


@pytest.mark.parametrize("datatype", ["NUCLEOTIDES", "AMINO_ACIDS"])
def test_site_patterns_equal(datatype):
    """Pattern compression, tip partials and the PAUP-style frequencies.
    The port keeps first-occurrence order, as the JAX package's native
    compression does; where that library is not loaded the JAX package sorts
    its patterns, and the two are compared as weighted sets."""
    t_dt, j_dt = getattr(tdatatype, datatype), getattr(jdatatype, datatype)
    rng = np.random.default_rng(1)
    letters = "ACGT-N" if datatype == "NUCLEOTIDES" else "ACDEFGHIKL-X"
    taxa = [f"t{i}" for i in range(6)]
    seqs = ["".join(rng.choice(list(letters), size=90 - 5 * (i == 2),
                               p=None)) for i in range(6)]
    # few distinct columns, so that patterns repeat
    seqs = [s[:12] * 7 + s[12:18] for s in seqs]
    seqs[2] = seqs[2][:-5]  # a short sequence is padded with gaps
    kw = {"dates": {"t0": 2000.0, "t3": 1990.5}}
    t_aln = talign.Alignment.from_sequences(taxa, seqs, t_dt, **kw)
    j_aln = jalign.Alignment.from_sequences(taxa, seqs, j_dt, **kw)
    np.testing.assert_array_equal(t_aln.states, j_aln.states)
    np.testing.assert_array_equal(t_aln.tip_heights(), j_aln.tip_heights())
    assert (t_aln.n_taxa, t_aln.n_sites) == (j_aln.n_taxa, j_aln.n_sites)
    for args in ({}, {"site_range": (3, 40)}, {"every": 3},
                 {"site_range": (1, -1), "every": 3}):
        got = talign.SitePatterns.from_alignment(t_aln, **args)
        ref = jalign.SitePatterns.from_alignment(j_aln, **args)
        assert got.n_sites == ref.n_sites and got.taxa == ref.taxa
        assert got.n_patterns == ref.n_patterns < got.n_sites
        assert got.states.dtype == ref.states.dtype
        if jnative.get_lib() is not None:
            np.testing.assert_array_equal(got.states, ref.states)
            np.testing.assert_array_equal(got.weights, ref.weights)
        as_set = lambda sp: sorted(  # noqa: E731
            (tuple(col), w) for col, w in zip(sp.states.T.tolist(),
                                              sp.weights.tolist()))
        assert as_set(got) == as_set(ref)
        np.testing.assert_allclose(got.empirical_frequencies(),
                                   ref.empirical_frequencies(), rtol=1e-12)
        np.testing.assert_array_equal(
            np.sort(got.tip_partials().reshape(got.n_taxa, -1), axis=None),
            np.sort(ref.tip_partials().reshape(ref.n_taxa, -1), axis=None))
        assert got.tip_partials().shape == (6, got.n_patterns,
                                            t_dt.state_count)
        assert (got.tip_states_unambiguous().max() == t_dt.state_count)


# -- substitution and site models -------------------------------------------

def _same_probs(t_eig, j_eig):
    got = transition_probs(t_eig, t64(TIMES)).numpy()
    ref = np.asarray(j_transition_probs(j_eig, jnp.asarray(TIMES)))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-9)
    np.testing.assert_allclose(got[0], np.eye(got.shape[-1]), atol=1e-9)


@pytest.mark.parametrize("name", ["WAG", "LG", "JTT", "Dayhoff"])
def test_empirical_aa_eigen_matches_jax(name):
    _same_probs(tsub.empirical_aa_eigen(name, device="cpu"),
                jsub.empirical_aa_eigen(name))
    # the +F variant: caller's frequencies
    freqs = np.random.default_rng(2).dirichlet(np.full(20, 5.0))
    _same_probs(tsub.empirical_aa_eigen(name, t64(freqs)),
                jsub.empirical_aa_eigen(name, jnp.asarray(freqs)))
    # stationary distribution = the model's frequencies
    p = transition_probs(tsub.empirical_aa_eigen(name, device="cpu"),
                         t64(2000.0))
    np.testing.assert_allclose(
        p.numpy()[0], taa.AA_MODELS[name.upper()]["frequencies"], atol=1e-6)


@pytest.mark.parametrize("uniform", [True, False])
def test_codon_eigen_matches_jax(uniform):
    freqs = (np.full(61, 1.0 / 61) if uniform
             else np.random.default_rng(3).dirichlet(np.full(61, 8.0)))
    _same_probs(tsub.gy94_eigen(2.0, 0.5, t64(freqs)),
                jsub.gy94_eigen(2.0, 0.5, jnp.asarray(freqs)))
    _same_probs(tsub.gy94_eigen(t64(3.1), t64(1.7), t64(freqs)),
                jsub.gy94_eigen(3.1, 1.7, jnp.asarray(freqs)))
    _same_probs(tsub.mg94_eigen(0.8, 0.3, 2.5, t64(freqs)),
                jsub.mg94_eigen(0.8, 0.3, 2.5, jnp.asarray(freqs)))
    # omega < 1 suppresses non-synonymous change
    nonsyn = tcodons.codon_structure()[2]
    p_low = transition_probs(tsub.gy94_eigen(2.0, 0.5, t64(freqs)), t64(0.1))
    p_one = transition_probs(tsub.gy94_eigen(2.0, 1.0, t64(freqs)), t64(0.1))
    assert (p_low.numpy() * nonsyn).sum() < (p_one.numpy() * nonsyn).sum()


def test_tn93_and_general_reversible_match_jax():
    freqs = np.array([0.31, 0.19, 0.22, 0.28])
    _same_probs(tsub.tn93_eigen(2.5, 4.0, t64(freqs)),
                jsub.tn93_eigen(2.5, 4.0, jnp.asarray(freqs)))
    # TN93 with equal kappas is HKY
    _same_probs(tsub.tn93_eigen(3.0, 3.0, t64(freqs)),
                jsub.hky_eigen(3.0, jnp.asarray(freqs)))
    rng = np.random.default_rng(4)
    for s in (2, 7):
        rates = rng.uniform(0.2, 3.0, s * (s - 1) // 2)
        fr = rng.dirichlet(np.full(s, 6.0))
        _same_probs(tsub.general_reversible_eigen(t64(rates), t64(fr)),
                    jsub.general_reversible_eigen(jnp.asarray(rates),
                                                  jnp.asarray(fr)))
        ind = (rng.random(rates.shape) > 0.3).astype(np.float64)
        ind[0] = 1.0
        np.testing.assert_array_equal(
            tsub.svs_masked_rates(t64(rates), t64(ind)).numpy(),
            np.asarray(jsub.svs_masked_rates(jnp.asarray(rates),
                                             jnp.asarray(ind))))


@pytest.mark.parametrize("alpha,p_inv,mu", [(0.5, 0.2, None), (2.3, 0.05, 1.7),
                                            (0.05, 0.6, 0.4)])
def test_site_model_additions_match_jax(alpha, p_inv, mu):
    j_mu = None if mu is None else jnp.asarray(mu)
    t_mu = None if mu is None else t64(mu)
    ref = jsite.discrete_gamma_rates(alpha, 4, p_invariant=p_inv, mu=j_mu)
    got = tsite.discrete_gamma_rates(t64(alpha), 4, p_invariant=t64(p_inv),
                                     mu=t_mu)
    assert got[0].shape == (5,) and float(got[0][0]) == 0.0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)
    # the mixture has mean rate mu
    np.testing.assert_allclose(float((got[0] * got[1]).sum()),
                               1.0 if mu is None else mu, rtol=1e-12)
    ref = jsite.invariant_only_rates(p_inv, mu=j_mu)
    got = tsite.invariant_only_rates(t64(p_inv), mu=t_mu)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)
    rates = np.array([0.1, alpha, 3.0])
    weights = np.array([2.0, 1.0, p_inv])
    ref = jsite.free_rates(jnp.asarray(rates), jnp.asarray(weights))
    got = tsite.free_rates(t64(rates), t64(weights))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)
    np.testing.assert_allclose(float((got[0] * got[1]).sum()), 1.0,
                               rtol=1e-12)


# -- tree likelihoods --------------------------------------------------------

def _both_likelihoods(tips, weights, newick, t_eig, j_eig, freqs, rates, cw):
    parent, children, heights, root, _ = parse_newick(newick)
    ref = j_tree_loglikelihood(
        jnp.asarray(tips), jnp.asarray(weights), jnp.asarray(parent),
        jnp.asarray(children), jnp.asarray(heights), root, j_eig,
        jnp.asarray(freqs), jnp.asarray(rates), jnp.asarray(cw), 1.0)
    tree = tree_from_numpy(parent, children, heights, root, device="cpu")
    got = tree_loglikelihood(
        t64(tips), t64(weights), tree.parent, tree.children, tree.heights,
        tree.root, t_eig, t64(freqs), t64(rates), t64(cw), 1.0)
    assert got.dtype == T64
    return float(got), float(ref)


def test_aa_tree_likelihood_matches_jax():
    """The WAG three-taxon case of tests/test_protein_codon.py, from the
    sequences to the likelihood, and with Gamma4 + invariant sites."""
    taxa, seqs = ["a", "b", "c"], ["ACDEF", "ACDEW", "ACDEY"]
    pats = talign.SitePatterns.from_alignment(
        talign.Alignment.from_sequences(taxa, seqs, tdatatype.AMINO_ACIDS))
    tips = pats.tip_partials().transpose(0, 2, 1)
    freqs = taa.AA_MODELS["WAG"]["frequencies"]
    for rates, cw in ((np.ones(1), np.ones(1)),
                      tuple(x.numpy() for x in tsite.discrete_gamma_rates(
                          t64(0.7), 4, p_invariant=t64(0.1)))):
        got, ref = _both_likelihoods(
            tips, pats.weights, "((a:0.1,b:0.1):0.1,c:0.2);",
            tsub.empirical_aa_eigen("WAG", device="cpu"),
            jsub.empirical_aa_eigen("WAG"), freqs, rates, cw)
        assert np.isfinite(got) and got < 0
        np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_codon_tree_likelihood_matches_jax():
    """GY94 on four codon sequences, a gap among them."""
    seqs = ["ATGTTTCCCAAAGGG", "ATGTTCCCAAAGGGG", "ATGT-TCCCAAAGGA",
            "ATGTTTCCTAGAGGG"]
    nuc = talign.Alignment.from_sequences(list("abcd"), seqs).states
    aln = talign.Alignment(list("abcd"), tcodons.encode_codon_alignment(nuc),
                           tcodons.codon_datatype())
    pats = talign.SitePatterns.from_alignment(aln)
    tips = pats.tip_partials().transpose(0, 2, 1)
    assert tips.shape == (4, 61, pats.n_patterns) and tips[2, :, 1].all()
    freqs = np.random.default_rng(5).dirichlet(np.full(61, 8.0))
    got, ref = _both_likelihoods(
        tips, pats.weights, "((a:0.1,b:0.2):0.1,(c:0.15,d:0.05):0.15);",
        tsub.gy94_eigen(2.0, 0.4, t64(freqs)),
        jsub.gy94_eigen(2.0, 0.4, jnp.asarray(freqs)), freqs, np.ones(1),
        np.ones(1))
    assert np.isfinite(got) and got < 0
    np.testing.assert_allclose(got, ref, rtol=1e-10)


# -- the two analyses of chip_smoke.py ---------------------------------------

def _jax_log_post(kind, aux, n_taxa):
    """The posterior of `protein_analysis` / `codon_analysis`, assembled
    from the JAX package's functions on the port's data."""
    tips = jnp.asarray(aux["tips"].numpy())
    weights = jnp.asarray(aux["weights"].numpy())
    freqs = jnp.asarray(aux["freqs"].numpy())

    def log_post(params, tree):
        if kind == "protein":
            eig = jsub.empirical_aa_eigen("LG")
            rates, cw = jsite.discrete_gamma_rates(params["alpha"], 4)
        else:
            eig = jsub.gy94_eigen(params["kappa"], params["omega"], freqs)
            rates, cw = jsite.single_rate()
        parent, children, heights, root = tree
        return (j_tree_loglikelihood(tips, weights, parent, children, heights,
                                     root, eig, freqs, rates, cw,
                                     params["clock.rate"])
                + j_one_on_x(params["pop.size"])
                + j_lognormal(params["clock.rate"], 0.0, 1.0)
                + j_coalescent(heights, n_taxa, params["pop.size"]))
    return log_post


PARAMS = {
    "protein": [{"alpha": 0.5, "clock.rate": 1.0, "pop.size": 0.5},
                {"alpha": 1.3, "clock.rate": 0.7, "pop.size": 0.9}],
    "codon": [{"kappa": 2.0, "omega": 0.5, "clock.rate": 1.0,
               "pop.size": 0.5},
              {"kappa": 3.4, "omega": 0.15, "clock.rate": 1.2,
               "pop.size": 0.3}],
}
BUILD = {"protein": (protein_analysis, 9, 40),
         "codon": (codon_analysis, 7, 24)}


@pytest.mark.parametrize("kind", ["protein", "codon"])
def test_analysis_log_post_matches_jax(kind):
    """convert.py carries the parameters (an S = 20 or 61 eigensystem and
    the site-rates tuple among the derived ones) as numpy; the port's
    log_post and log_post_cached agree with the JAX assembly."""
    build, n_taxa, n_patterns = BUILD[kind]
    log_post, ops, params0, tree0, aux = build(n_taxa, n_patterns, 0, T64,
                                               "cpu")
    n_states = 20 if kind == "protein" else 61
    assert aux["tips"].shape == (n_taxa, n_states, n_patterns)
    assert set(params0) == set(PARAMS[kind][0]) | set(aux["derived"])
    j_tree = tuple(jnp.asarray(x.numpy()) for x in (
        tree0.parent, tree0.children, tree0.heights, tree0.root))
    j_log_post = jax.jit(_jax_log_post(kind, aux, n_taxa))
    for values in PARAMS[kind]:
        j_params = {k: jnp.asarray(v, jnp.float64) for k, v in values.items()}
        ref = float(j_log_post(j_params, j_tree))
        # the derived entries are computed by JAX and carried over as numpy
        if kind == "protein":
            derived = {"site.rates": tuple(np.asarray(x) for x in
                                           jsite.discrete_gamma_rates(
                                               j_params["alpha"], 4))}
        else:
            eig = jsub.gy94_eigen(j_params["kappa"], j_params["omega"],
                                  jnp.asarray(aux["freqs"].numpy()))
            derived = {"eig": jax.tree_util.tree_map(np.asarray, eig)}
        params = params_from_numpy({**values, **derived}, device="cpu")
        assert params["clock.rate"].dtype == T64
        got = log_post(params, tree0)
        assert got.dtype == T64
        np.testing.assert_allclose(float(got), ref, rtol=1e-10)
        got = aux["log_post_cached"](params, tree0)
        np.testing.assert_allclose(float(got), ref, rtol=1e-10)


@pytest.mark.parametrize("kind", ["protein", "codon"])
def test_analysis_chain_runs(kind):
    """200 steps with the derived cache; then the full-evaluation check:
    the carried posterior equals a fresh evaluation to round-off."""
    build, n_taxa, n_patterns = BUILD[kind]
    log_post, ops, params0, tree0, aux = build(n_taxa, n_patterns, 1, T64,
                                               "cpu")
    cached = aux["log_post_cached"]
    step = make_mcmc_step(cached, ops, derived=aux["derived"])
    state = init_mcmc_state(params0, tree0, torch.Generator().manual_seed(3),
                            ops, cached)
    start = float(state.log_posterior)
    np.testing.assert_allclose(start, float(log_post(params0, tree0)),
                               rtol=1e-13)
    state, _ = run_chain(step, state, 200)
    assert np.isfinite(float(state.log_posterior))
    assert float(state.log_posterior) != start
    assert int(state.op_accept.sum()) > 20
    state, dev = full_evaluation_check(step, log_post, state, 30,
                                       derived=aux["derived"])
    assert float(dev) < 1e-8
    assert np.isfinite(float(state.log_posterior))
