"""The port's config/xml_hmc.py against the JAX package's, part b: the
matrix tags, the model-specific gradient providers, the Hessian and
numerical wrappers, the prior preconditioner, the Bayesian bridge's and
the geodesic operators, and the loadings' sphere walk.

Documents go through check_against_jax and check_chain
(tests/test_torch_interpreter.py) and their operators through
tests/test_torch_xml_hmc_a.py::check_operators. Reports of gradients over
fast densities (the coalescents, speciation, the multivariate normal) are
compared whole with tests/test_torch_xml_hmc_a.py::compare_reports; over
a tree likelihood, JAX's report takes its Hessian eagerly (~25 s each
here), so the analytic gradient of the spec (config/xml_assert.py::
analytic_gradient) is held against a jitted jax.grad of JAX's spec
density instead, both to 1e-10. The operator reports (geodesic HMC) and
the preconditioner's equal JAX's, and the geodesic HMC's target gradient
jax.grad's. SphereRowWalkOperator's proposal, given JAX's draws, equals
JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu.config import xml_assert as jassert
from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.config import xml_assert

from test_torch_interpreter import (
    COAL,
    SKY,
    SKY_OPS,
    SPECIATION,
    _doc,
    check_against_jax,
    check_chain,
)
from test_torch_xml_hmc_a import (
    check_gradient_reports,
    check_operators,
    check_target_gradients,
)
from test_torch_xml_traits_c import BRIDGE

REL = 1e-10

MATRICES = """<compoundSymmetricMatrix id="csm" asCorrelation="true">
      <diagonal><parameter id="csm.d" value="1.5 0.8" lower="0.0"/></diagonal>
      <offDiagonal><parameter id="csm.o" value="0.3"/></offDiagonal>
    </compoundSymmetricMatrix>
    <diagonalMatrix id="dm"><parameter id="dm.diag" value="0.8 0.6" lower="0.0"/></diagonalMatrix>
    <matrixInverse id="csmInv"><compoundSymmetricMatrix idref="csm"/></matrixInverse>
    <multivariateNormalDistributionModel id="mvn2">
      <meanParameter><parameter id="mu2" value="0.0 0.1"/></meanParameter>
      <precisionParameter><compoundSymmetricMatrix idref="csm"/></precisionParameter>
    </multivariateNormalDistributionModel>
    <multivariateDistributionLikelihood id="csmLik">
      <distribution><multivariateNormalDistributionModel idref="mvn2"/></distribution>
      <data><parameter id="z" value="0.3 -0.4"/></data>
    </multivariateDistributionLikelihood>
    <multivariateDistributionLikelihood id="dmLik">
      <distribution><multivariateNormalDistributionModel>
        <meanParameter><parameter id="mu4" value="0.2 0.0"/></meanParameter>
        <precisionParameter><diagonalMatrix idref="dm"/></precisionParameter>
      </multivariateNormalDistributionModel></distribution>
      <data><parameter idref="z"/></data>
    </multivariateDistributionLikelihood>
    <hessian id="hs"><multivariateDistributionLikelihood idref="csmLik"/>
      <parameter idref="z"/></hessian>
    <numericalGradient id="ng"><gradient>
      <multivariateDistributionLikelihood idref="csmLik"/>
      <parameter idref="csm.d"/></gradient></numericalGradient>"""
GEODESIC = """<matrixParameter id="L">
      <parameter id="L.col1" value="1.0 0.0 0.0"/>
      <parameter id="L.col2" value="0.0 0.6 0.8"/>
    </matrixParameter>
    <multivariateNormalDistributionModel id="mvn3">
      <meanParameter><parameter id="mu3" value="0.1 0.2 -0.1"/></meanParameter>
      <precisionParameter><diagonalMatrix><parameter id="p3" value="1.0 2.0 1.5"/></diagonalMatrix></precisionParameter>
    </multivariateNormalDistributionModel>
    <multivariateDistributionLikelihood id="Llik">
      <distribution><multivariateNormalDistributionModel idref="mvn3"/></distribution>
      <data><matrixParameter idref="L"/></data>
    </multivariateDistributionLikelihood>"""
GEODESIC_OP = """<geodesicHamiltonianMonteCarloOperator id="geoOp" weight="3"
        nSteps="3" stepSize="0.05">
      <matrixParameter idref="L"/>
      <gradient><multivariateDistributionLikelihood idref="Llik"/>
        <matrixParameter idref="L"/></gradient>
    </geodesicHamiltonianMonteCarloOperator>"""
BRANCH_SUBST = """<branchSubstitutionParameterGradient id="bsExact">
      <treeLikelihood idref="treeLikelihood"/><parameter idref="kappa"/>
    </branchSubstitutionParameterGradient>
    <branchSubstitutionParameterGradient id="bsFirst" mode="firstOrder">
      <treeLikelihood idref="treeLikelihood"/><parameter idref="kappa"/>
    </branchSubstitutionParameterGradient>"""

yule_block, yule_id, yule_rate = SPECIATION["yule"]
SPECIATION_DOC = _doc(
    models=yule_block + f"""<speciationLikelihood id="speciation">
      <model><yuleModel idref="{yule_id}"/></model>
      <speciesTree><treeModel idref="treeModel"/></speciesTree>
    </speciationLikelihood>
    <speciationLikelihoodGradient id="spH">
      <speciationLikelihood idref="speciation"/></speciationLikelihoodGradient>
    <speciationLikelihoodGradient id="spB" wrtParameter="birthRate">
      <speciationLikelihood idref="speciation"/></speciationLikelihoodGradient>
    <gradientWrtIncrements1D id="spI">
      <speciationLikelihoodGradient idref="spB"/>
      <parameter idref="{yule_rate}"/></gradientWrtIncrements1D>""",
    ops=f"""<scaleOperator scaleFactor="0.75" weight="2">
      <parameter idref="{yule_rate}"/></scaleOperator>""",
    tree_prior='<speciationLikelihood idref="speciation"/>')
SKYLINE_DOC = _doc(
    models=SKY["skyline"] + """<skylineGradient id="skyH">
      <generalizedSkyLineLikelihood idref="skyline"/></skylineGradient>
    <skylineGradient id="skyP" wrtParameter="populationSizes">
      <generalizedSkyLineLikelihood idref="skyline"/></skylineGradient>
    <coalescentGradient id="coalW"><coalescentLikelihood idref="coalescent"/>
      <wrt><parameter idref="constant.popSize"/></wrt></coalescentGradient>""",
    ops=SKY_OPS["skyline"],
    tree_prior='<generalizedSkyLineLikelihood idref="skyline"/>')

DOCS = {
    "matrices": _doc(
        models=MATRICES,
        priors='<multivariateDistributionLikelihood idref="csmLik"/>'
               '<multivariateDistributionLikelihood idref="dmLik"/>',
        ops="""<scaleOperator scaleFactor="0.75" weight="2"><parameter idref="csm.d"/></scaleOperator>
        <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="dm.diag"/></scaleOperator>
        <randomWalkOperator windowSize="0.05" weight="2"><parameter idref="csm.o"/></randomWalkOperator>
        <randomWalkOperator windowSize="0.3" weight="2"><parameter idref="z"/></randomWalkOperator>""",
        logs='<compoundSymmetricMatrix idref="csm"/>'
             '<diagonalMatrix idref="dm"/><matrixInverse idref="csmInv"/>'),
    "geodesic": _doc(
        models=GEODESIC,
        priors='<multivariateDistributionLikelihood idref="Llik"/>',
        ops=GEODESIC_OP),
    "bridge": _doc(
        models=BRIDGE + """<compoundPriorPreconditioner id="precond">
      <bayesianBridgeDistribution idref="bridgeDist"/></compoundPriorPreconditioner>""",
        priors='<bayesianBridge idref="bb"/>',
        ops="""<bayesianBridgeGibbsOperator weight="2">
          <bayesianBridge idref="bb"/><gammaPrior shape="1.0" scale="2.0"/>
        </bayesianBridgeGibbsOperator>
        <randomWalkOperator windowSize="0.2" weight="2"><parameter idref="coef"/></randomWalkOperator>"""),
    "speciation_gradients": SPECIATION_DOC,
    "skyline_gradients": SKYLINE_DOC,
    "branch_substitution": _doc(models="", treelik="",
                                logs="").replace(
        "<operators id=\"operators\">", BRANCH_SUBST
        + "\n  <operators id=\"operators\">"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS[name], tmp_path)
    check_operators(DOCS[name], tmp_path)


@pytest.mark.parametrize("name", ["matrices", "geodesic", "bridge"])
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS[name], tmp_path)


def test_geodesic_target_gradient_matches_jax(tmp_path):
    """The geodesic HMC's targets (the loadings' columns): the posterior's
    gradient against jax.grad's."""
    assert check_target_gradients(DOCS["geodesic"], tmp_path) == 1


@pytest.mark.parametrize("name,ids", [
    ("matrices", ["hs", "ng"]),
    ("speciation_gradients", ["spH", "spB", "spI"]),
    ("skyline_gradients", ["skyH", "skyP", "coalW"])])
def test_gradient_reports_match_jax(name, ids, tmp_path):
    assert check_gradient_reports(DOCS[name], tmp_path, ids) == ids


def _analyses(xml, tmp_path):
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    jax_ax = jinterp.XmlAnalysis(str(path))
    ax = interp.XmlAnalysis(str(path), device="cpu")
    for a in (jax_ax, ax):
        for el in a.root.iter("treeModel"):
            if el.get("id"):
                a.build(el)
    return jax_ax, ax


def jax_spec_gradient(jax_ax, spec):
    """jax.grad (jitted) of a JAX spec's density at the initial state:
    the analytic line of JAX's gradient_report."""
    names = list(spec.target_names())
    params0, tree0 = jassert.initial_eval_state(jax_ax)
    n_tips = (tree0.heights.shape[0] + 1) // 2

    def density(vals):
        p = dict(params0)
        p.update({n: jnp.reshape(v, params0[n].shape)
                  for n, v in zip(names, vals)})
        t = tree0
        if spec.height_tid is not None:
            t = t.replace(heights=t.heights.at[n_tips:].set(vals[-1]))
        return sum(lik.fn(p, t) for lik in spec.likelihoods)

    vals0 = [params0[n] for n in names]
    if spec.height_tid is not None:
        vals0.append(tree0.heights[n_tips:])
    g = jax.jit(jax.grad(density))(vals0)
    return np.concatenate([np.ravel(np.asarray(a)) for a in g])


def test_branch_substitution_gradients_match_jax(tmp_path):
    """The exact and first-order kappa gradients (the latter through the
    interpreter's surrogate, with the eigen model's generator reassembled)
    against jax.grad of JAX's; on this tree's short branches the two are
    close, and not equal."""
    jax_ax, ax = _analyses(DOCS["branch_substitution"], tmp_path)
    got = {}
    for gid in ("bsExact", "bsFirst"):
        spec = ax.build(ax._ids[gid])
        jspec = jax_ax.build(jax_ax._ids[gid])
        _, _, g = xml_assert.analytic_gradient(ax, spec)
        want = jax_spec_gradient(jax_ax, jspec)
        np.testing.assert_allclose(g.numpy(), want, rtol=REL, err_msg=gid)
        got[gid] = g
    assert not torch.equal(got["bsExact"], got["bsFirst"])


def test_operator_and_preconditioner_reports_match_jax(tmp_path):
    """The geodesic operator's deterministic-momentum report and the
    prior preconditioner's standard deviations equal JAX's."""
    from test_torch_xml_hmc_a import compare_reports

    for name, rid in (("geodesic", "geoOp"), ("bridge", "precond")):
        jax_ax, ax = _analyses(DOCS[name], tmp_path)
        compare_reports(xml_assert.report_of(ax, ax._ids[rid]),
                        jassert.report_of(jax_ax, jax_ax._ids[rid]), rid)


def test_sphere_row_walk_given_jax_draws(monkeypatch):
    """SphereRowWalkOperator's proposal with JAX's draws injected (the
    column pick, the angle's normal, each column's tangent normals)
    equals JAX's proposal from its key."""
    from beast_mcmc_tpu.config.xml_hmc import SphereRowWalkOperator as J
    from beast_mcmc_tpu_torch.config import xml_hmc
    from beast_mcmc_tpu_torch.inference import operators as O
    from beast_mcmc_tpu_torch.tree.topology import make_tree_state

    rng = np.random.default_rng(4)
    cols = {f"c{i}": rng.normal(size=5) for i in range(3)}
    names = tuple(cols)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        kp, kv, kt = jax.random.split(key, 3)
        pick = int(jax.random.randint(kp, (), 0, len(names)))
        normals = [float(jax.random.normal(kt, ()))] + [
            np.array(jax.random.normal(jax.random.fold_in(kv, i), (5,),
                                       jnp.float64))
            for i in range(len(names))]
        want, _, jlogh = J(parameters=names).propose(
            {n: jnp.asarray(v) for n, v in cols.items()}, None, key,
            jnp.asarray(0.3))
        draws = iter(normals)
        monkeypatch.setattr(xml_hmc, "_randint", lambda g, lo, hi, d:
                            torch.tensor([pick]))
        monkeypatch.setattr(O, "_normal", lambda g, like, shape=():
                            torch.as_tensor(next(draws),
                                            dtype=like.dtype).reshape(shape))
        tree = make_tree_state([2, 2, -1], [[-1, -1], [-1, -1], [0, 1]],
                               [0.0, 0.0, 1.0], 2, torch.float64, "cpu")
        op = xml_hmc.SphereRowWalkOperator(parameters=names)
        got, _, logh = op.propose(
            {n: torch.as_tensor(v) for n, v in cols.items()}, tree, None,
            torch.tensor(0.3, dtype=torch.float64))
        for n in names:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                       rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(float(torch.linalg.norm(got[n])),
                                       1.0 if n == names[pick] else
                                       np.linalg.norm(cols[n]), rtol=1e-12)
        assert float(logh) == float(jlogh) == 0.0
