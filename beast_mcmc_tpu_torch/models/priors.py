"""The prior log-density library.

Counterpart of beast_mcmc_tpu/models/priors.py, every function of it. Each
returns the sum of the elementwise log density, -inf outside the support.
The priors of the main path, the Makona joint analysis and the config
layer (the first nine below) take numbers or tensors as their
distribution's parameters, and `chains=True`: the leading axis of x is
then a chain batch's, and the sum is taken per chain ([B]).
"""

from __future__ import annotations

import math

import torch


def _total(lp: torch.Tensor, chains: bool) -> torch.Tensor:
    return lp.reshape(lp.shape[0], -1).sum(-1) if chains else torch.sum(lp)


def _log(v):
    """log of a number (math, as before) or of a tensor argument (the
    estimated parameters of a <distributionLikelihood>)."""
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _lgamma(v):
    return torch.lgamma(v) if isinstance(v, torch.Tensor) else math.lgamma(v)


def uniform_logpdf(x: torch.Tensor, lower: float, upper: float,
                   chains: bool = False) -> torch.Tensor:
    """Uniform on [lower, upper] (<uniformPrior>)."""
    lp = torch.zeros_like(x) - _log(upper - lower)
    inside = (x >= lower) & (x <= upper)
    return _total(torch.where(inside, lp, torch.full_like(lp, -math.inf)),
                  chains)


def normal_logpdf(x: torch.Tensor, mean: float, stdev: float,
                  chains: bool = False) -> torch.Tensor:
    """Normal(mean, stdev) (<normalPrior>)."""
    z = (x - mean) / stdev
    return _total(-0.5 * z * z - _log(stdev)
                  - 0.5 * math.log(2 * math.pi), chains)


def lognormal_logpdf(x: torch.Tensor, mu: float, sigma: float,
                     chains: bool = False) -> torch.Tensor:
    """mu, sigma in log space (LogNormalDistribution.java,
    meanInRealSpace=false)."""
    safe = x > 0
    lx = torch.log(torch.where(safe, x, torch.ones_like(x)))
    z = (lx - mu) / sigma
    lp = -0.5 * z * z - lx - _log(sigma) - 0.5 * math.log(2 * math.pi)
    return _total(torch.where(safe, lp, torch.full_like(lp, -math.inf)),
                  chains)


def one_on_x_logpdf(x: torch.Tensor, chains: bool = False) -> torch.Tensor:
    """Improper 1/x prior (OneOnXPrior)."""
    safe = x > 0
    lp = -torch.log(torch.where(safe, x, torch.ones_like(x)))
    return _total(torch.where(safe, lp, torch.full_like(lp, -math.inf)),
                  chains)


def gamma_logpdf(x: torch.Tensor, shape: float, scale: float,
                 chains: bool = False) -> torch.Tensor:
    """Gamma(shape, scale) (GammaDistribution.java, <gammaPrior>)."""
    safe = x > 0
    xs = torch.where(safe, x, torch.ones_like(x))
    lp = ((shape - 1) * torch.log(xs) - xs / scale - _lgamma(shape)
          - shape * _log(scale))
    return _total(torch.where(safe, lp, torch.full_like(lp, -math.inf)),
                  chains)


def exponential_logpdf(x: torch.Tensor, mean: float,
                       chains: bool = False) -> torch.Tensor:
    """Exponential of the given mean (<exponentialPrior>)."""
    lp = -x / mean - _log(mean)
    return _total(torch.where(x >= 0, lp, torch.full_like(lp, -math.inf)),
                  chains)


def poisson_logpmf(k: torch.Tensor, mean: float,
                   chains: bool = False) -> torch.Tensor:
    """Poisson of the given mean at (real-valued) counts k
    (<poissonPrior>)."""
    k = torch.as_tensor(k)
    return _total(k * _log(mean) - mean - torch.lgamma(k + 1.0), chains)


def dirichlet_logpdf(x: torch.Tensor, alpha,
                     chains: bool = False) -> torch.Tensor:
    """Dirichlet(alpha) on a simplex x (<dirichletPrior>); -inf off the
    simplex (a sum more than 1e-8 from 1, or an entry <= 0). With
    `chains` each row of x [B, K] is a chain's simplex."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    alpha = alpha.expand(x.shape)
    positive = _total((x <= 0).to(x.dtype), chains) == 0
    safe = positive & (torch.abs(_total(x, chains) - 1.0) < 1e-8)
    xs = torch.where(x > 0, x, torch.ones_like(x))
    lp = (_total((alpha - 1) * torch.log(xs), chains)
          + torch.lgamma(_total(alpha, chains))
          - _total(torch.lgamma(alpha), chains))
    return torch.where(safe, lp, torch.full_like(lp, -math.inf))


def ctmc_scale_logpdf(rate: torch.Tensor, tree_length,
                      chains: bool = False) -> torch.Tensor:
    """The CTMC reference prior of an overall clock rate
    (CTMCScalePrior.java:51): p(rate) proportional to sqrt(T / rate)
    e^{-rate T}, T the tree length in time units. With `chains` rate is
    [B, ...] and tree_length [B], one per chain."""
    safe = rate > 0
    rs = torch.where(safe, rate, torch.ones_like(rate))
    tl = torch.as_tensor(tree_length, dtype=rate.dtype, device=rate.device)
    if chains:
        tl = tl.reshape(-1, *([1] * (rate.dim() - 1)))
    lp = (0.5 * (torch.log(tl) - torch.log(rs)) - rs * tl
          - math.lgamma(0.5))
    return _total(torch.where(safe, lp, torch.full_like(lp, -math.inf)),
                  chains)


# ---------------------------------------------------------------------------
# The rest of the JAX package's library (beast_mcmc_tpu/models/priors.py:18,
# 53-507), one function each, with its arguments and reduction: the sum of
# the elementwise log density, or one value for a vector or matrix density;
# -inf outside the support. Arguments may be numbers or tensors; the result
# is on x's device, in x's floating type.
# ---------------------------------------------------------------------------

_LOG_2PI = math.log(2.0 * math.pi)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x)


def _x(x) -> torch.Tensor:
    """x as a floating tensor (integers as float64)."""
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float64)


def _t(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _outside(lp: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    return torch.where(inside, lp, torch.full_like(lp, -math.inf))


def _gamma_terms(x, shape, scale) -> torch.Tensor:
    """gamma_logpdf's elementwise terms with tensor shapes and scales."""
    x = _x(x)
    shape, scale = _t(shape, x), _t(scale, x)
    safe = x > 0
    xs = torch.where(safe, x, torch.ones_like(x))
    lp = ((shape - 1) * torch.log(xs) - xs / scale - torch.lgamma(shape)
          - shape * torch.log(scale))
    return _outside(lp, safe)


def inverse_gamma_logpdf(x, shape, scale) -> torch.Tensor:
    """InverseGammaDistribution.java."""
    x = _x(x)
    shape, scale = _t(shape, x), _t(scale, x)
    safe = x > 0
    xs = torch.where(safe, x, torch.ones_like(x))
    lp = (-(shape + 1) * torch.log(xs) - scale / xs - torch.lgamma(shape)
          + shape * torch.log(scale))
    return _sum(_outside(lp, safe))


def laplace_logpdf(x, mean, scale) -> torch.Tensor:
    """LaplaceDistribution.java."""
    x = _x(x)
    scale = _t(scale, x)
    return _sum(-torch.abs(x - mean) / scale - torch.log(2 * scale))


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def beta_logpdf(x, alpha, beta) -> torch.Tensor:
    """BetaDistribution.java, on (0, 1)."""
    x = _x(x)
    alpha, beta = _t(alpha, x), _t(beta, x)
    safe = (x > 0) & (x < 1)
    xs = torch.where(safe, x, torch.full_like(x, 0.5))
    lp = ((alpha - 1) * torch.log(xs) + (beta - 1) * torch.log1p(-xs)
          - _betaln(alpha, beta))
    return _sum(_outside(lp, safe))


def normal_gamma_precision_logpdf(x, mean, precision) -> torch.Tensor:
    """Normal(mean, 1/precision)."""
    x = _x(x)
    precision = _t(precision, x)
    z = x - mean
    return _sum(0.5 * torch.log(precision) - 0.5 * precision * z * z
                - 0.5 * _LOG_2PI)


def multivariate_normal_logpdf(x, mean, precision=None,
                               covariance=None) -> torch.Tensor:
    """MultivariateNormalDistribution: x [D] with a precision or a
    covariance matrix [D, D]."""
    x = _x(x)
    d = x.shape[-1]
    diff = x - _t(mean, x)
    if precision is not None:
        p = _t(precision, x)
        logdet_p = torch.linalg.slogdet(p)[1]
        return 0.5 * (logdet_p - d * _LOG_2PI - diff @ p @ diff)
    c = _t(covariance, x)
    sol = torch.linalg.solve(c, diff)
    logdet_c = torch.linalg.slogdet(c)[1]
    return -0.5 * (logdet_c + d * _LOG_2PI + diff @ sol)


def bayesian_bridge_logpdf(x, global_scale, exponent=0.25, local_scales=None,
                           reduce: bool = True) -> torch.Tensor:
    """BayesianBridgeDistributionModel: alpha / (2 tau Gamma(1/alpha))
    exp(-|x / tau|^alpha); with local scales x_i ~ N(0, (tau lambda_i)^2).
    `reduce=False` keeps the elementwise terms."""
    x = _x(x)
    tau, alpha = _t(global_scale, x), _t(exponent, x)
    if local_scales is not None:
        sd = tau * _t(local_scales, x)
        lp = -0.5 * (_LOG_2PI + 2 * torch.log(sd) + (x / sd) ** 2)
    else:
        lp = (torch.log(alpha) - torch.log(2 * tau) - torch.lgamma(1.0 / alpha)
              - torch.abs(x / tau) ** alpha)
    return _sum(lp) if reduce else lp


def lkj_logpdf(corr, shape=1.0) -> torch.Tensor:
    """LKJCorrelationDistribution without its constant normaliser:
    (shape - 1) log det R."""
    corr = _x(corr)
    return (_t(shape, corr) - 1.0) * torch.linalg.slogdet(corr)[1]


def _multivariate_gammaln(a, d: int) -> torch.Tensor:
    j = torch.arange(d, dtype=a.dtype, device=a.device)
    return (0.25 * d * (d - 1) * math.log(math.pi)
            + torch.sum(torch.lgamma(a - 0.5 * j)))


def wishart_logpdf(w, df, scale_matrix) -> torch.Tensor:
    """WishartDistribution over positive definite w [D, D]."""
    w = _x(w)
    s = _t(scale_matrix, w)
    d = w.shape[-1]
    df = _t(df, w)
    logdet_w = torch.linalg.slogdet(w)[1]
    logdet_s = torch.linalg.slogdet(s)[1]
    tr = torch.trace(torch.linalg.solve(s, w))
    return (0.5 * (df - d - 1) * logdet_w - 0.5 * tr
            - 0.5 * df * d * math.log(2.0) - 0.5 * df * logdet_s
            - _multivariate_gammaln(0.5 * df, d))


def inverse_wishart_logpdf(w, df, scale_matrix) -> torch.Tensor:
    """InverseWishartDistribution over positive definite w [D, D]."""
    w = _x(w)
    s = _t(scale_matrix, w)
    d = w.shape[-1]
    df = _t(df, w)
    logdet_w = torch.linalg.slogdet(w)[1]
    logdet_s = torch.linalg.slogdet(s)[1]
    tr = torch.trace(torch.linalg.solve(w, s))
    return (0.5 * df * logdet_s - 0.5 * (df + d + 1) * logdet_w - 0.5 * tr
            - 0.5 * df * d * math.log(2.0)
            - _multivariate_gammaln(0.5 * df, d))


def half_t_logpdf(x, scale, df=1.0) -> torch.Tensor:
    """Half-t on x >= 0 (df 1: half-Cauchy), the horseshoe scale prior."""
    x = _x(x)
    s, nu = _t(scale, x), _t(df, x)
    z = x / s
    lp = (torch.lgamma(0.5 * (nu + 1)) - torch.lgamma(0.5 * nu)
          - 0.5 * torch.log(nu * math.pi) - torch.log(s)
          - 0.5 * (nu + 1) * torch.log1p(z * z / nu) + math.log(2.0))
    return _sum(_outside(lp, x >= 0))


def chi_square_logpdf(x, df) -> torch.Tensor:
    """ChiSquareDistribution.java: gamma(df / 2, 2)."""
    x = _x(x)
    return _sum(_gamma_terms(x, 0.5 * _t(df, x), 2.0))


def t_logpdf(x, df, loc=0.0, scale=1.0) -> torch.Tensor:
    """TDistribution.java with location and scale."""
    x = _x(x)
    nu, s = _t(df, x), _t(scale, x)
    z = (x - loc) / s
    lp = (torch.lgamma(0.5 * (nu + 1.0)) - torch.lgamma(0.5 * nu)
          - 0.5 * torch.log(nu * math.pi) - torch.log(s)
          - 0.5 * (nu + 1.0) * torch.log1p(z * z / nu))
    return _sum(lp)


def cauchy_logpdf(x, loc=0.0, scale=1.0) -> torch.Tensor:
    """The t density at df 1."""
    return t_logpdf(x, 1.0, loc, scale)


def logistic_logpdf(x, loc=0.0, scale=1.0) -> torch.Tensor:
    """Logistic(loc, scale); softplus as log(1 + e^v), exactly."""
    x = _x(x)
    scale = _t(scale, x)
    z = (x - loc) / scale
    softplus = torch.logaddexp(-z, torch.zeros_like(z))
    return _sum(-z - 2.0 * softplus - torch.log(scale))


def weibull_logpdf(x, shape, scale) -> torch.Tensor:
    """Weibull(shape k, scale lambda) on x >= 0."""
    x = _x(x)
    k, lam = _t(shape, x), _t(scale, x)
    lp = (torch.log(k) - torch.log(lam)
          + (k - 1.0) * (torch.log(x) - torch.log(lam))
          - torch.pow(x / lam, k))
    return _sum(_outside(lp, x >= 0))


def gumbel2_logpdf(x, shape, scale) -> torch.Tensor:
    """Gumbel2Distribution.java: a b x^(-a-1) e^(-b x^-a) on x > 0."""
    x = _x(x)
    a, b = _t(shape, x), _t(scale, x)
    lp = (torch.log(a) + torch.log(b) - (a + 1.0) * torch.log(x)
          - b * torch.pow(x, -a))
    return _sum(_outside(lp, x > 0))


def half_normal_logpdf(x, stdev) -> torch.Tensor:
    """HalfNormalDistribution.java on x >= 0."""
    x = _x(x)
    s = _t(stdev, x)
    lp = (math.log(2.0) - 0.5 * _LOG_2PI - torch.log(s)
          - 0.5 * torch.square(x / s))
    return _sum(_outside(lp, x >= 0))


def pareto_logpdf(x, scale, shape) -> torch.Tensor:
    """ParetoDistribution.java: a m^a / x^(a+1) on x >= m."""
    x = _x(x)
    m, a = _t(scale, x), _t(shape, x)
    lp = torch.log(a) + a * torch.log(m) - (a + 1.0) * torch.log(x)
    return _sum(_outside(lp, x >= m))


def inverse_gaussian_logpdf(x, mean, shape) -> torch.Tensor:
    """InverseGaussianDistribution.java (Wald) on x > 0."""
    x = _x(x)
    mu, lam = _t(mean, x), _t(shape, x)
    lp = (0.5 * (torch.log(lam) - math.log(2.0 * math.pi) - 3.0 * torch.log(x))
          - lam * torch.square(x - mu) / (2.0 * mu * mu * x))
    return _sum(_outside(lp, x > 0))


def _normal_logcdf(z) -> torch.Tensor:
    return torch.special.log_ndtr(z)


def truncated_normal_logpdf(x, mean, stdev, lower=-math.inf,
                            upper=math.inf) -> torch.Tensor:
    """TruncatedNormalDistribution.java: the normal renormalised to
    [lower, upper], its mass in log space (a far-tail window would
    underflow)."""
    x = _x(x)
    mu, s = _t(mean, x), _t(stdev, x)
    lc_hi = _normal_logcdf((_t(upper, x) - mu) / s)
    lc_lo = _normal_logcdf((_t(lower, x) - mu) / s)
    log_mass = lc_hi + torch.log1p(
        -torch.exp(torch.clamp_max(lc_lo - lc_hi, -1e-30)))
    lp = (-0.5 * _LOG_2PI - torch.log(s) - 0.5 * torch.square((x - mu) / s)
          - log_mass)
    return _sum(_outside(lp, (x >= lower) & (x <= upper)))


def reflected_normal_logpdf(x, mean, stdev, lower, upper) -> torch.Tensor:
    """ReflectedNormalDistribution.java: the normal folded back at the
    bounds, the image sum cut at 8 reflections each way."""
    x = _x(x)
    mu, s = _t(mean, x), _t(stdev, x)
    width = upper - lower
    ks = torch.arange(-8, 9, dtype=x.dtype, device=x.device)
    centers_a = 2.0 * ks * width + mu
    centers_b = 2.0 * ks * width + 2.0 * lower - mu
    z = x[..., None]
    dens = (torch.exp(-0.5 * torch.square((z - centers_a) / s))
            + torch.exp(-0.5 * torch.square((z - centers_b) / s)))
    lp = torch.log(torch.sum(dens, -1)) - 0.5 * _LOG_2PI - torch.log(s)
    return _sum(_outside(lp, (x >= lower) & (x <= upper)))


def negative_binomial_logpmf(k, mean, alpha) -> torch.Tensor:
    """NegativeBinomialDistribution.java, var = mean + alpha mean^2."""
    k = _x(k)
    mu = _t(mean, k)
    r = 1.0 / _t(alpha, k)
    p = r / (r + mu)
    lp = (torch.lgamma(k + r) - torch.lgamma(r) - torch.lgamma(k + 1.0)
          + r * torch.log(p) + k * torch.log1p(-p))
    return _sum(lp)


def geometric_logpmf(k, p) -> torch.Tensor:
    """GeometricDistribution.java: p (1 - p)^k, k = 0, 1, ..."""
    k = _x(k)
    p = _t(p, k)
    return _sum(torch.log(p) + k * torch.log1p(-p))


def binomial_logpmf(k, n, p) -> torch.Tensor:
    """BinomialLikelihood."""
    k = _x(k)
    n, p = _t(n, k), _t(p, k)
    lp = (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
          - torch.lgamma(n - k + 1.0) + k * torch.log(p)
          + (n - k) * torch.log1p(-p))
    return _sum(lp)


def discrete_uniform_logpmf(k, lower, upper) -> torch.Tensor:
    """DiscreteUniformDistribution.java, bounds inclusive."""
    k = _x(k)
    n = _t(upper, k) - _t(lower, k) + 1.0
    lp = -torch.log(n).expand(k.shape)
    return _sum(_outside(lp, (k >= lower) & (k <= upper)))


def multivariate_gamma_logpdf(x, shapes, scales) -> torch.Tensor:
    """MultivariateGammaDistribution.java: independent gammas."""
    return _sum(_gamma_terms(x, shapes, scales))


def ar1_normal_logpdf(x, marginal_std, rho) -> torch.Tensor:
    """AutoRegressiveNormalDistribution.java: the stationary AR(1)
    Gaussian vector through its tridiagonal precision, O(n)."""
    x = _x(x)
    s, r = _t(marginal_std, x), _t(rho, x)
    n = x.shape[-1]
    z = x / s
    quad = (torch.sum(z * z) - 2.0 * r * torch.sum(z[1:] * z[:-1])
            + r * r * torch.sum(z[1:-1] * z[1:-1])) / (1.0 - r * r)
    logdet_cov = n * 2.0 * torch.log(s) + (n - 1) * torch.log1p(-r * r)
    return -0.5 * (n * _LOG_2PI + logdet_cov + quad)


def normal_kde_logpdf(x, samples, bandwidth=None) -> torch.Tensor:
    """NormalKDEDistribution.java, Silverman's bandwidth by default."""
    x = torch.atleast_1d(_x(x))
    samples = _t(samples, x)
    n = samples.shape[0]
    if bandwidth is None:
        bandwidth = 1.06 * torch.std(samples, correction=0) * n ** (-0.2)
    h = _t(bandwidth, x)
    z = (x[..., None] - samples) / h
    k = -0.5 * z * z - 0.5 * _LOG_2PI
    return _sum(torch.logsumexp(k, dim=-1) - math.log(n * 1.0) - torch.log(h))


def log_transformed_normal_kde_logpdf(x, samples,
                                      bandwidth=None) -> torch.Tensor:
    """LogTransformedNormalKDEDistribution.java: the KDE of log(samples),
    with the 1/x Jacobian."""
    x = _x(x)
    return (normal_kde_logpdf(torch.log(x), torch.log(_t(samples, x)),
                              bandwidth)
            - _sum(torch.log(x)))


def logit_transformed_normal_kde_logpdf(x, samples,
                                        bandwidth=None) -> torch.Tensor:
    """LogitTransformedNormalKDEDistribution.java: the KDE of
    logit(samples), with the 1/(x (1 - x)) Jacobian."""
    x = _x(x)

    def logit(v):
        return torch.log(v) - torch.log1p(-v)

    return (normal_kde_logpdf(logit(x), logit(_t(samples, x)), bandwidth)
            - _sum(torch.log(x) + torch.log1p(-x)))


def marginalized_alpha_stable_logpdf(x, scale, alpha) -> torch.Tensor:
    """MarginalizedAlphaStableDistribution.java:81-83, unnormalised:
    -log(scale) - (|x| / scale)^alpha."""
    x = _x(x)
    scale = _t(scale, x)
    return _sum(-torch.log(scale) - (torch.abs(x) / scale) ** alpha)


def multivariate_t_logpdf(x, mean, scale_matrix, df) -> torch.Tensor:
    """Multivariate Student t with scale matrix Sigma [D, D]."""
    x = _x(x)
    mu, sig, nu = _t(mean, x), _t(scale_matrix, x), _t(df, x)
    d = mu.shape[-1]
    diff = x - mu
    q = diff @ torch.linalg.solve(sig, diff)
    logdet = torch.linalg.slogdet(sig)[1]
    return (torch.lgamma(0.5 * (nu + d)) - torch.lgamma(0.5 * nu)
            - 0.5 * d * (torch.log(nu) + math.log(math.pi)) - 0.5 * logdet
            - 0.5 * (nu + d) * torch.log1p(q / nu))


def multivariate_lognormal_logpdf(x, mu, precision) -> torch.Tensor:
    """MultivariateLogNormalDistribution: log x ~ MVN(mu, P^-1)."""
    lx = torch.log(_x(x))
    return (multivariate_normal_logpdf(lx, _t(mu, lx), precision=precision)
            - torch.sum(lx))


def kumaraswamy_logpdf(x, a, b) -> torch.Tensor:
    """Kumaraswamy(a, b) on (0, 1): log(a b) + (a - 1) log x
    + (b - 1) log(1 - x^a); -inf unless every x is inside."""
    x = _x(x)
    a, b = _t(a, x), _t(b, x)
    lp = (torch.log(a) + torch.log(b) + (a - 1.0) * torch.log(x)
          + (b - 1.0) * torch.log1p(-(x ** a)))
    return _outside(_sum(lp), torch.all((x > 0) & (x < 1)))


def point_mass_mixture_logpmf(x, probs, values) -> torch.Tensor:
    """PointMassMixtureDistribution.java:48-70: sum_j probs[j] 1[x ==
    values[j]] over realised vectors values [J, D], floored at 1e-300."""
    x = _x(x)
    values = _t(values, x)
    hit = torch.all(values == x[None, :], dim=1)
    p = torch.sum(torch.where(hit, _t(probs, x),
                              torch.zeros_like(hit, dtype=x.dtype)))
    return torch.log(torch.clamp_min(p, 1e-300))


def frechet_logpdf(x, shape, scale) -> torch.Tensor:
    """Frechet (inverse Weibull): log(a / s) - (1 + a) log(x / s)
    - (x / s)^-a; -inf unless every x is positive."""
    x = _x(x)
    a, s = _t(shape, x), _t(scale, x)
    z = x / s
    lp = torch.log(a / s) - (1.0 + a) * torch.log(z) - z ** (-a)
    return _outside(_sum(lp), torch.all(x > 0))
