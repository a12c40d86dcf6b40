"""Classic published quantile algorithms, f64 host-side.

The reference's discrete-gamma site categories are the Yang-1994 median
quantiles computed with the AS91 chi-square percentage-point algorithm
(Best & Roberts 1975), which itself uses the AS32 incomplete-gamma
integral (Bhattacharjee 1970), the AS70 normal percentage points (Odeh &
Evans 1974) and the Pike & Hill (1966, CACM Algorithm 291) log-gamma
(ref: dr.math.distributions.GammaDistribution.pointChi2:530,
dr.math.GammaFunction.incompleteGamma:122 / lnGamma:49,
dr.math.ErrorFunction.pointNormal:95). AS91 converges to a RELATIVE
tolerance of 0.5e-6 and then stops — its truncation error is part of the
reference's published likelihood values at the corpus' 1e-13 assert
tolerance, so bit-parity requires running the same published algorithms,
not a more accurate quantile.

Used ONLY on the host path (a concrete f64 alpha: a tensor that does not
require grad, e.g. report evaluation); every other evaluation keeps the
smooth differentiable quantile of ops/special.py. The port's own copy of
beast_mcmc_tpu/utils/as91.py (pure Python, the same code).
"""

from __future__ import annotations

import math


def ln_gamma(alpha: float) -> float:
    """Pike & Hill (1966) Algorithm 291."""
    x = alpha
    f = 0.0
    if x < 7:
        f = 1.0
        z = x - 1.0
        z += 1.0
        while z < 7:
            f *= z
            z += 1.0
        x = z
        f = -math.log(f)
    z = 1.0 / (x * x)
    return (f + (x - 0.5) * math.log(x) - x + 0.918938533204673
            + (((-0.000595238095238 * z + 0.000793650793651) * z
                - 0.002777777777778) * z + 0.083333333333333) / x)


def incomplete_gamma_p(alpha: float, x: float,
                       ln_gamma_alpha: float | None = None) -> float:
    """AS32 (Bhattacharjee 1970): regularized lower incomplete gamma."""
    if ln_gamma_alpha is None:
        ln_gamma_alpha = ln_gamma(alpha)
    accurate, overflow = 1e-8, 1e30
    if x == 0.0:
        return 0.0
    if x < 0.0 or alpha <= 0.0:
        raise ValueError("arguments out of bounds")
    factor = math.exp(alpha * math.log(x) - x - ln_gamma_alpha)
    if x > 1 and x >= alpha:
        # continued fraction
        a = 1.0 - alpha
        b = a + x + 1.0
        term = 0.0
        pn0, pn1, pn2, pn3 = 1.0, x, x + 1.0, x * b
        gin = pn2 / pn3
        while True:
            a += 1.0
            b += 2.0
            term += 1.0
            an = a * term
            pn4 = b * pn2 - an * pn0
            pn5 = b * pn3 - an * pn1
            if pn5 != 0:
                rn = pn4 / pn5
                dif = abs(gin - rn)
                if dif <= accurate and dif <= accurate * rn:
                    break
                gin = rn
            pn0, pn1, pn2, pn3 = pn2, pn3, pn4, pn5
            if abs(pn4) >= overflow:
                pn0 /= overflow
                pn1 /= overflow
                pn2 /= overflow
                pn3 /= overflow
        return 1.0 - factor * gin
    # series expansion
    gin = 1.0
    term = 1.0
    rn = alpha
    while True:
        rn += 1.0
        term *= x / rn
        gin += term
        if term <= accurate:
            break
    return gin * factor / alpha


def point_normal(prob: float) -> float:
    """AS70 (Odeh & Evans 1974): standard-normal percentage points."""
    a0, a1, a2, a3 = -0.322232431088, -1.0, -0.342242088547, -0.0204231210245
    a4 = -0.453642210148e-4
    b0, b1 = 0.0993484626060, 0.588581570495
    b2, b3, b4 = 0.531103462366, 0.103537752850, 0.0038560700634
    p = prob
    p1 = p if p < 0.5 else 1.0 - p
    y = math.sqrt(math.log(1.0 / (p1 * p1)))
    z = y + ((((y * a4 + a3) * y + a2) * y + a1) * y + a0) / (
        (((y * b4 + b3) * y + b2) * y + b1) * y + b0)
    return -z if p < 0.5 else z


def point_chi2(prob: float, v: float) -> float:
    """AS91 (Best & Roberts 1975): chi-square percentage points with the
    reference's convergence thresholds (e = 0.5e-6)."""
    e, aa, p = 0.5e-6, 0.6931471805, prob
    epsi = 0.01
    if p < 0.000002 or p > 1 - 0.000002:
        epsi = 0.000001
    g = ln_gamma(v / 2.0)
    xx = v / 2.0
    c = xx - 1.0
    if v < -1.24 * math.log(p):
        ch = math.pow(p * xx * math.exp(g + xx * aa), 1.0 / xx)
        if ch - e < 0:
            return ch
    else:
        if v > 0.32:
            x = point_normal(p)
            p1 = 0.222222 / v
            ch = v * math.pow(x * math.sqrt(p1) + 1 - p1, 3.0)
            if ch > 2.2 * v + 6:
                ch = -2 * (math.log(1 - p) - c * math.log(0.5 * ch) + g)
        else:
            ch = 0.4
            a = math.log(1 - p)
            while True:
                q = ch
                p1 = 1 + ch * (4.67 + ch)
                p2 = ch * (6.73 + ch * (6.66 + ch))
                t = (-0.5 + (4.67 + 2 * ch) / p1
                     - (6.73 + ch * (13.32 + 3 * ch)) / p2)
                ch -= (1 - math.exp(a + g + 0.5 * ch + c * aa)
                       * p2 / p1) / t
                if abs(q / ch - 1) - epsi <= 0:
                    break
    while True:
        q = ch
        p1 = 0.5 * ch
        t = incomplete_gamma_p(xx, p1, g)
        if t < 0:
            raise ValueError("arguments out of range: t < 0")
        p2 = p - t
        t = p2 * math.exp(xx * aa + g + p1 - c * math.log(ch))
        b = t / ch
        a = 0.5 * t - b * c
        s1 = (210 + a * (140 + a * (105 + a * (84 + a * (70 + 60 * a))))) / 420
        s2 = (420 + a * (735 + a * (966 + a * (1141 + 1278 * a)))) / 2520
        s3 = (210 + a * (462 + a * (707 + 932 * a))) / 2520
        s4 = (252 + a * (672 + 1182 * a)
              + c * (294 + a * (889 + 1740 * a))) / 5040
        s5 = (84 + 264 * a + c * (175 + 606 * a)) / 2520
        s6 = (120 + c * (346 + 127 * c)) / 5040
        ch += t * (1 + 0.5 * t * s1 - b * c
                   * (s1 - b * (s2 - b * (s3 - b
                      * (s4 - b * (s5 - b * s6))))))
        if abs(q / ch - 1) <= e:
            break
    return ch


def gamma_quantile(y: float, shape: float, scale: float) -> float:
    """ref: GammaDistribution.quantile:281 — 0.5*scale*pointChi2(y, 2a)."""
    return 0.5 * scale * point_chi2(y, 2.0 * shape)


def gamma_category_rates(alpha: float, k: int) -> list:
    """Yang-1994 median rates, mean-normalized in the reference's exact
    summation order (ref: GammaSiteRateModel.setEqualRates:445-452 +
    normalize:459-471)."""
    rates = [gamma_quantile((2.0 * i + 1.0) / (2.0 * k), alpha, 1.0 / alpha)
             for i in range(k)]
    mean = 0.0
    for r in rates:
        mean += r
    mean /= k
    return [r / mean for r in rates]
