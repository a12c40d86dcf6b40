"""Per-site dN/dS analysis from robust-counting trace logs.

Role of dr.evomodel.trace.DnDsPerSiteAnalysis (ref:
src/dr/evomodel/trace/DnDsPerSiteAnalysis.java — consumes the four
per-site column families written by codon-partitioned robust counting,
c_S / u_S / c_N / u_N, and reports posterior per-site dN/dS with HPDs
and a sign test against neutrality).

For each posterior sample and site:
    dN = c_N / u_N   (conditional counts over unconditional expectations)
    dS = c_S / u_S
    omega = dN / dS
Summaries are computed sample-wise (ratio of means per sample, as the
reference's COND/UNCOND ratio), then over samples.

The port's own copy of beast_mcmc_tpu/apps/dnds.py: host-side numpy over
this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from beast_mcmc_tpu_torch.apps.treeannotator import hpd_interval


@dataclasses.dataclass
class SiteDnDs:
    site: int
    mean_dn: float
    mean_ds: float
    mean_dnds: float
    hpd_lower: float
    hpd_upper: float
    prob_positive: float  # P(dN > dS)


def _site_columns(columns: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    """Collect columns named '<prefix>[k]' or '<prefix>k' ordered by k into
    a [samples, sites] matrix."""
    import re

    pat = re.compile(re.escape(prefix) + r"\[?(\d+)\]?$")
    found = {}
    for name, values in columns.items():
        m = pat.match(name)
        if m:
            found[int(m.group(1))] = values
    if not found:
        raise KeyError(f"no columns matching {prefix!r}")
    sites = sorted(found)
    return np.stack([found[k] for k in sites], axis=1), sites


def dnds_per_site(columns: Dict[str, np.ndarray], burnin_fraction: float = 0.1,
                  prefix_cs: str = "c_S", prefix_us: str = "u_S",
                  prefix_cn: str = "c_N", prefix_un: str = "u_N",
                  eps: float = 1e-12) -> List[SiteDnDs]:
    """columns: trace name -> samples array (loganalyser.read_log format)."""
    cs, sites = _site_columns(columns, prefix_cs)
    us, _ = _site_columns(columns, prefix_us)
    cn, _ = _site_columns(columns, prefix_cn)
    un, _ = _site_columns(columns, prefix_un)
    n = cs.shape[0]
    start = int(n * burnin_fraction)
    cs, us, cn, un = cs[start:], us[start:], cn[start:], un[start:]
    dn = cn / np.maximum(un, eps)
    ds = cs / np.maximum(us, eps)
    omega = dn / np.maximum(ds, eps)
    out = []
    for j, site in enumerate(sites):
        lo, hi = hpd_interval(omega[:, j])
        out.append(SiteDnDs(
            site=site,
            mean_dn=float(dn[:, j].mean()),
            mean_ds=float(ds[:, j].mean()),
            mean_dnds=float(omega[:, j].mean()),
            hpd_lower=float(lo),
            hpd_upper=float(hi),
            prob_positive=float(np.mean(dn[:, j] > ds[:, j])),
        ))
    return out


def report(columns: Dict[str, np.ndarray], **kw) -> str:
    rows = dnds_per_site(columns, **kw)
    lines = ["site\tdN\tdS\tdN/dS\t95%HPD_lo\t95%HPD_hi\tP(dN>dS)"]
    for r in rows:
        lines.append(
            f"{r.site}\t{r.mean_dn:.4f}\t{r.mean_ds:.4f}\t{r.mean_dnds:.4f}"
            f"\t{r.hpd_lower:.4f}\t{r.hpd_upper:.4f}\t{r.prob_positive:.3f}"
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    from beast_mcmc_tpu_torch.apps.loganalyser import read_log

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log")
    ap.add_argument("--burnin", type=float, default=0.1)
    args = ap.parse_args(argv)
    _, columns = read_log(args.log)
    print(report(columns, burnin_fraction=args.burnin))


if __name__ == "__main__":
    main()
