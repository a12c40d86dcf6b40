#!/usr/bin/env python3
"""The node-height gradient of chip_smoke.py's phase 19a document under the
two forms of P(t) = U exp(values t) U_inv: the sum as written (the JAX
package's form) and I + U expm1(values t) U_inv (the port's), on the CPU
and on the card, each against the expm1 form on the CPU as a share of its
largest entry; with the start tree's shortest branches.

    python3 scripts/p_t_forms.py [DEVICE [TAXA SITES]]

From the root of a checkout; DEVICE is cuda (the default) or cpu, TAXA and
SITES default to the Makona shape (1,610 x 18,996). The documents go to
build/p_t_forms/.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as c  # noqa: E402
from beast_mcmc_tpu_torch.config import xml_assert  # noqa: E402
from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis  # noqa: E402
from beast_mcmc_tpu_torch.models import treelikelihood as tl  # noqa: E402
from beast_mcmc_tpu_torch.ops import eigen  # noqa: E402


def exp_form(eig, t):
    """P(t) as U exp(values t) U_inv, summed as written (no autograd
    eigensystem: 19a's gradient is in the heights alone)."""
    k_shape = eig.values.shape[:-1]
    s = eig.values.shape[-1]
    ones = (1,) * (t.dim() - len(k_shape))
    e = torch.exp(eig.values.reshape(*k_shape, *ones, s) * t[..., None])
    p = ((eig.U.reshape(*k_shape, *ones, s, s) * e[..., None, :])
         @ eig.U_inv.reshape(*k_shape, *ones, s, s))
    return torch.clamp_min(p, 0.0)


def main():
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    n_taxa = int(sys.argv[2]) if len(sys.argv) > 2 else c.SPEC_TAXA
    n_sites = int(sys.argv[3]) if len(sys.argv) > 3 else c.SPEC_SITES
    out = os.path.abspath(os.path.join("build", "p_t_forms"))
    os.makedirs(out, exist_ok=True)
    doc = os.path.join(out, "hmc.xml")
    c.hmc_document(doc, c.makona_data(n_taxa, n_sites, c.JOINT_SEED, dev),
                   50, 10)

    def gradient(device):
        ax = XmlAnalysis(doc, seed=c.P19_SEED, device=device, workdir=out)
        ax.build(ax._ids["treeModel"])
        _, _, g = xml_assert.analytic_gradient(
            ax, ax.build(ax._ids["heightGradient"]))
        return g.detach().cpu().double().numpy(), ax

    port = eigen.transition_probs
    devices = ["cpu", "cuda"] if dev == "cuda" else ["cpu"]
    res = {}
    for form, fn in (("exp", exp_form), ("expm1", port)):
        eigen.transition_probs = tl.transition_probs = fn
        try:
            for d in devices:
                res[form, d] = gradient(d)
        finally:
            eigen.transition_probs = tl.transition_probs = port
    params, tree = xml_assert.initial_eval_state(res["expm1", "cpu"][1])
    h = tree.heights.double().cpu()
    parent = tree.parent.long().cpu()
    bl = ((h[parent.clamp_min(0)] - h)[parent >= 0]
          * float(params["clock.rate"])).numpy()
    print(f"{n_taxa} taxa: branch lengths (substitutions) at quantiles 0, "
          f"0.01, 0.1, 0.5: {np.quantile(bl, [0, 0.01, 0.1, 0.5]).tolist()}")
    ref = res["expm1", "cpu"][0]
    big = float(np.abs(ref).max())
    for (form, d), (g, _) in res.items():
        diff = np.abs(g - ref)
        print(f"{form:5s} {d:4s} against expm1 on the CPU: "
              f"{float(diff.max()) / big:.3e} of the largest entry")
    for form in ("exp", "expm1"):
        if (form, "cuda") in res:
            diff = np.abs(res[form, "cuda"][0] - res[form, "cpu"][0])
            print(f"{form:5s} card against CPU: "
                  f"{float(diff.max()) / big:.3e} of the largest entry")


if __name__ == "__main__":
    main()
