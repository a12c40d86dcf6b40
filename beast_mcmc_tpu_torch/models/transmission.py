"""Transmission-tree likelihoods: a virus genealogy given who infected
whom and when.

Counterpart of beast_mcmc_tpu/models/transmission.py
(TransmissionLikelihood.java:273-414: lineages move across host boundaries
at the transmission times and each host's coalescent density is summed; a
coalescence of lineages in different hosts gives -inf;
CaseToCaseTransmissionLikelihood.java's sampled infection times). The
reference's recursive setupIntervals is a dense [edges x hosts] occupancy:
each edge's host chain comes from a fixed H-step chase of the donor map,
its time in each host from clipped interval intersections, and every
host's density from a masked sum, all hosts at once.

A node's host at its own height follows from its first child's tip: the
chase composes (`host_at` of a host already chased to a lower height is
`host_at` of the tip), so every node's host is one chase from the tip
reached by first children (the JAX package walks the internal nodes in
height order, each from its first child's host).
"""

from __future__ import annotations

import math

import torch

from beast_mcmc_tpu_torch.inference import operators as ops


def host_at(tip_host, height, donor_host: torch.Tensor,
            transmission_time: torch.Tensor) -> torch.Tensor:
    """The host holding a lineage that starts in `tip_host` once it has
    reached `height` back in time: the donor chain followed while the
    height passes the current host's infection time (setupIntervals
    :385-404); H steps, elementwise over the shapes of tip_host and
    height."""
    h = torch.as_tensor(tip_host, device=donor_host.device).long()
    for _ in range(donor_host.shape[0]):
        h = torch.where(height > transmission_time[h], donor_host[h].long(), h)
    return h


def _first_tips(children: torch.Tensor, n_taxa: int) -> torch.Tensor:
    """int64[M]: the tip reached from each node by first children, by
    pointer doubling."""
    m = children.shape[0]
    ar = torch.arange(m, device=children.device)
    q = torch.where(ar < n_taxa, ar, children[:, 0].long())
    for _ in range(math.ceil(math.log2(max(m, 2))) + 1):
        q = q[q]
    return q


def transmission_loglik(parent: torch.Tensor, children: torch.Tensor,
                        heights: torch.Tensor, n_taxa: int,
                        tip_host: torch.Tensor, donor_host: torch.Tensor,
                        transmission_time: torch.Tensor,
                        host_pop_sizes: torch.Tensor) -> torch.Tensor:
    """The sum over hosts of the within-host constant-size coalescent
    density of the genealogy (TransmissionDemographicModel CONSTANT,
    :124-132), -inf where a coalescence joins lineages of two hosts.
    donor_host [H] (the source host points at itself),
    transmission_time [H] (+inf for the source)."""
    dt = heights.dtype
    dev = heights.device
    m = parent.shape[0]
    n_hosts = donor_host.shape[0]
    tip_host = tip_host.long()
    transmission_time = transmission_time.to(dt)
    host_pop_sizes = host_pop_sizes.to(dt)
    internal = torch.arange(m, device=dev) >= n_taxa
    first = _first_tips(children, n_taxa)
    node_host = torch.where(internal, host_at(
        tip_host[first], heights, donor_host, transmission_time),
        tip_host[first])
    kids = children.clamp_min(0).long()
    h0 = host_at(tip_host[first[kids[:, 0]]], heights, donor_host,
                 transmission_time)
    h1 = host_at(tip_host[first[kids[:, 1]]], heights, donor_host,
                 transmission_time)
    compatible = torch.all((h0 == h1) | ~internal)

    # each edge's time inside each host: [M, H] (start, end)
    h_lo = heights
    h_hi = torch.where(parent >= 0, heights[parent.clamp_min(0)], heights)
    inf = torch.full((), math.inf, dtype=dt, device=dev)
    start = inf.expand(m, n_hosts).clone()
    end = (-inf).expand(m, n_hosts).clone()
    host, t = node_host, h_lo
    for _ in range(n_hosts):
        exit_t = torch.minimum(transmission_time[host], h_hi)
        seg_hi = torch.maximum(exit_t, t)
        live = seg_hi > t
        start = start.scatter_reduce(
            1, host[:, None], torch.where(live, t, inf)[:, None], "amin")
        end = end.scatter_reduce(
            1, host[:, None], torch.where(live, seg_hi, -inf)[:, None],
            "amax")
        host = torch.where(transmission_time[host] < h_hi,
                           donor_host[host].long(), host)
        t = seg_hi

    # each host's density: the lineage count between its events, -C(k, 2)
    # / N dt, and -log N a coalescence; [H, ...] for all hosts at once
    starts = torch.where(torch.isfinite(start), start, inf).T  # [H, M]
    ends = torch.where(torch.isfinite(end), end, inf).T
    times = torch.sort(torch.cat([starts, ends], dim=1), dim=1).values
    t0, t1 = times[:, :-1], times[:, 1:]
    fin = torch.isfinite(t1) & torch.isfinite(t0)
    span = torch.where(fin, t1 - t0, torch.zeros_like(t1))
    mid = torch.where(torch.isfinite(t1), 0.5 * (t0 + t1),
                      torch.zeros_like(t1))
    lin = torch.sum((starts[:, None, :] <= mid[:, :, None])
                    & (mid[:, :, None] < ends[:, None, :]), dim=2).to(dt)
    interval = -torch.sum(lin * (lin - 1.0) / 2.0 * span, dim=1) \
        / host_pop_sizes
    n_coal = torch.zeros(n_hosts, dtype=dt, device=dev).index_add_(
        0, node_host, internal.to(dt))
    total = torch.sum(interval - n_coal * torch.log(host_pop_sizes))
    return torch.where(compatible, total, -inf)


def infection_time_move(generator: torch.Generator,
                        transmission_time: torch.Tensor, window,
                        source_host):
    """A random walk of one host's infection time (the source host, of
    infinite time, excluded): (times', log Hastings), symmetric; -inf
    where the new time is not positive."""
    ex = torch.as_tensor([source_host], dtype=torch.long,
                         device=transmission_time.device)
    h = ops.sample_excluding(generator, transmission_time.shape[0], ex)
    delta = (ops._uniform(generator, transmission_time) * 2 - 1) * window
    new = transmission_time.index_put((h,), transmission_time[h] + delta)
    zero = torch.zeros((), dtype=transmission_time.dtype,
                       device=transmission_time.device)
    return new, torch.where(new[h][0] > 0.0, zero, zero - math.inf)
