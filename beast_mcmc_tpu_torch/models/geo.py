"""Geospatial priors and lattice diffusion (the dr.geo package).

Counterpart of beast_mcmc_tpu/models/geo.py (GeoSpatialDistribution.java
:74-96, MultiRegionGeoSpatialDistribution.java, Polygon2D.java
containsPoint2D, KMLCoordinates.java, GreatCircleDistances.java,
Lattice.java and InhomogeneousRandomWalk.java,
MultivariateBrownianBridge.java). Point-in-polygon is a ray cast over
the vertex array vectorised over the points ([N, V] at once), the
lattice walk a dense generator, and a bridge a fixed-depth midpoint
refinement, every midpoint of a level drawn at once.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import numpy as np
import torch

EARTH_RADIUS_KM = 6371.0


def point_in_polygon(points: torch.Tensor,
                     vertices: torch.Tensor) -> torch.Tensor:
    """bool[N]: ray-cast containment of points [N, 2] (x, y) in the ring
    vertices [V, 2] (the closing edge V-1 -> 0 implied); Polygon2D
    .containsPoint2D off the boundary."""
    points = torch.atleast_2d(points)
    x, y = points[:, 0][:, None], points[:, 1][:, None]
    vx, vy = vertices[:, 0][None, :], vertices[:, 1][None, :]
    vx2 = torch.roll(vertices[:, 0], -1)[None, :]
    vy2 = torch.roll(vertices[:, 1], -1)[None, :]
    straddle = (vy > y) != (vy2 > y)
    t = (y - vy) / torch.where(vy2 == vy, torch.ones_like(vy), vy2 - vy)
    cross_x = vx + t * (vx2 - vx)
    crossings = torch.sum(straddle & (cross_x > x), dim=1)
    return (crossings % 2) == 1


def geo_spatial_logpdf(x: torch.Tensor, vertices: torch.Tensor,
                       outside: bool = False) -> torch.Tensor:
    """A flat prior over a polygon: 0 inside, -inf outside; `outside`
    inverts the region (GeoSpatialDistribution.logPdf:74-96)."""
    ok = point_in_polygon(x[None, :], vertices)[0] != outside
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(ok, zero, zero - math.inf)


def multi_region_logpdf(x: torch.Tensor, polygons: Sequence[torch.Tensor],
                        union: bool = True) -> torch.Tensor:
    """A flat prior over a union (or intersection) of polygons
    (MultiRegionGeoSpatialDistribution.java)."""
    inside = torch.stack([point_in_polygon(x[None, :], v)[0]
                          for v in polygons])
    ok = torch.any(inside) if union else torch.all(inside)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(ok, zero, zero - math.inf)


def parse_kml_coordinates(text: str) -> list:
    """The rings of a KML text's <coordinates> blocks (lon,lat[,alt]
    tuples), [V, 2] (lon, lat) numpy arrays, an explicit closing vertex
    dropped (KMLCoordinates.java)."""
    rings = []
    for block in re.findall(r"<coordinates>(.*?)</coordinates>", text,
                            re.DOTALL):
        pts = []
        for tok in block.split():
            parts = tok.split(",")
            if len(parts) >= 2:
                pts.append((float(parts[0]), float(parts[1])))
        if pts:
            ring = np.asarray(pts)
            if len(ring) > 1 and np.allclose(ring[0], ring[-1]):
                ring = ring[:-1]
            rings.append(ring)
    return rings


def great_circle_distance(latlon1: torch.Tensor, latlon2: torch.Tensor,
                          radius: float = EARTH_RADIUS_KM) -> torch.Tensor:
    """Haversine distance in km between [..., 2] (lat, lon) in degrees
    (GreatCircleDistances.java)."""
    p1, p2 = torch.deg2rad(latlon1), torch.deg2rad(latlon2)
    dlat = p2[..., 0] - p1[..., 0]
    dlon = p2[..., 1] - p1[..., 1]
    a = (torch.sin(dlat / 2) ** 2 + torch.cos(p1[..., 0])
         * torch.cos(p2[..., 0]) * torch.sin(dlon / 2) ** 2)
    return 2.0 * radius * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def lattice_rate_matrix(valid: torch.Tensor, rates=1.0) -> torch.Tensor:
    """The generator [R C, R C] (dense, float64) of a nearest-neighbour
    walk on a raster restricted to its valid cells (Lattice.java,
    InhomogeneousRandomWalk.java): valid bool [R, C], rates a scalar or
    [R, C] jump rate of each cell."""
    r, c = valid.shape
    n = r * c
    dev = valid.device
    rates = torch.as_tensor(rates, dtype=torch.float64,
                            device=dev).expand(r, c)
    idx = torch.arange(n, device=dev).reshape(r, c)
    q = torch.zeros((n, n), dtype=torch.float64, device=dev)
    src = idx.reshape(-1)
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        in_bounds = torch.ones((r, c), dtype=torch.bool, device=dev)
        if dr == 1:
            in_bounds[-1, :] = False
        if dr == -1:
            in_bounds[0, :] = False
        if dc == 1:
            in_bounds[:, -1] = False
        if dc == -1:
            in_bounds[:, 0] = False
        can = valid & in_bounds & torch.roll(valid, (-dr, -dc), (0, 1))
        dst = torch.roll(idx, (-dr, -dc), (0, 1)).reshape(-1)
        w = torch.where(can, rates, torch.zeros_like(rates)).reshape(-1)
        q.index_put_((src, dst), w, accumulate=True)
    return q - torch.diag(torch.sum(q, dim=1))


def brownian_bridge(generator: torch.Generator, start: torch.Tensor,
                    end: torch.Tensor, t0, t1, precision, depth: int = 6,
                    noises: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """A multivariate Brownian bridge by fixed-depth midpoint refinement
    (MultivariateBrownianBridge.divideConquerBrownianBridge): each level's
    2^l midpoints at once, variance (t1 - t0) / precision x (the span's
    share) / 4. Returns the path [2^depth + 1, D], endpoints included.
    The standard normals of level l are [2^l, D] draws from the generator
    (or noises[l], given)."""
    d = start.shape[0]
    n = (1 << depth) + 1
    path = torch.zeros((n, d), dtype=start.dtype, device=start.device)
    path[0], path[n - 1] = start, end
    span = ((torch.as_tensor(t1, dtype=start.dtype) - t0)
            / torch.as_tensor(precision, dtype=start.dtype))
    step = n - 1
    for level in range(depth):
        half = step // 2
        starts = torch.arange(0, n - 1, step, device=start.device)
        var = span * (step / (n - 1)) / 4.0
        noise = (noises[level] if noises is not None else torch.randn(
            (starts.shape[0], d), generator=generator, dtype=start.dtype,
            device=start.device))
        path[starts + half] = (0.5 * (path[starts] + path[starts + step])
                               + torch.sqrt(var) * noise.to(start.dtype))
        step = half
    return path
