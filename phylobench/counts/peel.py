"""The peel's operations and bytes from its shapes: the arithmetic of the
port's bring-up bound (`chip_smoke.py::bound_ms`), frozen here.

Operations: 4 S^2 + 3 S a node, category and pattern (two matrix-vector
products of S x S, the product of the two children and the rescale), over
the n_int = N - 1 internal nodes, plus 2 C S P at the root (the weighting
by frequencies and categories). Bytes: each input read once and each output
written once: the tips [N, S, P], the branch matrices [B, M, C, S, S], the
weighted frequencies [B, C, S], the schedule's two int32 rows [B, n_int, 2]
and the site log-likelihoods [B, P]; a launch that keeps its partials for a
gradient also writes them, [B, n_int, C, S, P].
"""


def count(shape: dict, chains: int, partials: bool = False,
          itemsize: int = 8):
    """(operations, bytes) of one launch over `chains` trees of `shape`
    (taxa, nodes, categories, states, patterns)."""
    n, m = shape["taxa"], shape["nodes"]
    c, s, p = shape["categories"], shape["states"], shape["patterns"]
    n_int = n - 1
    flops = chains * (n_int * c * p * (4 * s * s + 3 * s) + 2 * c * s * p)
    nbytes = itemsize * (n * s * p + chains * (m * c * s * s + c * s + p))
    nbytes += 4 * chains * n_int * 2 * 2
    if partials:
        nbytes += itemsize * chains * n_int * c * s * p
    return flops, nbytes


def bound_s(shape: dict, chains: int, partials: bool, peak_flops: float,
            bytes_per_s: float, itemsize: int = 8) -> float:
    """The least seconds of one launch: the larger of its operations over
    the peak and its bytes over the bandwidth."""
    flops, nbytes = count(shape, chains, partials, itemsize)
    return max(flops / peak_flops, nbytes / bytes_per_s)
