"""The useful float64 operations of a window, from shapes.

An evaluation of B chains is one peel (`peel.count`) and the transition
matrices of every branch and category, P(t) = U diag(exp(lambda t)) U^-1:
S exponentials, S^2 products to scale U's columns and 2 S^3 for the
product, per matrix. A gradient counts as three evaluations (its forward
and a backward of twice the work), however the program computes it.
"""

from phylobench.counts import peel


def transition_ops(shape: dict, chains: int) -> int:
    s = shape["states"]
    return chains * shape["nodes"] * shape["categories"] * (
        2 * s ** 3 + s * s + s)


def evaluation_ops(shape: dict, chains: int) -> int:
    return peel.count(shape, chains)[0] + transition_ops(shape, chains)


def window_ops(shape: dict, chains: int, evaluations: int,
               gradients: int) -> int:
    """Operations of `evaluations` forward evaluations of the batch, of
    which `gradients` carried a backward."""
    return (evaluations + 2 * gradients) * evaluation_ops(shape, chains)
