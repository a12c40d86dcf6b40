"""Float-precision policy of the port.

The H100 has native float64, so the chain runs in float64 end to end: the
carried log posterior, the pattern-weighted sum and the peel itself. The
peel kernels also accept float32 so that the card can compare them with the
working type of the TPU kernels they replace.

default_float() is the type the config layer builds an analysis in when
its spec names none (counterpart of beast_mcmc_tpu/utils/dtypes.py). There
is no x64 switch to read and no global to set: it is float64, and an
analysis that wants another type names it in `AnalysisSpec.dtype`.
"""

import torch

DEFAULT_FLOAT = torch.float64
DEFAULT_DEVICE = "cuda"


def default_float() -> torch.dtype:
    """The framework-wide default float type: float64."""
    return DEFAULT_FLOAT
