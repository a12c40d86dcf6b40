"""Float-precision policy of the port.

The H100 has native float64, so the chain runs in float64 end to end: the
carried log posterior, the pattern-weighted sum and the peel itself. The
peel kernels also accept float32 so that the card can compare them with the
working type of the TPU kernels they replace.
"""

import torch

DEFAULT_FLOAT = torch.float64
DEFAULT_DEVICE = "cuda"
