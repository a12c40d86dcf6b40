from beast_mcmc_tpu_torch.data.datatype import (
    NUCLEOTIDES,
    AMINO_ACIDS,
    BINARY,
    DataType,
    general_datatype,
)
from beast_mcmc_tpu_torch.data.alignment import Alignment, SitePatterns
