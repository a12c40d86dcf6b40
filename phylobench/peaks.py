"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its full
700 W power limit; a card set below it runs slower under load, so each run
reports the card's power limit beside its numbers)."""

HBM_BYTES_PER_S = 3.35e12
# float64 on the FP64 tensor cores, float32 outside the tensor cores
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
