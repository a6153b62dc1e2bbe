"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit): HBM bytes/s and float32 operations/s outside the
tensor cores (an FMA counts two)."""

BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
