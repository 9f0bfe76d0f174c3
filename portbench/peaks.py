"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): the yardstick of every roofline share."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
