"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W power limit), frozen here so that no change to the program can move
the yardstick. The SFU's exponentials: 16 a clock an SM for compute
capability 9.0, 132 SMs at the 1.98 GHz boost clock."""

HBM_BYTES_S = 3.35e12          # HBM3 bytes/s
BF16_FLOP_S = 989e12           # bf16 on the tensor cores
FP32_FLOP_S = 67e12            # fp32 on the CUDA cores
SFU_EXP_S = 16 * 132 * 1.98e9  # exponentials/s
