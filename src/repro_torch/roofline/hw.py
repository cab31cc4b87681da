"""One NVIDIA H100 SXM (the port's target card; the reference's
``repro.roofline.hw`` holds the TPU v5e's).

Rates are NVIDIA's H100 SXM data sheet figures, dense (no sparsity), at the
card's 700 W power limit; a card set below it runs slower under load, so a
measured share of these peaks is stated beside the card's power limit.
"""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores (dense)
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, tf32 on the tensor cores (dense)
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, fp32 on the CUDA cores
HBM_BW = 3.35e12              # bytes/s, HBM3
HBM_BYTES = 80e9              # bytes of HBM3
SM_COUNT = 132                # streaming multiprocessors
BOOST_CLOCK_HZ = 1.98e9       # the SM boost clock
# the SFU's exponentials: 16 a clock an SM for compute capability 9.0 (CUDA
# programming guide, arithmetic instruction throughput)
PEAK_SFU_EXP_S = 16 * SM_COUNT * BOOST_CLOCK_HZ
SMEM_PER_SM = 228 * 1024      # bytes of shared memory an SM (227 KB a block)
SMEM_PER_BLOCK = 227 * 1024   # the most one block may take
REGS_PER_SM = 64 * 1024       # 32-bit registers an SM
THREADS_PER_SM = 2048         # resident threads an SM
L2_BYTES = 50 * 2**20         # the L2 cache
# NVLink 4: 18 links of 50 GB/s (25 each way) = 900 GB/s a card, both
# directions together; a collective's bytes leave a card at one direction's
NVLINK_BW = 450e9             # bytes/s a card, one direction
