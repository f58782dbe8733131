"""Hand-written Hopper kernels (``csrc/``), their wrappers and oracles."""

# shared memory one Hopper block may use: 227 KB of the SM's 256 KB, above
# 48 KB only as dynamic shared memory (H100/H200 data sheets)
SMEM_PER_BLOCK = 232_448
