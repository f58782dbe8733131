"""Target-hardware constants of the port: one NVIDIA H100 SXM (the twin of
the JAX package's ``launch/constants.py``).

The published figures of NVIDIA's H100 SXM data sheet, dense rates without
sparsity, at the card's full 700 W power limit.  A card set below 700 W
runs slower under load, so a bound taken from these figures is the least
time of a card at the full limit.  The collective rates are those of a
DGX H100 node: NVLink 4 inside a node of 8 GPUs, one 400 Gb/s ConnectX-7
link a GPU between nodes.  Every axis of the 16-wide production meshes
(``launch/mesh.py``) spans more than one node, so the roofline's
collective term (``launch/roofline.py``) reads the inter-node rate.

Every other module of the port, and ``chip_smoke.py``, reads the card's
figures from here, lower layers too (``core/cost_model.py``,
``core/resources.py``, ``kernels/__init__.py``): this module imports
nothing, and ``launch/__init__.py`` imports nothing either, so reading it
from below the entry points loads no launcher and makes no import cycle.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12        # tensor cores, dense bf16 flop/s
PEAK_FLOPS_FP32 = 67e12         # float32 flop/s outside the tensor cores
HBM_BW = 3.35e12                # HBM3 bytes/s
HBM_BYTES = 80 * 1024**3        # device memory
# the special-function units retire 16 sines/cosines/exps per clock per SM
# against 128 FP32 FMAs (256 flops): 1/16 of the FP32 flop rate
SFU_RATE = PEAK_FLOPS_FP32 / 16
SMEM_PER_BLOCK = 232_448        # shared memory one block may use (227 KB)
L2_BYTES = 50 * 1024 * 1024     # L2 cache
# NVLink 4, both directions together, per GPU (H100 SXM data sheet)
NVLINK_BW = 900e9
# one 400 Gb/s ConnectX-7 a GPU (DGX H100 data sheet), bytes/s one way
INTER_NODE_BW = 400e9 / 8
GPUS_PER_NODE = 8               # a DGX/HGX H100 node
SINGLE_POD_CHIPS = 256          # the 16x16 production mesh
MULTI_POD_CHIPS = 512           # the 2x16x16 production mesh


def projected_seconds(flops: float, hbm_bytes: float,
                      transcendentals: float = 0.0, *,
                      peak_flops: float = PEAK_FLOPS_BF16) -> dict:
    """Three-term roofline time of one card's work (seconds): the flops at
    ``peak_flops`` (bf16 tensor cores by default; pass ``PEAK_FLOPS_FP32``
    for float32 work), the bytes at the HBM rate, the transcendentals at
    the SFU rate.  Returns each term, the name of the largest (``bound``)
    and its value (``seconds``)."""
    terms = {"compute": flops / peak_flops,
             "memory": hbm_bytes / HBM_BW,
             "transcendental": transcendentals / SFU_RATE}
    bound = max(terms, key=terms.get)
    return {**terms, "bound": bound, "seconds": terms[bound]}
