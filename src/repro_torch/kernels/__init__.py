"""Hand-written Hopper kernels (``csrc/``), their wrappers and oracles."""

# shared memory one Hopper block may use, from the port's one module of
# the card's figures
from repro_torch.launch.constants import SMEM_PER_BLOCK  # noqa: F401 (re-export)


def launch_counters() -> tuple:
    """The kernel wrappers: the seven kernels' and the flash combine's
    (``flash_attention_combine``, the second kernel of a split bf16 flash
    call).  Each carries ``launches``, the count of its kernel's
    executions, which a caller may set to 0 and read back."""
    from repro_torch.kernels import (decode_attention, fir, flash_attention,
                                     mriq, rglru_scan, rmsnorm, ssm_scan)
    return (fir.fir_filter_bank, mriq.mriq_compute_q,
            flash_attention.flash_attention, decode_attention.decode_attention,
            ssm_scan.ssm_scan, rglru_scan.rglru_scan, rmsnorm.rmsnorm,
            flash_attention.flash_attention_combine)
