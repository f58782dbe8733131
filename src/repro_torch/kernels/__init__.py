"""Hand-written Hopper kernels (``csrc/``), their wrappers and oracles."""

# shared memory one Hopper block may use: 227 KB of the SM's 256 KB, above
# 48 KB only as dynamic shared memory (H100/H200 data sheets)
SMEM_PER_BLOCK = 232_448


def launch_counters() -> tuple:
    """The seven kernel wrappers.  Each carries ``launches``, the count of
    its kernel's executions, which a caller may set to 0 and read back."""
    from repro_torch.kernels import (decode_attention, fir, flash_attention,
                                     mriq, rglru_scan, rmsnorm, ssm_scan)
    return (fir.fir_filter_bank, mriq.mriq_compute_q,
            flash_attention.flash_attention, decode_attention.decode_attention,
            ssm_scan.ssm_scan, rglru_scan.rglru_scan, rmsnorm.rmsnorm)
