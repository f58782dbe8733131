"""Configs for the paper's two evaluation applications (§5.1.1).

These mirror the C originals' problem sizes:

* **tdFIR** (HPEC challenge, time-domain finite impulse response filter bank):
  the standard dataset set runs M filter banks of K complex taps over N-sample
  complex inputs.  HPEC set 1: M=64, K=128, N=4096.  The C code has 36 loop
  statements (init, load, outer bank loop, tap loop, sample loop, verify, ...).

* **MRI-Q** (Parboil): Q-matrix computation for non-Cartesian MRI
  reconstruction.  For every voxel x (numX) accumulate over k-space samples
  (numK):  Q(x) += |phi(k)|^2 * [cos(2*pi*k.x), sin(2*pi*k.x)].
  Parboil 'large': numX=262144, numK=2048.  The C code has 16 loop statements.

The ``*_BENCH`` variants are smaller sample sizes of the same structure; the
``*_FULL`` variants are the paper-faithful sizes used for FLOP/AI accounting.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class TdFirConfig:
    n_banks: int      # M filters
    n_taps: int       # K complex taps per filter
    n_samples: int    # N input samples per bank
    n_loops_in_source: int = 36   # paper §5.1.2

    @property
    def flops(self) -> int:
        # complex MAC = 8 real flops, per (bank, sample, tap)
        return 8 * self.n_banks * self.n_samples * self.n_taps


@dataclass(frozen=True)
class MriQConfig:
    num_x: int        # voxels
    num_k: int        # k-space samples
    n_loops_in_source: int = 16   # paper §5.1.2

    @property
    def flops(self) -> int:
        # per (x, k): 5 mul/add for phase + sin + cos (counted as 1 flop each
        # here; transcendental weight handled in the intensity model) + 4 MAC
        return 13 * self.num_x * self.num_k


TDFIR_FULL = TdFirConfig(n_banks=64, n_taps=128, n_samples=4096)
TDFIR_BENCH = TdFirConfig(n_banks=16, n_taps=64, n_samples=1024)

MRIQ_FULL = MriQConfig(num_x=262_144, num_k=2048)
MRIQ_BENCH = MriQConfig(num_x=16_384, num_k=512)
