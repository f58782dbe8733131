// MRI-Q computeQ for Hopper (sm_90a).
//
//   phase    = 2*pi * (kx[j]*x[i] + ky[j]*y[i] + kz[j]*z[i])
//   Q_re[i]  = sum_j phi[j] * cos(phase),   Q_im[i] = sum_j phi[j] * sin(phase)
//
// Replaces the TPU kernel src/repro/kernels/mriq.py::mriq_compute_q (Pallas
// body _mriq_kernel).
//
// What bounds it on an H100: operations.  Every (voxel, sample) pair needs
// one sine and one cosine, which run on the special-function units at 16
// results per clock per SM — an eighth of the FP32 FMA rate — so at Parboil
// "large" (262,144 voxels x 2,048 samples = 5.4e8 pairs, 1.07e9
// transcendentals) the SFUs need ~0.26 ms while the ~10 FP32 flops per pair
// need ~0.08 ms and the 5.3 MB of traffic ~1.6 us.
//
// Design:
// * one thread per voxel; a block of MRIQ_THREADS voxels walks the k-space
//   samples in chunks of MRIQ_CHUNK staged through shared memory as float4
//   (kx, ky, kz, phi), so each sample is read from device memory once per
//   block and then broadcast to every thread.
// * Q_re and Q_im accumulate in registers over the whole sample loop, so no
//   reduction crosses blocks: this loop takes the place of the TPU's output
//   block revisited sequentially across grid axis 1.
// * the phase is two FMAs and a multiply in *turns* (no 4-wide matrix
//   product as on the TPU's MXU).  Subtracting rintf(turns) puts the angle
//   in [-pi, pi], where __sincosf (one SFU sine and cosine, max abs error
//   2^-21.41 on that range) is accurate to ~4e-7 per term: over 2,048 terms
//   of |phi| ~ 2 that stays far inside the 3e-3 tolerance against the
//   precise-libm reference.  The precise sincosf would run its range
//   reduction and polynomial on the FMA pipe and cost ~3x the SFU bound.
// * the ragged ends of numX and numK are masked (a tail thread loads but
//   does not store; the last chunk is shorter), not padded.
#include <cuda_runtime.h>

constexpr int MRIQ_THREADS = 256;
constexpr int MRIQ_CHUNK = 1024;   // 16 KB of float4 per block

__global__ void __launch_bounds__(MRIQ_THREADS)
mriq_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ z, const float* __restrict__ kx,
            const float* __restrict__ ky, const float* __restrict__ kz,
            const float* __restrict__ phi, float* __restrict__ qr,
            float* __restrict__ qi, int num_x, int num_k) {
  __shared__ float4 samples[MRIQ_CHUNK];
  const int i = blockIdx.x * MRIQ_THREADS + threadIdx.x;
  const bool live = i < num_x;
  const float xi = live ? x[i] : 0.f;
  const float yi = live ? y[i] : 0.f;
  const float zi = live ? z[i] : 0.f;
  float acc_r = 0.f, acc_i = 0.f;
  for (int base = 0; base < num_k; base += MRIQ_CHUNK) {
    const int count = min(MRIQ_CHUNK, num_k - base);
    __syncthreads();               // the previous chunk is consumed
    for (int t = threadIdx.x; t < count; t += MRIQ_THREADS) {
      samples[t] = make_float4(kx[base + t], ky[base + t], kz[base + t],
                               phi[base + t]);
    }
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      const float4 s = samples[j];
      float turns = fmaf(s.x, xi, fmaf(s.y, yi, s.z * zi));
      turns -= rintf(turns);
      float sn, cs;
      __sincosf(6.28318530717958648f * turns, &sn, &cs);
      acc_r = fmaf(s.w, cs, acc_r);
      acc_i = fmaf(s.w, sn, acc_i);
    }
  }
  if (live) {
    qr[i] = acc_r;
    qi[i] = acc_i;
  }
}

extern "C" {

int mriq_threads() { return MRIQ_THREADS; }

int mriq_chunk() { return MRIQ_CHUNK; }

// All pointers: contiguous float32 on the current device; x, y, z, qr, qi
// hold num_x values, kx, ky, kz, phi hold num_k.
int mriq_compute_q_launch(const void* x, const void* y, const void* z,
                          const void* kx, const void* ky, const void* kz,
                          const void* phi, void* qr, void* qi, int num_x,
                          int num_k, void* stream) {
  const int blocks = (num_x + MRIQ_THREADS - 1) / MRIQ_THREADS;
  mriq_kernel<<<blocks, MRIQ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(z), static_cast<const float*>(kx),
      static_cast<const float*>(ky), static_cast<const float*>(kz),
      static_cast<const float*>(phi), static_cast<float*>(qr),
      static_cast<float*>(qi), num_x, num_k);
  return static_cast<int>(cudaGetLastError());
}

int mriq_compute_q_attributes(int* regs, int* static_smem, int* max_threads) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, mriq_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
