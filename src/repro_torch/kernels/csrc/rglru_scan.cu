// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
//   h_t[b, c] = a_t[b, c] * h_{t-1}[b, c] + b_t[b, c]      (h_all = every h_t)
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (Pallas body _rglru_kernel).
//
// What bounds it on an H100: bytes.  At the serving bucket (B=1, S=2,080,
// D=2,560, bf16) it reads a and b and writes h_all once: 3 x 2,080 x 2,560
// x 2 B = 31.9 MB, 9.5 us at 3.35 TB/s, and one FMA per element.  The
// first version (one thread per (batch, channel) walking all S steps) took
// 0.1191 ms there on an NVIDIA H100 80GB HBM3 at 700 W, 8% of the bound: at
// batch 1 it had only 2,560 chains, 20 blocks of 128 threads on 132 SMs,
// each thread 2,080 dependent FMAs long.  This version: 0.0159-0.0171 ms
// (56-60% of the bound) as a CUDA-graph replay on the same card model
// (chip_smoke.py phase 3; PERF.md).
//
// Design: a single-pass scan chunked over time, so that the card fills at
// batch 1 (Merrill & Garland's chained scan, with a chunk of TC steps as
// the scan element and a fixed look-back, so that the result does not
// depend on the order in which blocks run).
// * grid = (time chunks, channel tiles of block_c, B): 65 x 20 = 1,300
//   blocks of 64 threads at the serving shape with TC = 32.  A block takes
//   its chunk k from an atomic ticket per (batch, tile), so it only ever
//   waits on chunks whose blocks have already started (forward progress
//   whatever the scheduler does).
// * each thread owns one 32-bit word of channels (two bf16 channels, or one
//   float32; one bf16 where D is odd or a pointer is not 4-byte aligned).
//   The block copies its chunk of a and b into shared memory with
//   cp.async, every copy in flight at once (a warp reads whole 128-byte
//   lines), and keeps it there while it waits for its carry: 16 KB a block
//   at the serving shape, so all 1,300 blocks are resident together.  (A
//   draft that held the chunk in registers needed so many a thread that
//   the blocks ran in two waves, each with its own chain of waits, and
//   took about half as long again.)
// * local pass, in float32: the chunk's aggregate A = prod a_t and H = the
//   chunk's scan from h = 0, so that h_out = A * h_in + H.
// * carry-in: chunks come in groups of W = 32 and runs of V = 8.  The
//   first chunk of a group (k = g W) publishes its end state P = A *
//   carry + H; every other chunk publishes its aggregate, and the chunk
//   that ends a run also the run's composite.  Chunk k (k > 0) composes the
//   whole runs between its group's first chunk j0 = W floor((k - 1) / W)
//   and its own run, then the chunks of its own run before it (at most 3
//   + 7 reads), in ascending order, and applies that to P of chunk j0.
//   The composition runs while the group's end states are still being
//   formed, so the chain of waits is one link per group (2 at the serving
//   shape), and every carry is the same expression of the inputs in every
//   run and every replay.
// * the chunk is run again from its carry out of shared memory: h_all is
//   written once, and the last chunk writes h_final.  a and b are read
//   once from device memory; the aggregates, runs and end states (1.7 MB
//   at the serving shape) stay in L2.
// * status words: one per (batch, tile, chunk), 1 = aggregate, 2 = run
//   composite, 3 = end state published; tickets one per (batch, tile).
//   The C entry point clears both with cudaMemsetAsync before each launch,
//   so a launch replayed from a CUDA graph starts from zeros.
//   Publication: each thread stores its values (st.global.cg), fences, the
//   block synchronises, one thread stores the status word with release
//   semantics; the waiter reads it with acquire semantics, and the block
//   reads the values with ld.global.cg (L2, never a stale L1 line).
// * ragged edges: the last chunk is short, channels past D are masked; S
//   <= TC is one chunk with no waits.
// * precision as the TPU kernel: a and b are read in their type, h is
//   float32, h_all is stored in a's type and h_final in float32.  Chunk
//   composition reorders the float32 rounding against a sequential walk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int W = 32;     // chunks per group: one warp polls their words
constexpr int V = 8;      // chunks per run (W / V runs per group)
// a chunk's status word: 0 until it publishes; then
constexpr int AGGREGATE = 1;   // its aggregate,
constexpr int RUN = 2;         // also its run's composite (a run's last chunk),
constexpr int END_STATE = 3;   // its end state (a group's first chunk)

// one 32-bit word of channels: VEC values of type T
template <typename T, int VEC>
struct Word;

template <>
struct Word<float, 1> {
  using type = float;
  static __device__ __forceinline__ void unpack(type w, float (&v)[1]) {
    v[0] = w;
  }
  static __device__ __forceinline__ type pack(const float (&v)[1]) {
    return v[0];
  }
};

template <>
struct Word<__nv_bfloat16, 1> {
  using type = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(type w, float (&v)[1]) {
    v[0] = __bfloat162float(w);
  }
  static __device__ __forceinline__ type pack(const float (&v)[1]) {
    return __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Word<__nv_bfloat16, 2> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ void unpack(type w, float (&v)[2]) {
    const float2 f = __bfloat1622float2(w);
    v[0] = f.x;
    v[1] = f.y;
  }
  static __device__ __forceinline__ type pack(const float (&v)[2]) {
    return __floats2bfloat162_rn(v[0], v[1]);
  }
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// warp 0 waits until the status words of chunks lo, lo + stride, ... (n of
// them, n <= 32) all read at least `want`; then the block synchronises.  A
// wait of more than 2^22 polls (seconds) traps: a broken invariant fails
// the launch instead of hanging the card.
__device__ __forceinline__ void wait_status(const int* status, int lo,
                                            int stride, int n, int want) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int polls = 0;; ++polls) {
      const bool ok =
          lane >= n || load_acquire(status + lo + lane * stride) >= want;
      if (__all_sync(0xffffffffu, ok)) break;
      if (polls == 1 << 22) __trap();
    }
  }
  __syncthreads();
}

// every thread's stores are fenced, then one thread raises the status word
__device__ __forceinline__ void publish(int* status, int value) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(status, value);
}

// (A, H) of one word of channels: h_out = A * h_in + H for each channel
template <int VEC>
struct Affine {
  float A[VEC], H[VEC];

  __device__ __forceinline__ static Affine identity() {
    Affine f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) f.A[i] = 1.f, f.H[i] = 0.f;
    return f;
  }
  // this, then g
  __device__ __forceinline__ Affine then(const Affine& g) const {
    Affine f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      f.A[i] = g.A[i] * A[i];
      f.H[i] = fmaf(g.A[i], H[i], g.H[i]);
    }
    return f;
  }
  // one 16- or 8-byte access through L2 (never a stale L1 line)
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (VEC == 2)
      __stcg(reinterpret_cast<float4*>(p), make_float4(A[0], A[1], H[0], H[1]));
    else
      __stcg(reinterpret_cast<float2*>(p), make_float2(A[0], H[0]));
  }
  __device__ __forceinline__ static Affine load(const float* p) {
    Affine f;
    if constexpr (VEC == 2) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
      f.A[0] = q.x, f.A[1] = q.y, f.H[0] = q.z, f.H[1] = q.w;
    } else {
      const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
      f.A[0] = q.x, f.H[0] = q.y;
    }
    return f;
  }
};

// the composite of n <= N affines at p, p + step, ... in ascending order;
// the loads are all issued before the first is used
template <int VEC, int N>
__device__ __forceinline__ Affine<VEC> compose(const float* p, size_t step,
                                               int n) {
  Affine<VEC> f[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) f[i] = Affine<VEC>::load(p + i * step);
  Affine<VEC> c = Affine<VEC>::identity();
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) c = c.then(f[i]);
  return c;
}

// a copy of one word from device to shared memory: cp.async for 4-byte
// words (no register holds it), a load and a store for a single bf16
template <typename Word>
__device__ __forceinline__ void stage(Word* dst, const Word* src) {
  if constexpr (sizeof(Word) == 4) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
                 : "memory");
  } else {
    *dst = *src;
  }
}

// Scratch layout (see layout()): int tickets[B * tiles]; int status[B *
// tiles * chunks]; then, 16-byte aligned, floats: agg[B][chunks][D][2] (per
// chunk and word of channels: A[VEC] then H[VEC]), run[B][chunks / V +
// 1][D][2] (the run ending at chunk k at k / V) and end[B][groups][D].
// Dynamic shared memory: the chunk's words of a, then of b, [TC][threads].
template <typename T, int VEC, int TC>
__global__ void __launch_bounds__(MAX_THREADS)
rglru_chunk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const float* __restrict__ h0, T* __restrict__ h_all,
                   float* __restrict__ hf, int S, int D, int* tickets,
                   int* status, float* agg, float* run, float* end) {
  using Wd = Word<T, VEC>;
  using word = typename Wd::type;
  using Aff = Affine<VEC>;
  extern __shared__ float4 smem[];
  __shared__ int s_chunk;
  const int nchunks = gridDim.x, tiles = gridDim.y;
  const int tile = blockIdx.y, bi = blockIdx.z;
  const int row = bi * tiles + tile;
  if (threadIdx.x == 0) s_chunk = atomicAdd(tickets + row, 1);
  __syncthreads();
  const int k = s_chunk;
  int* st = status + static_cast<size_t>(row) * nchunks;

  const int ch = (tile * blockDim.x + threadIdx.x) * VEC;   // first channel
  const bool active = ch < D;
  const int t0 = k * TC;
  const int steps = min(TC, S - t0);
  const word* aw = reinterpret_cast<const word*>(a);
  const word* bw = reinterpret_cast<const word*>(b);
  word* hw = reinterpret_cast<word*>(h_all);
  const size_t w0 = ((static_cast<size_t>(bi) * S + t0) * D + ch) / VEC;
  const int wstride = D / VEC;
  // this thread's words of step j: as[j * nt], bs[j * nt]
  const int nt = blockDim.x;
  word* as = reinterpret_cast<word*>(smem) + threadIdx.x;
  word* bs = as + TC * nt;

  // the chunk's words, all copies in flight at once; each thread reads
  // back only its own words, so waiting for its own copies is enough
  if (active) {
#pragma unroll 8
    for (int j = 0; j < steps; ++j) {
      stage(as + j * nt, aw + w0 + static_cast<size_t>(j) * wstride);
      stage(bs + j * nt, bw + w0 + static_cast<size_t>(j) * wstride);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");

  // the chunk's aggregate
  Aff own = Aff::identity();
  float v[VEC], u[VEC];
#pragma unroll 8
  for (int j = 0; j < steps; ++j) {
    Wd::unpack(as[j * nt], v);
    Wd::unpack(bs[j * nt], u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      own.H[i] = fmaf(v[i], own.H[i], u[i]);
      own.A[i] *= v[i];
    }
  }
  // per batch row: agg of chunk j at agg0 + j * 2 D, the run ending at
  // chunk j at run0 + (j / V) * 2 D, group g's end state at end0 + g * D
  const size_t agg0 = (static_cast<size_t>(bi) * nchunks * D + ch) * 2;
  const size_t run0 = (static_cast<size_t>(bi) * (nchunks / V + 1) * D + ch) * 2;
  const size_t end0 = static_cast<size_t>(bi) * ((nchunks + W - 1) / W) * D + ch;
  if (k % W != 0) {
    if (active) own.store(agg + agg0 + static_cast<size_t>(k) * 2 * D);
    publish(st + k, AGGREGATE);
  }

  // the carry into chunk k: with j0 its group's first chunk (or the first
  // chunk of the group before, for k = j0 + W), the whole runs between,
  // then the aggregates of k's own run before k, applied to j0's end state
  float h[VEC];
  if (k == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      h[i] = active ? h0[static_cast<size_t>(bi) * D + ch + i] : 0.f;
  } else {
    const int j0 = (k - 1) / W * W;
    const int whole = (k - j0 - 1) / V;          // whole runs before k's
    const int first = j0 + V * whole + 1;        // k's run starts here
    Aff part = Aff::identity();
    if (k > first) {
      wait_status(st, first, 1, k - first, AGGREGATE);
      if (active)
        part = compose<VEC, V - 1>(agg + agg0 + static_cast<size_t>(first) * 2 * D,
                                   2 * static_cast<size_t>(D), k - first);
    }
    if ((k - j0) % V == 0 && k - j0 < W) {       // k ends a run
      if (active) part.then(own).store(run + run0 + static_cast<size_t>(k / V) * 2 * D);
      publish(st + k, RUN);
    }
    Aff runs = Aff::identity();
    if (whole > 0) {
      wait_status(st, j0 + V, V, whole, RUN);
      if (active)
        runs = compose<VEC, W / V - 1>(
            run + run0 + static_cast<size_t>(j0 / V + 1) * 2 * D,
            2 * static_cast<size_t>(D), whole);
    }
    const Aff carry = runs.then(part);
    wait_status(st, j0, 1, 1, END_STATE);
    const float* p = end + end0 + static_cast<size_t>(j0 / W) * D;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      h[i] = fmaf(carry.A[i], active ? __ldcg(p + i) : 0.f, carry.H[i]);
  }
  if (k % W == 0 && k + 1 < nchunks) {   // the group's end state
    if (active) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        __stcg(end + end0 + static_cast<size_t>(k / W) * D + i,
               fmaf(own.A[i], h[i], own.H[i]));
    }
    publish(st + k, END_STATE);
  }

  // the chunk again from its carry, out of shared memory; h_all written once
  if (!active) return;
#pragma unroll 8
  for (int j = 0; j < steps; ++j) {
    Wd::unpack(as[j * nt], v);
    Wd::unpack(bs[j * nt], u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) h[i] = fmaf(v[i], h[i], u[i]);
    hw[w0 + static_cast<size_t>(j) * wstride] = Wd::pack(h);
  }
  if (k == nchunks - 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      hf[static_cast<size_t>(bi) * D + ch + i] = h[i];
  }
}

struct Layout {
  int tiles, chunks, groups;
  size_t status_words, bytes;
};

Layout layout(int B, int S, int D, int block_c, int time_chunk) {
  Layout l;
  l.tiles = (D + block_c - 1) / block_c;
  l.chunks = (S + time_chunk - 1) / time_chunk;
  l.groups = (l.chunks + W - 1) / W;
  l.status_words = static_cast<size_t>(B) * l.tiles * (1 + l.chunks);
  const size_t ints = (l.status_words + 3) / 4 * 4;
  const size_t floats = static_cast<size_t>(B) * D *
                        (2 * l.chunks + 2 * (l.chunks / V + 1) + l.groups);
  l.bytes = 4 * (ints + floats);
  return l;
}

template <typename T, int VEC, int TC>
int launch_one(const void* a, const void* b, const void* h0, void* h_all,
               void* hf, int B, int S, int D, int block_c, void* scratch,
               const Layout& l, cudaStream_t stream) {
  int* tickets = static_cast<int*>(scratch);
  int* status = tickets + static_cast<size_t>(B) * l.tiles;
  float* agg = reinterpret_cast<float*>(scratch) + (l.status_words + 3) / 4 * 4;
  float* run = agg + static_cast<size_t>(B) * l.chunks * D * 2;
  float* end = run + static_cast<size_t>(B) * (l.chunks / V + 1) * D * 2;
  const dim3 grid(l.chunks, l.tiles, B);
  const int smem = 2 * TC * block_c * static_cast<int>(sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_chunk_kernel<T, VEC, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rglru_chunk_kernel<T, VEC, TC><<<grid, block_c / VEC, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<T*>(h_all),
      static_cast<float*>(hf), S, D, tickets, status, agg, run, end);
  return static_cast<int>(cudaGetLastError());
}

template <int TC>
int launch_tc(const void* a, const void* b, const void* h0, void* h_all,
              void* hf, int B, int S, int D, int block_c, int bf16,
              void* scratch, const Layout& l, cudaStream_t stream) {
  if (!bf16)
    return launch_one<float, 1, TC>(a, b, h0, h_all, hf, B, S, D, block_c,
                                    scratch, l, stream);
  const bool pairs = D % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(h_all)) % 4) == 0;
  return pairs ? launch_one<__nv_bfloat16, 2, TC>(a, b, h0, h_all, hf, B, S,
                                                  D, block_c, scratch, l,
                                                  stream)
               : launch_one<__nv_bfloat16, 1, TC>(a, b, h0, h_all, hf, B, S,
                                                  D, block_c, scratch, l,
                                                  stream);
}

template <int TC>
cudaError_t attributes_tc(int bf16, cudaFuncAttributes* attr) {
  return bf16 ? cudaFuncGetAttributes(attr,
                                      rglru_chunk_kernel<__nv_bfloat16, 2, TC>)
              : cudaFuncGetAttributes(attr, rglru_chunk_kernel<float, 1, TC>);
}

}  // namespace

extern "C" {

int rglru_scan_group() { return W; }

int rglru_scan_run() { return V; }

// Dynamic shared memory of one block: the chunk's a and b.
int rglru_scan_smem_bytes(int block_c, int time_chunk, int bf16) {
  return 2 * time_chunk * block_c * (bf16 ? 2 : 4);
}

// Bytes of scratch the launch needs (status words, tickets, aggregates and
// end states).
size_t rglru_scan_scratch_bytes(int B, int S, int D, int block_c,
                                int time_chunk) {
  return layout(B, S, D, block_c, time_chunk).bytes;
}

// a, b, h_all: contiguous [B, S, D] of one type (bf16 when bf16 != 0, else
// float32); h0, hf: contiguous float32 [B, D]; scratch: scratch_bytes bytes,
// 16-byte aligned, of any content.  block_c in {64, 128, 256}; time_chunk in
// {16, 32, 64}.
int rglru_scan_launch(const void* a, const void* b, const void* h0,
                      void* h_all, void* hf, int B, int S, int D, int block_c,
                      int time_chunk, int bf16, void* scratch,
                      size_t scratch_bytes, void* stream) {
  if ((block_c != 64 && block_c != 128 && block_c != 256) || B <= 0 ||
      S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(B, S, D, block_c, time_chunk);
  if (scratch_bytes < l.bytes || reinterpret_cast<uintptr_t>(scratch) % 16 ||
      l.tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, 4 * l.status_words, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (time_chunk) {
    case 16: return launch_tc<16>(a, b, h0, h_all, hf, B, S, D, block_c, bf16, scratch, l, s);
    case 32: return launch_tc<32>(a, b, h0, h_all, hf, B, S, D, block_c, bf16, scratch, l, s);
    case 64: return launch_tc<64>(a, b, h0, h_all, hf, B, S, D, block_c, bf16, scratch, l, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int rglru_scan_attributes(int time_chunk, int bf16, int* regs,
                          int* static_smem, int* max_threads) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (time_chunk) {
    case 16: e = attributes_tc<16>(bf16, &attr); break;
    case 32: e = attributes_tc<32>(bf16, &attr); break;
    case 64: e = attributes_tc<64>(bf16, &attr); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *static_smem = static_cast<int>(attr.sharedSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return 0;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
