// Causal or sliding-window prefill attention with GQA, for Hopper (sm_90a).
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] / sqrt(D)) v[b, h / G, j]
//   over the keys j the mask admits: j < S, j <= i (causal), j > i - window
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _flash_kernel).
//
// What bounds it on an H100: at the serving shape (B=1, Hq=32, Hkv=8, D=128,
// S=2,048, causal) it does ~34 GFLOP of products (35 us at the 989 TFLOP/s
// bf16 tensor-core rate) and moves ~42 MB of q/k/v/o (12.5 us at 3.35 TB/s):
// the operations bound it, so bf16 runs on the tensor cores.
//
// bf16: flash_wgmma_kernel, tensor cores fed by TMA.
// * a block has one producer warpgroup (one thread of it issues every load)
//   and BQ / 64 consumer warpgroups, each of which owns 64 query rows.
//   The kv head is qh / (Hq / Hkv).
// * work units (split-KV): a block takes one unit, a q tile and a
//   contiguous chunk of the kv tiles it visits; grid = (B * Hq, units of a
//   head), heads fastest, so that every head's units go out in unit order:
//   the q tiles from the last (under a causal mask, the most kv tiles)
//   down, each tile's chunks in turn.  Where one unit a q tile leaves SMs
//   idle (few heads, short or causal sequences: 48 blocks at paligemma's
//   [1, 8/1, 768, 256], 144 in two waves at whisper's encoder [1, 12/12,
//   1,500, 64] on 132 SMs), split_plan cuts the longest ranges into chunks
//   of at least 2 tiles.  An unsplit tile stores o in bf16; a chunk of a
//   split tile stores its unnormalized float32 accumulator and each row's
//   (m, l) in a workspace, and flash_combine_kernel, launched next on the
//   stream as a programmatic dependent, sums the chunks of each row in a
//   fixed order (replays are bit-equal).
// * the producer loads the Q tile once, then streams K and V tiles of BK
//   keys through a ring of STAGES stages in shared memory with
//   cp.async.bulk.tensor (TMA) over 3-D tensor maps [B * H, S, D], so that
//   a box never crosses a head and rows >= S arrive as zeros.  K runs one
//   tile ahead of V; "full" mbarriers carry the bytes, and "empty" ones
//   (one for K, one for V per stage) return each slot as soon as its
//   product has read it.  Tiles stay bf16 in the swizzled layout wgmma
//   reads: 128-byte swizzle in boxes of 64 columns (D >= 64), 64-byte at
//   D = 32, 32-byte at D = 16.
// * S = Q.K^T is wgmma m64n{BK}k16 with both operands in shared memory
//   (K-major).  The softmax scale (times log2 e, for exp2) is applied to
//   the float32 accumulator after the product; the TPU kernel scales q in
//   float32 first and its float32 jnp.dot runs at the TPU's default
//   precision.  The two orders differ by float32 rounding only, far inside
//   the bf16 tolerance of 2e-2.
// * the online softmax runs on the accumulator fragments in registers: a
//   thread holds two rows, each spread over the 4 lanes of a quad, so a
//   row max is 2 shuffles; the row sum stays per thread until the end, and
//   each score costs one FFMA and one ex2.  Only tiles that cross the
//   causal diagonal, the window's edge or S are masked, with the TPU
//   kernel's finite NEG_INF = -1e30: a row whose keys so far are all
//   masked adds exp(0) = 1 per key, and the first real score wipes that
//   with alpha = exp(-1e30 - m) = 0.  Tiles above the diagonal and tiles
//   wholly below every row's window are never loaded.
// * O += P.V is a second wgmma, m64n{D}k16: P, rounded to bf16, is the
//   register A operand (for 16-bit types the f32 accumulator layout of
//   Q.K^T is the A-fragment layout), V the shared-memory B operand,
//   MN-major with the transpose bit set.  The row sum l is taken over the
//   unrounded p, and o = acc / max(l, 1e-30) in bf16, rows >= S not stored.
// * overlap: a consumer issues S of tile i + 1 and P.V of tile i, then runs
//   the softmax of tile i + 1 while P.V is in flight.  Each product is its
//   own wgmma stage (a wgmma.fence of its own): within one stage ptxas
//   would serialize every wgmma, since the softmax reads S meanwhile.  Two
//   consumer warpgroups take turns issuing (named barriers 1 and 2), so
//   that one's softmax runs while the other's products hold the tensor
//   cores.
// * with two consumer warpgroups (384 threads, 168 registers each at
//   launch), setmaxnreg moves registers from the producer warpgroup (24) to
//   the consumers (240) at D >= 128, where S, P and the output accumulator
//   take 160-192 registers a thread.  setmaxnreg acts on whole warpgroups:
//   a lone producer warp waits in it for three warps that do not exist.
//
// float32: flash_tf32_kernel, split-TF32 (3xTF32) products on the tensor
// cores.  A single TF32 product keeps 10 of float32's 23 mantissa bits and
// misses the float32 tolerance of 2e-5 (tests/test_torch_tf32_split.py); a
// split one does not.  Each operand x is cut into x = hi + lo, hi
// rounded to TF32 to nearest (ties away) and lo = x - hi, and a.b is taken
// as hi_a.hi_b + hi_a.lo_b + lo_a.hi_b in float32 accumulators (lo.lo is
// below float32's rounding), ~21 bits a product.  Three TF32 products run at
// 495 / 3 = 165 TFLOP/s, 2.5x the FP32 CUDA cores.  At the serving shape the
// products bound it (3 x 34 GFLOP: 208 us), not the 84 MB of q/k/v/o.
// * route: wgmma .tf32, as the bf16 body, with the split done where the
//   operand lives.  TF32 wgmma reads a shared-memory operand only K-major,
//   so V (keys x D, the B operand of P.V) is stored transposed, and both
//   halves of each B operand sit in shared memory.  A first version on
//   warp-level mma.sync m16n8k8, which split every fragment in registers
//   from raw float32 tiles (each warp splitting the same K and V again),
//   was tried first and dropped for this one.
// * a block has one producer warpgroup and BQ / 64 consumer warpgroups of 64
//   query rows each; grid = (query tiles, B * Hq), the q tiles with the most
//   kv tiles first.  The producer loads the Q tile once, raw, then for each
//   kv tile reads K and V from global memory (4 pieces of 16 bytes of each
//   in flight a thread), splits them and writes K hi / lo as [BK][D] and V
//   hi / lo transposed as [D][BK], both in the 128-byte swizzle wgmma reads
//   (64-byte for K at D = 16), into a ring of two stages (one where two do
//   not fit beside Q: D = 256, and 64 x 64 at D = 128).  "full" mbarriers
//   (after fence.proxy.async: generic stores read by the async proxy) and
//   "empty" ones hand the stages over.  With two consumer warpgroups,
//   setmaxnreg gives the producer 136 registers and each consumer 184.
// * S = Q.K^T: wgmma m64n{BK}k8 with A (q * scale, split, read from the raw
//   Q tile) in registers, two k8 steps a group in two register sets so that
//   a set is refilled while the other's products run, and B from the ring;
//   q is scaled in float32 before the product, as the TPU kernel does.
// * the S accumulator is the bf16 body's layout, so the float32 body shares
//   its online softmax (softmax_tile: exp2, the same masks and the finite
//   NEG_INF), in float32, with the scale log2(e) alone (q is scaled).  A
//   warpgroup skips a tile whose keys its 64 rows all mask.
// * O += P.V: wgmma m64n{D}k8; the S fragment of 8 keys, split, is the A
//   fragment of one k8 step when lane t's keys (2t, 2t + 1) are its k = t
//   and k = t + 4, so V^T keeps its keys in that order (vt_position).
// * o = acc / max(l, 1e-30), rows >= S not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <functional>
#include <map>
#include <mutex>
#include <queue>
#include <vector>

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int STAGES = 2;           // K/V ring depth
constexpr int SMEM_ALIGN = 1024;    // the 128-byte swizzle repeats every 1 KB
constexpr int BARRIER_BYTES = 128;  // q_full and k/v full/empty per stage

// bytes of dynamic shared memory: the Q tile and STAGES K and V tiles, all
// bf16, the barriers, and room to align the tiles to 1 KB
constexpr size_t wgmma_smem_bytes(int bq, int bk, int d) {
  return 2 * static_cast<size_t>(d) * (bq + 2 * STAGES * bk) + SMEM_ALIGN +
         BARRIER_BYTES;
}

constexpr int PRODUCER_THREADS = 128;   // the producer warpgroup
constexpr int wgmma_threads(int bq) { return bq / 64 * 128 + PRODUCER_THREADS; }

// ---------------------------------------------------------------------------
// bf16 work units (split-KV): a q tile's kv tiles [begin, end) are cut into
// `chunks` contiguous chunks of at least SPLIT_MIN_TILES tiles (the first
// n % chunks one tile longer), one block each.  split_plan (host) picks
// chunk_tiles; kernels/flash_attention.py::split_plan is its twin.
// ---------------------------------------------------------------------------
constexpr int SPLIT_MIN_TILES = 2;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// the kv tiles [begin, end) that q tile qt visits: below the causal
// diagonal, not wholly below the window
__host__ __device__ inline void visit_range(int qt, int S, int bq, int bk,
                                            int causal, int window,
                                            int& begin, int& end) {
  const int q0 = qt * bq;
  const int n_tiles = (S + bk - 1) / bk;
  end = causal ? imin(n_tiles, (q0 + bq + bk - 1) / bk) : n_tiles;
  begin = window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / bk : 0;
}

// chunks of a range of n tiles: ceil(n / chunk_tiles), none below
// SPLIT_MIN_TILES tiles; one where chunk_tiles is 0 (no split) or n fits
__host__ __device__ inline int chunk_count(int n, int chunk_tiles) {
  if (chunk_tiles <= 0 || n <= chunk_tiles) return 1;
  return imin((n + chunk_tiles - 1) / chunk_tiles, n / SPLIT_MIN_TILES);
}

struct WorkUnit {
  int qt;        // q tile
  int begin, n;  // its kv tiles [begin, begin + n)
  int partial;   // index among the (batch, head)'s split chunks; -1 unsplit
};

// unit u of a (batch, head): the q tiles from the last (under a causal mask,
// the one with the most kv tiles) to the first, each tile's chunks in order
__host__ __device__ inline WorkUnit work_unit(int u, int S, int bq, int bk,
                                              int causal, int window,
                                              int chunk_tiles) {
  if (chunk_tiles <= 0) {                      // one unit a q tile
    const int qt = (S + bq - 1) / bq - 1 - u;
    int begin, end;
    visit_range(qt, S, bq, bk, causal, window, begin, end);
    return WorkUnit{qt, begin, end - begin, -1};
  }
  int partial = 0;
  for (int qt = (S + bq - 1) / bq - 1; qt >= 0; --qt) {
    int begin, end;
    visit_range(qt, S, bq, bk, causal, window, begin, end);
    const int n = end - begin, c = chunk_count(n, chunk_tiles);
    if (u < c) {
      const int base = n / c, rem = n % c;
      return WorkUnit{qt, begin + u * base + imin(u, rem),
                      base + (u < rem ? 1 : 0), c > 1 ? partial + u : -1};
    }
    u -= c;
    if (c > 1) partial += c;
  }
  return WorkUnit{0, 0, 0, -1};   // past the last unit: not launched
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// TMA: the box at (c0, c1, c2) of `map` into dst, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (stored in 16-byte units), swizzle (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// named barriers of the two consumer warpgroups' turns (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] += A[64 x 16] B[16 x 16], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "S tile width");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "head width");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// S = Q K^T for one warpgroup's 64 rows: D / 16 steps of 16 columns, both
// operands K-major in shared memory (Q rows at q_wg, K rows at k_st)
template <int D, int BQ, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2],
                                         const __nv_bfloat16* q_wg,
                                         const __nv_bfloat16* k_st) {
  constexpr int CW = D < 64 ? D : 64;
  constexpr uint32_t SWZ = CW == 64 ? 1 : CW == 32 ? 2 : 3;
  constexpr uint32_t SBO = 16 * CW;            // 8 rows of 2 * CW bytes
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = kk * 16 / CW * CW, col = kk * 16 % CW;
    wgmma_ss<BK>(s, smem_desc(q_wg + off * BQ + col, 16, SBO, SWZ),
                 smem_desc(k_st + off * BK + col, 16, SBO, SWZ), kk > 0);
  }
}

// O += P V: BK / 16 steps of 16 keys, P in registers, V MN-major in shared
// memory (its column boxes BK rows apart)
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const __nv_bfloat16* v_st) {
  constexpr int CW = D < 64 ? D : 64;
  constexpr uint32_t SWZ = CW == 64 ? 1 : CW == 32 ? 2 : 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk],
                smem_desc(v_st + kk * 16 * CW, 2 * BK * CW, 16 * CW, SWZ));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one tile's online-softmax step on the S fragments of a thread's two rows
// (qi0, qi0 + 8), in log2 units (scale_log2 = log2(e) / sqrt(D)): fold the
// row max into m and return alpha = exp2(m_old - m_new), and turn s into
// p = exp2(s * scale_log2 - m), its float32 sum folded into l.  A tile on an
// edge is scaled and masked first (NEG_INF); elsewhere the scale rides in
// one FFMA per score (the row max of s times the positive scale is the row
// max of the scaled scores).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool edge, int k0, int qi0, int cq,
                                             int S, int causal, int window,
                                             float scale_log2) {
  float scale = scale_log2;
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int kj = k0 + 8 * (j / 4) + cq + (j & 1);
      const int qi = qi0 + (j & 2 ? 8 : 0);
      const bool ok = kj < S && (!causal || kj <= qi) &&
                      (window <= 0 || kj > qi - window);
      s[j] = ok ? s[j] * scale_log2 : NEG_INF;
    }
    scale = 1.f;
  }
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) mt[(j >> 1) & 1] = fmaxf(mt[(j >> 1) & 1], s[j]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float mn = fmaxf(m[r], mt[r] * scale);
    alpha[r] = fast_exp2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
    neg_m[r] = -mn;
  }
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    s[j] = fast_exp2(fmaf(s[j], scale, neg_m[(j >> 1) & 1]));
    l[(j >> 1) & 1] += s[j];
  }
}

// p (float32 accumulator layout) as the bf16 A fragments of P.V
template <int BK>
__device__ __forceinline__ void pack_p(const float (&p)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 2; j += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[j], p[j + 1]);
    pa[j / 8][j % 8 / 2] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(wgmma_threads(BQ), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ part,
                   int S, int Hq, int Hkv, int causal, int window,
                   float scale_log2, int chunk_tiles, int partials) {
  constexpr int NWG = BQ / 64;                 // consumer warpgroups
  constexpr int CW = D < 64 ? D : 64;          // columns of one swizzle row
  constexpr int Q_ELEMS = BQ * D, KV_ELEMS = BK * D;
  constexpr bool MOVE_REGS = NWG == 2 && D >= 128;   // setmaxnreg

  // [Q: D / CW boxes of BQ x CW][K: STAGES x D / CW boxes of BK x CW][V: same]
  extern __shared__ uint8_t smem_raw[];
  const uintptr_t base =
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
      ~static_cast<uintptr_t>(SMEM_ALIGN - 1);
  auto* qs = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* ks = qs + Q_ELEMS;
  __nv_bfloat16* vs = ks + STAGES * KV_ELEMS;
  auto* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * KV_ELEMS);
  uint64_t* k_full = q_full + 1;               // [STAGES] each
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;                   // b * Hq + qh
  const int b = bh / Hq, qh = bh % Hq;
  const int kv_bh = b * Hkv + qh / (Hq / Hkv);
  const WorkUnit unit = work_unit(blockIdx.y, S, BQ, BK, causal, window,
                                  chunk_tiles);
  const int q0 = unit.qt * BQ;
  const int kt_begin = unit.begin, n_visit = unit.n;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], NWG * 4);         // lane 0 of each consumer warp
      mbar_init(&v_empty[s], NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the combine kernel, launched as a programmatic dependent, may be
  // scheduled once every block has started (it waits for this grid's end)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp >= NWG * 4) {
    // ---- producer: one thread issues every TMA load, K one tile ahead of
    // V (Q.K^T of tile i + 1 runs beside P.V of tile i) ----
    if constexpr (MOVE_REGS) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == NWG * 4 && lane == 0) {
      auto load_k = [&](int i) {
        const int st = i % STAGES;
        mbar_wait(&k_empty[st], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[st], 2 * KV_ELEMS);
#pragma unroll
        for (int c = 0; c < D / CW; ++c)
          tma_load_3d(ks + st * KV_ELEMS + c * BK * CW, &tm_k, &k_full[st],
                      c * CW, (kt_begin + i) * BK, kv_bh);
      };
      mbar_expect_tx(q_full, 2 * Q_ELEMS);
#pragma unroll
      for (int c = 0; c < D / CW; ++c)
        tma_load_3d(qs + c * BQ * CW, &tm_q, q_full, c * CW, q0, bh);
      load_k(0);
      for (int i = 0; i < n_visit; ++i) {
        if (i + 1 < n_visit) load_k(i + 1);
        const int st = i % STAGES;
        mbar_wait(&v_empty[st], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&v_full[st], 2 * KV_ELEMS);
#pragma unroll
        for (int c = 0; c < D / CW; ++c)
          tma_load_3d(vs + st * KV_ELEMS + c * BK * CW, &tm_v, &v_full[st],
                      c * CW, (kt_begin + i) * BK, kv_bh);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64) ----
    if constexpr (MOVE_REGS) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4;
    const int row_lo = q0 + 64 * wg;
    // this thread's rows (qi0, qi0 + 8) and first column of each 8-column block
    const int qi0 = row_lo + 16 * (warp % 4) + lane / 4;
    const int cq = 2 * (lane % 4);
    const __nv_bfloat16* q_wg = qs + 64 * wg * CW;
    // whether tile kt has a key the mask removes for one of these 64 rows
    auto edge = [&](int k0) {
      return k0 + BK > S || (causal && k0 + BK - 1 > row_lo) ||
             (window > 0 && k0 <= row_lo + 63 - window);
    };
    // with two consumer warpgroups, they take turns issuing their products
    // (named barriers 1 and 2), so that one's softmax runs while the other's
    // products hold the tensor cores; warpgroup 1 lets warpgroup 0 go first
    // and skips its last hand-over, so every arrival is awaited
    auto turn_begin = [&]() {
      if constexpr (NWG == 2) bar_sync(1 + wg, 256);
    };
    auto turn_end = [&](bool last) {
      if constexpr (NWG == 2)
        if (!(last && wg == 1)) bar_arrive(2 - wg, 256);
    };
    if (NWG == 2 && wg == 1) bar_arrive(1, 256);

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    float s[BK / 2];
    uint32_t pa[BK / 16][4];

    // tile 0: S, then p
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    turn_begin();
    fence_regs(s);
    wgmma_fence();
    issue_qk<D, BQ, BK>(s, q_wg, ks);
    wgmma_commit();
    turn_end(false);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&k_empty[0]);
    softmax_tile<BK>(s, m, l, alpha, edge(kt_begin * BK), kt_begin * BK, qi0,
                     cq, S, causal, window, scale_log2);
    pack_p<BK>(s, pa);

    // tile i < last: issue S of tile i + 1, then O += P V of tile i, each
    // product its own wgmma stage (a fence of its own), so that the softmax
    // of tile i + 1 runs on S while P V is in flight
    for (int i = 0; i + 1 < n_visit; ++i) {
      const int st = i % STAGES, sn = (i + 1) % STAGES;
      const int k0n = (kt_begin + i + 1) * BK;
      mbar_wait(&k_full[sn], ((i + 1) / STAGES) & 1);
      mbar_wait(&v_full[st], (i / STAGES) & 1);
      turn_begin();
      fence_regs(s);
      wgmma_fence();
      issue_qk<D, BQ, BK>(s, q_wg, ks + sn * KV_ELEMS);
      wgmma_commit();
      fence_regs(s);
      fence_regs(acc);
      wgmma_fence();
      issue_pv<D, BK>(acc, pa, vs + st * KV_ELEMS);
      wgmma_commit();
      fence_regs(acc);
      turn_end(false);
      wgmma_wait<1>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(&k_empty[sn]);
      softmax_tile<BK>(s, m, l, alpha, edge(k0n), k0n, qi0, cq, S, causal,
                       window, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&v_empty[st]);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      pack_p<BK>(s, pa);
    }
    // the last tile's P V
    {
      const int st = (n_visit - 1) % STAGES;
      mbar_wait(&v_full[st], ((n_visit - 1) / STAGES) & 1);
      turn_begin();
      fence_regs(acc);
      wgmma_fence();
      issue_pv<D, BK>(acc, pa, vs + st * KV_ELEMS);
      wgmma_commit();
      turn_end(true);
      wgmma_wait<0>();
      fence_regs(acc);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (unit.partial < 0) {
      float den[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) den[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 2; j += 2) {
        const int r = (j >> 1) & 1;
        const int qi = qi0 + 8 * r;
        if (qi < S) {
          const size_t at = (static_cast<size_t>(bh) * S + qi) * D + 8 * (j / 4) + cq;
          *reinterpret_cast<__nv_bfloat162*>(o + at) =
              __floats2bfloat162_rn(acc[j] / den[r], acc[j + 1] / den[r]);
        }
      }
    } else {
      // a chunk of a split q tile: its unnormalized float32 accumulator and
      // each row's (m, l), m in log2 units, for flash_combine_kernel
      const size_t slot = static_cast<size_t>(bh) * partials + unit.partial;
      float* pacc = part + slot * BQ * D;
      float* pml = part + static_cast<size_t>(gridDim.x) * partials * BQ * D +
                   slot * BQ * 2;
#pragma unroll
      for (int j = 0; j < D / 2; j += 2) {
        const int qi = qi0 + 8 * ((j >> 1) & 1);
        if (qi < S)
          *reinterpret_cast<float2*>(pacc + (qi - q0) * D + 8 * (j / 4) + cq) =
              make_float2(acc[j], acc[j + 1]);
      }
      if (lane % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = qi0 + 8 * r;
          if (qi < S)
            *reinterpret_cast<float2*>(pml + (qi - q0) * 2) = make_float2(m[r], l[r]);
        }
      }
    }
  }
}

// o of the split q tiles.  Per row, over its tile's chunks c in order:
// M = max_c m_c, w_c = 2^(m_c - M), o = sum_c w_c acc_c / max(sum_c w_c l_c,
// 1e-30) in float32, rounded to bf16 once.  A chunk whose keys the mask
// removes for the row kept m_c = NEG_INF, so its weight is 2^(NEG_INF - M)
// = 0.  A thread takes COLS columns of one row (8 from D = 64: two 16-byte
// loads a chunk), a block ROWS rows of one tile; a thread issues the loads
// of its first COMBINE_HELD chunks before it uses any, and it is a bytes-
// bound pass: the partials read once, o's rows written once.  Launched as
// a programmatic dependent of flash_wgmma_kernel: it waits for that grid's
// end (griddepcontrol.wait) before it reads a partial.
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_HELD = 4;                 // chunks a thread holds

template <int D>
struct CombineShape {
  static constexpr int COLS = D >= 64 ? 8 : 4;  // columns a thread
  static constexpr int TPR = D / COLS;          // threads a row
  static constexpr int ROWS = COMBINE_THREADS / TPR;   // divides 64
};

template <int D>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_combine_kernel(const float* __restrict__ part,
                     __nv_bfloat16* __restrict__ o, int S, int bq, int bk,
                     int causal, int window, int chunk_tiles, int partials) {
  constexpr int COLS = CombineShape<D>::COLS, TPR = CombineShape<D>::TPR;
  constexpr int ROWS = CombineShape<D>::ROWS, V4 = COLS / 4;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int groups = bq / ROWS;
  const int bh = blockIdx.y;
  const int row = blockIdx.x % groups * ROWS + threadIdx.x / TPR;
  const int col = threadIdx.x % TPR * COLS;
  // the (blockIdx.x / groups)-th split q tile, in work_unit's order
  int skip = blockIdx.x / groups, partial = 0, chunks = 1, qt;
  for (qt = (S + bq - 1) / bq - 1; qt >= 0; --qt) {
    int begin, end;
    visit_range(qt, S, bq, bk, causal, window, begin, end);
    chunks = chunk_count(end - begin, chunk_tiles);
    if (chunks == 1) continue;
    if (skip == 0) break;
    --skip;
    partial += chunks;
  }
  const int qi = qt * bq + row;
  if (qt < 0 || qi >= S) return;
  const size_t slot = static_cast<size_t>(bh) * partials + partial;
  const float4* pacc =
      reinterpret_cast<const float4*>(part + (slot * bq + row) * D + col);
  const float2* pml = reinterpret_cast<const float2*>(
      part + static_cast<size_t>(gridDim.y) * partials * bq * D) +
      slot * bq + row;
  const size_t acc_step = static_cast<size_t>(bq) * D / 4;   // chunk c + 1
  float2 ml[COMBINE_HELD];
  float4 x[COMBINE_HELD][V4];
#pragma unroll
  for (int c = 0; c < COMBINE_HELD; ++c) {
    if (c < chunks) {
      ml[c] = pml[c * bq];
#pragma unroll
      for (int v = 0; v < V4; ++v) x[c][v] = pacc[c * acc_step + v];
    }
  }
  float mx = NEG_INF;
#pragma unroll
  for (int c = 0; c < COMBINE_HELD; ++c)
    if (c < chunks) mx = fmaxf(mx, ml[c].x);
  for (int c = COMBINE_HELD; c < chunks; ++c) mx = fmaxf(mx, pml[c * bq].x);
  float l = 0.f, a[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) a[j] = 0.f;
  auto add = [&](float2 m_l, const float4 (&xc)[V4]) {
    const float w = exp2f(m_l.x - mx);
    l = fmaf(w, m_l.y, l);
#pragma unroll
    for (int v = 0; v < V4; ++v) {
      a[4 * v] = fmaf(w, xc[v].x, a[4 * v]);
      a[4 * v + 1] = fmaf(w, xc[v].y, a[4 * v + 1]);
      a[4 * v + 2] = fmaf(w, xc[v].z, a[4 * v + 2]);
      a[4 * v + 3] = fmaf(w, xc[v].w, a[4 * v + 3]);
    }
  };
#pragma unroll
  for (int c = 0; c < COMBINE_HELD; ++c)
    if (c < chunks) add(ml[c], x[c]);
  for (int c = COMBINE_HELD; c < chunks; ++c) {
    float4 xc[V4];
#pragma unroll
    for (int v = 0; v < V4; ++v) xc[v] = pacc[c * acc_step + v];
    add(pml[c * bq], xc);
  }
  const float den = fmaxf(l, 1e-30f);
  uint32_t packed[COLS / 2];
#pragma unroll
  for (int j = 0; j < COLS; j += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a[j] / den, a[j + 1] / den);
    packed[j / 2] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __nv_bfloat16* out = o + (static_cast<size_t>(bh) * S + qi) * D + col;
  if constexpr (COLS == 8)
    *reinterpret_cast<uint4*>(out) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  else
    *reinterpret_cast<uint2*>(out) = make_uint2(packed[0], packed[1]);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 [heads, S, d] tensor in boxes of `rows` rows by min(d, 64) columns,
// swizzled as wgmma reads them
int make_map(CUtensorMap* map, const void* ptr, int heads, int S, int d,
             int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int cw = d < 64 ? d : 64;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {2ull * d, 2ull * d * S};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cw),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// the split plan (host; kernels/flash_attention.py::split_plan is its twin,
// and _lib() holds the two equal).  A block per (batch x head, unit); units
// are dispatched head-fastest (grid.x = B * Hq), so that every head's
// longest units go first.  The plan simulates that dispatch onto n_sm x
// ctas_per_sm slots, each unit to the slot free first: a unit of n kv tiles
// costs 250 + BQ * D / 4 ns (its Q tile's load, its output's store) plus n
// tiles of BQ * BK * (D + 64) / 1500 ns (the products, and the softmax as
// much as 64 columns more), and a split adds the combine, 1,000 ns plus
// the partials' float32 bytes at 2,500 bytes a ns.  The constants are a fit
// to every cut of rows 3, 3b, 3p and 3w of PERF.md on an H100 (split +
// combine as graph replays, tools/flash_split_probe.py --sweep): the fit
// that picks each row's fastest measured cut within 2%.  No split where
// the one-unit-a-q-tile grid fills SPLIT_NO_SPLIT_WAVES waves; chunk_tiles
// falls from the longest range down to SPLIT_MIN_TILES while the units
// stay within SPLIT_MAX_WAVES waves; the least estimate wins, the longer
// chunks on a tie.  All integer arithmetic, so that C and Python agree.
// ---------------------------------------------------------------------------
constexpr int SPLIT_NO_SPLIT_WAVES = 4;
constexpr int SPLIT_MAX_WAVES = 16;
constexpr long long SPLIT_COMBINE_NS = 1000;
constexpr long long SPLIT_BYTES_PER_NS = 2500;

struct SplitPlan {
  int chunk_tiles;   // 0: one unit a q tile
  int units;         // blocks of one (batch, head)
  int partials;      // chunks of split q tiles, one (batch, head)
  int split_tiles;   // q tiles cut into more than one chunk, one (batch, head)
};

// what cutting the ranges at chunk_tiles gives one (batch, head)
SplitPlan split_counts(int S, int bq, int bk, int causal, int window,
                       int chunk_tiles) {
  SplitPlan p{chunk_tiles, 0, 0, 0};
  for (int qt = (S + bq - 1) / bq - 1; qt >= 0; --qt) {
    int begin, end;
    visit_range(qt, S, bq, bk, causal, window, begin, end);
    const int c = chunk_count(end - begin, chunk_tiles);
    p.units += c;
    if (c > 1) {
      p.partials += c;
      ++p.split_tiles;
    }
  }
  return p;
}

long long split_unit_ns(int bq, int d) {
  return 250 + static_cast<long long>(bq) * d / 4;
}

long long split_tile_ns(int bq, int bk, int d) {
  return static_cast<long long>(bq) * bk * (d + 64) / 1500;
}

// the last finish time of `sizes` (a head's units in order, in kv tiles)
// dispatched head-fastest for bh heads onto `slots` identical slots, each
// unit to the slot free first
long long schedule_ns(int bh, const int* sizes, int n_units, int slots,
                      long long unit_ns, long long tile_ns) {
  std::priority_queue<long long, std::vector<long long>,
                      std::greater<long long>> free_at;
  for (int i = 0; i < slots; ++i) free_at.push(0);
  long long last = 0;
  for (int u = 0; u < n_units; ++u)
    for (int h = 0; h < bh; ++h) {
      const long long t = free_at.top() + unit_ns + sizes[u] * tile_ns;
      free_at.pop();
      free_at.push(t);
      last = t > last ? t : last;
    }
  return last;
}

SplitPlan compute_split_plan(int bh, int S, int d, int bq, int bk, int causal,
                             int window, int n_sm, int ctas_per_sm) {
  const int n_qt = (S + bq - 1) / bq;
  const int slots = n_sm * ctas_per_sm;
  std::vector<int> ranges;                     // kv tiles, in unit order
  for (int qt = n_qt - 1; qt >= 0; --qt) {
    int begin, end;
    visit_range(qt, S, bq, bk, causal, window, begin, end);
    ranges.push_back(end - begin);
  }
  SplitPlan best{0, n_qt, 0, 0};
  if (static_cast<long long>(bh) * n_qt >=
      static_cast<long long>(SPLIT_NO_SPLIT_WAVES) * slots)
    return best;
  const long long unit_ns = split_unit_ns(bq, d);
  const long long tile_ns = split_tile_ns(bq, bk, d);
  long long best_ns =
      schedule_ns(bh, ranges.data(), n_qt, slots, unit_ns, tile_ns);
  int longest = 0;
  for (int n : ranges) longest = n > longest ? n : longest;
  std::vector<int> sizes;
  for (int t = longest - 1; t >= SPLIT_MIN_TILES; --t) {
    sizes.clear();
    for (int n : ranges) {
      const int c = chunk_count(n, t);
      for (int i = 0; i < c; ++i) sizes.push_back(n / c + (i < n % c ? 1 : 0));
    }
    const SplitPlan p = split_counts(S, bq, bk, causal, window, t);
    if (static_cast<long long>(bh) * p.units >
        static_cast<long long>(SPLIT_MAX_WAVES) * slots)
      break;
    if (p.partials == 0) continue;
    const long long bytes =
        static_cast<long long>(bh) * p.partials * bq * (d + 2) * 4;
    const long long ns =
        schedule_ns(bh, sizes.data(), p.units, slots, unit_ns, tile_ns) +
        SPLIT_COMBINE_NS + bytes / SPLIT_BYTES_PER_NS;
    if (ns < best_ns) {
      best_ns = ns;
      best = p;
    }
  }
  return best;
}

// the plan, memoized: it runs on every launch
SplitPlan split_plan_cached(int bh, int S, int d, int bq, int bk, int causal,
                            int window, int n_sm, int ctas_per_sm) {
  using Key = std::array<int, 9>;
  static std::mutex lock;
  static std::map<Key, SplitPlan> plans;
  const Key key{bh, S, d, bq, bk, causal, window, n_sm, ctas_per_sm};
  {
    std::lock_guard<std::mutex> g(lock);
    const auto it = plans.find(key);
    if (it != plans.end()) return it->second;
  }
  const SplitPlan p =
      compute_split_plan(bh, S, d, bq, bk, causal, window, n_sm, ctas_per_sm);
  std::lock_guard<std::mutex> g(lock);
  if (plans.size() >= 4096) plans.clear();
  plans.emplace(key, p);
  return p;
}

template <int D, int BQ, int BK>
cudaError_t prepare_wgmma() {
  return cudaFuncSetAttribute(
      flash_wgmma_kernel<D, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(wgmma_smem_bytes(BQ, BK, D)));
}

// blocks of the instance an SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once a device
template <int D, int BQ, int BK>
int wgmma_ctas_per_sm(int* ctas) {
  static std::mutex lock;
  static std::map<int, int> known;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> g(lock);
  const auto it = known.find(dev);
  if (it != known.end()) {
    *ctas = it->second;
    return 0;
  }
  e = prepare_wgmma<D, BQ, BK>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, flash_wgmma_kernel<D, BQ, BK>, wgmma_threads(BQ),
        wgmma_smem_bytes(BQ, BK, D));
  if (e == cudaSuccess) known[dev] = *ctas;
  return static_cast<int>(e);
}

// SMs of the current device, asked once a device
int device_sms(int* n_sm) {
  static std::mutex lock;
  static std::map<int, int> sms;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> g(lock);
  const auto it = sms.find(dev);
  if (it != sms.end()) {
    *n_sm = it->second;
    return 0;
  }
  e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) sms[dev] = *n_sm;
  return static_cast<int>(e);
}

// the split kernel with chunk_tiles (0: one unit a q tile); ws holds
// ws_floats float32 words, at least what the schedule's partials take
template <int D, int BQ, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int S, int causal, int window, float scale,
                 int chunk_tiles, float* ws, long long ws_floats,
                 cudaStream_t stream) {
  const int bh = B * Hq;
  const SplitPlan p = split_counts(S, BQ, BK, causal, window, chunk_tiles);
  if (p.units > 65535 ||
      static_cast<long long>(bh) * p.partials * BQ * (D + 2) > ws_floats ||
      (p.partials > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, B * Hq, S, D, BQ);
  if (e == 0) e = make_map(&tk, k, B * Hkv, S, D, BK);
  if (e == 0) e = make_map(&tv, v, B * Hkv, S, D, BK);
  if (e != 0) return e;
  const cudaError_t a = prepare_wgmma<D, BQ, BK>();
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid(bh, p.units);
  flash_wgmma_kernel<D, BQ, BK>
      <<<grid, wgmma_threads(BQ), wgmma_smem_bytes(BQ, BK, D), stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), ws, S, Hq, Hkv, causal,
          window, scale * 1.4426950408889634f, chunk_tiles, p.partials);
  return static_cast<int>(cudaGetLastError());
}

// the combine of a split launch with chunk_tiles, as a programmatic
// dependent of it on the same stream (its launch overlaps the split grid's
// tail)
template <int D>
int launch_combine(const float* ws, void* o, int B, int Hq, int S, int bq,
                   int bk, int causal, int window, int chunk_tiles,
                   cudaStream_t stream) {
  const SplitPlan p = split_counts(S, bq, bk, causal, window, chunk_tiles);
  if (p.split_tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split_tiles * (bq / CombineShape<D>::ROWS), B * Hq);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_combine_kernel<D>, ws, static_cast<__nv_bfloat16*>(o), S,
      bq, bk, causal, window, chunk_tiles, p.partials));
}

// ---------------------------------------------------------------------------
// float32: wgmma .tf32 on split operands
// ---------------------------------------------------------------------------
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory of a block
// setmaxnreg with two consumer warpgroups: the block holds 168 registers a
// thread from its launch, 64,512 in all, and moves them from the producer
// to the consumers (136 * 128 + 184 * 256 = 64,512); an increase the pool
// cannot grant waits forever.  The producer's address arithmetic needs the
// 136: at 104 and 72 it spilled, and the kernel ran 1.29x and 1.60x slower
// at [1, 32/8, 2,048, 128] (tools/flash_f32_probe.py)
constexpr int TF32_PRODUCER_REGS = 136;
constexpr int TF32_CONSUMER_REGS = 184;

// Q rows in shared memory: D + 4 floats apart, so that lanes (g, t) reading
// column t of row g hit 32 distinct banks
__host__ __device__ constexpr int tf32_ldq(int d) { return d + 4; }

// bytes of one K/V stage: K hi, K lo, V^T hi, V^T lo, each [BK x D] float32
__host__ __device__ constexpr size_t tf32_stage_bytes(int bk, int d) {
  return 16 * static_cast<size_t>(bk) * d;
}

__host__ __device__ constexpr size_t tf32_smem_with(int bq, int bk, int d, int stages) {
  return stages * tf32_stage_bytes(bk, d) +
         4 * static_cast<size_t>(bq) * tf32_ldq(d) + SMEM_ALIGN + BARRIER_BYTES;
}

// the K/V ring: two stages where they fit beside the Q tile, else one
__host__ __device__ constexpr int tf32_stages(int bq, int bk, int d) {
  return tf32_smem_with(bq, bk, d, 2) <= SMEM_LIMIT ? 2 : 1;
}

// bytes of dynamic shared memory: the K/V ring, the raw Q tile, the
// barriers, and room to align the ring to 1 KB
constexpr size_t tf32_smem_bytes(int bq, int bk, int d) {
  return tf32_smem_with(bq, bk, d, tf32_stages(bq, bk, d));
}

// mbar_wait that traps after 2^22 polls: a broken invariant fails the
// launch instead of hanging the card
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, int parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 22)) asm volatile("trap;");
  }
}

// byte offset `off` within a tile, as the wgmma swizzle of WIDTH-byte rows
// places it (128: Swizzle<3,4,3>, 64: Swizzle<2,4,3>: the 16-byte chunk
// index XOR the row's low bits); the tile starts on a 1 KB boundary
template <int WIDTH>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t MASK = WIDTH == 128 ? 7 : 3;
  return off ^ (((off >> 7) & MASK) << 4);
}

// x = hi + lo: hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero: add half of TF32's last place to the bits,
// then clear the 13 bits below it), lo = x - hi, exact in float32.  The
// tensor cores read the top 19 bits of a .tf32 operand, so lo enters its
// products truncated to TF32 (CUTLASS's 3xTF32 rounds its small part the
// same way).  cvt.rna itself lowers to the same add plus a guard for Inf and
// NaN (FSETP, SEL) that the split does not need.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(const float4& x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// D[64 x 16] (+)= A[64 x 8] B[8 x 16] in TF32, A from registers, B from
// shared memory (K-major)
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 8] B[8 x 32] in TF32, A from registers, B from
// shared memory (K-major)
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] in TF32, A from registers, B from
// shared memory (K-major)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128] in TF32, A from registers, B from
// shared memory (K-major)
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 256] (+)= A[64 x 8] B[8 x 256] in TF32, A from registers, B from
// shared memory (K-major)
__device__ __forceinline__ void wgmma_tf32_n256(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256, "N");
  if constexpr (N == 16) wgmma_tf32_n16(d, a, db, accumulate);
  else if constexpr (N == 32) wgmma_tf32_n32(d, a, db, accumulate);
  else if constexpr (N == 64) wgmma_tf32_n64(d, a, db, accumulate);
  else if constexpr (N == 128) wgmma_tf32_n128(d, a, db, accumulate);
  else wgmma_tf32_n256(d, a, db, accumulate);
}

// the key of position p (0..7) of an 8-key block of V^T: P's A fragment
// holds keys (2t, 2t + 1) of lane t as its k = t and k = t + 4
__device__ __forceinline__ int vt_position(int key) {
  const int r = key % 8;
  return key - r + (r % 2 ? 4 + r / 2 : r / 2);
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 64 * 128 + 128, 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S,
                  int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int NWG = BQ / 64;                 // consumer warpgroups
  constexpr int STG = tf32_stages(BQ, BK, D);
  constexpr int LDQ = tf32_ldq(D);
  constexpr int KW = D < 32 ? 64 : 128;        // K's swizzle row, bytes
  constexpr int KCOLS = KW / 4;                // floats in a K swizzle row
  constexpr int TILE = BK * D;                 // floats of one split tile
  constexpr int PIECES = TILE / 4 / 128;       // float4 of K (and V) a producer thread
  constexpr int BATCH = PIECES < 4 ? PIECES : 4;

  // [STG x (K hi, K lo, V^T hi, V^T lo)][Q: BQ x LDQ][barriers]
  extern __shared__ uint8_t smem_raw[];
  const uintptr_t base =
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
      ~static_cast<uintptr_t>(SMEM_ALIGN - 1);
  auto* ring = reinterpret_cast<float*>(base);
  float* qs = ring + STG * 4 * TILE;
  auto* q_full = reinterpret_cast<uint64_t*>(qs + BQ * LDQ);
  uint64_t* full = q_full + 1;                 // [STG] each
  uint64_t* empty = full + STG;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;                   // b * Hq + qh
  const int b = bh / Hq, qh = bh % Hq;
  const size_t q_base = static_cast<size_t>(bh) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + qh / (Hq / Hkv)) * S * D;
  const int n_tiles = (S + BK - 1) / BK;
  const int kt_end = causal ? min(n_tiles, (q0 + BQ + BK - 1) / BK) : n_tiles;
  const int kt_begin =
      window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / BK : 0;
  const int n_visit = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 128);
    for (int s = 0; s < STG; ++s) {
      mbar_init(&full[s], 128);                // every producer thread
      mbar_init(&empty[s], NWG * 4);           // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    // ---- producer: loads Q once, then splits each K and V tile into the
    // ring: K hi / lo as [BK rows][D] and V hi / lo transposed, [D rows][BK
    // keys] in vt_position order, both K-major in the swizzle wgmma reads ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(TF32_PRODUCER_REGS));
    const int tid = threadIdx.x - NWG * 128;
    for (int p = tid; p < BQ * D / 4; p += 128) {
      const int r = p / (D / 4), c = p % (D / 4) * 4;
      const float4 x = q0 + r < S
          ? __ldg(reinterpret_cast<const float4*>(q + q_base + static_cast<size_t>(q0 + r) * D + c))
          : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(qs + r * LDQ + c) = x;
    }
    mbar_arrive(q_full);
    for (int i = 0; i < n_visit; ++i) {
      const int st = i % STG;
      const int k0 = (kt_begin + i) * BK;
      const uint32_t kh = smem_u32(ring + st * 4 * TILE);
      const uint32_t kl = kh + 4 * TILE, vh = kl + 4 * TILE, vl = vh + 4 * TILE;
      mbar_wait_or_trap(&empty[st], ((i / STG) & 1) ^ 1);
      // BATCH pieces of K and of V in flight at a time.  K: a warp takes 16-
      // byte pieces of consecutive columns of a row, stored whole.  V: a warp
      // takes 8 keys by 4 pieces of 4 columns, so that its transposed 4-byte
      // stores spread over the banks
#pragma unroll
      for (int u0 = 0; u0 < PIECES; u0 += BATCH) {
        float4 xk[BATCH], xv[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int p = tid + 128 * (u0 + u);
          const int rk = p / (D / 4), ck = p % (D / 4) * 4;
          const int rv = p / (2 * D) * 8 + p % 8, cv = p / 8 % (D / 4) * 4;
          xk[u] = k0 + rk < S
              ? __ldg(reinterpret_cast<const float4*>(k + kv_base + static_cast<size_t>(k0 + rk) * D + ck))
              : make_float4(0.f, 0.f, 0.f, 0.f);
          xv[u] = k0 + rv < S
              ? __ldg(reinterpret_cast<const float4*>(v + kv_base + static_cast<size_t>(k0 + rv) * D + cv))
              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int p = tid + 128 * (u0 + u);
          const int rk = p / (D / 4), ck = p % (D / 4) * 4;
          const int rv = p / (2 * D) * 8 + p % 8, cv = p / 8 % (D / 4) * 4;
          uint4 hi, lo;
          split_tf32(xk[u], hi, lo);
          const uint32_t off = swizzle<KW>(ck / KCOLS * (BK * KW) + rk * KW + ck % KCOLS * 4);
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                       :: "r"(kh + off), "r"(hi.x), "r"(hi.y), "r"(hi.z), "r"(hi.w) : "memory");
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                       :: "r"(kl + off), "r"(lo.x), "r"(lo.y), "r"(lo.z), "r"(lo.w) : "memory");
          split_tf32(xv[u], hi, lo);
          // lanes whose pieces lie 8 columns apart write their columns in
          // orders 2 apart, so that the 32 stores of a warp hit 32 banks
          const bool turn = cv & 8;
          const uint32_t h[4] = {turn ? hi.z : hi.x, turn ? hi.w : hi.y,
                                 turn ? hi.x : hi.z, turn ? hi.y : hi.w};
          const uint32_t l[4] = {turn ? lo.z : lo.x, turn ? lo.w : lo.y,
                                 turn ? lo.x : lo.z, turn ? lo.y : lo.w};
          const int col = vt_position(rv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = cv + (turn ? (e + 2) % 4 : e);
            const uint32_t at = swizzle<128>(col / 32 * (D * 128) + row * 128 + col % 32 * 4);
            asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(vh + at), "r"(h[e]) : "memory");
            asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(vl + at), "r"(l[e]) : "memory");
          }
        }
      }
      // the stores are read by wgmma, through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[st]);
    }
  } else {
    // ---- consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64) ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(TF32_CONSUMER_REGS));
    const int wg = warp / 4;
    const int row_lo = q0 + 64 * wg;
    const int g = lane / 4, t = lane % 4;
    const int qi0 = row_lo + 16 * (warp % 4) + g;
    const float* q_lane = qs + (qi0 - q0) * LDQ + t;

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

    mbar_wait_or_trap(q_full, 0);
    for (int i = 0; i < n_visit; ++i) {
      const int st = i % STG;
      const int k0 = (kt_begin + i) * BK;
      mbar_wait_or_trap(&full[st], (i / STG) & 1);
      const float* kh = ring + st * 4 * TILE;
      const float* kl = kh + TILE;
      const float* vh = kl + TILE;
      const float* vl = vh + TILE;
      // a tile whose keys all lie above the diagonal or below the window
      // for all 64 rows changes none of the warpgroup's sums
      const bool skip = (causal && k0 > row_lo + 63) ||
                        (window > 0 && k0 + BK - 1 <= row_lo - window);
      if (!skip) {
        // S = (q * scale) K^T: D / 8 k8 steps, three products each; the A
        // fragments of two steps at a time, in two register sets
        float s[BK / 2];
        uint32_t ah[2][2][4], al[2][2][4];     // [set][step][a0..a3]
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const int set = c % 2;
          if (c >= 2) {
            wgmma_wait<1>();                   // the set's last products are done
            fence_regs(s);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* qp = q_lane + 16 * c + 8 * h;
            split_tf32(qp[0] * scale, ah[set][h][0], al[set][h][0]);
            split_tf32(qp[8 * LDQ] * scale, ah[set][h][1], al[set][h][1]);
            split_tf32(qp[4] * scale, ah[set][h][2], al[set][h][2]);
            split_tf32(qp[8 * LDQ + 4] * scale, ah[set][h][3], al[set][h][3]);
          }
          fence_regs(s);
          wgmma_fence();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kk = 2 * c + h;
            const int at = kk * 8 / KCOLS * (BK * KCOLS) + kk * 8 % KCOLS;
            const uint64_t dh = smem_desc(kh + at, 16, 8 * KW, KW == 128 ? 1 : 2);
            const uint64_t dl = smem_desc(kl + at, 16, 8 * KW, KW == 128 ? 1 : 2);
            wgmma_tf32<BK>(s, al[set][h], dh, kk > 0);
            wgmma_tf32<BK>(s, ah[set][h], dl, 1);
            wgmma_tf32<BK>(s, ah[set][h], dh, 1);
          }
          wgmma_commit();
          fence_regs(s);
        }
        wgmma_wait<0>();
        fence_regs(s);

        const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > row_lo) ||
                          (window > 0 && k0 <= row_lo + 63 - window);
        softmax_tile<BK>(s, m, l, alpha, edge, k0, qi0, 2 * t, S, causal,
                         window, 1.4426950408889634f);
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];

        // O += P V: BK / 8 k8 steps; the S fragment of 8 keys is the A
        // fragment of its step with keys (2t, 2t + 1) as k = (t, t + 4)
        uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          split_tf32(s[4 * j], ph[j][0], pl[j][0]);
          split_tf32(s[4 * j + 2], ph[j][1], pl[j][1]);
          split_tf32(s[4 * j + 1], ph[j][2], pl[j][2]);
          split_tf32(s[4 * j + 3], ph[j][3], pl[j][3]);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int at = j * 8 / 32 * (D * 32) + j * 8 % 32;
          const uint64_t dh = smem_desc(vh + at, 16, 1024, 1);
          const uint64_t dl = smem_desc(vl + at, 16, 1024, 1);
          wgmma_tf32<D>(acc, pl[j], dh, 1);
          wgmma_tf32<D>(acc, ph[j], dl, 1);
          wgmma_tf32<D>(acc, ph[j], dh, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int r = (j >> 1) & 1;
      const int qi = qi0 + 8 * r;
      if (qi < S)
        *reinterpret_cast<float2*>(o + q_base + static_cast<size_t>(qi) * D +
                                   8 * (j / 4) + 2 * t) =
            make_float2(acc[j] / den[r], acc[j + 1] / den[r]);
    }
  }
}

// every (head width, block_q, block_k) the float32 kernel is built for:
// block_q in {64, 128}, block_k in {32, 64}, where the ring (two stages, else
// one) and the Q tile fit shared memory and the consumers' accumulators,
// P's fragments and two sets of Q's fit their registers (not 128 x 64 at D
// = 128, where they would take ~220 of 208)
#define TF32_INSTANCES(X)                                            \
  X(16, 64, 32) X(16, 64, 64) X(16, 128, 32) X(16, 128, 64)          \
  X(32, 64, 32) X(32, 64, 64) X(32, 128, 32) X(32, 128, 64)          \
  X(64, 64, 32) X(64, 64, 64) X(64, 128, 32) X(64, 128, 64)          \
  X(128, 64, 32) X(128, 64, 64) X(128, 128, 32) X(256, 64, 32)

bool tf32_instance(int d, int bq, int bk) {
#define X(D_, BQ_, BK_) if (d == D_ && bq == BQ_ && bk == BK_) return true;
  TF32_INSTANCES(X)
#undef X
  return false;
}

template <int D, int BQ, int BK>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int S, int causal, int window, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = tf32_smem_bytes(BQ, BK, D);
  static_assert(smem <= SMEM_LIMIT, "the tiles exceed shared memory");
  const cudaError_t a = cudaFuncSetAttribute(
      flash_tf32_kernel<D, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid((S + BQ - 1) / BQ, B * Hq);
  flash_tf32_kernel<D, BQ, BK><<<grid, BQ / 64 * 128 + 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq, Hkv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// every (head width, block_q, block_k) the bf16 kernel is built for: block_q
// and block_k in {64, 128} where the tiles fit (not D = 256 with block_k 128)
#define WGMMA_INSTANCES(X)                                           \
  X(16, 64, 64) X(16, 64, 128) X(16, 128, 64) X(16, 128, 128)        \
  X(32, 64, 64) X(32, 64, 128) X(32, 128, 64) X(32, 128, 128)        \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128)        \
  X(128, 64, 64) X(128, 64, 128) X(128, 128, 64) X(128, 128, 128)    \
  X(256, 64, 64) X(256, 128, 64)

bool wgmma_instance(int d, int bq, int bk) {
#define X(D_, BQ_, BK_) if (d == D_ && bq == BQ_ && bk == BK_) return true;
  WGMMA_INSTANCES(X)
#undef X
  return false;
}

}  // namespace

extern "C" {

// threads of one block (the consumer warpgroups and the producer
// warpgroup), or -1 where no kernel is built for the point
int flash_attention_threads(int block_q, int block_k, int d, int bf16) {
  if (bf16) return wgmma_instance(d, block_q, block_k) ? wgmma_threads(block_q) : -1;
  return tf32_instance(d, block_q, block_k) ? wgmma_threads(block_q) : -1;
}

// dynamic shared memory of one block, or -1 where no kernel is built
long long flash_attention_smem_bytes(int block_q, int block_k, int d, int bf16) {
  if (bf16)
    return wgmma_instance(d, block_q, block_k)
               ? static_cast<long long>(wgmma_smem_bytes(block_q, block_k, d))
               : -1;
  if (!tf32_instance(d, block_q, block_k)) return -1;
#define X(D_, BQ_, BK_)                                         \
  if (d == D_ && block_q == BQ_ && block_k == BK_)              \
    return static_cast<long long>(tf32_smem_bytes(BQ_, BK_, D_));
  TF32_INSTANCES(X)
#undef X
  return -1;
}

// the split plan for B * Hq = bh heads on n_sm SMs holding ctas_per_sm
// blocks each: out = {chunk_tiles, units, partials, split_tiles}
int flash_attention_split_plan(int bh, int S, int d, int block_q, int block_k,
                               int causal, int window, int n_sm,
                               int ctas_per_sm, int* out) {
  if (bh <= 0 || S <= 0 || block_q <= 0 || block_k <= 0 || n_sm <= 0 ||
      ctas_per_sm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitPlan p = split_plan_cached(bh, S, d, block_q, block_k, causal,
                                        window, n_sm, ctas_per_sm);
  out[0] = p.chunk_tiles;
  out[1] = p.units;
  out[2] = p.partials;
  out[3] = p.split_tiles;
  return 0;
}

// blocks of the bf16 instance (d, block_q, block_k) an SM holds at once
int flash_attention_ctas_per_sm(int block_q, int block_k, int d, int* ctas) {
#define X(D_, BQ_, BK_)                                 \
  if (d == D_ && block_q == BQ_ && block_k == BK_)      \
    return wgmma_ctas_per_sm<D_, BQ_, BK_>(ctas);
  WGMMA_INSTANCES(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, o: contiguous [B, Hq, S, D]; k, v: contiguous [B, Hkv, S, D]; all of
// one type (bf16 when bf16 != 0, else float32), 16-byte aligned.
// bf16: (d, block_q, block_k) one of WGMMA_INSTANCES, run as chunk_tiles
// cuts it (0: one unit a q tile), its partials in ws (ws_floats float32
// words; flash_attention_combine_launch then writes the split q tiles'
// o); float32: one of TF32_INSTANCES, chunk_tiles 0.
int flash_attention_launch_schedule(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int S, int d, int block_q,
                                    int block_k, int causal, int window,
                                    float scale, int bf16, int chunk_tiles,
                                    float* ws, long long ws_floats,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
#define X(D_, BQ_, BK_)                                                    \
    if (d == D_ && block_q == BQ_ && block_k == BK_)                       \
      return launch_wgmma<D_, BQ_, BK_>(q, k, v, o, B, Hq, Hkv, S, causal, \
                                        window, scale, chunk_tiles, ws,    \
                                        ws_floats, s);
    WGMMA_INSTANCES(X)
#undef X
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunk_tiles != 0) return static_cast<int>(cudaErrorInvalidValue);
#define X(D_, BQ_, BK_)                                                   \
  if (d == D_ && block_q == BQ_ && block_k == BK_)                        \
    return launch_tf32<D_, BQ_, BK_>(q, k, v, o, B, Hq, Hkv, S, causal,   \
                                     window, scale, s);
  TF32_INSTANCES(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// flash_attention_launch_schedule with the plan's chunk_tiles: bf16 plans
// for the current device (its SMs, the instance's blocks an SM holds) and
// fails unless the caller's chunk_tiles is that plan's
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hkv, int S, int d,
                           int block_q, int block_k, int causal, int window,
                           float scale, int bf16, int chunk_tiles, float* ws,
                           long long ws_floats, void* stream) {
  if (bf16) {
    int n_sm = 0, ctas = 0;
    int e = device_sms(&n_sm);
    if (e == 0) e = flash_attention_ctas_per_sm(block_q, block_k, d, &ctas);
    if (e != 0) return e;
    const SplitPlan p = split_plan_cached(B * Hq, S, d, block_q, block_k,
                                          causal, window, n_sm, ctas);
    if (p.chunk_tiles != chunk_tiles)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return flash_attention_launch_schedule(q, k, v, o, B, Hq, Hkv, S, d,
                                         block_q, block_k, causal, window,
                                         scale, bf16, chunk_tiles, ws,
                                         ws_floats, stream);
}

// o's split q tiles from the partials ws of a bf16 launch with the same
// shape, tiles and chunk_tiles, on the same stream after it
int flash_attention_combine_launch(const float* ws, void* o, int B, int Hq,
                                   int S, int d, int block_q, int block_k,
                                   int causal, int window, int chunk_tiles,
                                   void* stream) {
  if (!wgmma_instance(d, block_q, block_k))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define X(D_)                                                                  \
  if (d == D_)                                                                 \
    return launch_combine<D_>(ws, o, B, Hq, S, block_q, block_k, causal,       \
                              window, chunk_tiles, s);
  X(16) X(32) X(64) X(128) X(256)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaFuncGetAttributes of the instance that runs (block_q, block_k, d) in
// the given type
int flash_attention_attributes(int block_q, int block_k, int d, int bf16,
                               int* regs, int* static_smem, int* max_threads) {
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
  if (bf16) {
#define X(D_, BQ_, BK_)                                   \
    if (d == D_ && block_q == BQ_ && block_k == BK_)      \
      e = cudaFuncGetAttributes(&a, flash_wgmma_kernel<D_, BQ_, BK_>);
    WGMMA_INSTANCES(X)
#undef X
  } else {
#define X(D_, BQ_, BK_)                                   \
    if (d == D_ && block_q == BQ_ && block_k == BK_)      \
      e = cudaFuncGetAttributes(&a, flash_tf32_kernel<D_, BQ_, BK_>);
    TF32_INSTANCES(X)
#undef X
  }
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
