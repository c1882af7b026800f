// Block recurrence of the inverse masked convolution, for a chain of up to
// four pad orders, in fp32 on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_chain_kernel` in
// inverse_flow_tpu/ops/fused_chain.py:209. For each order o (phase o reads
// phase o-1's output) it scans the NB row blocks of the activation and
// computes
//
//     y_b = x_b . T[o]^T - carry . G[o]^T
//
// where carry is the previously solved block's last KCW columns (unflipped
// orders, scanning up) or first KCW columns (H-flipped orders, scanning
// down). Padded tail columns of the last block are written as zero after
// every phase. Every phase output is kept in y: it is the residual the
// backward pass needs.
//
// Three kernels compute this function. ops/fused_chain.py:chain_variant
// picks one from (RCW, KCW) alone: the cluster kernel wherever its T and G
// slices fit in shared memory (every shape the repo's models reach), the
// wide cluster kernel for every wider block up to RCW = 2048 (its design
// is above chain_phases_cluster_wide_kernel). The streaming kernel, the
// first design, is no longer dispatched: it stays as a forced variant that
// the timings compare against.
//
// The streaming kernel (chain_phases_kernel, the first design). The TPU
// kernel keeps all of T resident in VMEM; T is 614 KB at the flagship shape
// (RCW=392) and 16 MB at RCW=2048, far above the shared memory one block
// may use. So one CTA takes a tile of kBatchTile batch rows through every
// phase and block in order, keeps the block's input tile and its carry in
// shared memory, and streams the rows of T and G from global memory, where
// they stay in L2 (every CTA reads the same T). A warp computes one output
// column at a time: its lanes stride over k, each lane accumulates all rows
// of the batch tile, and a shuffle reduction finishes the dot products.
// What bounds it: every CTA re-reads all of T and G from L2 at every block
// step (1.18 MB at RCW=KCW=384), with only ceil(B / kBatchTile) = 25 CTAs
// on 132 SMs at B=100 and a few loads in flight per warp. It is bound by
// L2 latency, about 90-100 us per block step whatever the shape.
//
// The cluster kernel (chain_phases_cluster_kernel). A block step is a
// small product ([8 x 768] . [768 x 384] at imagenet32, 2.4 M multiply-
// adds), so what sets the time is the latency of each step, and the fix is
// to stop re-reading T and G:
//   - A thread-block cluster of kClusterSize CTAs takes kRows batch rows.
//     CTA r owns the output columns [r * cpc, (r + 1) * cpc), cpc =
//     ceil(RCW / kClusterSize) rounded up to a multiple of 4, the last
//     slices possibly short or empty.
//   - Rows j of T[o] and G[o] are the weights of output column j, so a
//     CTA's slice is one contiguous run of each. It is loaded into shared
//     memory once per phase by cp.async.bulk copies completed on an
//     mbarrier (147 KB at imagenet32), and every block step of the phase
//     reads it there.
//   - Each block step stages its input rows (the previous phase's output,
//     or x) with cp.async, prefetched one step ahead within a phase. The
//     carry goes through distributed shared memory: each CTA keeps its
//     outputs of the step in its own shared memory, the cluster meets once
//     at barrier.cluster.arrive.release / wait.acquire, and each CTA then
//     gathers the carried columns from its peers in float4 loads
//     (ld.shared::cluster; consecutive threads read consecutive columns of
//     one peer). No L2 access is on a step's critical path: going through
//     y in L2 would add a load round trip to every step. A first design
//     pushed each output to all eight peers with 4-byte remote stores
//     before the barrier; it was slower. The output and input buffers are
//     double buffered, so one barrier per step is the only
//     synchronisation.
//   - The warps split k; a warp's lanes are 8 column groups x 4 float4
//     chunks of k. A lane accumulates up to kLaneCols columns (its group's:
//     group, group + 8, ...) for all kRows rows. Lanes of one chunk read
//     the same input rows (a broadcast), so the input rows are read from
//     shared memory once per CTA and step, not once per warp (172 KB a
//     step at imagenet32 instead of 344 KB). T's and G's slice rows are 16
//     floats past a multiple of 32, so the two column groups of a quarter
//     warp fall in different banks. A butterfly over the 4 chunk lanes (48
//     shuffles) and a sum over the 8 warps' partials in shared memory
//     finish the dot products.
//   - kRows = 8 gives ceil(100 / 8) = 13 clusters, 104 CTAs at one per SM
//     at B=100: one wave (chip_smoke.py prints the active-cluster count).
//   - fp32 on the CUDA cores. The parity limit is 1e-5 * max(1, max|y|);
//     TF32 keeps about three digits, so neither wgmma nor mma.sync in TF32
//     meets it. The multiply-adds are now about half of a step
//     (scripts/chain_step_profile.py prints the parts of a step); an
//     error-compensated 3xTF32 variant on the tensor cores is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBatchTile = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the widest block row the shared-memory tile takes: kBatchTile rows of
// the input block and of the carry (KCW <= RCW), 64 KB at RCW = 2048
constexpr int kMaxRcw = 2048;
constexpr int kMaxSmem = sizeof(float) * kBatchTile * 2 * kMaxRcw;

__global__ void __launch_bounds__(kThreads)
chain_phases_kernel(const float* x, const float* __restrict__ t_all,
                    const float* __restrict__ g_all, float* y, int n, int nb,
                    int b, int rcw, int kcw, int pad_cw, int dirs) {
  extern __shared__ float smem[];
  float* src = smem;                         // [kBatchTile][rcw]
  float* carry = smem + kBatchTile * rcw;    // [kBatchTile][kcw]

  const int b0 = blockIdx.x * kBatchTile;
  const int rows = min(kBatchTile, b - b0);  // ragged batch edge
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t blk = static_cast<size_t>(b) * rcw;  // one row block

  for (int o = 0; o < n; ++o) {
    const bool flip_h = (dirs >> o) & 1;
    const float* t = t_all + static_cast<size_t>(o) * rcw * rcw;
    const float* g = g_all + static_cast<size_t>(o) * rcw * kcw;
    const float* in = o == 0 ? x : y + static_cast<size_t>(o - 1) * nb * blk;
    float* out = y + static_cast<size_t>(o) * nb * blk;
    const int carry_col = flip_h ? 0 : rcw - kcw;

    for (int i = 0; i < nb; ++i) {
      const int m = flip_h ? nb - 1 - i : i;
      const int prev = flip_h ? m + 1 : m - 1;

      // The previous step's reads of shared memory are done, and its
      // writes to y (this block's carry, the previous phase's output) are
      // visible to every thread of the CTA.
      __syncthreads();
      for (int e = threadIdx.x; e < kBatchTile * rcw; e += kThreads) {
        const int r = e / rcw;
        const int k = e - r * rcw;
        src[e] = r < rows ? in[m * blk + static_cast<size_t>(b0 + r) * rcw + k]
                          : 0.f;
      }
      for (int e = threadIdx.x; e < kBatchTile * kcw; e += kThreads) {
        const int r = e / kcw;
        const int k = e - r * kcw;
        carry[e] = (i > 0 && r < rows)
                       ? out[prev * blk + static_cast<size_t>(b0 + r) * rcw +
                             carry_col + k]
                       : 0.f;
      }
      __syncthreads();

      // Columns at or past `live` are the zero-padded tail rows.
      const int live = m == nb - 1 ? rcw - pad_cw : rcw;
      for (int j = warp; j < rcw; j += kWarps) {
        float acc[kBatchTile];
#pragma unroll
        for (int r = 0; r < kBatchTile; ++r) acc[r] = 0.f;
        if (j < live) {
          const float* tj = t + static_cast<size_t>(j) * rcw;
#pragma unroll 4
          for (int k = lane; k < rcw; k += 32) {
            const float tv = __ldg(tj + k);
#pragma unroll
            for (int r = 0; r < kBatchTile; ++r) acc[r] += src[r * rcw + k] * tv;
          }
          if (i > 0) {
            const float* gj = g + static_cast<size_t>(j) * kcw;
#pragma unroll 4
            for (int k = lane; k < kcw; k += 32) {
              const float gv = __ldg(gj + k);
#pragma unroll
              for (int r = 0; r < kBatchTile; ++r)
                acc[r] -= carry[r * kcw + k] * gv;
            }
          }
#pragma unroll
          for (int r = 0; r < kBatchTile; ++r) {
#pragma unroll
            for (int s = 16; s > 0; s >>= 1)
              acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], s);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kBatchTile; ++r)
            if (r < rows)
              out[m * blk + static_cast<size_t>(b0 + r) * rcw + j] = acc[r];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The cluster kernel
// ---------------------------------------------------------------------------

constexpr int kClusterSize = 8;     // CTAs per cluster (the portable size)
constexpr int kRows = 8;            // batch rows per cluster
constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kGroups = 8;          // column groups of a warp's lanes
constexpr int kChunks = 4;          // k chunks of a warp's lanes
constexpr int kLaneCols = 8;        // output columns per lane, at most
// output columns per CTA, at most: RCW <= 512 at kClusterSize = 8
constexpr int kMaxCols = kLaneCols * kGroups;
// the partial sums of one step: kClusterWarps x (kMaxCols x kRows)
constexpr int kPartials = kClusterWarps * kMaxCols * kRows;
// remote loads a thread keeps in flight while it gathers the carry
constexpr int kBatch = 4;
// the shared memory one block may opt into on sm_90
constexpr int kSmemLimit = 232448;
// the mbarrier, padded so that the float buffers start 16-byte aligned
constexpr int kHeader = 16;

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// the smallest row stride >= v that is 16 past a multiple of 32 floats
__host__ __device__ constexpr int pad16(int v) {
  return (v + 16 + 31) / 32 * 32 - 16;
}

// output columns per CTA: ceil(RCW / kClusterSize) rounded up to a
// multiple of 4, so that no float4 of the carry straddles two CTAs
__host__ __device__ constexpr int cluster_cols(int rcw) {
  return round4((rcw + kClusterSize - 1) / kClusterSize);
}

// Dynamic shared memory of the cluster kernel, in floats after the
// header: the T and G slices (cpc rows each, row strides pad16), two
// buffers of kRows input rows and one of kRows carry rows (rows padded to
// a multiple of 4 floats), two of this CTA's kRows x cpc outputs, and the
// warps' partial sums. ops/fused_chain.py:cluster_smem_bytes is the same
// sum.
__host__ __device__ constexpr int cluster_smem_floats(int rcw, int kcw) {
  return cluster_cols(rcw) * (pad16(rcw) + pad16(kcw)) +
         kRows * (2 * round4(rcw) + round4(kcw)) +
         2 * kRows * cluster_cols(rcw) + kPartials;
}

constexpr size_t cluster_smem_bytes(int rcw, int kcw) {
  return kHeader + sizeof(float) * cluster_smem_floats(rcw, kcw);
}

// Per-step timing for scripts/chain_step_profile.py. Built with
// -DCHAIN_STEP_PROFILE (the package's build never is), thread 0 of the
// first CTA records clock64() at eight points of each of the first 1024
// block steps; chain_step_clock_copy reads them out.
#ifdef CHAIN_STEP_PROFILE
__device__ long long g_step_clock[1024 * 8];
#define STEP_MARK(k)                                     \
  if (blockIdx.x == 0 && threadIdx.x == 0 && s < 1024) \
  g_step_clock[s * 8 + (k)] = clock64()
// the wide kernel: clock64() at points 0-4 of a step, then the cycles of
// the step spent waiting for chunks (5), multiplying (6) and in the
// per-chunk fence, barrier and refill (7)
#define WIDE_MARK(k, v)                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0 && s < 1024) \
  g_step_clock[s * 8 + (k)] = (v)
#define WIDE_TIC(t) t = clock64()
#define WIDE_TOC(sum, t) \
  sum += clock64() - t;  \
  t = clock64()
#else
#define STEP_MARK(k)
#define WIDE_MARK(k, v)
#define WIDE_TIC(t)
#define WIDE_TOC(sum, t)
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of shared::cta address `addr` in cluster rank `rank`'s CTA
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one contiguous global -> shared copy by the async proxy; bytes and both
// addresses 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async.wait_group n for a runtime n; more than 7 waits for 7, which
// is stricter
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Stages `rows` rows of one row block (`src`, row stride rcw) into `dst`
// (row stride ldt) with cp.async; 16-byte copies when `vec`.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int rcw, int ldt,
                                           bool vec) {
  if (vec) {
    const int n4 = rcw >> 2;
    for (int e = threadIdx.x; e < rows * n4; e += kClusterThreads) {
      const int r = e / n4;
      const int q = e - r * n4;
      cp_async16(dst + r * ldt + 4 * q, src + static_cast<size_t>(r) * rcw +
                                            4 * q);
    }
  } else {
    for (int e = threadIdx.x; e < rows * rcw; e += kClusterThreads) {
      const int r = e / rcw;
      const int k = e - r * rcw;
      cp_async4(dst + r * ldt + k, src + static_cast<size_t>(r) * rcw + k);
    }
  }
  cp_async_commit();
}

// v[c * kRows + r] += part(av[r]) * part(wv[c]) for every (column, row)
template <typename Part>
__device__ __forceinline__ void madd(float (&v)[kLaneCols * kRows],
                                     const float4 (&av)[kRows],
                                     const float4 (&wv)[kLaneCols],
                                     Part part) {
#pragma unroll
  for (int c = 0; c < kLaneCols; ++c) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v[c * kRows + r] = fmaf(part(av[r]), part(wv[c]), v[c * kRows + r]);
  }
}

// v[c * kRows + r] += sign * sum_k a[r][k] * w[group + c * kGroups][k]
// over this lane's float4 chunks k4 = k0, k0 + 32, ... below n4, for its
// ncg columns; a and w have row strides lda and ldw (multiples of 4, zero
// past the live width). All of a chunk's operands are loaded first, and
// its multiply-adds run one float4 component at a time over every
// (column, row), so that consecutive ones are independent: one basic block
// of 256 multiply-adds, with the k loop unrolled twice. Columns past ncg
// multiply zeros: a branch and a load per column was slower.
template <bool kSubtract>
__device__ __forceinline__ void accumulate(float (&v)[kLaneCols * kRows],
                                           const float* a, int lda,
                                           const float* w, int ldw, int n4,
                                           int k0, int ncg) {
#pragma unroll 2
  for (int k4 = k0; k4 < n4; k4 += kClusterWarps * kChunks) {
    float4 av[kRows], wv[kLaneCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      av[r] = reinterpret_cast<const float4*>(a + r * lda)[k4];
      if (kSubtract) {
        av[r].x = -av[r].x;
        av[r].y = -av[r].y;
        av[r].z = -av[r].z;
        av[r].w = -av[r].w;
      }
    }
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c)
      wv[c] = c < ncg ? reinterpret_cast<const float4*>(
                            w + c * kGroups * ldw)[k4]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    madd(v, av, wv, [](float4 q) { return q.x; });
    madd(v, av, wv, [](float4 q) { return q.y; });
    madd(v, av, wv, [](float4 q) { return q.z; });
    madd(v, av, wv, [](float4 q) { return q.w; });
  }
}

// One round of a butterfly reduce-scatter: lanes that differ in lane bit
// `Bit` pair up; each keeps one half of entries [0, 2H) of its v (the
// upper half when its bit is set) and adds its partner's copy of that
// half, so v[0, H) then holds the kept entries base + [0, H).
template <int H, int Bit>
__device__ __forceinline__ void reduce_half(float (&v)[kLaneCols * kRows],
                                            int lane, int& base) {
  const bool hi = lane & Bit;
#pragma unroll
  for (int e = 0; e < H; ++e) {
    const float send = hi ? v[e] : v[e + H];
    const float keep = hi ? v[e + H] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, Bit);
  }
  if (hi) base += H;
}

__global__ void __launch_bounds__(kClusterThreads, 1)
chain_phases_cluster_kernel(const float* x, const float* __restrict__ t_all,
                            const float* __restrict__ g_all, float* y, int n,
                            int nb, int b, int rcw, int kcw, int pad_cw,
                            int dirs, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  const int ldt = pad16(rcw);   // slice row strides
  const int ldg = pad16(kcw);
  const int ldx = round4(rcw);  // input and carry row strides
  const int ldc = round4(kcw);
  const int cpc = cluster_cols(rcw);
  const int c0 = min(rank * cpc, rcw);
  const int ncols = min(cpc, rcw - c0);   // this CTA's output columns
  float* t_s = reinterpret_cast<float*>(smem_raw + kHeader);  // [cpc][ldt]
  float* g_s = t_s + cpc * ldt;                                // [cpc][ldg]
  float* x_s = g_s + cpc * ldg;                    // [2][kRows][ldx]
  float* c_s = x_s + 2 * kRows * ldx;              // [kRows][ldc]
  float* o_s = c_s + kRows * ldc;                  // [2][kRows][cpc]
  float* p_s = o_s + 2 * kRows * cpc;  // [warp][kLaneCols*kRows/4][lane]
  const uint32_t bar = smem_u32(smem_raw);

  const int b0 = static_cast<int>(blockIdx.x / kClusterSize) * kRows;
  const int rows = min(kRows, b - b0);  // ragged batch edge
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane / kChunks;
  // this lane's first chunk of k, and its columns: group + c * kGroups
  // for c < ncg
  const int k0 = warp * kChunks + lane % kChunks;
  const int ncg = max(0, (ncols - group + kGroups - 1) / kGroups);
  const size_t blk = static_cast<size_t>(b) * rcw;  // one row block

  // Zero every buffer: row padding, and the rows past the batch edge,
  // stay zero for the whole launch.
  const int n_floats = cluster_smem_floats(rcw, kcw);
  for (int e = threadIdx.x; e < n_floats; e += kClusterThreads) t_s[e] = 0.f;
  if (threadIdx.x == 0) mbar_init(bar, 1);
  fence_proxy_async();
  // every peer's shared memory is live before the first gather
  cluster.sync();

  int s = 0;  // block steps so far, over all phases: picks the buffers
  for (int o = 0; o < n; ++o) {
    const bool flip_h = (dirs >> o) & 1;
    const float* t = t_all + (static_cast<size_t>(o) * rcw + c0) * rcw;
    const float* g = g_all + (static_cast<size_t>(o) * rcw + c0) * kcw;
    const float* in = o == 0 ? x : y + static_cast<size_t>(o - 1) * nb * blk;
    float* out = y + static_cast<size_t>(o) * nb * blk;
    const int carry_col = flip_h ? 0 : rcw - kcw;

    // This CTA's slices of T[o] and G[o], once for the phase. The last
    // step of the previous phase ended in a proxy fence and the cluster
    // barrier, so no thread still reads the old slices.
    if (vec) {
      if (warp == 0) {
        if (lane == 0)
          mbar_expect_tx(bar, static_cast<uint32_t>(
                                  sizeof(float) * ncols * (rcw + kcw)));
        __syncwarp();
        for (int j = lane; j < ncols; j += 32) {
          bulk_copy(t_s + j * ldt, t + static_cast<size_t>(j) * rcw,
                    sizeof(float) * rcw, bar);
          bulk_copy(g_s + j * ldg, g + static_cast<size_t>(j) * kcw,
                    sizeof(float) * kcw, bar);
        }
      }
    } else {
      for (int e = threadIdx.x; e < ncols * rcw; e += kClusterThreads)
        t_s[(e / rcw) * ldt + e % rcw] = __ldg(t + e);
      for (int e = threadIdx.x; e < ncols * kcw; e += kClusterThreads)
        g_s[(e / kcw) * ldg + e % kcw] = __ldg(g + e);
    }
    const int m_first = flip_h ? nb - 1 : 0;
    stage_rows(x_s + (s & 1) * kRows * ldx,
               in + m_first * blk + static_cast<size_t>(b0) * rcw, rows, rcw,
               ldx, vec);

    for (int i = 0; i < nb; ++i, ++s) {
      STEP_MARK(0);
      const int m = flip_h ? nb - 1 - i : i;
      // prefetch the next block's input rows: the previous phase's output
      // (or x), complete before this phase began
      if (i + 1 < nb) {
        const int m_next = flip_h ? m - 1 : m + 1;
        stage_rows(x_s + ((s + 1) & 1) * kRows * ldx,
                   in + m_next * blk + static_cast<size_t>(b0) * rcw, rows,
                   rcw, ldx, vec);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      STEP_MARK(1);
      if (i > 0) {
        // the carry: the previous step's outputs, from the CTAs that own
        // its columns, in float4s when `vec` (cpc is a multiple of 4, and
        // so are the carry's first column and width)
        const uint32_t prev = smem_u32(o_s + ((s - 1) & 1) * kRows * cpc);
        const int w = vec ? 4 : 1;
        const int per_row = kcw / w;
        const int total = rows * per_row;
        // up to kBatch loads in flight before the first store
        for (int e0 = threadIdx.x; e0 < total;
             e0 += kBatch * kClusterThreads) {
          float4 got[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = e0 + u * kClusterThreads;
            if (e < total) {
              const int r = e / per_row;
              const int col = carry_col + (e - r * per_row) * w;
              const int q = col / cpc;
              const uint32_t src =
                  map_rank(prev + 4 * (r * cpc + col - q * cpc), q);
              if (vec)
                got[u] = ld_cluster4(src);
              else
                got[u].x = ld_cluster(src);
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = e0 + u * kClusterThreads;
            if (e < total) {
              const int r = e / per_row;
              const int k = (e - r * per_row) * w;
              if (vec)
                *reinterpret_cast<float4*>(c_s + r * ldc + k) = got[u];
              else
                c_s[r * ldc + k] = got[u].x;
            }
          }
        }
      }
      STEP_MARK(2);
      if (i == 0 && vec) mbar_wait(bar, o & 1);
      __syncthreads();
      STEP_MARK(3);

      float v[kLaneCols * kRows];
#pragma unroll
      for (int e = 0; e < kLaneCols * kRows; ++e) v[e] = 0.f;
      accumulate<false>(v, x_s + (s & 1) * kRows * ldx, ldx, t_s + group * ldt,
                        ldt, ldx / 4, k0, ncg);
      if (i > 0)
        accumulate<true>(v, c_s, ldc, g_s + group * ldg, ldg, ldc / 4, k0,
                         ncg);

      STEP_MARK(4);
      // Sum over the 4 chunk lanes (lane bits 1 and 0): the lane then holds
      // entries base + [0, 16) of its group, base = 16 * (lane % 4).
      int base = 0;
      reduce_half<32, 2>(v, lane, base);
      reduce_half<16, 1>(v, lane, base);
      constexpr int kKept = kLaneCols * kRows / kChunks;
      float* part = p_s + warp * kKept * 32;
#pragma unroll
      for (int e = 0; e < kKept; ++e) part[e * 32 + lane] = v[e];
      __syncthreads();
      STEP_MARK(5);

      // Sum over the warps: thread t finishes entries e = t / 32 and
      // e + 8 of lane t % 32's group. Columns at or past `live` are the
      // zero-padded tail rows.
      const int live = m == nb - 1 ? rcw - pad_cw : rcw;
      float* outs = o_s + (s & 1) * kRows * cpc;
      for (int slot = threadIdx.x; slot < kKept * 32;
           slot += kClusterThreads) {
        const int l = slot % 32;
        const int e = slot / 32;
        const int idx = 16 * (l % kChunks) + e;
        const int jl = l / kChunks + (idx / kRows) * kGroups;
        if (jl < ncols) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kClusterWarps; ++w)
            sum += p_s[(w * kKept + e) * 32 + l];
          const int r = idx % kRows;
          const int j = c0 + jl;
          const float val = j < live ? sum : 0.f;
          if (r < rows)
            out[m * blk + static_cast<size_t>(b0 + r) * rcw + j] = val;
          outs[r * cpc + jl] = val;
        }
      }
      STEP_MARK(6);
      // before the next phase's bulk copies overwrite the slices
      if (i == nb - 1) fence_proxy_async();
      // release: this step's outputs; acquire: the peers'
      cluster.sync();
      STEP_MARK(7);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide cluster kernel
// ---------------------------------------------------------------------------

constexpr int kWideCluster = 16;     // CTAs per cluster (a non-portable size)
// k floats of a streamed chunk: the widest of these for which two chunk
// buffers fit. Fewer, wider chunks were faster at W2 (RCW = KCW = 768, B =
// 100) on an H100 SXM at 700 W: 655 / 843 / 1142 us per launch at 256 /
// 128 / 64
// (scripts/chain_step_profile.py --wide, which builds with -DWIDE_CHUNK
// to allow one size only; the package's build never does).
#ifdef WIDE_CHUNK
constexpr int kWideChunks[] = {WIDE_CHUNK};
#else
constexpr int kWideChunks[] = {256, 128, 64};
#endif
constexpr int kWideMaxStages = 8;    // streamed chunk buffers, at most
constexpr int kWideMaxGroups = 4;    // row groups of kRows rows a cluster

// output columns per CTA: ceil(RCW / kWideCluster) rounded up to a
// multiple of 4; more than kMaxCols go in passes of at most kMaxCols
__host__ __device__ constexpr int wide_cols(int rcw) {
  return round4((rcw + kWideCluster - 1) / kWideCluster);
}

// floats of the buffers both modes have: `groups` x kRows input rows and
// carry rows, two buffers of the CTA's outputs for those rows, and the
// warps' partial sums
__host__ __device__ constexpr int wide_fixed_floats(int rcw, int kcw,
                                                    int groups) {
  return kRows * groups * (round4(rcw) + round4(kcw) + 2 * wide_cols(rcw)) +
         kPartials;
}

// the resident mode's T and G slices (row strides pad16)
__host__ __device__ constexpr int wide_slice_floats(int rcw, int kcw) {
  return wide_cols(rcw) * (pad16(rcw) + pad16(kcw));
}

// one streamed chunk buffer: a pass's rows x `chunk` (stride pad16)
__host__ __device__ constexpr int wide_stage_floats(int rcw, int chunk) {
  return (wide_cols(rcw) < kMaxCols ? wide_cols(rcw) : kMaxCols) *
         pad16(chunk);
}

// How the wide kernel lays out its shared memory at one shape: resident
// when the slices fit beside the fixed buffers (and a CTA has at most
// kMaxCols columns), else streamed in the widest chunks of which at
// least 2 buffers fit, as many buffers as fit. smem 0: `groups` row
// groups do not fit. ops/fused_chain.py:cluster_wide_layout is the same
// computation.
struct WidePlan {
  int groups, stages, chunk, smem;  // stages 0: resident
};

WidePlan wide_plan(int rcw, int kcw, int groups) {
  WidePlan p = {groups, 0, 0, 0};
  const int fixed = wide_fixed_floats(rcw, kcw, groups);
  const int avail = (kSmemLimit - kHeader) / 4 - fixed;
  if (avail <= 0) return p;
  if (wide_cols(rcw) <= kMaxCols && wide_slice_floats(rcw, kcw) <= avail) {
    p.smem = kHeader + 4 * (fixed + wide_slice_floats(rcw, kcw));
    return p;
  }
  for (const int chunk : kWideChunks) {
    int stages = avail / wide_stage_floats(rcw, chunk);
    if (stages > kWideMaxStages) stages = kWideMaxStages;
    if (stages < 2) continue;
    p.stages = stages;
    p.chunk = chunk;
    p.smem = kHeader + 4 * (fixed + stages * wide_stage_floats(rcw, chunk));
    return p;
  }
  return p;
}

// The wide kernel (chain_phases_cluster_wide_kernel): the cluster kernel's
// design for blocks whose slices do not fit it.
//   - A cluster of kWideCluster = 16 CTAs (cudaFuncAttributeNonPortable-
//     ClusterSizeAllowed), so a CTA owns ceil(RCW / 16) columns (36 at RCW
//     = 520); past kMaxCols (RCW > 1024) in passes of at most kMaxCols.
//   - A cluster takes `groups` row groups of kRows batch rows. A 16-CTA
//     cluster needs 16 SMs of one GPC, so only about 8 are resident at
//     once; the host picks the fewest groups for which ceil(B / (8 x
//     groups)) clusters fit in one wave (cudaOccupancyMaxActiveClusters).
//     The groups of a step are worked in turn between one cluster barrier.
//   - Resident mode (the slices fit beside the staging buffers, as at RCW
//     = 520): T's and G's slices are loaded once per phase, as in the
//     cluster kernel. Streamed mode (slices past 227 KB: RCW = KCW = 768
//     needs 294,912 bytes a CTA): the slice rows stream through a ring of
//     `stages` chunk buffers of `chunk` k-columns, filled by every
//     thread's 16-byte cp.async copies, one commit group a chunk. The
//     chunk sequence depends on the shape alone, so `stages` - 1 chunks
//     stay in flight ahead of the one being read, across block steps and
//     phases, with one CTA barrier a chunk; every cluster reads the same T
//     and G, so they stay in L2.
//   - The input rows are staged once per step with cp.async; a row
//     group's next-step rows are prefetched as soon as its last T chunk
//     is read. The carry is gathered from the peers' outputs (DSMEM), as
//     in the cluster kernel, and stored negated, so T's and G's chunks are
//     one product y = [x, -carry] . [T, G]^T; it is zero at a scan's first
//     block.
//   - The multiply-adds, the butterfly and the cross-warp sum are the
//     cluster kernel's (accumulate, reduce_half), fp32 on the CUDA cores.
__global__ void __launch_bounds__(kClusterThreads, 1)
chain_phases_cluster_wide_kernel(const float* x, const float* __restrict__ t_all,
                                 const float* __restrict__ g_all, float* y,
                                 int n, int nb, int b, int rcw, int kcw,
                                 int pad_cw, int dirs, int groups, int stages,
                                 int chunk, int flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool resident = stages == 0;
  const bool xvec = flags & 1;  // input rows in 16-byte cp.async copies
  const bool tvec = flags & 2;  // T's rows 16-byte aligned
  const bool gvec = flags & 4;  // G's rows 16-byte aligned
  const bool cvec = rcw % 4 == 0 && kcw % 4 == 0;  // the carry in float4s
  // streamed chunks in 16-byte cp.async copies when both may, else in
  // plain loads and stores
  const bool wvec = tvec && gvec;

  const int rows_all = kRows * groups;
  const int ldx = round4(rcw);  // input and carry row strides
  const int ldc = round4(kcw);
  const int cpc = wide_cols(rcw);
  const int c0 = min(rank * cpc, rcw);
  const int ncols = min(cpc, rcw - c0);  // this CTA's output columns
  const int passes = (cpc + kMaxCols - 1) / kMaxCols;
  // W rows: resident, the T slice [cpc][ldt] then the G slice [cpc][ldg];
  // streamed, `stages` buffers of [min(cpc, kMaxCols)][ldw]
  const int ldt = pad16(rcw);
  const int ldg = pad16(kcw);
  const int ldw = pad16(chunk);
  const int stage_floats = resident ? 0 : wide_stage_floats(rcw, chunk);
  // chunks of a tile (one row group, one pass): T's range, then G's
  const int n_t = resident ? 1 : (ldx + chunk - 1) / chunk;
  const int n_g = resident ? 1 : (ldc + chunk - 1) / chunk;
  const int per_tile = n_t + n_g;
  const int per_step = groups * passes * per_tile;

  // the mbarrier of the resident slices' copies
  const uint32_t bar = smem_u32(smem_raw);
  float* x_s = reinterpret_cast<float*>(smem_raw + kHeader);  // [rows_all][ldx]
  float* c_s = x_s + rows_all * ldx;                // [rows_all][ldc], -carry
  float* o_s = c_s + rows_all * ldc;                // [2][rows_all][cpc]
  float* p_s = o_s + 2 * rows_all * cpc;            // partial sums
  float* w_s = p_s + kPartials;

  const int b0 = static_cast<int>(blockIdx.x / kWideCluster) * rows_all;
  const int rows = min(rows_all, b - b0);  // ragged batch edge
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane / kChunks;
  const int k0 = warp * kChunks + lane % kChunks;
  const size_t blk = static_cast<size_t>(b) * rcw;  // one row block

  // Streamed chunk q (counted over the whole launch) is chunk c of pass p
  // of phase o: its source rows, width and buffer.
  const int per_phase = nb * per_step;
  const int total = n * per_phase;
  auto chunk_src = [&](int q, const float*& src, int& len, int& width,
                       int& rows_p) {
    const int o = q / per_phase;
    const int u = (q % per_phase) % (passes * per_tile);
    const int p = u / per_tile;
    const int c = u % per_tile;
    const bool is_t = c < n_t;
    const int kc = (is_t ? c : c - n_t) * chunk;
    len = is_t ? rcw : kcw;
    width = min(chunk, len - kc);
    rows_p = max(0, min(kMaxCols, ncols - p * kMaxCols));
    src = (is_t ? t_all : g_all) +
          (static_cast<size_t>(o) * rcw + c0 + p * kMaxCols) * len + kc;
  };
  // Every thread: start chunk q's copy into its buffer and commit it as
  // one cp.async group. cp.async groups complete in order, so counting the
  // groups committed after a chunk's (`commits`, and `committed` per
  // buffer) says how many may still be in flight when it is read. (A
  // first version filled the buffers with one cp.async.bulk copy per row
  // from one warp: about 80 SM cycles a copy, 48 a chunk, on the critical
  // path of an H100; scripts/chain_step_profile.py --wide.)
  int commits = 0;
  int committed[kWideMaxStages];
  auto load_chunk = [&](int q) {
    const float* src;
    int len, width, rows_p;
    chunk_src(q, src, len, width, rows_p);
    const int stage = q % stages;
    float* dst = w_s + stage * stage_floats;
    if (wvec) {
      const int n4 = width / 4;
      for (int e = threadIdx.x; e < rows_p * n4; e += kClusterThreads) {
        const int j = e / n4;
        const int k = 4 * (e - j * n4);
        cp_async16(dst + j * ldw + k, src + static_cast<size_t>(j) * len + k);
      }
    } else {
      for (int e = threadIdx.x; e < rows_p * width; e += kClusterThreads) {
        const int j = e / width;
        const int k = e - j * width;
        dst[j * ldw + k] = __ldg(src + static_cast<size_t>(j) * len + k);
      }
    }
    cp_async_commit();
    committed[stage] = commits++;
  };
  int x_committed = 0;  // the group of the last input-row staging

  // Zero every buffer: row padding, and the rows past the batch edge,
  // stay zero for the whole launch.
  const int n_floats =
      wide_fixed_floats(rcw, kcw, groups) +
      (resident ? wide_slice_floats(rcw, kcw) : stages * stage_floats);
  for (int e = threadIdx.x; e < n_floats; e += kClusterThreads) x_s[e] = 0.f;
  if (threadIdx.x == 0) mbar_init(bar, 1);
  fence_proxy_async();
  // every peer's shared memory is live before the first gather
  cluster.sync();
  // streamed: `stages` - 1 chunks in flight ahead of the one being read
  if (!resident)
    for (int q = 0; q + 1 < stages && q < total; ++q) load_chunk(q);

  int q = 0;  // streamed chunks read so far
  int s = 0;        // block steps so far, over all phases
  for (int o = 0; o < n; ++o) {
    const bool flip_h = (dirs >> o) & 1;
    const float* in = o == 0 ? x : y + static_cast<size_t>(o - 1) * nb * blk;
    float* out = y + static_cast<size_t>(o) * nb * blk;
    const int carry_col = flip_h ? 0 : rcw - kcw;

    if (resident) {
      // this CTA's slices of T[o] and G[o], once for the phase; the last
      // step of the previous phase ended in a proxy fence and the cluster
      // barrier, so no thread still reads the old ones
      const float* t = t_all + (static_cast<size_t>(o) * rcw + c0) * rcw;
      const float* g = g_all + (static_cast<size_t>(o) * rcw + c0) * kcw;
      float* t_s = w_s;
      float* g_s = w_s + cpc * ldt;
      if ((tvec || gvec) && warp == 0) {
        if (lane == 0)
          mbar_expect_tx(bar, static_cast<uint32_t>(
                                  4 * ncols * ((tvec ? rcw : 0) +
                                               (gvec ? kcw : 0))));
        __syncwarp();
        for (int j = lane; j < ncols; j += 32) {
          if (tvec)
            bulk_copy(t_s + j * ldt, t + static_cast<size_t>(j) * rcw,
                      4 * rcw, bar);
          if (gvec)
            bulk_copy(g_s + j * ldg, g + static_cast<size_t>(j) * kcw,
                      4 * kcw, bar);
        }
      }
      if (!tvec)
        for (int e = threadIdx.x; e < ncols * rcw; e += kClusterThreads)
          t_s[(e / rcw) * ldt + e % rcw] = __ldg(t + e);
      if (!gvec)
        for (int e = threadIdx.x; e < ncols * kcw; e += kClusterThreads)
          g_s[(e / kcw) * ldg + e % kcw] = __ldg(g + e);
    }
    const int m_first = flip_h ? nb - 1 : 0;
    stage_rows(x_s, in + m_first * blk + static_cast<size_t>(b0) * rcw, rows,
               rcw, ldx, xvec);
    x_committed = commits++;

    for (int i = 0; i < nb; ++i, ++s) {
      const int m = flip_h ? nb - 1 - i : i;
      const int m_next = flip_h ? m - 1 : m + 1;
      long long t_wait = 0, t_mul = 0, t_sync = 0, tic = 0;
      (void)t_wait, (void)t_mul, (void)t_sync, (void)tic;
      WIDE_MARK(0, clock64());
      if (i > 0) {
        // -carry: the previous step's outputs, from the CTAs that own its
        // columns (cpc is a multiple of 4: a float4 never straddles two)
        const uint32_t prev = smem_u32(o_s + ((s - 1) & 1) * rows_all * cpc);
        const int w = cvec ? 4 : 1;
        const int per_row = kcw / w;
        const int count = rows * per_row;
        for (int e0 = threadIdx.x; e0 < count;
             e0 += kBatch * kClusterThreads) {
          float4 got[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = e0 + u * kClusterThreads;
            if (e < count) {
              const int r = e / per_row;
              const int col = carry_col + (e - r * per_row) * w;
              const int qr = col / cpc;
              const uint32_t src =
                  map_rank(prev + 4 * (r * cpc + col - qr * cpc), qr);
              if (cvec)
                got[u] = ld_cluster4(src);
              else
                got[u].x = ld_cluster(src);
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = e0 + u * kClusterThreads;
            if (e < count) {
              const int r = e / per_row;
              const int k = (e - r * per_row) * w;
              if (cvec)
                *reinterpret_cast<float4*>(c_s + r * ldc + k) = make_float4(
                    -got[u].x, -got[u].y, -got[u].z, -got[u].w);
              else
                c_s[r * ldc + k] = -got[u].x;
            }
          }
        }
      } else {
        for (int e = threadIdx.x; e < rows * kcw; e += kClusterThreads)
          c_s[(e / kcw) * ldc + e % kcw] = 0.f;
      }
      WIDE_MARK(1, clock64());
      cp_async_wait_n(commits - x_committed - 1);  // this step's input rows
      if (resident && i == 0 && (tvec || gvec)) mbar_wait(bar, o & 1);
      __syncthreads();
      WIDE_MARK(2, clock64());

      // Columns at or past `live` are the zero-padded tail rows.
      const int live = m == nb - 1 ? rcw - pad_cw : rcw;
      float* outs = o_s + (s & 1) * rows_all * cpc;
      for (int rg = 0; rg < groups; ++rg) {
        const int rows_rg = min(kRows, rows - rg * kRows);
        float* x_rg = x_s + rg * kRows * ldx;
        float* c_rg = c_s + rg * kRows * ldc;
        for (int p = 0; p < passes; ++p) {
          const int pcols = min(kMaxCols, ncols - p * kMaxCols);
          const int ncg = max(0, (pcols - group + kGroups - 1) / kGroups);
          float v[kLaneCols * kRows];
#pragma unroll
          for (int e = 0; e < kLaneCols * kRows; ++e) v[e] = 0.f;
          for (int c = 0; c < per_tile; ++c) {
            const bool is_t = c < n_t;
            const float* a;
            const float* wp;
            int lda, ldr, n4;
            WIDE_TIC(tic);
            if (resident) {
              a = is_t ? x_rg : c_rg;
              lda = is_t ? ldx : ldc;
              wp = is_t ? w_s : w_s + cpc * ldt;
              ldr = is_t ? ldt : ldg;
              n4 = lda / 4;
            } else {
              // chunk q has landed for every thread, and every thread has
              // read chunk q - 1, whose buffer then takes chunk q + stages
              // - 1
              const int stage = q % stages;
              float* buf = w_s + stage * stage_floats;
              cp_async_wait_n(commits - committed[stage] - 1);
              __syncthreads();
              if (q + stages - 1 < total) load_chunk(q + stages - 1);
              const int kc = (is_t ? c : c - n_t) * chunk;
              lda = is_t ? ldx : ldc;
              a = (is_t ? x_rg : c_rg) + kc;
              wp = buf;
              ldr = ldw;
              n4 = min(chunk, lda - kc) / 4;
            }
            WIDE_TOC(t_wait, tic);
            accumulate<false>(v, a, lda, wp + group * ldr, ldr, n4, k0, ncg);
            WIDE_TOC(t_mul, tic);
            if (!resident) ++q;
            // this group's input rows are read: prefetch the next block's
            if (is_t && c == n_t - 1 && p == passes - 1 && i + 1 < nb &&
                rows_rg > 0) {
              __syncthreads();
              stage_rows(x_rg, in + m_next * blk +
                                   static_cast<size_t>(b0 + rg * kRows) * rcw,
                         rows_rg, rcw, ldx, xvec);
              x_committed = commits++;
            }
            WIDE_TOC(t_sync, tic);
          }

          // the cluster kernel's sums: over the 4 chunk lanes, then over
          // the warps
          int base = 0;
          reduce_half<32, 2>(v, lane, base);
          reduce_half<16, 1>(v, lane, base);
          constexpr int kKept = kLaneCols * kRows / kChunks;
          float* part = p_s + warp * kKept * 32;
          __syncthreads();  // the previous tile's sums have read p_s
#pragma unroll
          for (int e = 0; e < kKept; ++e) part[e * 32 + lane] = v[e];
          __syncthreads();
          for (int slot = threadIdx.x; slot < kKept * 32;
               slot += kClusterThreads) {
            const int l = slot % 32;
            const int e = slot / 32;
            const int idx = 16 * (l % kChunks) + e;
            const int jl = l / kChunks + (idx / kRows) * kGroups;
            if (jl < pcols) {
              float sum = 0.f;
#pragma unroll
              for (int w = 0; w < kClusterWarps; ++w)
                sum += p_s[(w * kKept + e) * 32 + l];
              const int r = idx % kRows;
              const int jc = p * kMaxCols + jl;  // column within the CTA
              const int j = c0 + jc;
              const float val = j < live ? sum : 0.f;
              if (r < rows_rg)
                out[m * blk + static_cast<size_t>(b0 + rg * kRows + r) * rcw +
                    j] = val;
              outs[(rg * kRows + r) * cpc + jc] = val;
            }
          }
        }
      }
      WIDE_MARK(3, clock64());
      // before the next phase's bulk copies overwrite the slices
      if (i == nb - 1 && resident) fence_proxy_async();
      // release: this step's outputs; acquire: the peers'
      cluster.sync();
      WIDE_MARK(4, clock64());
      WIDE_MARK(5, t_wait);
      WIDE_MARK(6, t_mul);
      WIDE_MARK(7, t_sync);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaLaunchConfig_t cluster_config(int b, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((b + kRows - 1) / kRows) * kClusterSize);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterSize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool cluster_fits(int rcw, int kcw) {
  return 0 < kcw && kcw <= rcw && cluster_cols(rcw) <= kMaxCols &&
         cluster_smem_bytes(rcw, kcw) <= kSmemLimit;
}

cudaLaunchConfig_t wide_config(int b, const WidePlan& plan,
                               cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int rows = kRows * plan.groups;
  cfg.gridDim = dim3(((b + rows - 1) / rows) * kWideCluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kWideCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The wide kernel's plan at batch b: the fewest row groups whose clusters,
// ceil(b / (8 x groups)), are all resident at once, else the most that fit
// in shared memory. *active: the resident clusters at that plan. Plans are
// kept for the last shapes asked (the query is host work on every launch).
struct WideCacheEntry {
  int b, rcw, kcw, active;
  WidePlan plan;
};
constexpr int kWideCache = 16;
WideCacheEntry g_wide_cache[kWideCache];
int g_wide_cached = 0;

cudaError_t wide_choose(int b, int rcw, int kcw, WidePlan* out,
                        int* active) {
  for (int e = 0; e < g_wide_cached && e < kWideCache; ++e) {
    const WideCacheEntry& c = g_wide_cache[e];
    if (c.b == b && c.rcw == rcw && c.kcw == kcw) {
      *out = c.plan;
      *active = c.active;
      return cudaSuccess;
    }
  }
  WidePlan best = {0, 0, 0, 0};
  int best_active = 0;
  for (int groups = 1; groups <= kWideMaxGroups; ++groups) {
    const WidePlan plan = wide_plan(rcw, kcw, groups);
    if (plan.smem == 0) break;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = wide_config(b, plan, nullptr, &attr);
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &clusters, chain_phases_cluster_wide_kernel, &cfg);
    if (err != cudaSuccess) return err;
    best = plan;
    best_active = clusters;
    const int rows = kRows * groups;
    if ((b + rows - 1) / rows <= clusters) break;
  }
  if (best.smem == 0 || best_active == 0) return cudaErrorInvalidConfiguration;
  g_wide_cache[g_wide_cached % kWideCache] = {b, rcw, kcw, best_active, best};
  ++g_wide_cached;
  *out = best;
  *active = best_active;
  return cudaSuccess;
}

bool wide_takes(int rcw, int kcw) {
  return 0 < kcw && kcw <= rcw && rcw <= kMaxRcw;
}

}  // namespace

// Raises the kernels' dynamic shared memory limits, and allows the wide
// kernel its 16-CTA clusters, on the current device.
// Call once per device before the first launch there.
extern "C" int chain_phases_init() {
  cudaError_t err = cudaFuncSetAttribute(
      chain_phases_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(chain_phases_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(chain_phases_cluster_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      chain_phases_cluster_wide_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
}

// The streaming kernel.
// x (nb, b, rcw); t_all (n, rcw, rcw); g_all (n, rcw, kcw);
// y (n, nb, b, rcw). Bit o of `dirs` is set when order o flips H.
// Returns the CUDA error of the launch (0 on success).
extern "C" int chain_phases_f32(const float* x, const float* t_all,
                                const float* g_all, float* y, int n, int nb,
                                int b, int rcw, int kcw, int pad_cw, int dirs,
                                void* stream) {
  if (rcw > kMaxRcw || kcw > rcw)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kBatchTile * (rcw + kcw);
  const dim3 grid((b + kBatchTile - 1) / kBatchTile);
  chain_phases_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, t_all, g_all, y, n, nb, b, rcw, kcw, pad_cw, dirs);
  return static_cast<int>(cudaGetLastError());
}

// The cluster kernel: the same arguments and function. Returns
// cudaErrorInvalidValue for a shape whose slices do not fit
// (ops/fused_chain.py:chain_variant sends those to the wide cluster kernel),
// else the CUDA error of the launch.
extern "C" int chain_phases_cluster_f32(const float* x, const float* t_all,
                                        const float* g_all, float* y, int n,
                                        int nb, int b, int rcw, int kcw,
                                        int pad_cw, int dirs, void* stream) {
  if (!cluster_fits(rcw, kcw)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = rcw % 4 == 0 && kcw % 4 == 0 && aligned16(x) &&
                  aligned16(t_all) && aligned16(g_all) && aligned16(y);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(b, cluster_smem_bytes(rcw, kcw),
                     static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, chain_phases_cluster_kernel, x, t_all, g_all,
                         y, n, nb, b, rcw, kcw, pad_cw, dirs, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the cluster kernel can be resident at once at this
// shape (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int chain_phases_cluster_occupancy(int b, int rcw, int kcw,
                                              int* clusters) {
  if (!cluster_fits(rcw, kcw)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(b, cluster_smem_bytes(rcw, kcw), nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, chain_phases_cluster_kernel, &cfg));
}

// The wide cluster kernel: the same arguments and function, for every
// shape with 0 < KCW <= RCW <= 2048 (ops/fused_chain.py:chain_variant
// sends it those the cluster kernel refuses). Returns
// cudaErrorInvalidValue for a shape it does not take, else the CUDA error
// of the plan's occupancy query or of the launch.
extern "C" int chain_phases_cluster_wide_f32(const float* x,
                                             const float* t_all,
                                             const float* g_all, float* y,
                                             int n, int nb, int b, int rcw,
                                             int kcw, int pad_cw, int dirs,
                                             void* stream) {
  if (!wide_takes(rcw, kcw)) return static_cast<int>(cudaErrorInvalidValue);
  WidePlan plan;
  int active = 0;
  cudaError_t err = wide_choose(b, rcw, kcw, &plan, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int flags = (rcw % 4 == 0 && aligned16(x) && aligned16(y) ? 1 : 0) |
                    (rcw % 4 == 0 && aligned16(t_all) ? 2 : 0) |
                    (kcw % 4 == 0 && aligned16(g_all) ? 4 : 0);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      wide_config(b, plan, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, chain_phases_cluster_wide_kernel, x, t_all,
                           g_all, y, n, nb, b, rcw, kcw, pad_cw, dirs,
                           plan.groups, plan.stages, plan.chunk, flags);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The wide kernel's plan at this shape, into out[0..5]: row groups a
// cluster, chunk buffers (0: resident slices), k-columns a chunk, shared
// memory bytes a CTA, clusters resident at once, clusters the launch
// needs.
extern "C" int chain_phases_cluster_wide_plan(int b, int rcw, int kcw,
                                              int* out) {
  if (!wide_takes(rcw, kcw)) return static_cast<int>(cudaErrorInvalidValue);
  WidePlan plan;
  int active = 0;
  const cudaError_t err = wide_choose(b, rcw, kcw, &plan, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kRows * plan.groups;
  out[0] = plan.groups;
  out[1] = plan.stages;
  out[2] = plan.chunk;
  out[3] = plan.smem;
  out[4] = active;
  out[5] = (b + rows - 1) / rows;
  return 0;
}

#ifdef CHAIN_STEP_PROFILE
// The clocks of the last launch: 8 per block step, 1024 steps.
extern "C" int chain_step_clock_copy(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_step_clock, sizeof(g_step_clock)));
}
#endif
