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
// Two kernels compute this function. ops/fused_chain.py:chain_variant picks
// one from (RCW, KCW) alone: the cluster kernel wherever its T and G slices
// fit in shared memory (every shape the repo's models reach), the streaming
// kernel for wider blocks.
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
#else
#define STEP_MARK(k)
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

}  // namespace

// Raises both kernels' dynamic shared memory limits on the current device.
// Call once per device before the first launch there.
extern "C" int chain_phases_init() {
  cudaError_t err = cudaFuncSetAttribute(
      chain_phases_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      chain_phases_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit));
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
// (ops/fused_chain.py:chain_variant sends those to the streaming kernel),
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

#ifdef CHAIN_STEP_PROFILE
// The clocks of the last launch: 8 per block step, 1024 steps.
extern "C" int chain_step_clock_copy(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_step_clock, sizeof(g_step_clock)));
}
#endif
