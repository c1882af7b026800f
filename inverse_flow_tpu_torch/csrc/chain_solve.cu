// Block recurrence of the inverse masked convolution, for a chain of up to
// four pad orders, in fp32 on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_chain_kernel` in
// inverse_flow_tpu/ops/fused_chain.py. For each order o (phase o reads
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
// Design. The TPU kernel keeps all of T resident in VMEM; here T is
// 614 KB at the flagship shape (RCW=392) and 16 MB at RCW=2048, far above
// the shared memory one block may use. So one CTA takes a tile of
// kBatchTile batch rows through every phase and block in order, keeps the
// block's input tile and its carry in shared memory, and streams the rows
// of T and G from global memory, where they stay in L2 (every CTA reads
// the same T). A warp computes one output column at a time: its lanes
// stride over k (coalesced reads of one row of T), each lane accumulates
// all rows of the batch tile, and a shuffle reduction finishes the dot
// products. The projection x.T^T and the carry product are both computed
// here, as in the TPU kernel; the operator build stays outside.
//
// What bounds it: every CTA re-reads all of T from L2 for every block step
// (RCW^2 * 4 bytes against RCW^2 * kBatchTile FMAs), and at B=100 the grid
// is only ceil(B / kBatchTile) = 25 CTAs on 132 SMs, each warp walking its
// rows of T with a few loads in flight. So the kernel is bound by the
// latency of its L2 reads of T, far below L2 bandwidth: occupancy at B=100
// is the first thing a later performance change should look at (larger
// batch tiles reading T once through shared memory, split-K over more CTAs,
// or tensor cores).

#include <cuda_runtime.h>

#include <cstddef>

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

}  // namespace

// Raises the kernel's dynamic shared memory limit to kMaxSmem on the
// current device. Call once per device before the first launch there.
extern "C" int chain_phases_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      chain_phases_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem));
}

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
