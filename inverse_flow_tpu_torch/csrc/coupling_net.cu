// The first two convolutions of a coupling net, conv3x3 (Cin -> N, padding
// 1, no bias) -> ReLU -> conv1x1 (N -> C, no bias), forward and backward, for
// Hopper (sm_90a), float32 FMA.
//
// Replaces no Pallas kernel: the JAX package leaves these convs to XLA, and
// the port gave them to cuDNN, which writes the N-wide hidden activation h
// (N = 512 at the flagship: 3.29 GB a net at B=8192, 14x14), transposes it
// NHWC <-> NCHW, runs the ReLU as its own pass and reads h back for the 1x1
// conv; its backward does that several times over. Per pixel the two convs
// are a small matrix-vector pair (K = 9 Cin -> N -> C: 18 x 512 then 512 x 4
// at the flagship's first level), so the card's float32 FMA rate (67 TFLOP/s)
// bounds them once h stays on chip: 2 (K + C) N FLOPs a pixel forward,
// 2 (3K + 2C) N backward (the hidden activation recomputed, dh, dW2, dW1,
// the input's patch gradient). The only bytes left are x1, the cotangent and
// the C-channel output.
//
// Layout. A pixel p = (b, y, x) of the B*H*W; its patch is the 3x3xCin
// neighbourhood, k = ci*9 + dy*3 + dx, zero outside the image, so that
// W1 (N, Cin, 3, 3) is the row-major N x K matrix. A block stages its tile
// of TP pixels' patches in shared memory k-major (pt[k][p]) and the hidden
// width in chunks of NJ channels (w1t[k][j], from W1 transposed to K x N
// by the wrapper, and w2c[c][j], W2's), zero past N and C. Every copy into
// shared memory is a cp.async issued for a whole tile or chunk at once, and
// the chunks are double-buffered: the next chunk's copies fly while this
// one is used, so no loop waits on a global load. Every thread owns pixels
// p = lane + 32 t (t < TPP) of its warp's group, so that its patch reads are
// one consecutive row across the warp, and walks hidden channels TJ at a
// time, a warp reading the same TJ weights.
//
// Shared-memory bandwidth. An SM returns one 32-lane register of shared
// memory a cycle (128 bytes, a 128-bit load taking four) and issues 128
// FMAs, so a loop that reads one value per FMA runs at a quarter of the FMA
// rate; on the card the kernels are bound by that and by latency, not by
// device memory. Every loop reads a value for several FMAs: a TPP x TJ tile
// of the hidden activation (4 x 16 forward, 4 x 8 backward) reads TPP + TJ
// values for TPP x TJ FMAs; the weight gradient's TJB x TCB tiles (4 x 5 to
// 4 x 9) and the patch gradient's 4 x TCB tiles read TJB + TCB and 4 + TCB.
// Scalar reads across a warp are consecutive or broadcast (conflict-free);
// the staged rows of da and h are padded to TP + 4 so that the weight
// gradient's 8 x 4 lane grid reads 32 distinct banks. The tile sizes trade
// that reuse against occupancy: the host's plan picks, from K, C and the
// card's shared memory, the instance whose blocks fit 3-4 to an SM at the
// flagship's shapes (PERF.md, section 6).
//
// coupling_net_fwd_kernel<TPP, TJ, CPT>: 4 warps, TP = 128 TPP pixels, each
// warp its own 32 TPP. For each chunk and each TJ channels of it: the hidden
// tile a (TPP x TJ, in registers), h = max(a, 0) in registers, and the
// output o[t][c] += h[t][j] W2[c][j] accumulated in registers over the
// block's width (CPT channels, C padded; a C above 64 runs in groups of 64
// output channels, one launch each). h never leaves the registers. Where the
// pixels give fewer tiles than twice the card's SMs (a small batch or
// image), the width splits over a thread-block cluster of S = 2-8 blocks
// (blockIdx.y, a contiguous slice each): each block leaves its partial
// output in its shared memory, and after one cluster barrier each sums a
// share of the tile's outputs over the S partials in rank order
// (distributed shared memory), so one launch still writes the output and
// the sum's order is fixed.
//
// coupling_net_bwd_kernel<TPP, TJ, TCB, TCC, DREG, W2SPLIT>: a persistent
// grid of G x S blocks (those resident on the card), each over tiles
// blockIdx.x, +G, ... and the chunks of its slice blockIdx.y of the width
// (S = 1 unless the tiles are fewer than the resident blocks); the 4 warps
// share a tile of TP = 32 TPP pixels and split each chunk of NJ = 4 TJ
// channels. Per chunk:
//   A. each warp's TJ channels: a (recomputed) and dh = W2^T g in registers,
//      da = dh [a > 0], h = max(a, 0); h and da go to shared memory (ht, dat,
//      [j][p]).
//   B. the weight gradients of the chunk over the tile's pixels, lanes on an
//      8 (j) x 4 (p) grid: dW1's K columns (da x patch) split over the warps
//      in TCB-column groups, each lane a quarter of the pixels; dW2's C rows
//      (h x g) in TCC-row groups, the pixels split over the warps (W2SPLIT,
//      each warp its own partial) or the rows as dW1's. Each sum goes over
//      its lane's pixels (four at a time), then over the 4 pixel lanes of a
//      channel by shuffles (a fixed tree), and into the block's partial
//      (part1[G][N][K], part2[G or 4G][C][N], written on the block's first
//      tile): each element one thread's, in a fixed order, its old value
//      read before the sums so that the read's latency hides behind them.
//   C. the patch gradient dP[p][k] += sum_j da[p][j] W1[j][k] over the chunk,
//      lanes on pixels, warps on K: summed over the chunks in registers
//      where a warp's share of K fits one column group (DREG: the
//      flagship's shapes), else in the tile's dps[k][p] in shared memory;
//      written to the slice's dpatch[S][K][P] after its last chunk.
// coupling_net_reduce_kernel then sums the partials in block order (dW1,
// dW2) and gathers dx1 from dpatch (col2im: each input element sums its 9
// taps, each over the S slices, in a fixed order). No float atomics: a run
// repeats bit for bit.
//
// Built without --use_fast_math; every product is an fmaf.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// the output channels one forward launch accumulates at most
constexpr int kMaxCpt = 64;
// the forward's largest split of the width: the portable cluster size
constexpr int kMaxSplit = 8;
// the weight gradient's lane grid: 8 lanes on channels x 4 on pixels
constexpr int kLj = 8;
constexpr int kLp = 4;

struct Shape {
  int b, cin, h, w, n, c;
  int hw, k, p;      // H*W, 9*Cin, B*H*W
  long long sb;      // x1's batch stride, in elements
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Asynchronous 4-byte copies into shared memory (cp.async, through L1): a
// block issues a whole tile's or chunk's loads at once and waits for them
// once; an invalid element is filled with zero (source size 0, the source
// address then only has to be a valid one).
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// pt[k][i] = the patch value k of pixel p0 + i (zero outside the image and
// past the last pixel), for i < TP: a thread takes an input channel of a
// pixel, finds the pixel's place once and copies its 9 taps.
template <int TP>
__device__ void load_patches(float* pt, const float* __restrict__ x1,
                             const Shape& s, int p0) {
  for (int idx = threadIdx.x; idx < s.cin * TP; idx += kThreads) {
    const int ci = idx / TP, i = idx - ci * TP;
    const int p = p0 + i;
    const bool in = p < s.p;
    int bi = 0, y = 0, x = 0;
    if (in) {
      bi = p / s.hw;
      const int r = p - bi * s.hw;
      y = r / s.w;
      x = r - y * s.w;
    }
    const float* src = x1 + bi * s.sb
                       + (static_cast<long long>(ci) * s.h + y) * s.w + x;
    float* dst = pt + ci * 9 * TP + i;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3 - 1, dx = t % 3 - 1;
      const bool valid = in && y + dy >= 0 && y + dy < s.h && x + dx >= 0
                         && x + dx < s.w;
      copy4(dst + t * TP, valid ? src + dy * s.w + dx : x1, valid);
    }
  }
}

// gt[c][i] = the cotangent g of output channel c at pixel p0 + i, zero past
// C (up to cp rows) and past the last pixel: a thread takes a pixel and
// copies its channels.
template <int TP>
__device__ void load_cotangent(float* gt, const float* __restrict__ g,
                               const Shape& s, int p0, int cp) {
  for (int i = threadIdx.x; i < TP; i += kThreads) {
    const int p = p0 + i;
    const bool in = p < s.p;
    int bi = 0, r = 0;
    if (in) {
      bi = p / s.hw;
      r = p - bi * s.hw;
    }
    const float* src = g + static_cast<long long>(bi) * s.c * s.hw + r;
    for (int c = 0; c < cp; ++c) {
      const bool valid = in && c < s.c;
      copy4(gt + c * TP + i, valid ? src + static_cast<long long>(c) * s.hw
                                   : g, valid);
    }
  }
}

// The chunk of channels j0 .. j0 + nj of W1: w1t[k][j] = W1^T[k][j0 + j]
// (W1 transposed to K x N by the wrapper), zero past N.
__device__ void load_w1(float* w1t, const float* __restrict__ w1t_g,
                        const Shape& s, int j0, int nj) {
  for (int idx = threadIdx.x; idx < s.k * nj; idx += kThreads) {
    const int kk = idx / nj, j = j0 + idx - kk * nj;
    const bool valid = j < s.n;
    copy4(w1t + idx,
          valid ? w1t_g + static_cast<long long>(kk) * s.n + j : w1t_g,
          valid);
  }
}

// The chunk of W2 (C, N): w2c[c][j] = W2[c][j0 + j] (c < crows), zero past
// N and C.
__device__ void load_w2(float* w2c, const float* __restrict__ w2,
                        const Shape& s, int j0, int nj, int crows) {
  for (int idx = threadIdx.x; idx < crows * nj; idx += kThreads) {
    const int c = idx / nj, j = j0 + idx - c * nj;
    const bool valid = c < s.c && j < s.n;
    copy4(w2c + idx, valid ? w2 + static_cast<long long>(c) * s.n + j : w2,
          valid);
  }
}

// The chunk of W2 transposed (N x C, by the wrapper) for output channels
// c0 .. c0 + CPT: w2t[j][c] = W2^T[j0 + j][c0 + c], zero past N and C.
template <int CPT>
__device__ void load_w2t(float* w2t, const float* __restrict__ w2t_g,
                         const Shape& s, int j0, int nj, int c0) {
  for (int idx = threadIdx.x; idx < nj * CPT; idx += kThreads) {
    const int jl = idx / CPT, c = c0 + idx - jl * CPT, j = j0 + jl;
    const bool valid = c < s.c && j < s.n;
    copy4(w2t + idx,
          valid ? w2t_g + static_cast<long long>(j) * s.c + c : w2t_g,
          valid);
  }
}

// a[t][j] = sum_k pt[k][pl + 32 t] w1t[k][jj + j], k in order.
template <int TPP, int TJ, int TP>
__device__ __forceinline__ void hidden_tile(float (&a)[TPP][TJ],
                                            const float* pt, const float* w1t,
                                            int k, int nj, int pl, int jj) {
#pragma unroll
  for (int t = 0; t < TPP; ++t)
#pragma unroll
    for (int j = 0; j < TJ; ++j) a[t][j] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < k; ++kk) {
    float pv[TPP];
#pragma unroll
    for (int t = 0; t < TPP; ++t) pv[t] = pt[kk * TP + pl + 32 * t];
    const float4* wr = reinterpret_cast<const float4*>(w1t + kk * nj + jj);
    float wv[TJ];
#pragma unroll
    for (int q = 0; q < TJ / 4; ++q) {
      const float4 v = wr[q];
      wv[4 * q] = v.x;
      wv[4 * q + 1] = v.y;
      wv[4 * q + 2] = v.z;
      wv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int t = 0; t < TPP; ++t)
#pragma unroll
      for (int j = 0; j < TJ; ++j) a[t][j] = fmaf(pv[t], wv[j], a[t][j]);
  }
}

template <int TPP, int TJ, int CPT>
__global__ void __launch_bounds__(kThreads)
coupling_net_fwd_kernel(const float* __restrict__ x1,
                        const float* __restrict__ w1t_g,
                        const float* __restrict__ w2t_g,
                        float* __restrict__ out, Shape s, int nj, int c0,
                        int ns) {
  constexpr int TP = kThreads * TPP;
  static_assert(CPT % 4 == 0, "output channels in fours");
  extern __shared__ float4 smem4[];
  // [K][TP] (and after the chunks the block's partial output [CPT][TP]
  // where the width splits over the cluster)
  float* pt = reinterpret_cast<float*>(smem4);
  const int split = static_cast<int>(gridDim.y);
  // two buffers of the chunk: w1t [K][nj] then w2t [nj][CPT] each
  const int w1size = round4(s.k * nj);
  const int wsize = w1size + nj * CPT;
  float* wbuf = pt + max(round4(s.k * TP), split > 1 ? CPT * TP : 0);
  const int p0 = blockIdx.x * TP;
  // this block's slice of the width (ns a multiple of nj)
  const int jb = blockIdx.y * ns, je = min(s.n, jb + ns);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this thread's pixels, as columns of pt: pl + 32 t
  const int pl = warp * 32 * TPP + lane;
  load_patches<TP>(pt, x1, s, p0);
  if (jb < je) {
    load_w1(wbuf, w1t_g, s, jb, nj);
    load_w2t<CPT>(wbuf + w1size, w2t_g, s, jb, nj, c0);
  }
  copies_commit();
  float o[TPP][CPT];
#pragma unroll
  for (int t = 0; t < TPP; ++t)
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[t][c] = 0.0f;
  int buf = 0;
  for (int j0 = jb; j0 < je; j0 += nj, buf ^= 1) {
    copies_wait();
    __syncthreads();
    // the next chunk into the other buffer, while this one is used
    if (j0 + nj < je) {
      float* nb = wbuf + (buf ^ 1) * wsize;
      load_w1(nb, w1t_g, s, j0 + nj, nj);
      load_w2t<CPT>(nb + w1size, w2t_g, s, j0 + nj, nj, c0);
      copies_commit();
    }
    const float* w1t = wbuf + buf * wsize;
    const float* w2t = w1t + w1size;
    for (int jj = 0; jj < nj; jj += TJ) {
      float a[TPP][TJ];
      hidden_tile<TPP, TJ, TP>(a, pt, w1t, s.k, nj, pl, jj);
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        float hv[TPP];
#pragma unroll
        for (int t = 0; t < TPP; ++t) hv[t] = fmaxf(a[t][j], 0.0f);
        const float4* wr =
            reinterpret_cast<const float4*>(w2t + (jj + j) * CPT);
#pragma unroll
        for (int c4 = 0; c4 < CPT / 4; ++c4) {
          const float4 v = wr[c4];
          const float wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int t = 0; t < TPP; ++t)
              o[t][4 * c4 + e] = fmaf(hv[t], wv[e], o[t][4 * c4 + e]);
        }
      }
    }
  }
  if (split > 1) {
    // the partials meet: each block sums its share of the tile's outputs
    // over the cluster's S blocks in rank order
    cg::cluster_group cluster = cg::this_cluster();
    copies_wait();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TPP; ++t)
#pragma unroll
      for (int c = 0; c < CPT; ++c) pt[c * TP + pl + 32 * t] = o[t][c];
    cluster.sync();
    // four pixels of a channel a step, the S ranks' loads issued together
    const int rank = static_cast<int>(cluster.block_rank());
    const float4* part[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      part[q] = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(pt, q < split ? q : 0));
    const int n4 = min(CPT, s.c - c0) * (TP / 4);
    for (int idx = rank * kThreads + threadIdx.x; idx < n4;
         idx += split * kThreads) {
      float4 got[kMaxSplit];
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q)
        if (q < split) got[q] = part[q][idx];
      float4 v = got[0];
#pragma unroll
      for (int q = 1; q < kMaxSplit; ++q)
        if (q < split) {
          v.x += got[q].x;
          v.y += got[q].y;
          v.z += got[q].z;
          v.w += got[q].w;
        }
      const int c = idx / (TP / 4), i = 4 * (idx - c * (TP / 4));
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + i + e;
        if (p < s.p) {
          const int bi = p / s.hw, r = p - bi * s.hw;
          out[(static_cast<long long>(bi) * s.c + c0 + c) * s.hw + r] =
              vs[e];
        }
      }
    }
    // no block leaves while another reads its shared memory
    cluster.sync();
    return;
  }
#pragma unroll
  for (int t = 0; t < TPP; ++t) {
    const int p = p0 + pl + 32 * t;
    if (p < s.p) {
      const int bi = p / s.hw, r = p - bi * s.hw;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (c0 + c < s.c)
          out[(static_cast<long long>(bi) * s.c + c0 + c) * s.hw + r] =
              o[t][c];
    }
  }
}

// Phase B, one group of up to TCB columns [col, col + nq) of a weight
// gradient: sum op[j][i] rows[col + q][i] over this lane's QP consecutive
// pixels i from pix0 (read four at a time) for the chunk's channels j = jl
// + 8 u (u < TJB), then over the 4 pixel lanes of a channel by shuffles (a
// fixed tree: every lane ends with the same sum), and add it into the
// partial part[j * js + (col + q) * cs] (the chunk's j0 added to j; written
// on the block's first tile).
// A lane stores the channels u = pl4 + 4 uu; their old values are read
// before the sums, so that the reads' latency hides behind them.
template <int TJB, int TCB, int TP, int QP>
__device__ __forceinline__ void grad_group(const float* op, const float* rows,
                                           int col, int nq, float* part,
                                           long long js, long long cs,
                                           int j0, int n, bool first,
                                           int jl, int pl4, int pix0) {
  constexpr int SP = TP + 4;
  constexpr int UO = TJB / kLp;
  static_assert(TJB % kLp == 0, "each pixel lane stores TJB / 4 channels");
  static_assert(QP % 4 == 0, "a lane's pixels in fours");
  float old[UO][TCB];
#pragma unroll
  for (int uu = 0; uu < UO; ++uu) {
    const int j = j0 + jl + kLj * (pl4 + kLp * uu);
#pragma unroll
    for (int q = 0; q < TCB; ++q)
      old[uu][q] = (!first && q < nq && j < n)
                       ? part[j * js + (col + q) * cs] : 0.0f;
  }
  float acc[TJB][TCB];
#pragma unroll
  for (int u = 0; u < TJB; ++u)
#pragma unroll
    for (int q = 0; q < TCB; ++q) acc[u][q] = 0.0f;
  const float* opl = op + jl * SP + pix0;
  const float* rowl = rows + col * TP + pix0;
  for (int m = 0; m < QP; m += 4) {
    float4 ov[TJB], rv[TCB];
#pragma unroll
    for (int u = 0; u < TJB; ++u)
      ov[u] = *reinterpret_cast<const float4*>(opl + kLj * u * SP + m);
#pragma unroll
    for (int q = 0; q < TCB; ++q)
      rv[q] = q < nq ? *reinterpret_cast<const float4*>(rowl + q * TP + m)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < TJB; ++u)
#pragma unroll
      for (int q = 0; q < TCB; ++q) {
        float v = fmaf(ov[u].x, rv[q].x, acc[u][q]);
        v = fmaf(ov[u].y, rv[q].y, v);
        v = fmaf(ov[u].z, rv[q].z, v);
        acc[u][q] = fmaf(ov[u].w, rv[q].w, v);
      }
  }
#pragma unroll
  for (int u = 0; u < TJB; ++u)
#pragma unroll
    for (int q = 0; q < TCB; ++q) {
      float v = acc[u][q];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[u][q] = v;
    }
#pragma unroll
  for (int uu = 0; uu < UO; ++uu) {
    const int j = j0 + jl + kLj * (pl4 + kLp * uu);
#pragma unroll
    for (int q = 0; q < TCB; ++q) {
      const int u0 = kLp * uu;
      const float v = pl4 == 0 ? acc[u0][q] : pl4 == 1 ? acc[u0 + 1][q]
                      : pl4 == 2 ? acc[u0 + 2][q] : acc[u0 + 3][q];
      if (q < nq && j < n) part[j * js + (col + q) * cs] = old[uu][q] + v;
    }
  }
}

// Phase C, one group of up to TCB columns [col, col + nq) of the patch
// gradient: acc[t][q] += sum over the chunk's channels j of
// dat[j][lane + 32 t] w1t[col + q][j], four channels at a time.
template <int TPP, int TCB, int TP, int NJ>
__device__ __forceinline__ void patch_group(float (&acc)[TPP][TCB],
                                            const float* dat,
                                            const float* w1t, int col,
                                            int nq, int lane) {
  constexpr int SP = TP + 4;
#pragma unroll 2
  for (int j = 0; j < NJ; j += 4) {
    float dv[4][TPP];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int t = 0; t < TPP; ++t) dv[e][t] = dat[(j + e) * SP + lane + 32 * t];
#pragma unroll
    for (int q = 0; q < TCB; ++q) {
      if (q >= nq) continue;
      const float4 w = *reinterpret_cast<const float4*>(w1t + (col + q) * NJ + j);
#pragma unroll
      for (int t = 0; t < TPP; ++t) {
        float v = fmaf(dv[0][t], w.x, acc[t][q]);
        v = fmaf(dv[1][t], w.y, v);
        v = fmaf(dv[2][t], w.z, v);
        acc[t][q] = fmaf(dv[3][t], w.w, v);
      }
    }
  }
}

// DREG: the warp's patch-gradient columns fit one group (K / 4 <= TCB), so
// its sums stay in registers over the chunks; else they go to shared
// memory (dps) after each chunk.
// W2SPLIT: dW2's pixels split over the warps (each warp a quarter of the
// tile, all C columns, its own partial), so that each warp reads ht once
// for all C; else its C columns split over the warps as dW1's are.
template <int TPP, int TJ, int TCB, int TCC, bool DREG, bool W2SPLIT>
__global__ void __launch_bounds__(kThreads)
coupling_net_bwd_kernel(const float* __restrict__ x1,
                        const float* __restrict__ w1t_g,
                        const float* __restrict__ w2,
                        const float* __restrict__ g,
                        float* __restrict__ dpatch, float* __restrict__ part1,
                        float* __restrict__ part2, Shape s, int cp,
                        int ntiles, int nsc) {
  constexpr int TP = 32 * TPP;
  constexpr int NJ = kWarps * TJ;
  constexpr int TJB = NJ / kLj;
  constexpr int SP = TP + 4;   // dat / ht rows
  constexpr int DS = TP + 1;   // dps rows
  static_assert(NJ % kLj == 0, "the chunk splits over 8 channel lanes");
  extern __shared__ float4 smem4[];
  float* pt = reinterpret_cast<float*>(smem4);   // [K][TP]
  float* gt = pt + round4(s.k * TP);             // [cp][TP]
  float* dat = gt + round4(cp * TP);             // [NJ][SP]
  float* ht = dat + NJ * SP;                     // [NJ][SP]
  // two buffers of the chunk: [K][NJ] then [cp][NJ] each
  float* wbuf = ht + NJ * SP;
  const int wsize = round4(s.k * NJ) + round4(cp * NJ);
  float* dps = wbuf + 2 * wsize;                 // [K][DS], unless DREG
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jl = lane & (kLj - 1), pl4 = lane >> 3;
  // the warp's share of dW1's columns and of dP's K, and of dW2's rows
  const int kper = (s.k + kWarps - 1) / kWarps;
  const int kb = min(s.k, warp * kper), ke = min(s.k, kb + kper);
  const int cper = (s.c + kWarps - 1) / kWarps;
  const int cb = min(s.c, warp * cper), ce = min(s.c, cb + cper);
  // this block's slice of the width: chunks [mb, me), nsc a slice
  const int nch = (s.n + NJ - 1) / NJ;
  const int mb = blockIdx.y * nsc, me = min(nch, mb + nsc);
  const long long k64 = s.k, n64 = s.n;
  dpatch += static_cast<long long>(blockIdx.y) * s.k * s.p;
  float* part1_b = part1 + static_cast<long long>(blockIdx.x) * n64 * k64;
  // (at most 4 x the resident blocks) x C rows: within 32 bits
  float* part2_b = part2 + (W2SPLIT ? kWarps * blockIdx.x + warp
                                     : blockIdx.x) * s.c * n64;
  if (static_cast<int>(blockIdx.x) < ntiles && mb < me) {
    load_w1(wbuf, w1t_g, s, mb * NJ, NJ);
    load_w2(wbuf + round4(s.k * NJ), w2, s, mb * NJ, NJ, cp);
    copies_commit();
  }
  bool first = true;
  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * TP;
    __syncthreads();
    load_patches<TP>(pt, x1, s, p0);
    load_cotangent<TP>(gt, g, s, p0, cp);
    copies_commit();
    float dacc[TPP][TCB];
#pragma unroll
    for (int t = 0; t < TPP; ++t)
#pragma unroll
      for (int q = 0; q < TCB; ++q) dacc[t][q] = 0.0f;
    if constexpr (!DREG)
      for (int idx = threadIdx.x; idx < s.k * DS; idx += kThreads)
        dps[idx] = 0.0f;
    for (int m = mb; m < me; ++m, buf ^= 1) {
      const int j0 = m * NJ;
      copies_wait();
      __syncthreads();
      // the next chunk (of this tile, or the next tile's first) into the
      // other buffer, while this one is used
      if (m + 1 < me || tile + static_cast<int>(gridDim.x) < ntiles) {
        float* nb = wbuf + (buf ^ 1) * wsize;
        const int jn = (m + 1 < me ? m + 1 : mb) * NJ;
        load_w1(nb, w1t_g, s, jn, NJ);
        load_w2(nb + round4(s.k * NJ), w2, s, jn, NJ, cp);
        copies_commit();
      }
      const float* w1t = wbuf + buf * wsize;
      const float* w2c = w1t + round4(s.k * NJ);
      // A: a, dh, da and h of this warp's TJ channels at the tile's pixels
      {
        const int jj = warp * TJ;
        float a[TPP][TJ];
        hidden_tile<TPP, TJ, TP>(a, pt, w1t, s.k, NJ, lane, jj);
        unsigned mask[TPP] = {};
#pragma unroll
        for (int t = 0; t < TPP; ++t)
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            const bool on = a[t][j] > 0.0f;
            mask[t] |= static_cast<unsigned>(on) << j;
            ht[(jj + j) * SP + lane + 32 * t] = on ? a[t][j] : 0.0f;
          }
        float d[TPP][TJ];
#pragma unroll
        for (int t = 0; t < TPP; ++t)
#pragma unroll
          for (int j = 0; j < TJ; ++j) d[t][j] = 0.0f;
        for (int c = 0; c < s.c; ++c) {
          float gv[TPP];
#pragma unroll
          for (int t = 0; t < TPP; ++t) gv[t] = gt[c * TP + lane + 32 * t];
          const float4* wr =
              reinterpret_cast<const float4*>(w2c + c * NJ + jj);
          float wv[TJ];
#pragma unroll
          for (int q = 0; q < TJ / 4; ++q) {
            const float4 v = wr[q];
            wv[4 * q] = v.x;
            wv[4 * q + 1] = v.y;
            wv[4 * q + 2] = v.z;
            wv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int t = 0; t < TPP; ++t)
#pragma unroll
            for (int j = 0; j < TJ; ++j) d[t][j] = fmaf(gv[t], wv[j], d[t][j]);
        }
#pragma unroll
        for (int t = 0; t < TPP; ++t)
#pragma unroll
          for (int j = 0; j < TJ; ++j)
            dat[(jj + j) * SP + lane + 32 * t] =
                (mask[t] >> j) & 1u ? d[t][j] : 0.0f;
      }
      __syncthreads();
      // B: the chunk's weight gradients over the tile, into the partials:
      // dW1[j][k] (da x patch) and dW2[c][j] (h x g)
      for (int col = kb; col < ke; col += TCB)
        grad_group<TJB, TCB, TP, TP / kLp>(dat, pt, col, min(TCB, ke - col),
                                           part1_b, k64, 1, j0, s.n, first,
                                           jl, pl4, pl4 * (TP / kLp));
      if constexpr (W2SPLIT) {
        for (int col = 0; col < s.c; col += TCC)
          grad_group<TJB, TCC, TP, TP / (kLp * kWarps)>(
              ht, gt, col, min(TCC, s.c - col), part2_b, 1, n64, j0, s.n,
              first, jl, pl4,
              warp * (TP / kWarps) + pl4 * (TP / (kLp * kWarps)));
      } else {
        for (int col = cb; col < ce; col += TCC)
          grad_group<TJB, TCC, TP, TP / kLp>(ht, gt, col, min(TCC, ce - col),
                                             part2_b, 1, n64, j0, s.n, first,
                                             jl, pl4, pl4 * (TP / kLp));
      }
      // C: the patch gradient of the chunk
      if constexpr (DREG) {
        patch_group<TPP, TCB, TP, NJ>(dacc, dat, w1t, kb, ke - kb, lane);
      } else {
        for (int col = kb; col < ke; col += TCB) {
          const int nq = min(TCB, ke - col);
          float acc[TPP][TCB];
#pragma unroll
          for (int t = 0; t < TPP; ++t)
#pragma unroll
            for (int q = 0; q < TCB; ++q) acc[t][q] = 0.0f;
          patch_group<TPP, TCB, TP, NJ>(acc, dat, w1t, col, nq, lane);
#pragma unroll
          for (int q = 0; q < TCB; ++q)
            if (q < nq)
#pragma unroll
              for (int t = 0; t < TPP; ++t)
                dps[(col + q) * DS + lane + 32 * t] += acc[t][q];
        }
      }
    }
    first = false;
    // the tile's patch gradient, dpatch[k][p]
    if constexpr (DREG) {
#pragma unroll
      for (int q = 0; q < TCB; ++q)
#pragma unroll
        for (int t = 0; t < TPP; ++t) {
          const int p = p0 + lane + 32 * t;
          if (kb + q < ke && p < s.p)
            dpatch[static_cast<long long>(kb + q) * s.p + p] = dacc[t][q];
        }
    } else {
      __syncthreads();
      for (int idx = threadIdx.x; idx < s.k * TP; idx += kThreads) {
        const int kk = idx / TP, i = idx - kk * TP;
        const int p = p0 + i;
        if (p < s.p)
          dpatch[static_cast<long long>(kk) * s.p + p] = dps[kk * DS + i];
      }
    }
  }
}

// Blocks [0, nw): dW1 = sum over the grid partials of part1, then dW2 over
// the grid2 of part2, in order. Blocks [nw, ...): dx1, each element's 9 taps
// of dpatch in order, each tap over the split slices in order.
__global__ void __launch_bounds__(256)
coupling_net_reduce_kernel(const float* __restrict__ part1,
                           const float* __restrict__ part2,
                           const float* __restrict__ dpatch,
                           float* __restrict__ dw1, float* __restrict__ dw2,
                           float* __restrict__ dx1, Shape s, int grid,
                           int grid2, int nw, int split) {
  if (blockIdx.x < nw) {
    const long long n1 = static_cast<long long>(s.n) * s.k;
    const long long n2 = static_cast<long long>(s.c) * s.n;
    const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
    if (e < n1) {
      float v = 0.0f;
      for (int b = 0; b < grid; ++b) v += part1[b * n1 + e];
      dw1[e] = v;
    } else if (e < n1 + n2) {
      float v = 0.0f;
      for (int b = 0; b < grid2; ++b) v += part2[b * n2 + e - n1];
      dw2[e - n1] = v;
    }
    return;
  }
  const long long e =
      static_cast<long long>(blockIdx.x - nw) * 256 + threadIdx.x;
  if (e >= static_cast<long long>(s.p) * s.cin) return;
  const int x = static_cast<int>(e % s.w);
  long long r = e / s.w;
  const int y = static_cast<int>(r % s.h);
  r /= s.h;
  const int ci = static_cast<int>(r % s.cin);
  const int bi = static_cast<int>(r / s.cin);
  float v = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = y - dy + 1;
    if (yy < 0 || yy >= s.h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = x - dx + 1;
      if (xx < 0 || xx >= s.w) continue;
      const long long p = (static_cast<long long>(bi) * s.h + yy) * s.w + xx;
      const float* d =
          dpatch + static_cast<long long>(ci * 9 + dy * 3 + dx) * s.p + p;
      for (int q = 0; q < split; ++q)
        v += d[static_cast<long long>(q) * s.k * s.p];
    }
  }
  dx1[e] = v;
}

// ---------------------------------------------------------------------------
// The host's plan: which instance, pixels a tile, channels a chunk, and how
// far the width splits where the tiles alone do not fill the card.
// ---------------------------------------------------------------------------

Shape make_shape(int b, int cin, int h, int w, int n, int c, long long sb) {
  Shape s;
  s.b = b; s.cin = cin; s.h = h; s.w = w; s.n = n; s.c = c;
  s.hw = h * w; s.k = 9 * cin; s.p = b * h * w; s.sb = sb;
  return s;
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

int max_smem_optin() {
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// forward instances, by the output channels a launch takes
enum FwdKind { kF4, kF8, kF16, kF32, kF64 };
struct FwdPlan { int kind, tpp, tj, cpt, nj, ns, split, tiles, smem; };

int fwd_smem(const Shape& s, int tp, int cpt, int nj, int split) {
  return 4 * (max(round4(s.k * tp), split > 1 ? cpt * tp : 0)
              + 2 * (round4(s.k * nj) + nj * cpt));
}

// The forward at this shape with the width split over `split` blocks of a
// cluster: 64 channels a chunk, fewer for a narrower slice, or where a
// wide patch leaves room for one block an SM and the least chunk would
// fit two, or the block would not fit at all; ns, the channels of a slice,
// a multiple of the chunk.
FwdPlan fwd_plan(const Shape& s, int split) {
  FwdPlan f;
  const int c = s.c;
  if (c <= 4) { f.kind = kF4; f.tpp = 4; f.tj = 16; f.cpt = 4; }
  else if (c <= 8) { f.kind = kF8; f.tpp = 4; f.tj = 16; f.cpt = 8; }
  else if (c <= 16) { f.kind = kF16; f.tpp = 2; f.tj = 16; f.cpt = 16; }
  else if (c <= 32) { f.kind = kF32; f.tpp = 1; f.tj = 16; f.cpt = 32; }
  else { f.kind = kF64; f.tpp = 1; f.tj = 16; f.cpt = kMaxCpt; }
  const int tp = kThreads * f.tpp;
  const int per = (s.n + split - 1) / split;
  f.nj = per >= 64 ? 64 : (per + f.tj - 1) / f.tj * f.tj;
  const int limit = max_smem_optin();
  const int room = fwd_smem(s, tp, f.cpt, f.tj, split) <= limit / 2
                       ? limit / 2 : limit;
  for (;;) {
    f.smem = fwd_smem(s, tp, f.cpt, f.nj, split);
    if (f.smem <= room || f.nj <= f.tj) break;
    f.nj = max(f.tj, f.nj / 2 / f.tj * f.tj);
  }
  f.ns = (per + f.nj - 1) / f.nj * f.nj;
  f.split = split;
  f.tiles = (s.p + tp - 1) / tp;
  return f;
}

// backward instances
enum BwdKind { kB8x5x4, kB8x9x8, kB8x8x4, kB8x8x4p1 };
struct BwdPlan { int kind, tpp, tj, tcb, dreg, w2parts, smem; };

int bwd_smem(const Shape& s, int tpp, int tj, int cp, bool dreg) {
  const int tp = 32 * tpp, nj = kWarps * tj;
  return 4 * (round4(s.k * tp) + round4(cp * tp) + 2 * nj * (tp + 4)
              + 2 * (round4(s.k * nj) + round4(cp * nj))
              + (dreg ? 0 : s.k * (tp + 1)));
}

// The backward's instance at this shape: the one whose lanes fit K and C,
// else the 32-pixel tile, whose shared memory fits any K the forward
// takes.
BwdPlan bwd_plan(const Shape& s) {
  BwdPlan b;
  const int kper = (s.k + kWarps - 1) / kWarps;
  b.w2parts = kWarps;
  if (kper <= 5 && s.c <= 4) {
    b.kind = kB8x5x4; b.tpp = 4; b.tj = 8; b.tcb = 5; b.dreg = 1;
  } else if (kper == 9 && s.c <= 8) {
    b.kind = kB8x9x8; b.tpp = 4; b.tj = 8; b.tcb = 9; b.dreg = 1;
  } else {
    b.kind = kB8x8x4; b.tpp = 4; b.tj = 8; b.tcb = 8; b.dreg = 0;
  }
  const int cp = round4(s.c);
  b.smem = bwd_smem(s, b.tpp, b.tj, cp, b.dreg);
  if (b.smem > max_smem_optin()) {
    b.kind = kB8x8x4p1; b.tpp = 1; b.tj = 8; b.tcb = 8; b.dreg = 0;
    b.w2parts = 1;
    b.smem = bwd_smem(s, b.tpp, b.tj, cp, b.dreg);
  }
  return b;
}

// The backward's chunks a slice when the width splits `split` ways.
int bwd_slice(const Shape& s, const BwdPlan& b, int split) {
  const int nch = (s.n + kWarps * b.tj - 1) / (kWarps * b.tj);
  return (nch + split - 1) / split;
}

// Raises the kernel's dynamic shared-memory limit to `smem` bytes, once a
// size (the largest asked for so far, per instance).
template <auto Kernel>
int prepare(int smem) {
  static int raised = 0;
  if (smem <= raised) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) raised = smem;
  return static_cast<int>(err);
}

// The forward's launch: a grid of tiles x split, the split blocks of a
// tile one cluster.
cudaLaunchConfig_t fwd_config(const FwdPlan& f, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(f.tiles, f.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = f.smem;
  cfg.stream = stream;
  if (f.split > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = 1;
    attr->val.clusterDim.y = f.split;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

template <int TPP, int TJ, int CPT>
int launch_fwd(const float* x1, const float* w1t, const float* w2t,
               float* out, const Shape& s, const FwdPlan& f,
               cudaStream_t stream) {
  constexpr auto kernel = coupling_net_fwd_kernel<TPP, TJ, CPT>;
  int err = prepare<kernel>(f.smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fwd_config(f, stream, &attr);
  for (int c0 = 0; c0 < s.c; c0 += CPT) {
    err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, x1, w1t, w2t,
                                              out, s, f.nj, c0, f.ns));
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

// *active: the clusters of the forward's plan resident at once (0 where
// its clusters do not fit an SM group).
template <int TPP, int TJ, int CPT>
int fwd_clusters(const FwdPlan& f, int* active) {
  constexpr auto kernel = coupling_net_fwd_kernel<TPP, TJ, CPT>;
  int err = prepare<kernel>(f.smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fwd_config(f, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(active, kernel,
                                                         &cfg));
}

int fwd_active(const FwdPlan& f, int* active) {
  switch (f.kind) {
    case kF4: return fwd_clusters<4, 16, 4>(f, active);
    case kF8: return fwd_clusters<4, 16, 8>(f, active);
    case kF16: return fwd_clusters<2, 16, 16>(f, active);
    case kF32: return fwd_clusters<1, 16, 32>(f, active);
    default: return fwd_clusters<1, 16, 64>(f, active);
  }
}

// The forward's split: the largest power of two to 8 that leaves every
// slice TJ channels or more and whose clusters, one a tile, are all
// resident at once; 1 where no split's are.
int fwd_split(const Shape& s) {
  const FwdPlan f = fwd_plan(s, 1);
  int best = 1;
  for (int split = 2; split <= kMaxSplit && split * f.tj <= s.n;
       split *= 2) {
    int active = 0;
    if (fwd_active(fwd_plan(s, split), &active) != 0) {
      cudaGetLastError();
      break;
    }
    if (active < f.tiles) break;
    best = split;
  }
  return best;
}

template <int TPP, int TJ, int TCB, int TCC, bool DREG, bool W2SPLIT>
int bwd_occupancy(int smem, int* per_sm) {
  constexpr auto kernel =
      coupling_net_bwd_kernel<TPP, TJ, TCB, TCC, DREG, W2SPLIT>;
  int err = prepare<kernel>(smem);
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, kThreads, smem));
}

int bwd_resident(const BwdPlan& b, int* blocks) {
  int per_sm = 0, err = 0;
  switch (b.kind) {
    case kB8x5x4:
      err = bwd_occupancy<4, 8, 5, 4, true, true>(b.smem, &per_sm);
      break;
    case kB8x9x8:
      err = bwd_occupancy<4, 8, 9, 8, true, true>(b.smem, &per_sm);
      break;
    case kB8x8x4:
      err = bwd_occupancy<4, 8, 8, 4, false, true>(b.smem, &per_sm);
      break;
    default:
      err = bwd_occupancy<1, 8, 8, 4, false, false>(b.smem, &per_sm);
      break;
  }
  if (err) return err;
  *blocks = per_sm * device_attr(cudaDevAttrMultiProcessorCount);
  return per_sm > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

template <int TPP, int TJ, int TCB, int TCC, bool DREG, bool W2SPLIT>
int launch_bwd(const float* x1, const float* w1t, const float* w2,
               const float* g, float* dpatch, float* part1, float* part2,
               int grid, int split, const Shape& s, const BwdPlan& b,
               cudaStream_t stream) {
  constexpr auto kernel =
      coupling_net_bwd_kernel<TPP, TJ, TCB, TCC, DREG, W2SPLIT>;
  int err = prepare<kernel>(b.smem);
  if (err) return err;
  const int tp = 32 * TPP;
  const int ntiles = (s.p + tp - 1) / tp;
  kernel<<<dim3(grid, split), kThreads, b.smem, stream>>>(
      x1, w1t, w2, g, dpatch, part1, part2, s, round4(s.c), ntiles,
      bwd_slice(s, b, split));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan at this shape: out[0..15] = forward pixels a block, channels a
// chunk, output channels a launch, shared-memory bytes; backward pixels a
// tile, channels a chunk, column group, shared-memory bytes, blocks
// resident on the card, tiles; forward launches (groups of output
// channels); dW2's partials a backward block; the forward's split (blocks
// a cluster); the backward's split (slices of the width), its grid of
// tile blocks and its instance. The backward splits where its tiles are
// fewer than the resident blocks: the largest power of two of whole
// chunks a slice that keeps every tile of every slice on a resident block.
int coupling_net_plan(int b, int cin, int h, int w, int n, int c, int* out) {
  const Shape s = make_shape(b, cin, h, w, n, c, 0);
  const BwdPlan bp = bwd_plan(s);
  int resident = 0;
  const int err = bwd_resident(bp, &resident);
  if (err) return err;
  const FwdPlan f = fwd_plan(s, fwd_split(s));
  const int tp = 32 * bp.tpp;
  const int tiles = (s.p + tp - 1) / tp;
  const int nch = (s.n + kWarps * bp.tj - 1) / (kWarps * bp.tj);
  int split = 1;
  while (2 * split <= nch && tiles * 2 * split <= resident) split *= 2;
  split = (nch + bwd_slice(s, bp, split) - 1) / bwd_slice(s, bp, split);
  out[0] = kThreads * f.tpp; out[1] = f.nj; out[2] = f.cpt; out[3] = f.smem;
  out[4] = tp; out[5] = kWarps * bp.tj; out[6] = bp.tcb; out[7] = bp.smem;
  out[8] = resident; out[9] = tiles;
  out[10] = (c + f.cpt - 1) / f.cpt; out[11] = bp.w2parts;
  out[12] = f.split; out[13] = split;
  out[14] = min(tiles, max(1, resident / split));
  out[15] = bp.kind;
  if (f.smem > max_smem_optin() || bp.smem > max_smem_optin())
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// out (B, C, H, W) = conv1x1(relu(conv3x3(x1, w1, padding 1)), w2), given
// w1t = W1 as the K x N matrix (W1 (N, Cin, 3, 3) transposed) and w2t = W2
// (C, N) transposed; x1's batch stride is sb elements (a channel slice of a
// wider tensor), its channel, row and column strides H*W, W and 1; split
// from coupling_net_plan (out[12]).
int coupling_net_fwd_f32(const float* x1, const float* w1t, const float* w2t,
                         float* out, int b, int cin, int h, int w, int n,
                         int c, long long sb, int split, void* stream) {
  const Shape s = make_shape(b, cin, h, w, n, c, sb);
  const FwdPlan f = fwd_plan(s, split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (f.kind) {
    case kF4: return launch_fwd<4, 16, 4>(x1, w1t, w2t, out, s, f, st);
    case kF8: return launch_fwd<4, 16, 8>(x1, w1t, w2t, out, s, f, st);
    case kF16: return launch_fwd<2, 16, 16>(x1, w1t, w2t, out, s, f, st);
    case kF32: return launch_fwd<1, 16, 32>(x1, w1t, w2t, out, s, f, st);
    default: return launch_fwd<1, 16, 64>(x1, w1t, w2t, out, s, f, st);
  }
}

// The backward launch: dpatch (split, 9*Cin, B*H*W) and the partials part1
// (grid, N, 9*Cin) and part2 (grid * out[11], C, N); grid and split from
// coupling_net_plan (out[14], out[13]).
int coupling_net_bwd_f32(const float* x1, const float* w1t, const float* w2,
                         const float* g, float* dpatch, float* part1,
                         float* part2, int grid, int split, int b, int cin,
                         int h, int w, int n, int c, long long sb,
                         void* stream) {
  const Shape s = make_shape(b, cin, h, w, n, c, sb);
  const BwdPlan bp = bwd_plan(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bp.kind) {
    case kB8x5x4:
      return launch_bwd<4, 8, 5, 4, true, true>(x1, w1t, w2, g, dpatch,
                                                 part1, part2, grid, split, s,
                                                 bp, st);
    case kB8x9x8:
      return launch_bwd<4, 8, 9, 8, true, true>(x1, w1t, w2, g, dpatch,
                                                part1, part2, grid, split, s,
                                                bp, st);
    case kB8x8x4:
      return launch_bwd<4, 8, 8, 4, false, true>(x1, w1t, w2, g, dpatch,
                                                 part1, part2, grid, split, s,
                                                 bp, st);
    default:
      return launch_bwd<1, 8, 8, 4, false, false>(x1, w1t, w2, g, dpatch,
                                                  part1, part2, grid, split,
                                                  s, bp, st);
  }
}

// dw1 (N, Cin, 3, 3) and dw2 (C, N) from the grid and grid2 partials; dx1
// (B, Cin, H, W) from the split slices of dpatch unless it is null.
int coupling_net_reduce_f32(const float* part1, const float* part2,
                            const float* dpatch, float* dw1, float* dw2,
                            float* dx1, int grid, int grid2, int split, int b,
                            int cin, int h, int w, int n, int c,
                            void* stream) {
  const Shape s = make_shape(b, cin, h, w, n, c, 0);
  const long long nw_elems = static_cast<long long>(n) * s.k
                             + static_cast<long long>(c) * n;
  const int nw = static_cast<int>((nw_elems + 255) / 256);
  const long long nx = dx1 ? static_cast<long long>(s.p) * cin : 0;
  const int blocks = nw + static_cast<int>((nx + 255) / 256);
  coupling_net_reduce_kernel<<<blocks, 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      part1, part2, dpatch, dw1, dw2, dx1, s, grid, grid2, nw, split);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
