// Orientation-bin matching kernels for Hopper (sm_90a), plain C interface.
//
// They replace the two Pallas TPU kernels of ccvpe_tpu/ops/pallas_matching.py:
//
//   K1  ccvpe_match_epilogue  <- _kernel_fused (pallas_call at :225)
//       Cg == Cs.  One read of each pixel row X = x[b, p, :] gives
//         scores[b,p,i] = sum_c X[c] * g_b[(c - k_i) mod Cs] / max(||X|| ||g_b||, 1e-12)
//         smax[b,p]     = max_i scores[b,p,i]   (f32, before the cast)
//         xnorm[b,p,:]  = X / max(||X||, 1e-12)
//   K2  ccvpe_match_scores    <- _kernel (pallas_call at :116)
//       scores only; with Cg < Cs the window norm is masked per bin:
//         sq[b,p,i] = sum_c X[c]^2 * [(c - k_i) mod Cs < Cg]
//
// k_i = (start + offset_i * shift) mod Cs is computed on the host.
//
// What bounds them on the card: device-memory bytes.  Per element of X they
// do 2 * bins FLOP (about 4 FLOP per byte moved at bins = 20), far below
// the card's ratio of f32 FLOP rate to memory rate (about 20), so what
// matters is to read X once, write each output once, and keep the
// instructions per element few enough that the FMA pipes are not the limit.
// Two layouts, chosen by the wrapper from the shape (both compute the same
// function in f32, equal to within an ulp per output, K2's tile within a
// few):
//
//   * warp layout (large Cs or few pixel rows: the coarse scales, and rows
//     that are not whole 16-byte granules): one block per (tile of rows,
//     sample b); g_b, zero-padded to Cs and stored twice, sits in shared
//     memory so that g[(c - k_i) mod Cs] is g2[c - k_i + Cs];
//     one warp per pixel row, lanes striding over the channels (coalesced
//     loads), `NB` f32 accumulators per lane, warp shuffles to reduce them.
//     The shuffles cost about 5 * (bins + 1) instructions per row, which
//     is small beside the row's Cs * bins / 32 FMAs per lane only when Cs is
//     large.  K1 writes xnorm in a second pass over the rows, which were
//     just read, so it hits L2.  It scales by 1 / max(||X||, 1e-12),
//     computed once per row: within an ulp of the division, which would
//     cost several instructions per element.
//   * tile layout (the fine scales, and K2 at 320 channels; chosen over
//     `warp` where it measured faster): persistent, double-buffered, one
//     read of x.  K1's (match_tile_kernel) is bound by bytes like the
//     warp layout; each choice cuts a cost that kept a simpler layout (a
//     block per 128 rows that built W for itself and staged x in
//     32-channel chunks) from the memory rate:
//       - blocks live long: the grid is (blocks resident on the card /
//         batch) x batch, each block walks the tiles of its sample with a
//         stride of the grid and builds W and ||g_b|| once, not per 128
//         rows, while its first tile is already in flight;
//       - a tile is R consecutive pixel rows, one contiguous span of x,
//         copied in 16-byte cp.async granules into a ring of two stages:
//         tile t+1 is in flight while tile t is computed and written;
//       - the row stride in shared memory is padded to an odd number of
//         granules, so a warp's per-row 16-byte reads (thread = row) hit
//         distinct banks (a flat copy gives 2-, 4- and 8-way conflicts at
//         40, 80 and 160 f32 channels); bf16 is staged raw, 8 a granule;
//       - a thread per pixel row runs the row's Cs x bins product in f32
//         FMAs against float4 broadcast reads of the rolled descriptor
//         matrix W[c][i] = g_b[(c - k_i) mod Cs] in shared memory (no
//         shuffles, no reductions across threads), and scales the scores by
//         one reciprocal per row (within an ulp of the division per bin);
//       - all three outputs leave from shared memory in 16-byte stores,
//         xnorm from the staged tile itself: no second read of x.
//     K2's (match_scores_tile_kernel) shares the ring, the copies and the
//     stores, with no smax and no xnorm, and differs in three ways:
//       - a thread may take R = 2 rows (rows t and t + threads of the
//         tile), so one float4 of W feeds 8 FMAs; the ring may have one
//         stage (the next tile's copy starts once the tile is computed,
//         and the SM's other blocks compute meanwhile); the wrapper's plan
//         picks threads, R and stages per shape from times on the card;
//       - the window norm when Cg < Cs comes from segments: the window
//         edges k_i and (k_i + Cg) mod Cs, with channel 0, cut the row into
//         at most 2 bins + 1 runs of channels, and every window is a cyclic
//         run of whole segments (matching_cuda.window_segments).  After the
//         products, a second pass over the staged row sums X^2 per segment
//         (the segment ends are one bit per channel, the same for every
//         thread, so the flush is a predicated store, not a branch); then
//         per block of segments (as long as the shortest window) the
//         prefix sums P and suffix sums Q; bin i's sq is Q of its first
//         segment, Q of the first segment of each whole block it spans and
//         P of its last segment (matching_cuda.window_blocks).  All are
//         sums of non-negative terms, never differences of prefix sums, so
//         a window of zeros gives exactly 0 (a difference could come out a
//         few ulps below 0, and sqrt NaN) and a small window beside large
//         values loses no accuracy to cancellation;
//       - the scale is min(rsqrt(sq) / ||g_b||, 1e12), within 2 ulp of the
//         clamped division.
//     Alignment: x, xnorm and a tile's span of them are 16-byte aligned
//     because Cs * sizeof(T) is a multiple of 16 (the wrapper refuses
//     other Cs).  A span of scores (R * bins) or smax (R) starts anywhere:
//     its rows are staged at an offset of (first element mod V) in shared
//     memory, so a granule there is a granule in the output; the part
//     before the first whole granule and after the last is written element
//     by element, and nothing outside the span.  The last tile of a sample
//     copies, computes and writes only its rows < HW.
//
// Where it is likely to go wrong, and what the code does about it:
//   * negative offsets: C's % is not Python's; k_i comes from the host,
//     already in [0, Cs), and c - k_i is brought into [0, Cs) by adding Cs
//     when negative (warp layout: g2[c - k_i + Cs], c - k_i + Cs in [1, 2 Cs));
//   * ragged spatial tails: the last tile of a sample masks rows p >= HW
//     (no padding and slicing as on the TPU);
//   * zero rows: the 1e-12 clamps of the TPU kernel are kept, so a zero row
//     gives scores 0 and xnorm 0, not NaN;
//   * centred window (Oxford): the mask (c - k_i) mod Cs < Cg is computed
//     from k_i (inline in the warp layout); the tile layout's segment table
//     comes from the host by value, like k_i, and nothing is copied to the
//     device per call;
//   * ||g_b||: reduced in the block while g_b is staged.
//
// Inputs are f32 or bf16; accumulation is f32; outputs are in x's dtype.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxBins = 32;
constexpr int kWarps = 8;                 // warp layout: rows in flight per block
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;                // warp layout: loads in flight per lane
constexpr int kTileMaxRows = 128;         // tile layout: rows per tile = threads per block
constexpr int kTileStages = 2;            // tile layout: tiles in the shared-memory ring
constexpr int kTileMinBlocks = 4;         // tile layout: blocks per SM the registers allow
constexpr int kMaxSegs = 2 * kMaxBins + 1;  // K2's window segments: edges k_i, k_i + Cg and 0

struct BinShifts {
  int k[kMaxBins];  // k_i for i < bins; 0 (any valid shift) beyond
};

// K2's windows as runs of segments (matching_cuda.window_segments and
// window_blocks).  Segments fall into blocks of `block` (the last may be
// shorter); P[j] sums the segments of j's block up to j, Q[j] those from j.
struct Windows {
  int n;                    // segments; 1 where Cg == Cs (the whole row)
  int end[kMaxSegs + 2];    // segment j is channels [end[j - 1] (0 for j = 0), end[j]); 0 beyond
  int block;
  int suffix[kMaxBins];     // bin i's sq: Q[suffix[i]], plus Q of the first segment of
  int whole[kMaxBins];      //   blocks whole[i], whole[i] + 1, ... (nwhole[i] of them),
  int nwhole[kMaxBins];     //   plus P[prefix[i]] unless prefix[i] < 0
  int prefix[kMaxBins];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum of one value per thread; every thread gets the total.
// `red` holds one float per warp.  Starts and ends with a barrier.
template <int THREADS>
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += red[w];
  return total;
}

// ----------------------------------------------------------- warp layout

// Stage the descriptor g (cg values, zero-padded to cs) twice into
// g2[0, 2 cs) and return ||g|| in every thread.  Ends with a barrier.
template <typename T>
__device__ float stage_descriptor2(const T* __restrict__ g, int cs, int cg, float* g2,
                                   float* red) {
  float ss = 0.f;
#pragma unroll 4
  for (int t = threadIdx.x; t < cs; t += kThreads) {
    const float v = t < cg ? to_f32(g[t]) : 0.f;
    g2[t] = v;
    g2[t + cs] = v;
    ss = fmaf(v, v, ss);
  }
  return sqrtf(block_sum<kThreads>(ss, red));
}

// K1 and K2, one warp per pixel row.  EPI: K1 (Cg == Cs, scores + smax +
// xnorm); else K2 (scores; MASKED: per-bin window norm when Cg < Cs).
template <typename T, int NB, bool EPI, bool MASKED>
__global__ void __launch_bounds__(kThreads)
match_warp_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ scores,
                  T* __restrict__ smax, T* __restrict__ xnorm, int hw, int cs, int cg,
                  int bins, BinShifts sh, int rows_per_block) {
  extern __shared__ float warp_smem[];
  float* g2 = warp_smem;
  float* red = warp_smem + 2 * cs;
  const int b = blockIdx.y;
  const float gnorm = stage_descriptor2(g + (size_t)b * cg, cs, cg, g2, red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p_end = min(hw, (blockIdx.x + 1) * rows_per_block);

  for (int p = blockIdx.x * rows_per_block + warp; p < p_end; p += kWarps) {
    const size_t row = (size_t)b * hw + p;
    const T* xr = x + row * cs;
    float acc[NB];
    float sq[MASKED ? NB : 1];
#pragma unroll
    for (int i = 0; i < NB; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (MASKED ? NB : 1); ++i) sq[i] = 0.f;
    // kUnroll loads of the row in flight per lane, then their products
    for (int c0 = lane; c0 < cs; c0 += 32 * kUnroll) {
      float xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        xv[u] = c < cs ? to_f32(xr[c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c >= cs) break;
        const float v = xv[u];
        const float v2 = v * v;
        if (!MASKED) sq[0] += v2;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int t = cs + c - sh.k[i];  // in [1, 2 cs)
          acc[i] = fmaf(v, g2[t], acc[i]);
          if (MASKED) {
            const int j = t >= cs ? t - cs : t;  // (c - k_i) mod cs
            if (j < cg) sq[i] += v2;
          }
        }
      }
    }
    const float sq_full = MASKED ? 0.f : warp_sum(sq[0]);
    const float norm = sqrtf(sq_full);
    float m = -__int_as_float(0x7f800000);
    float mine = 0.f;  // lane i keeps score i: one coalesced store per row
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i < bins) {
        const float sqi = MASKED ? warp_sum(sq[i]) : sq_full;
        const float den = fmaxf((MASKED ? sqrtf(sqi) : norm) * gnorm, 1e-12f);
        const float s = warp_sum(acc[i]) / den;
        m = fmaxf(m, s);
        if (lane == i) mine = s;
      }
    }
    if (lane < bins) scores[row * bins + lane] = from_f32<T>(mine);
    if (EPI) {
      if (lane == 0) smax[row] = from_f32<T>(m);
      const float inv = 1.f / fmaxf(norm, 1e-12f);
      T* xo = xnorm + row * cs;
      for (int c = lane; c < cs; c += 32) xo[c] = from_f32<T>(to_f32(xr[c]) * inv);
    }
  }
}

// ----------------------------------------------------------- tile layout

struct TileSmem {  // byte offsets into the dynamic shared memory
  int stage, w, sc, sm, inv, gs, total;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Row stride of a staged tile in 16-byte granules: Cs * sizeof(T) / 16,
// made odd so that 8 rows' granules at one column fall in distinct banks.
__host__ __device__ inline int tile_stride(int cs, int tsize) { return (cs * tsize / 16) | 1; }

// ccvpe_torch/ops/matching_cuda.py::tile_smem_bytes mirrors this layout.
__host__ __device__ inline TileSmem tile_smem(int cs, int nb, int bins, int rows, int tsize) {
  const int v = 16 / tsize;  // elements per granule
  TileSmem s;
  s.stage = 0;                                            // [stages][rows][stride] granules of x
  s.w = s.stage + kTileStages * rows * tile_stride(cs, tsize) * 16;
  s.sc = s.w + cs * nb * 4;                               // W [cs][nb] f32
  s.sm = s.sc + round16((rows * bins + v) * tsize);       // a tile's scores, T, after `lead`
  s.inv = s.sm + round16((rows + v) * tsize);             // a tile's smax, T, after `lead`
  s.gs = s.inv + rows * 4;                                // [rows] 1 / max(||X||, 1e-12)
  s.total = s.gs + round16(cs * 4);                       // [cs] descriptor g_b
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of nrows rows of gr granules, contiguous at src, into dst
// with a row stride of gp granules; consecutive threads take consecutive
// granules.
__device__ __forceinline__ void stage_tile(uint4* dst, const uint4* src, int nrows, int gr,
                                           int gp) {
  const int dr = blockDim.x / gr, dc = blockDim.x - dr * gr;
  int r = threadIdx.x / gr, c = threadIdx.x - r * gr;
  for (int q = threadIdx.x; q < nrows * gr; q += blockDim.x) {
    cp_async16(dst + r * gp + c, src + q);
    r += dr;
    c += dc;
    if (c >= gr) c -= gr, ++r;
  }
}

// The 16 / sizeof(T) values of one granule as f32, and back (bf16: element
// 2j is the low half of word j).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* v) {
  const unsigned wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (std::is_same<T, float>::value) {
      v[j] = __uint_as_float(wd[j]);
    } else {
      v[2 * j] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(wd[j])));
      v[2 * j + 1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(wd[j] >> 16)));
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* v) {
  unsigned wd[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (std::is_same<T, float>::value) {
      wd[j] = __float_as_uint(v[j]);
    } else {
      wd[j] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j]))) |
              static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]))) << 16;
    }
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// Write dst[e0, e0 + n) from buf, where buf[k] holds element
// e0 - (e0 mod V) + k (V = 16 / sizeof(T)): a whole 16-byte granule of dst
// is then a whole granule of buf and goes in one store.  The elements before
// the first whole granule and after the last go one by one; nothing outside
// the span is written.  dst must be 16-byte aligned.
template <typename T>
__device__ __forceinline__ void store_span(T* __restrict__ dst, const T* buf, size_t e0, int n) {
  constexpr int V = 16 / sizeof(T);
  const int lead = static_cast<int>(e0 % V);
  const int head = lead ? min(V - lead, n) : 0;
  const int body = (n - head) / V;
  for (int k = threadIdx.x; k < head; k += blockDim.x) dst[e0 + k] = buf[lead + k];
  const uint4* src = reinterpret_cast<const uint4*>(buf + lead + head);
  uint4* out = reinterpret_cast<uint4*>(dst + e0 + head);
  for (int j = threadIdx.x; j < body; j += blockDim.x) out[j] = src[j];
  for (int k = head + body * V + threadIdx.x; k < n; k += blockDim.x) dst[e0 + k] = buf[lead + k];
}

// K1, one thread per pixel row of a tile of blockDim.x rows.  Block
// (blockIdx.x, b) walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
// sample b; tile t+1's copy is in flight while tile t is computed.
template <typename T, int NB>
__global__ void __launch_bounds__(kTileMaxRows, kTileMinBlocks)
match_tile_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ scores,
                  T* __restrict__ smax, T* __restrict__ xnorm, int hw, int cs, int bins,
                  BinShifts sh) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char tile_smem_buf[];
  const int rows = blockDim.x, tid = threadIdx.x, b = blockIdx.y;
  const TileSmem L = tile_smem(cs, NB, bins, rows, sizeof(T));
  const int gr = cs / V, gp = tile_stride(cs, sizeof(T));
  uint4* stage = reinterpret_cast<uint4*>(tile_smem_buf + L.stage);
  float* w = reinterpret_cast<float*>(tile_smem_buf + L.w);
  T* sc = reinterpret_cast<T*>(tile_smem_buf + L.sc);
  T* sm = reinterpret_cast<T*>(tile_smem_buf + L.sm);
  float* inv = reinterpret_cast<float*>(tile_smem_buf + L.inv);
  float* gs = reinterpret_cast<float*>(tile_smem_buf + L.gs);
  const size_t row0 = (size_t)b * hw;  // the sample's first pixel row
  const uint4* xg = reinterpret_cast<const uint4*>(x + row0 * cs);
  const int tiles = (hw + rows - 1) / rows;

  // the first tile is in flight while the block builds W and ||g_b||
  int t = blockIdx.x;
  if (t < tiles) stage_tile(stage, xg + (size_t)t * rows * gr, min(rows, hw - t * rows), gr, gp);
  cp_async_commit();
  for (int c = tid; c < cs; c += rows) gs[c] = to_f32(g[(size_t)b * cs + c]);
  __syncthreads();
  float gsq = 0.f;
  for (int c = 0; c < cs; ++c) gsq = fmaf(gs[c], gs[c], gsq);
  const float gnorm = sqrtf(gsq);
  // W[c][i] = g_b[(c - k_i) mod cs], 0 for i >= bins; complete after the
  // barrier that follows the first tile's arrival
  for (int e = tid; e < cs * NB; e += rows) {
    const int c = e / NB, i = e - c * NB;
    float wv = 0.f;
    if (i < bins) {
      int j = c - sh.k[i];
      if (j < 0) j += cs;
      wv = gs[j];
    }
    w[e] = wv;
  }

  for (int k = 0; t < tiles; t += gridDim.x, ++k) {
    const int p0 = t * rows, nrows = min(rows, hw - p0);
    const uint4* cur = stage + (k & 1) * rows * gp;
    const int tn = t + gridDim.x;
    if (tn < tiles)
      stage_tile(stage + ((k + 1) & 1) * rows * gp, xg + (size_t)tn * rows * gr,
                 min(rows, hw - tn * rows), gr, gp);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed,
    __syncthreads();     // and every thread's
    const size_t e0 = row0 + p0;  // the tile's first pixel row in x
    if (tid < nrows) {
      float acc[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) acc[i] = 0.f;
      float sq = 0.f;
      const uint4* xr = cur + tid * gp;
#pragma unroll 2
      for (int q = 0; q < gr; ++q) {
        float v[V];
        unpack<T>(xr[q], v);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float4* wc = reinterpret_cast<const float4*>(w + (q * V + u) * NB);
#pragma unroll
          for (int i4 = 0; i4 < NB / 4; ++i4) {
            const float4 wq = wc[i4];
            acc[4 * i4 + 0] = fmaf(v[u], wq.x, acc[4 * i4 + 0]);
            acc[4 * i4 + 1] = fmaf(v[u], wq.y, acc[4 * i4 + 1]);
            acc[4 * i4 + 2] = fmaf(v[u], wq.z, acc[4 * i4 + 2]);
            acc[4 * i4 + 3] = fmaf(v[u], wq.w, acc[4 * i4 + 3]);
          }
          sq += v[u] * v[u];
        }
      }
      const float norm = sqrtf(sq);
      // one reciprocal per row in place of a division per bin
      const float rden = 1.f / fmaxf(norm * gnorm, 1e-12f);
      float m = -__int_as_float(0x7f800000);
      T* sr = sc + static_cast<int>(e0 * bins % V) + tid * bins;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (i < bins) {
          const float s = acc[i] * rden;
          m = fmaxf(m, s);
          sr[i] = from_f32<T>(s);
        }
      }
      sm[e0 % V + tid] = from_f32<T>(m);
      inv[tid] = 1.f / fmaxf(norm, 1e-12f);
    }
    __syncthreads();
    store_span(scores, sc, e0 * bins, nrows * bins);
    store_span(smax, sm, e0, nrows);
    // xnorm: the staged rows times their 1 / norm, a granule per store
    uint4* xo = reinterpret_cast<uint4*>(xnorm + e0 * cs);
    const int dr = rows / gr, dc = rows - dr * gr;
    int r = tid / gr, c = tid - r * gr;
    for (int q = tid; q < nrows * gr; q += rows) {
      float v[V];
      unpack<T>(cur[r * gp + c], v);
      const float s = inv[r];
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] *= s;
      xo[q] = pack<T>(v);
      r += dr;
      c += dc;
      if (c >= gr) c -= gr, ++r;
    }
    __syncthreads();  // stage k & 1 and the output staging are read out
  }
}

// ------------------------------------------------------ tile layout, K2

struct ScoresTileSmem {  // byte offsets into the dynamic shared memory
  int stage, w, sc, seg, ends, gs, total;
};

// ccvpe_torch/ops/matching_cuda.py::tile_smem_bytes mirrors this layout:
// K1's ring, W and scores, no smax and no 1 / ||X||, and where Cg < Cs
// (nseg > 1) the per-segment sums of X^2 and a bit per channel that marks
// the last channel of a segment.
__host__ __device__ inline ScoresTileSmem scores_tile_smem(int cs, int nb, int bins, int rows,
                                                           int tsize, int stages, int nseg) {
  const int v = 16 / tsize;  // elements per granule
  const bool masked = nseg > 1;
  ScoresTileSmem s;
  s.stage = 0;                                           // [stages][rows][stride] granules of x
  s.w = s.stage + stages * rows * tile_stride(cs, tsize) * 16;
  s.sc = s.w + cs * nb * 4;                              // W [cs][nb] f32
  s.seg = s.sc + round16((rows * bins + v) * tsize);     // a tile's scores, T, after `lead`
  s.ends = s.seg + (masked ? 2 * nseg * rows * 4 : 0);   // Q, P [nseg][rows] f32
  s.gs = s.ends + (masked ? round16((cs + 31) / 32 * 4) : 0);  // [cs] bits: segment ends
  s.total = s.gs + round16(cs * 4);                      // [cs] descriptor g_b, zero-padded
  return s;
}

// R floats at p (R-float aligned), R = 1 or 2, as one shared-memory access
template <int R>
__device__ __forceinline__ void load_r(const float* p, float (&v)[R]) {
  if constexpr (R == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x, v[1] = u.y;
  } else {
    v[0] = *p;
  }
}

template <int R>
__device__ __forceinline__ void store_r(float* p, const float (&v)[R]) {
  if constexpr (R == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// K2 with R pixel rows per thread: thread t of a block of blockDim.x
// threads takes rows t, t + blockDim.x, ... of a tile of R * blockDim.x
// rows, so that one float4 of W read from shared memory feeds R rows' FMAs.
// Block (blockIdx.x, b) walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// of sample b.  stages 2: tile t+1's copy is in flight while tile t is
// computed; stages 1: the next tile's copy starts once this one is
// computed, while its scores are written (the SM's other blocks compute
// meanwhile).
template <typename T, int NB, bool MASKED, int R>
__global__ void __launch_bounds__(kTileMaxRows, R == 1 ? kTileMinBlocks : 2)
match_scores_tile_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ scores, int hw, int cs, int cg, int bins, int stages,
                         BinShifts sh, const __grid_constant__ Windows seg) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char tile_smem_buf[];
  const int threads = blockDim.x, rows = R * threads, tid = threadIdx.x, b = blockIdx.y;
  const int nseg = MASKED ? seg.n : 1;
  const ScoresTileSmem L = scores_tile_smem(cs, NB, bins, rows, sizeof(T), stages, nseg);
  const int gr = cs / V, gp = tile_stride(cs, sizeof(T));
  uint4* stage = reinterpret_cast<uint4*>(tile_smem_buf + L.stage);
  float* w = reinterpret_cast<float*>(tile_smem_buf + L.w);
  T* sc = reinterpret_cast<T*>(tile_smem_buf + L.sc);
  // S, then Q, and P [segment][thread][R]: a thread's R rows of one segment
  // are one R-float access
  float* qs = reinterpret_cast<float*>(tile_smem_buf + L.seg) + tid * R;
  float* ps = qs + nseg * rows;
  unsigned* ends = reinterpret_cast<unsigned*>(tile_smem_buf + L.ends);
  float* gs = reinterpret_cast<float*>(tile_smem_buf + L.gs);
  const size_t row0 = (size_t)b * hw;  // the sample's first pixel row
  const uint4* xg = reinterpret_cast<const uint4*>(x + row0 * cs);
  const int tiles = (hw + rows - 1) / rows;

  // the first tile is in flight while the block builds W, ||g_b|| and the
  // segment ends
  int t = blockIdx.x;
  if (t < tiles) stage_tile(stage, xg + (size_t)t * rows * gr, min(rows, hw - t * rows), gr, gp);
  cp_async_commit();
  for (int c = tid; c < cs; c += threads) gs[c] = c < cg ? to_f32(g[(size_t)b * cg + c]) : 0.f;
  if constexpr (MASKED) {
    for (int wd = tid; wd < (cs + 31) / 32; wd += threads) {
      unsigned bits = 0;
      for (int j = 0; j < nseg; ++j) {
        const int c = seg.end[j] - 1;  // segment j's last channel
        if (c >> 5 == wd) bits |= 1u << (c & 31);
      }
      ends[wd] = bits;
    }
  }
  __syncthreads();
  float gsq = 0.f;  // every warp sums ||g_b||^2 itself
  for (int c = tid & 31; c < cg; c += 32) gsq = fmaf(gs[c], gs[c], gsq);
  const float gnorm = sqrtf(warp_sum(gsq));
  const float rgnorm = 1.f / gnorm;  // masked: inf where g_b = 0, clamped per bin
  // W[c][i] = g_b[(c - k_i) mod cs] (0 outside the window), 0 for i >= bins
  for (int e = tid; e < cs * NB; e += threads) {
    const int c = e / NB, i = e - c * NB;
    float wv = 0.f;
    if (i < bins) {
      int j = c - sh.k[i];
      if (j < 0) j += cs;
      wv = gs[j];
    }
    w[e] = wv;
  }

  for (int k = 0; t < tiles; t += gridDim.x, ++k) {
    const int p0 = t * rows, nrows = min(rows, hw - p0);
    const int slot = stages == 2 ? (k & 1) : 0;
    const uint4* cur = stage + slot * rows * gp;
    const int tn = t + gridDim.x;
    if (stages == 2) {
      if (tn < tiles)
        stage_tile(stage + (slot ^ 1) * rows * gp, xg + (size_t)tn * rows * gr,
                   min(rows, hw - tn * rows), gr, gp);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of tile t have landed,
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();       // and every thread's
    const size_t e0 = row0 + p0;  // the tile's first pixel row in x
    if (tid < nrows) {
      // rows tid + j * threads, j < R; those past nrows (the last tile)
      // are computed from stale shared memory and never written out
      float acc[R][NB], run[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        run[j] = 0.f;
#pragma unroll
        for (int i = 0; i < NB; ++i) acc[j][i] = 0.f;
      }
      const uint4* xr = cur + tid * gp;
      // the products, and X^2 summed over the row (Cg == Cs): no stores in
      // this loop, so the loads of W and x run ahead of the FMAs
#pragma unroll 2
      for (int q = 0; q < gr; ++q) {
        float v[R][V];
#pragma unroll
        for (int j = 0; j < R; ++j) unpack<T>(xr[j * threads * gp + q], v[j]);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float4* wc = reinterpret_cast<const float4*>(w + (q * V + u) * NB);
#pragma unroll
          for (int i4 = 0; i4 < NB / 4; ++i4) {
            const float4 wq = wc[i4];
#pragma unroll
            for (int j = 0; j < R; ++j) {
              acc[j][4 * i4 + 0] = fmaf(v[j][u], wq.x, acc[j][4 * i4 + 0]);
              acc[j][4 * i4 + 1] = fmaf(v[j][u], wq.y, acc[j][4 * i4 + 1]);
              acc[j][4 * i4 + 2] = fmaf(v[j][u], wq.z, acc[j][4 * i4 + 2]);
              acc[j][4 * i4 + 3] = fmaf(v[j][u], wq.w, acc[j][4 * i4 + 3]);
            }
          }
          if constexpr (!MASKED) {
#pragma unroll
            for (int j = 0; j < R; ++j) run[j] = fmaf(v[j][u], v[j][u], run[j]);
          }
        }
      }
      T* sr = sc + static_cast<int>(e0 * bins % V) + tid * bins;
      if constexpr (MASKED) {
        // X^2 per segment, in a second pass over the staged rows, 16
        // channels (kGroup granules) loaded at a time: at a segment's last
        // channel (the same for every thread) the open sums go to S, a
        // predicated store, no branch
        constexpr int kGroup = 16 / V;
        int sg = 0;
        for (int q0 = 0; q0 < gr; q0 += kGroup) {
          float v[kGroup][R][V];
#pragma unroll
          for (int d = 0; d < kGroup; ++d) {
#pragma unroll
            for (int j = 0; j < R; ++j)
              if (q0 + d < gr) unpack<T>(xr[j * threads * gp + q0 + d], v[d][j]);
          }
#pragma unroll
          for (int d = 0; d < kGroup; ++d) {
            if (q0 + d < gr) {
              const int c0 = (q0 + d) * V;
              const unsigned last = ends[c0 >> 5] >> (c0 & 31);
#pragma unroll
              for (int u = 0; u < V; ++u) {
                const bool end = (last >> u) & 1u;
#pragma unroll
                for (int j = 0; j < R; ++j) run[j] = fmaf(v[d][j][u], v[d][j][u], run[j]);
                if (end) store_r<R>(qs + sg * rows, run);
#pragma unroll
                for (int j = 0; j < R; ++j) run[j] = end ? 0.f : run[j];
                sg += end;
              }
            }
          }
        }
        // within each block of segments: P, the prefix sums, and Q, the
        // suffix sums, in place of S; four segments loaded at a time
        for (int b0 = 0; b0 < nseg; b0 += seg.block) {
          const int b1 = min(nseg, b0 + seg.block);
          float part[R];
#pragma unroll
          for (int j = 0; j < R; ++j) part[j] = 0.f;
          for (int s0 = b0; s0 < b1; s0 += 4) {
            float sv[4][R];
#pragma unroll
            for (int d = 0; d < 4; ++d)
              if (s0 + d < b1) load_r<R>(qs + (s0 + d) * rows, sv[d]);
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              if (s0 + d < b1) {
#pragma unroll
                for (int j = 0; j < R; ++j) part[j] += sv[d][j];
                store_r<R>(ps + (s0 + d) * rows, part);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < R; ++j) part[j] = 0.f;
          for (int s0 = b1 - 1; s0 >= b0; s0 -= 4) {
            float sv[4][R];
#pragma unroll
            for (int d = 0; d < 4; ++d)
              if (s0 - d >= b0) load_r<R>(qs + (s0 - d) * rows, sv[d]);
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              if (s0 - d >= b0) {
#pragma unroll
                for (int j = 0; j < R; ++j) part[j] += sv[d][j];
                store_r<R>(qs + (s0 - d) * rows, part);
              }
            }
          }
        }
        // each window: a suffix, whole blocks and a prefix, all sums of
        // non-negative terms, so a window of zeros gives exactly 0; every
        // bin's sums are loaded before any score is stored
        const int nblocks = (nseg + seg.block - 1) / seg.block;
#pragma unroll
        for (int i0 = 0; i0 < NB; i0 += 4) {
          float wsq[4][R];  // four bins' sums loaded before their scores are stored
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int i = i0 + d;
            if (i < bins) {
              load_r<R>(qs + seg.suffix[i] * rows, wsq[d]);
              if (seg.prefix[i] >= 0) {
                float p[R];
                load_r<R>(ps + seg.prefix[i] * rows, p);
#pragma unroll
                for (int j = 0; j < R; ++j) wsq[d][j] += p[j];
              }
              for (int n = 0, bb = seg.whole[i]; n < seg.nwhole[i]; ++n) {
                float p[R];
                load_r<R>(qs + bb * seg.block * rows, p);
#pragma unroll
                for (int j = 0; j < R; ++j) wsq[d][j] += p[j];
                bb = bb + 1 == nblocks ? 0 : bb + 1;
              }
            }
          }
          // min(1 / sqrt(sq), 1e12 ||g_b||) / ||g_b||: the 1e-12 clamp
#pragma unroll
          for (int d = 0; d < 4; ++d)
            if (i0 + d < bins)
#pragma unroll
              for (int j = 0; j < R; ++j)
                sr[j * threads * bins + i0 + d] =
                    from_f32<T>(acc[j][i0 + d] * fminf(rsqrtf(wsq[d][j]) * rgnorm, 1e12f));
        }
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          // one reciprocal per row in place of a division per bin
          const float rden = 1.f / fmaxf(sqrtf(run[j]) * gnorm, 1e-12f);
#pragma unroll
          for (int i = 0; i < NB; ++i)
            if (i < bins) sr[j * threads * bins + i] = from_f32<T>(acc[j][i] * rden);
        }
      }
    }
    __syncthreads();       // the tile is computed: its stage is free
    if (stages == 1) {
      if (tn < tiles) stage_tile(stage, xg + (size_t)tn * rows * gr, min(rows, hw - tn * rows),
                                 gr, gp);
      cp_async_commit();
    }
    store_span(scores, sc, e0 * bins, nrows * bins);
    __syncthreads();       // the scores' staging is read out
  }
}

// ------------------------------------------------------------- dispatch

int pick_nb(int bins) { return (bins + 3) / 4 * 4; }  // 4, 8, ..., 32

BinShifts pack_shifts(const int* ks, int bins) {
  BinShifts sh{};
  for (int i = 0; i < bins; ++i) sh.k[i] = ks[i];
  return sh;
}

struct Args {
  const void* x;
  const void* g;
  void* scores;
  void* smax;
  void* xnorm;
  int batch, hw, cs, cg, bins, rows_per_block;
  BinShifts sh;
  cudaStream_t st;
  int tile_rows = 0, tile_grid = 0, tile_smem = 0;  // tile layout: rows, grid.x, bytes
  int tile_stages = 2, tile_rpt = 1;                // K2's tile: ring depth, rows per thread
  Windows seg{};                                    // K2's tile: the window segments
};

// f(std::integral_constant<int, R>{}) with R = rpt rows per thread (1 or 2)
template <typename F>
auto with_rpt(int rpt, F&& f) {
  return rpt == 1 ? f(std::integral_constant<int, 1>{}) : f(std::integral_constant<int, 2>{});
}

// Raise a kernel's dynamic shared-memory cap to the device's opt-in maximum
// and prefer shared memory over L1, once per device (both attributes are
// set for the current device only).
template <auto Kernel>
void opt_in_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && done[dev]) return;
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  if (dev < kMaxDevices) done[dev] = true;
}

template <typename T, int NB, bool EPI, bool MASKED>
void launch(const Args& a, int layout) {
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* scores = static_cast<T*>(a.scores);
  T* smax = static_cast<T*>(a.smax);
  T* xnorm = static_cast<T*>(a.xnorm);
  if (layout == 0) {
    const dim3 grid((a.hw + a.rows_per_block - 1) / a.rows_per_block, a.batch);
    const size_t smem = (2 * (size_t)a.cs + kWarps) * sizeof(float);
    match_warp_kernel<T, NB, EPI, MASKED><<<grid, kThreads, smem, a.st>>>(
        x, g, scores, smax, xnorm, a.hw, a.cs, a.cg, a.bins, a.sh, a.rows_per_block);
  } else if constexpr (EPI && !MASKED) {
    opt_in_smem<&match_tile_kernel<T, NB>>();
    match_tile_kernel<T, NB><<<dim3(a.tile_grid, a.batch), a.tile_rows, a.tile_smem, a.st>>>(
        x, g, scores, smax, xnorm, a.hw, a.cs, a.bins, a.sh);
  } else if constexpr (!EPI) {
    with_rpt(a.tile_rpt, [&](auto r) {
      constexpr auto kernel = &match_scores_tile_kernel<T, NB, MASKED, decltype(r)::value>;
      opt_in_smem<kernel>();
      kernel<<<dim3(a.tile_grid, a.batch), a.tile_rows / a.tile_rpt, a.tile_smem, a.st>>>(
          x, g, scores, a.hw, a.cs, a.cg, a.bins, a.tile_stages, a.sh, a.seg);
    });
  }
}

// f(std::integral_constant<int, NB>{}) with NB = pick_nb(bins)
template <typename F>
auto with_nb(int bins, F&& f) {
  switch (pick_nb(bins)) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 12: return f(std::integral_constant<int, 12>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 20: return f(std::integral_constant<int, 20>{});
    case 24: return f(std::integral_constant<int, 24>{});
    case 28: return f(std::integral_constant<int, 28>{});
    default: return f(std::integral_constant<int, 32>{});
  }
}

// f(T{}) with T the element type of dtype (0 = float32, 1 = bfloat16)
template <typename F>
auto with_dtype(int dtype, F&& f) {
  return dtype == 1 ? f(__nv_bfloat16{}) : f(float{});
}

template <bool EPI, bool MASKED>
int dispatch(const Args& a, int dtype, int layout) {
  with_dtype(dtype, [&](auto t) {
    with_nb(a.bins, [&](auto nb) {
      launch<decltype(t), decltype(nb)::value, EPI, MASKED>(a, layout);
    });
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory (bytes) of the tile layout at `tile_rows` rows a tile; the
// wrapper computes the same in Python (matching_cuda.tile_smem_bytes).
extern "C" int ccvpe_match_tile_smem_bytes(int cs, int bins, int dtype, int tile_rows) {
  return tile_smem(cs, pick_nb(bins), bins, tile_rows, dtype == 1 ? 2 : 4).total;
}

// Blocks of the tile layout that one SM keeps resident (the CUDA occupancy
// calculator, registers included); the wrapper's plan must not exceed it.
extern "C" int ccvpe_match_tile_blocks_per_sm(int cs, int bins, int dtype, int tile_rows,
                                              int smem_bytes) {
  (void)cs;
  return with_dtype(dtype, [&](auto t) {
    return with_nb(bins, [&](auto nb) {
      constexpr auto kernel = &match_tile_kernel<decltype(t), decltype(nb)::value>;
      opt_in_smem<kernel>();
      int n = -1;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, tile_rows, smem_bytes);
      return n;
    });
  });
}

// Shared memory (bytes) of K2's tile layout at `tile_rows` rows a tile,
// `stages` tiles in the ring and nseg window segments (1 where Cg == Cs);
// the wrapper computes the same in Python (matching_cuda.tile_smem_bytes).
extern "C" int ccvpe_match_scores_tile_smem_bytes(int cs, int bins, int dtype, int tile_rows,
                                                  int stages, int nseg) {
  return scores_tile_smem(cs, pick_nb(bins), bins, tile_rows, dtype == 1 ? 2 : 4, stages, nseg)
      .total;
}

// Blocks of K2's tile layout (masked 1 where Cg < Cs, rpt rows per thread)
// that one SM keeps resident at `threads` threads and smem_bytes a block.
extern "C" int ccvpe_match_scores_tile_blocks_per_sm(int bins, int dtype, int masked, int rpt,
                                                     int threads, int smem_bytes) {
  const auto occupancy = [&](auto t, auto nb, auto m, auto r) {
    constexpr auto kernel = &match_scores_tile_kernel<decltype(t), decltype(nb)::value,
                                                      decltype(m)::value, decltype(r)::value>;
    opt_in_smem<kernel>();
    int n = -1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem_bytes);
    return n;
  };
  return with_dtype(dtype, [&](auto t) {
    return with_nb(bins, [&](auto nb) {
      return with_rpt(rpt, [&](auto r) {
        return masked ? occupancy(t, nb, std::true_type{}, r)
                      : occupancy(t, nb, std::false_type{}, r);
      });
    });
  });
}

// dtype: 0 = float32, 1 = bfloat16.  layout: 0 = warp, 1 = tile.
// x [batch, hw, cs] and g [batch, cs] are contiguous; scores [batch, hw,
// bins], smax [batch, hw], xnorm [batch, hw, cs].  ks holds bins values in
// [0, cs), 1 <= bins <= 32.  rows_per_block: warp layout only.  tile_rows
// (a multiple of 32, <= 128), tile_grid (blocks per sample) and tile_bytes
// (dynamic shared memory, at least the layout's): tile layout only, which also needs
// cs * sizeof(T) a multiple of 16 and 16-byte aligned x, scores, smax and
// xnorm.  Returns cudaErrorInvalidValue for a tile plan it does not take,
// else cudaGetLastError().
extern "C" int ccvpe_match_epilogue(const void* x, const void* g, void* scores,
                                    void* smax, void* xnorm, int batch, int hw,
                                    int cs, int bins, const int* ks, int dtype,
                                    int layout, int rows_per_block, int tile_rows,
                                    int tile_grid, int tile_bytes, void* stream) {
  if (layout < 0 || layout > 1) return static_cast<int>(cudaErrorInvalidValue);
  if (layout == 1) {
    const int tsize = dtype == 1 ? 2 : 4;
    const bool ok = tile_rows >= 32 && tile_rows <= kTileMaxRows && tile_rows % 32 == 0 &&
                    tile_grid >= 1 && (cs * tsize) % 16 == 0 &&
                    tile_smem(cs, pick_nb(bins), bins, tile_rows, tsize).total <= tile_bytes;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{x, g, scores, smax, xnorm, batch, hw, cs, cs, bins, rows_per_block,
         pack_shifts(ks, bins), static_cast<cudaStream_t>(stream)};
  a.tile_rows = tile_rows;
  a.tile_grid = tile_grid;
  a.tile_smem = tile_bytes;
  return dispatch<true, false>(a, dtype, layout);
}

// x [batch, hw, cs], g [batch, cg] with cg <= cs, scores [batch, hw, bins].
// layout: 0 = warp, 1 = tile.  The tile layout takes tile_rows
// rows a tile (tile_rpt rows per thread, 1 or 2, so tile_rows /
// tile_rpt threads: a multiple of 32, <= 128), tile_grid blocks per sample,
// tile_bytes of dynamic shared memory (at least the layout's), tile_stages
// (1 or 2) tiles in its ring, x and scores 16-byte aligned and cs *
// sizeof(T) a multiple of 16; and the windows (matching_cuda.window_segments
// and window_blocks): nseg segments (1 where cg == cs) ending at seg_end
// [nseg] (ascending to cs), blocks of `block` segments, and per bin suffix,
// prefix, whole and nwhole [bins].  Returns cudaErrorInvalidValue for a
// plan or table it does not take, else cudaGetLastError().
extern "C" int ccvpe_match_scores(const void* x, const void* g, void* scores, int batch,
                                  int hw, int cs, int cg, int bins, const int* ks,
                                  int dtype, int layout, int rows_per_block, int tile_rows,
                                  int tile_grid, int tile_bytes, int tile_stages, int tile_rpt,
                                  int nseg, const int* seg_end, int block, const int* suffix,
                                  const int* prefix, const int* whole, const int* nwhole,
                                  void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (layout < 0 || layout > 1) return bad;
  Args a{x, g, scores, nullptr, nullptr, batch, hw, cs, cg, bins, rows_per_block,
         pack_shifts(ks, bins), static_cast<cudaStream_t>(stream)};
  if (layout == 1) {
    const int tsize = dtype == 1 ? 2 : 4;
    const int threads = tile_rpt > 0 ? tile_rows / tile_rpt : 0;
    const bool ok = (tile_rpt == 1 || tile_rpt == 2) &&
                    threads * tile_rpt == tile_rows && threads >= 32 &&
                    threads <= kTileMaxRows && threads % 32 == 0 && tile_grid >= 1 &&
                    (tile_stages == 1 || tile_stages == 2) && (cs * tsize) % 16 == 0 &&
                    nseg >= 1 && nseg <= kMaxSegs && (cg < cs) == (nseg > 1) &&
                    seg_end[nseg - 1] == cs && block >= 1 && block <= nseg &&
                    scores_tile_smem(cs, pick_nb(bins), bins, tile_rows, tsize, tile_stages,
                                     nseg).total <= tile_bytes;
    if (!ok) return bad;
    a.tile_rows = tile_rows;
    a.tile_grid = tile_grid;
    a.tile_smem = tile_bytes;
    a.tile_stages = tile_stages;
    a.tile_rpt = tile_rpt;
    a.seg.n = nseg;
    a.seg.block = block;
    for (int j = 0; j < nseg; ++j) {
      if (seg_end[j] <= (j ? seg_end[j - 1] : 0)) return bad;
      a.seg.end[j] = seg_end[j];
    }
    const int nblocks = (nseg + block - 1) / block;
    for (int i = 0; i < bins; ++i) {
      if (suffix[i] < 0 || suffix[i] >= nseg || prefix[i] < -1 || prefix[i] >= nseg ||
          whole[i] < 0 || whole[i] >= nblocks || nwhole[i] < 0 || nwhole[i] > nblocks)
        return bad;
      a.seg.suffix[i] = suffix[i];
      a.seg.prefix[i] = prefix[i];
      a.seg.whole[i] = whole[i];
      a.seg.nwhole[i] = nwhole[i];
    }
  }
  return cg < cs ? dispatch<false, true>(a, dtype, layout)
                 : dispatch<false, false>(a, dtype, layout);
}
