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
// Two layouts, chosen by the wrapper from Cs (both compute the same
// function, with the same f32 arithmetic per output):
//
//   * warp layout (large Cs, few pixel rows: the coarse scales): one block
//     per (tile of rows, sample b); g_b, zero-padded to Cs and stored twice,
//     sits in shared memory so that g[(c - k_i) mod Cs] is g2[c - k_i + Cs];
//     one warp per pixel row, lanes striding over the channels (coalesced
//     loads), `NB` f32 accumulators per lane, warp shuffles to reduce them.
//     The shuffles cost about 5 * (bins + 1) instructions per row, which
//     is small beside the row's Cs * bins / 32 FMAs per lane only when Cs is
//     large.
//   * row layout (small Cs, many pixel rows: the fine scales): one thread
//     per pixel row, 128 rows per block.  The block builds the rolled
//     descriptor matrix W[c][i] = g_b[(c - k_i) mod Cs] (and, masked, the
//     0/1 window M[c][i]) in shared memory.  Then each warp works alone on
//     its 32 rows: it stages them in 32-channel chunks with cp.async (each
//     step a coalesced 128-byte row segment, no registers held while the
//     copies fly), each lane runs its row's Cs x bins product with float4
//     broadcast reads of W (no shuffles, no reductions across threads), and
//     the rows' scores leave through shared memory as one contiguous span.
//
// K1 writes xnorm in a second pass over the rows, which were just read, so
// it hits L2.  It scales by 1 / max(||X||, 1e-12), computed once per row:
// within an ulp of the division, which would cost several instructions per
// element.
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
//     from k_i (inline in the warp layout, once per block into M in the row
//     layout); no mask array comes from the host;
//   * ||g_b||: reduced in the block while g_b is staged.
//
// Inputs are f32 or bf16; accumulation is f32; outputs are in x's dtype.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kMaxBins = 32;
constexpr int kWarps = 8;                 // warp layout: rows in flight per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowThreads = 128;          // row layout: pixel rows per block
constexpr int kChunk = 32;                // row layout: channels staged per pass
constexpr int kRowMaxSmem = 200 * 1024;   // row layout: dynamic shared memory cap
constexpr int kUnroll = 8;                // warp layout: loads in flight per lane

struct BinShifts {
  int k[kMaxBins];  // k_i for i < bins; 0 (any valid shift) beyond
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

// ------------------------------------------------------------ row layout

struct RowSmem {  // float offsets into the dynamic shared memory
  int w, m, xs, gs, red, total;
};

__host__ __device__ inline RowSmem row_smem(int cs, int nb, bool masked) {
  RowSmem s;
  s.w = 0;                                   // [cs][nb], 16-byte aligned rows
  s.m = s.w + cs * nb;                       // [cs][nb] if masked
  s.xs = s.m + (masked ? cs * nb : 0);       // per warp [32][kChunk + 1]: x, then scores
  s.gs = s.xs + kRowThreads * (kChunk + 1);  // [cs]
  s.red = s.gs + cs;                         // [kRowThreads / 32]
  s.total = s.red + kRowThreads / 32;
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool valid) {
  // 4 bytes global -> shared without a register; zero-filled when !valid
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// Stage 32 rows x 32 channels of x (row r at src + r * stride, channel =
// lane; rows >= nrows and lanes !col_ok read as 0) into xs[r][lane], f32.
// Each step is one coalesced row segment.  Only this lane's copies are
// complete on return: the caller syncs the warp.
template <typename T>
__device__ __forceinline__ void stage_rows(float* xs, const T* src, int stride, int nrows,
                                           bool col_ok) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const bool ok = col_ok && r < nrows;
      cp_async4(xs + r * (kChunk + 1) + lane, ok ? src + (size_t)r * stride + lane : src, ok);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const bool ok = col_ok && r < nrows;
      xs[r * (kChunk + 1) + lane] = ok ? to_f32(src[(size_t)r * stride + lane]) : 0.f;
    }
  }
}

// K1 and K2, one thread per pixel row (same EPI / MASKED meaning as above).
// After the block has built W (and M), each warp works alone on its 32 rows:
// lane = row while computing, lane = channel while moving data.
template <typename T, int NB, bool EPI, bool MASKED>
__global__ void __launch_bounds__(kRowThreads)
match_row_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ scores,
                 T* __restrict__ smax, T* __restrict__ xnorm, int hw, int cs, int cg,
                 int bins, BinShifts sh) {
  extern __shared__ __align__(16) float row_smem_buf[];
  const RowSmem L = row_smem(cs, NB, MASKED);
  float* w = row_smem_buf + L.w;
  float* msk = row_smem_buf + L.m;
  float* gs = row_smem_buf + L.gs;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // descriptor (zero-padded to cs) and its norm
  float ss = 0.f;
  for (int t = tid; t < cs; t += kRowThreads) {
    const float v = t < cg ? to_f32(g[(size_t)b * cg + t]) : 0.f;
    gs[t] = v;
    ss = fmaf(v, v, ss);
  }
  const float gnorm = sqrtf(block_sum<kRowThreads>(ss, row_smem_buf + L.red));
  // W[c][i] = gp[(c - k_i) mod cs], M[c][i] = [(c - k_i) mod cs < cg]; 0 for i >= bins
  for (int e = tid; e < cs * NB; e += kRowThreads) {
    const int c = e / NB, i = e - (e / NB) * NB;
    float wv = 0.f, mv = 0.f;
    if (i < bins) {
      int j = c - sh.k[i];
      if (j < 0) j += cs;
      wv = gs[j];
      mv = j < cg ? 1.f : 0.f;
    }
    w[e] = wv;
    if (MASKED) msk[e] = mv;
  }
  __syncthreads();

  const int wrow0 = blockIdx.x * kRowThreads + warp * 32;  // this warp's first row
  const int nrows = min(32, hw - wrow0);
  if (nrows <= 0) return;
  float* xs = row_smem_buf + L.xs + warp * 32 * (kChunk + 1);
  const size_t wbase = (size_t)b * hw + wrow0;             // its rows are contiguous
  const T* xw = x + wbase * cs;

  float acc[NB];
  float sq[MASKED ? NB : 1];
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (MASKED ? NB : 1); ++i) sq[i] = 0.f;

  for (int c0 = 0; c0 < cs; c0 += kChunk) {
    const int ck = min(kChunk, cs - c0);
    stage_rows(xs, xw + c0, cs, nrows, lane < ck);
    __syncwarp();
    const float* xr = xs + lane * (kChunk + 1);
#pragma unroll 2
    for (int c = 0; c < ck; ++c) {
      const float v = xr[c];
      const float4* wc = reinterpret_cast<const float4*>(w + (c0 + c) * NB);
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {
        const float4 wq = wc[q];
        acc[4 * q + 0] = fmaf(v, wq.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
      }
      const float v2 = v * v;
      if (MASKED) {
        const float4* mc = reinterpret_cast<const float4*>(msk + (c0 + c) * NB);
#pragma unroll
        for (int q = 0; q < NB / 4; ++q) {
          const float4 mq = mc[q];
          sq[4 * q + 0] = fmaf(v2, mq.x, sq[4 * q + 0]);
          sq[4 * q + 1] = fmaf(v2, mq.y, sq[4 * q + 1]);
          sq[4 * q + 2] = fmaf(v2, mq.z, sq[4 * q + 2]);
          sq[4 * q + 3] = fmaf(v2, mq.w, sq[4 * q + 3]);
        }
      } else {
        sq[0] += v2;
      }
    }
    __syncwarp();  // xs consumed before the next chunk lands
  }

  // scores of row `lane` into xs[lane][...]; the warp's rows are one
  // contiguous span of the output, copied out coalesced
  const float norm = sqrtf(sq[0]);
  float m = -__int_as_float(0x7f800000);
  float* sc = xs;
  if (lane < nrows) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i < bins) {
        const float den = fmaxf((MASKED ? sqrtf(sq[i]) : norm) * gnorm, 1e-12f);
        const float s = acc[i] / den;
        m = fmaxf(m, s);
        sc[lane * bins + i] = s;
      }
    }
    if (EPI) smax[wbase + lane] = from_f32<T>(m);
  }
  __syncwarp();
  T* sdst = scores + wbase * bins;
  for (int e = lane; e < nrows * bins; e += 32) sdst[e] = from_f32<T>(sc[e]);
  if (EPI) {
    // xnorm: the warp re-stages its rows (from L2) and writes them scaled,
    // lane = channel; row r's 1 / clamped norm comes from lane r
    const float inv = 1.f / fmaxf(norm, 1e-12f);
    T* xo = xnorm + wbase * cs;
    for (int c0 = 0; c0 < cs; c0 += kChunk) {
      const int ck = min(kChunk, cs - c0);
      __syncwarp();  // scores / previous chunk read out
      stage_rows(xs, xw + c0, cs, nrows, lane < ck);
      __syncwarp();
      for (int r = 0; r < 32; ++r) {
        const float n = __shfl_sync(0xffffffffu, inv, r);
        if (r < nrows && lane < ck)
          xo[(size_t)r * cs + c0 + lane] = from_f32<T>(xs[r * (kChunk + 1) + lane] * n);
      }
    }
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
};

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
  } else {
    // raise the dynamic shared-memory cap once per device (the attribute
    // is set for the current device only)
    constexpr int kMaxDevices = 64;
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= kMaxDevices || !opted_in[dev]) {
      cudaFuncSetAttribute(match_row_kernel<T, NB, EPI, MASKED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kRowMaxSmem);
      if (dev < kMaxDevices) opted_in[dev] = true;
    }
    const dim3 grid((a.hw + kRowThreads - 1) / kRowThreads, a.batch);
    const size_t smem = row_smem(a.cs, NB, MASKED).total * sizeof(float);
    match_row_kernel<T, NB, EPI, MASKED><<<grid, kRowThreads, smem, a.st>>>(
        x, g, scores, smax, xnorm, a.hw, a.cs, a.cg, a.bins, a.sh);
  }
}

template <typename T, bool EPI, bool MASKED>
void dispatch_nb(const Args& a, int layout) {
  switch (pick_nb(a.bins)) {
    case 4: launch<T, 4, EPI, MASKED>(a, layout); break;
    case 8: launch<T, 8, EPI, MASKED>(a, layout); break;
    case 12: launch<T, 12, EPI, MASKED>(a, layout); break;
    case 16: launch<T, 16, EPI, MASKED>(a, layout); break;
    case 20: launch<T, 20, EPI, MASKED>(a, layout); break;
    case 24: launch<T, 24, EPI, MASKED>(a, layout); break;
    case 28: launch<T, 28, EPI, MASKED>(a, layout); break;
    default: launch<T, 32, EPI, MASKED>(a, layout); break;
  }
}

template <bool EPI, bool MASKED>
int dispatch(const Args& a, int dtype, int layout) {
  if (dtype == 1)
    dispatch_nb<__nv_bfloat16, EPI, MASKED>(a, layout);
  else
    dispatch_nb<float, EPI, MASKED>(a, layout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory (bytes) that the row layout needs; the wrapper refuses the
// row layout above kRowMaxSmem.
extern "C" int ccvpe_match_row_smem_bytes(int cs, int bins, int masked) {
  return row_smem(cs, pick_nb(bins), masked != 0).total * static_cast<int>(sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16.  layout: 0 = warp, 1 = row.  x [batch,
// hw, cs] and g [batch, cs] are contiguous; scores [batch, hw, bins], smax
// [batch, hw], xnorm [batch, hw, cs].  ks holds bins values in [0, cs),
// 1 <= bins <= 32.  Returns cudaGetLastError().
extern "C" int ccvpe_match_epilogue(const void* x, const void* g, void* scores,
                                    void* smax, void* xnorm, int batch, int hw,
                                    int cs, int bins, const int* ks, int dtype,
                                    int layout, int rows_per_block, void* stream) {
  const Args a{x, g, scores, smax, xnorm, batch, hw, cs, cs, bins, rows_per_block,
               pack_shifts(ks, bins), static_cast<cudaStream_t>(stream)};
  return dispatch<true, false>(a, dtype, layout);
}

// x [batch, hw, cs], g [batch, cg] with cg <= cs, scores [batch, hw, bins].
extern "C" int ccvpe_match_scores(const void* x, const void* g, void* scores, int batch,
                                  int hw, int cs, int cg, int bins, const int* ks,
                                  int dtype, int layout, int rows_per_block,
                                  void* stream) {
  const Args a{x, g, scores, nullptr, nullptr, batch, hw, cs, cg, bins, rows_per_block,
               pack_shifts(ks, bins), static_cast<cudaStream_t>(stream)};
  return cg < cs ? dispatch<false, true>(a, dtype, layout)
                 : dispatch<false, false>(a, dtype, layout);
}
