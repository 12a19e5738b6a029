// 3x3 convolutions of the CVM decoders for Hopper (sm_90a), float32 FFMA,
// plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (ccvpe_tpu/models/cvm.py's double convs through nn.layers.conv_apply).
// They were added because the decoders' 24 double-conv 3x3 convolutions of
// an inference forward (2 per stage x 6 stages x 2 branches) hold about
// three quarters of its FLOPs (VIGOR: 348 GFLOP of ~456 at batch 8), and
// cuDNN's heuristic ran them at about 15 % of the card's float32 rate with
// algorithms this repository does not choose (FFT, legacy implicit sgemm).
//
// What each computes: out = act(conv3x3(x, w) + bias), stride 1, zero
// padding 1, groups 1, in float32 (no TF32: the configurations run float32
// with TF32 off), where act is a ReLU or the identity.  x is NHWC (the
// model's channels_last tensor), out is NHWC.
//
// What bounds them on the H100: the FFMA rate (67 TFLOP/s at 1980 MHz; no
// tensor cores in float32) for every decoder shape but the last 512x512
// convs to Cout 1 and 2, which are bound by device-memory bytes (134 MB of
// input at batch 8 for 1.2 GFLOP at most).  So the design keeps the FFMA
// pipes fed: the math warps issue FFMAs and shared-memory reads, and almost
// nothing else.
//
// Both GEMM kernels are implicit GEMMs: M = B*H*W output pixels, N = Cout,
// K = 9 * Cin; C[m][n] = sum_k A[m][k] B[k][n], with A[m][k] the input pixel
// under one tap of pixel m (zero outside the image) and B the weight,
// repacked by the wrapper at each call to [K][N] (N zero-padded to the
// plan's BN; one copy, a few hundredths of the conv's time).  K runs in
// chunks of kBK = 8 channels, the nine taps of a chunk in turn, the chunk's
// channels in order within a tap (Cin zero-padded to a whole chunk), so each
// output sums its products in the order chunk -> tap -> channel.
//
// conv3x3_halo_kernel, every shape whose Cin is a multiple of 4 (every
// decoder conv to Cout > 2, forward and dgrad):
//   * a block computes the outputs of a TH x TW tile of one image's pixels
//     for BN output channels;
//   * for each chunk of channels, one TMA tile load brings the tile's input
//     with its one-pixel halo, (TH+2) x (TW+2) x 8 floats of the NHWC x (a
//     4-D tensor map [B][H][W][Cin], the box at (y0-1, x0-1)), into shared
//     memory; TMA's out-of-bounds fill writes the conv's zero padding and
//     the zero channels past Cin, so no tap masks or per-copy addresses
//     remain.  A second TMA load brings the chunk's 9 x 8 x BN weights;
//   * the nine taps of the chunk then run from that one stage: 72 K values
//     a stage, and each input byte leaves L2 about (TH+2)(TW+2)/(TH TW)
//     times a chunk instead of nine;
//   * a producer warp (one lane) keeps the loads in flight in a ring of
//     three stages, full and empty mbarriers between it and the consumer
//     warps, which wait for a stage, compute it and release it: the main
//     loop has no block-wide barrier;
//   * a consumer thread holds 8 pixels x 8 channels of float32 accumulators
//     in registers: the 8 pixels of one tile column, RG rows apart (so tap
//     (dy, dx) of its pixel r lies at a fixed offset from the thread's base,
//     halo row (py + dy)(TW + 2) + (px + dx)), the channels tn*4 + {0..3}
//     and (tn + BN/8)*4 + {0..3}.  Each 4 k of a tap load the thread's 8
//     float4s of A and the 8 of B's four rows first, then run their 256
//     FFMAs: the loop is FFMA but for about 6 % of reads, and a step's 16
//     reads are in flight together;
//   * the halo tile is stored as TMA writes it, a pixel's 8 channels in 32
//     bytes; a warp's lanes run over BN first and over consecutive pixels of
//     one row next (TW a multiple of the pixels a warp spans), so the float4
//     reads of a quarter warp are one broadcast or distinct banks, and B's
//     are consecutive float4s;
//   * a block has 4 or 8 consumer warps, so the SM's four schedulers get
//     equal shares of the FFMAs (a 6-warp block ran ~25 % slower), and 1 or
//     3 blocks fill an SM's registers (128 a thread at 3);
//   * tiles are numbered with the N tile fastest, so the blocks that share
//     an input tile run together and read it from L2;
//   * epilogue: bias and the optional ReLU in registers, float4 stores
//     where Cout is a multiple of 4.
// The plans (with_plan below, the same table as ops/conv_cuda.py's PLANS)
// differ in TH x TW, BN and the blocks resident on an SM; the wrapper picks
// plan and split of K from a cost model fitted to their times on the H100
// (launch_cost: tiles, resident blocks, the SMs' last round).  Where the
// tiles leave resident slots empty (the 16x16 and 32x32 stages), K is
// split in whole chunks over gridDim.z into a float32 workspace that
// conv3x3_splitk_reduce sums in a fixed order, adding the bias and the ReLU.
//
// conv3x3_gemm_kernel, the gather: a shape whose Cin is not a multiple of 4,
// which a tensor map cannot stride (of the decoders', only the dgrad of the
// convs to Cout 1 and 2, whose input gradient has 1 or 2 channels).  A
// 256 x 32 tile of flattened pixels; K in slabs of one tap's 8 channels; the
// threads copy each slab's A themselves with 4-byte cp.async (zero-filled
// outside the image from a per-row tap mask) and B in 16-byte granules,
// through a ring of three stages and a block barrier per slab.
//
// conv3x3_direct_kernel: Cout 1 and 2 (the last conv of each branch at
// 512x512).  Bound by bytes, so a thread per output pixel reads its 3x3
// neighbourhood in float4s through L1 (neighbouring threads share it; each
// input byte leaves device memory about once) against weights broadcast
// from shared memory, and writes Cout floats.  (Four pixels a thread, each
// weight read feeding four FFMAs, measured 1.6-2.1x slower on the H100:
// the threads' float4 reads then lie four pixels apart.)
//
// The backward of a training step (ops/conv_cuda.py's autograd Function):
//   * dgrad, dx = conv3x3(g, w') with w'[c][o][ky][kx] = w[o][c][2-ky][2-kx]
//     (stride 1, padding 1), no bias, no ReLU: the forward's kernels
//     themselves, the wrapper packing w' as it packs w;
//   * wgrad, conv3x3_wgrad_kernel: a GEMM of M = 9*Cin + 1 rows (the nine
//     taps' input channels and a row of ones, whose sums are the bias
//     gradient), N = Cout, K = B*H*W pixels, on the gather's ring and
//     k-major tiles (six tile shapes, chosen by Cout), A the implicit
//     gather of x's halo, B the rows of g.  K is split over pixel ranges
//     (gridDim.z) into a float32 workspace until the tiles fill the card's
//     resident slots (hundreds of splits at 512x512, where M x N is one
//     tile), and conv3x3_wgrad_reduce sums the splits in a fixed order into
//     the weight's channels_last layout [Cout][ky][kx][Cin] and the bias,
//     so a step's gradients are the same bits run to run.

#include <cuda.h>  // CUtensorMap and its enums; the driver's encoder is reached at run time
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

template <class T>
__device__ __forceinline__ T* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct ConvArgs {
  const float* x;     // [batch][h][w][cin]
  const float* wt;    // GEMM: [9 * cin padded to kBK][npad]; direct: [9 * cin][cout]
  const float* bias;  // [cout] or null
  float* out;         // [m][cout]; with a split of K, the workspace [splits][m][cout]
  int h, w, cin, cout, npad;
  int m;              // batch*h*w
  int slabs;          // K slabs of each split
  int relu;
};

constexpr int kBK = 8;  // channels of a K chunk (and of the gather's slab of one tap)

// The gather's and wgrad's tiles: A k-major ([BK][BM + 4]) from 4-byte
// copies, B [BK][BN].
template <int BM_, int BN_, int TN_, int MIN_BLOCKS_>
struct Plan {
  static constexpr int BM = BM_, BN = BN_, BK = kBK, TM = 8, TN = TN_, STAGES = 3;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int MT = BM / TM, NT = BN / TN, THREADS = MT * NT;
  // a warp's thread columns and rows
  static constexpr int WN = NT % 8 == 0 ? 8 : NT % 4 == 0 ? 4 : NT, WM = 32 / WN;
  static constexpr int SA = BM + 4;                           // A row stride (floats)
  static constexpr int A_STAGE = BK * SA;
  static constexpr int STAGE = A_STAGE + BK * BN;             // floats of one ring stage
  static constexpr int SMEM = STAGES * STAGE * 4;
  static constexpr int A_ROW_STEP = THREADS / BK;
  static constexpr int A_COPIES = (BM + A_ROW_STEP - 1) / A_ROW_STEP;  // of a thread a slab
  static constexpr int B_GRANULES = BK * BN / 4;
  static_assert(THREADS % 32 == 0 && MT % WM == 0 && NT % WN == 0, "warp layout");
  static_assert(THREADS % BK == 0, "A copies");
  static_assert(TN == 4 || TN == 8, "thread tile");
};

// Bits ty*3 + tx of the taps (ty, tx) of pixel (y, x) that lie inside the
// image.
__device__ __forceinline__ int tap_mask(int y, int x, int h, int w) {
  const int rows = (y > 0 ? 1 : 0) | 2 | (y < h - 1 ? 4 : 0);
  const int cols = (x > 0 ? 1 : 0) | 2 | (x < w - 1 ? 4 : 0);
  int mask = 0;
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
    if (rows >> ty & 1) mask |= cols << (3 * ty);
  return mask;
}

// One slab's FFMAs into a thread's TM x TN tile: columns (tn + h*NT)*4 + j;
// rows (tm + h*MT)*4 + j.
template <class P>
__device__ __forceinline__ void fma_slab(const float* As, const float* Bs,
                                         float (&acc)[P::TM][P::TN], int tm, int tn) {
#pragma unroll
  for (int q = 0; q < P::BK; ++q) {
    alignas(16) float av[P::TM], bv[P::TN];
#pragma unroll
    for (int h = 0; h < P::TM / 4; ++h)
      *reinterpret_cast<float4*>(av + 4 * h) =
          *reinterpret_cast<const float4*>(As + q * P::SA + (tm + h * P::MT) * 4);
#pragma unroll
    for (int h = 0; h < P::TN / 4; ++h)
      *reinterpret_cast<float4*>(bv + 4 * h) =
          *reinterpret_cast<const float4*>(Bs + q * P::BN + (tn + h * P::NT) * 4);
#pragma unroll
    for (int r = 0; r < P::TM; ++r)
#pragma unroll
      for (int j = 0; j < P::TN; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
  }
}

// A block's GEMM over its nslabs K slabs, through the ring of STAGES stages:
// copy_slab(s, stage) issues the copies of slab s (called once a slab, in
// increasing s), the copies of slab s+2 in flight while slab s is computed.
template <class P, class Copy>
__device__ __forceinline__ void gemm_slabs(float* smem, int nslabs, Copy&& copy_slab,
                                           float (&acc)[P::TM][P::TN], int tm, int tn) {
#pragma unroll
  for (int i = 0; i < P::TM; ++i)
#pragma unroll
    for (int j = 0; j < P::TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < nslabs) copy_slab(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nslabs; ++i) {
    cp_async_wait<P::STAGES - 2>();  // this thread's copies of slab i have landed
    __syncthreads();                 // everyone's have, and slab i-1's stage is free
    const int next = i + P::STAGES - 1;
    if (next < nslabs) copy_slab(next, next % P::STAGES);
    cp_async_commit();
    const float* As = smem + (i % P::STAGES) * P::STAGE;
    fma_slab<P>(As, As + P::A_STAGE, acc, tm, tn);
  }
  cp_async_wait<0>();
}

// The epilogue of a thread's 8 x 8 or 8 x 4 tile: out[m][n] = act(acc +
// bias) for its rows' pixels m (-1: none) and columns n0 + (tn + h*NT)*4 +
// {0..3}; with a split of K (gridDim.z > 1) the raw sums go to the split's
// slice of the workspace.
template <int TM, int TN, int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[TM][TN], const int (&m)[TM],
                                           int n0, int tn, const float* bias, float* out,
                                           int mtotal, int cout, int relu) {
  const bool split = gridDim.z > 1;
  out += static_cast<size_t>(blockIdx.z) * mtotal * cout;
  const bool vec = cout % 4 == 0;
#pragma unroll
  for (int h2 = 0; h2 < TN / 4; ++h2) {
    const int n = n0 + (tn + h2 * NT) * 4;
    if (n >= cout) continue;
    float b[4] = {0.f, 0.f, 0.f, 0.f};
    if (!split && bias != nullptr)
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = n + j < cout ? bias[n + j] : 0.f;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      if (m[r] < 0) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[r][h2 * 4 + j] + b[j];
        if (!split && relu) v[j] = fmaxf(v[j], 0.f);
      }
      float* dst = out + static_cast<size_t>(m[r]) * cout + n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < cout) dst[j] = v[j];
      }
    }
  }
}

template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS) conv3x3_gemm_kernel(ConvArgs a) {
  float* smem = dynamic_smem<float>();
  const int t = threadIdx.x;
  const int ntn = a.npad / P::BN;
  const int m0 = (blockIdx.x / ntn) * P::BM, n0 = (blockIdx.x % ntn) * P::BN;
  const int slab0 = blockIdx.z * a.slabs;
  const int chunks = (a.cin + P::BK - 1) / P::BK;
  const int nslabs = min(a.slabs, 9 * chunks - slab0);

  // A copies: this thread's channel col of the slab and tile rows r0 + s * A_ROW_STEP
  const int col = t % P::BK, r0 = t / P::BK;
  int base[P::A_COPIES], mask[P::A_COPIES];
#pragma unroll
  for (int s = 0; s < P::A_COPIES; ++s) {
    const int m = m0 + r0 + s * P::A_ROW_STEP;
    base[s] = 0;
    mask[s] = 0;
    if (m < a.m && r0 + s * P::A_ROW_STEP < P::BM) {
      const int p = m % (a.h * a.w), y = p / a.w;
      base[s] = m * a.cin;
      mask[s] = tap_mask(y, p - y * a.w, a.h, a.w);
    }
  }

  // slab q holds channels (q / 9) * BK + [0, BK) of tap q % 9: the nine taps
  // of a chunk of channels follow each other, so the rows they read stay in L1
  auto copy_slab = [&](int slab, int stage) {
    float* As = smem + stage * P::STAGE;
    float* Bs = As + P::A_STAGE;
    const int q = slab0 + slab, tap = q % 9, c = (q / 9) * P::BK + col;
    const int off = ((tap / 3 - 1) * a.w + tap % 3 - 1) * a.cin + c;
#pragma unroll
    for (int s = 0; s < P::A_COPIES; ++s) {
      const int r = r0 + s * P::A_ROW_STEP;
      if (P::BM % P::A_ROW_STEP && r >= P::BM) break;
      const bool ok = ((mask[s] >> tap) & 1) && c < a.cin;
      cp_async4(As + col * P::SA + r, a.x + (ok ? base[s] + off : 0), ok);
    }
    const float* src = a.wt + static_cast<size_t>(q) * P::BK * a.npad + n0;
    for (int g = t; g < P::B_GRANULES; g += P::THREADS) {
      const int row = g / (P::BN / 4), gc = (g % (P::BN / 4)) * 4;
      cp_async16(Bs + row * P::BN + gc, src + static_cast<size_t>(row) * a.npad + gc);
    }
  };

  // thread tile: columns (tn + h*NT)*4 + j; rows (tm + h*MT)*4 + j
  const int warp = t / 32, lane = t % 32;
  const int tn = (warp % (P::NT / P::WN)) * P::WN + lane % P::WN;
  const int tm = (warp / (P::NT / P::WN)) * P::WM + lane / P::WN;

  float acc[P::TM][P::TN];
  gemm_slabs<P>(smem, nslabs, copy_slab, acc, tm, tn);

  int m[P::TM];
#pragma unroll
  for (int r = 0; r < P::TM; ++r) {
    m[r] = m0 + (tm + (r / 4) * P::MT) * 4 + r % 4;
    if (m[r] >= a.m) m[r] = -1;
  }
  store_tile<P::TM, P::TN, P::NT>(acc, m, n0, tn, a.bias, a.out, a.m, a.cout, a.relu);
}

// ---- the halo kernel: TMA loads into an mbarrier ring ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA writes before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

struct HaloArgs {
  const float* bias;  // [cout] or null
  float* out;         // [m][cout]; with a split of K, the workspace [splits][m][cout]
  int h, w, cout;
  int m;              // batch*h*w
  int chunks;         // K chunks of kBK channels
  int steps;          // chunks of each split
  int tiles_x, tiles_y, ntn;
  int relu;
};

// A halo plan: TH x TW output pixels of one image and BN output channels a
// block, BLOCKS blocks resident on an SM.
template <int TH_, int TW_, int BN_, int BLOCKS_>
struct Halo {
  static constexpr int TH = TH_, TW = TW_, BN = BN_, BLOCKS = BLOCKS_;
  static constexpr int CK = kBK, TM = 8, TN = 8, STAGES = 3;
  static constexpr int HH = TH + 2, HW = TW + 2;              // the halo tile
  static constexpr int MT = TH * TW / TM, NT = BN / TN;       // thread rows and columns
  static constexpr int RG = MT / TW;                          // rows between a thread's pixels
  static constexpr int CONSUMERS = MT * NT, WARPS = CONSUMERS / 32;
  static constexpr int THREADS = CONSUMERS + 32;              // and the producer warp
  static constexpr int WN = NT % 8 == 0 ? 8 : NT % 4 == 0 ? 4 : 2, WM = 32 / WN;
  static constexpr int A_BYTES = HH * HW * CK * 4, B_BYTES = 9 * CK * BN * 4;
  static constexpr int A_STAGE = (A_BYTES + 127) / 128 * 32;  // floats, 128-byte aligned
  static constexpr int STAGE = A_STAGE + B_BYTES / 4;
  static constexpr int SMEM = STAGES * STAGE * 4 + 2 * STAGES * 8;  // and the barriers
  static_assert(CONSUMERS % 32 == 0 && NT % WN == 0 && MT % WM == 0 && TW % WM == 0,
                "a warp spans one row of pixels");
  static_assert(MT % TW == 0 && TH == TM * RG, "a thread's pixels: one column, RG rows apart");
  static_assert(BN % 16 == 0 && BN <= 256 && HW <= 256 && HH <= 256 && 9 * CK <= 256,
                "TMA boxes");
  static_assert(STAGE % 32 == 0, "128-byte aligned stages");
};

// One stage's FFMAs: the nine taps of a chunk, its channels in order within
// a tap.  a: the halo at the thread's first pixel; b: B at its first column.
// Each 4 k of a tap load the thread's 8 A float4s and the 4 B rows' 8
// float4s first, then run their 256 FFMAs.
template <class P>
__device__ __forceinline__ void halo_fma(const float* a, const float* b,
                                         float (&acc)[P::TM][P::TN]) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const float* at = a + ((tap / 3) * P::HW + tap % 3) * P::CK;
    const float* bt = b + tap * P::CK * P::BN;
#pragma unroll
    for (int kq = 0; kq < P::CK / 4; ++kq) {
      alignas(16) float av[P::TM][4], bv[4][P::TN];
#pragma unroll
      for (int r = 0; r < P::TM; ++r)
        *reinterpret_cast<float4*>(av[r]) =
            *reinterpret_cast<const float4*>(at + r * P::RG * P::HW * P::CK + kq * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* bq = bt + (kq * 4 + q) * P::BN;
        *reinterpret_cast<float4*>(bv[q]) = *reinterpret_cast<const float4*>(bq);
        *reinterpret_cast<float4*>(bv[q] + 4) = *reinterpret_cast<const float4*>(bq + P::NT * 4);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < P::TM; ++r)
#pragma unroll
          for (int j = 0; j < P::TN; ++j) acc[r][j] = fmaf(av[r][q], bv[q][j], acc[r][j]);
    }
  }
}

template <class P>
__global__ void __launch_bounds__(P::THREADS, P::BLOCKS)
    conv3x3_halo_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, HaloArgs a) {
  // (no static shared memory: the dynamic block starts 128-byte aligned, as
  // TMA wants; the pointer stays visibly shared, so its reads are LDS)
  extern __shared__ __align__(128) unsigned char halo_smem[];
  float* smem = reinterpret_cast<float*>(halo_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::STAGES * P::STAGE);
  uint64_t* empty = full + P::STAGES;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;

  // the block's tile (N tile fastest): image b, rows y0.., columns x0..,
  // channels n0..; chunks c0 .. c0 + n - 1 of its split
  int idx = blockIdx.x;
  const int n0 = idx % a.ntn * P::BN;
  idx /= a.ntn;
  const int x0 = idx % a.tiles_x * P::TW;
  idx /= a.tiles_x;
  const int y0 = idx % a.tiles_y * P::TH, b = idx / a.tiles_y;
  const int c0 = blockIdx.z * a.steps;
  const int n = min(a.steps, a.chunks - c0);

  if (t == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, P::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == P::WARPS) {  // the producer: one lane issues the loads
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % P::STAGES;
        if (i >= P::STAGES) mbar_wait(empty + s, (i / P::STAGES - 1) & 1);
        float* As = smem + s * P::STAGE;
        mbar_expect_tx(full + s, P::A_BYTES + P::B_BYTES);
        tma_load_4d(As, &xmap, full + s, (c0 + i) * P::CK, x0 - 1, y0 - 1, b);
        tma_load_2d(As + P::A_STAGE, &wmap, full + s, n0, (c0 + i) * 9 * P::CK);
      }
    }
    return;
  }

  // thread tile: pixels (g + r*RG, px) of the tile, columns (tn + h*NT)*4 + j
  const int tn = (warp % (P::NT / P::WN)) * P::WN + lane % P::WN;
  const int tm = (warp / (P::NT / P::WN)) * P::WM + lane / P::WN;
  const int g = tm / P::TW, px = tm % P::TW;
  float acc[P::TM][P::TN];
#pragma unroll
  for (int i = 0; i < P::TM; ++i)
#pragma unroll
    for (int j = 0; j < P::TN; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % P::STAGES;
    mbar_wait(full + s, (i / P::STAGES) & 1);
    const float* As = smem + s * P::STAGE;
    halo_fma<P>(As + (g * P::HW + px) * P::CK, As + P::A_STAGE + tn * 4, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

  int m[P::TM];
  const int x = x0 + px;
#pragma unroll
  for (int r = 0; r < P::TM; ++r) {
    const int y = y0 + g + r * P::RG;
    m[r] = y < a.h && x < a.w ? (b * a.h + y) * a.w + x : -1;
  }
  store_tile<P::TM, P::TN, P::NT>(acc, m, n0, tn, a.bias, a.out, a.m, a.cout, a.relu);
}

// out[i] = act(sum over the splits of ws[z][i] + bias[i % cout]), the
// splits added in order.
__global__ void conv3x3_splitk_reduce(const float* ws, const float* bias, float* out, int mn,
                                      int cout, int splits, int relu) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < mn; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[static_cast<size_t>(z) * mn + i];
    if (bias != nullptr) s += bias[i % cout];
    out[i] = relu ? fmaxf(s, 0.f) : s;
  }
}

template <int COUT>
__global__ void __launch_bounds__(256) conv3x3_direct_kernel(ConvArgs a) {
  float* ws = dynamic_smem<float>();  // [9*cin][COUT]
  for (int i = threadIdx.x; i < 9 * a.cin * COUT; i += blockDim.x) ws[i] = a.wt[i];
  __syncthreads();
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= a.m) return;
  const int b = m / (a.h * a.w), p = m - b * a.h * a.w, y = p / a.w, x = p - y * a.w;
  float acc[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) acc[o] = 0.f;
  const int c4 = a.cin / 4;
  for (int ty = 0; ty < 3; ++ty) {
    const int yy = y + ty - 1;
    if (yy < 0 || yy >= a.h) continue;
    for (int tx = 0; tx < 3; ++tx) {
      const int xx = x + tx - 1;
      if (xx < 0 || xx >= a.w) continue;
      const float4* src = reinterpret_cast<const float4*>(
          a.x + static_cast<size_t>((b * a.h + yy) * a.w + xx) * a.cin);
      const float* wt = ws + (ty * 3 + tx) * a.cin * COUT;
      for (int q = 0; q < c4; ++q) {
        const float4 v = __ldg(src + q);
        const float* wq = wt + 4 * q * COUT;
#pragma unroll
        for (int o = 0; o < COUT; ++o) {
          acc[o] = fmaf(v.x, wq[o], acc[o]);
          acc[o] = fmaf(v.y, wq[COUT + o], acc[o]);
          acc[o] = fmaf(v.z, wq[2 * COUT + o], acc[o]);
          acc[o] = fmaf(v.w, wq[3 * COUT + o], acc[o]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < COUT; ++o) {
    const float v = acc[o] + (a.bias != nullptr ? a.bias[o] : 0.f);
    a.out[static_cast<size_t>(m) * COUT + o] = a.relu ? fmaxf(v, 0.f) : v;
  }
}

struct WgradArgs {
  const float* x;  // [m][cin]
  const float* g;  // [m][cout]: the gradient of the conv's output (after the ReLU's mask)
  float* ws;       // [splits][cout][ldw]
  int h, w, cin, cout;
  int m;           // batch*h*w
  int rows;        // 9*cin + 1: the taps' rows and the bias row
  int ldw;         // rows rounded up to 4
  int slabs;       // K slabs (of BK pixels) of each split
};

// The weight gradient as a GEMM: C[k][n] = sum over pixels p of A[k][p] B[p][n],
// k = tap * cin + c (tap = ky * 3 + kx) for k < 9*cin, A the input pixel
// under tap of p (zero outside the image), and A = 1 in row 9*cin, so that
// its C row is the bias gradient; B = g.  Tiles and ring are the forward's
// k-major ones: a slab is BK pixels.  Each thread copies the A granules of
// one pixel row of the slab (whose image position it steps along) and B in
// 16-byte granules along n.  Split z writes its tile's raw sums transposed
// into ws[z][n][k], in the layout of a channels_last weight
// ([cout][ky][kx][cin]) with the bias row after the taps.
template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS) conv3x3_wgrad_kernel(WgradArgs a) {
  static_assert(P::THREADS % P::BK == 0, "wgrad tiles are k-major");
  constexpr int GROUPS = P::THREADS / P::BK;                     // A granule columns of a pass
  constexpr int A_G = (P::BM / 4 + GROUPS - 1) / GROUPS;         // A granules of a thread a slab
  constexpr int B_COLS = P::BN / 4, B_G = P::BK * B_COLS;       // B granules of a slab
  float* smem = dynamic_smem<float>();
  const int t = threadIdx.x;
  const int ntn = (a.cout + P::BN - 1) / P::BN;
  const int m0 = (blockIdx.x / ntn) * P::BM, n0 = (blockIdx.x % ntn) * P::BN;
  const int slab0 = blockIdx.z * a.slabs;
  const int nslabs = min(a.slabs, (a.m + P::BK - 1) / P::BK - slab0);
  const int k9 = 9 * a.cin;
  const bool avec = a.cin % 4 == 0, bvec = a.cout % 4 == 0;

  // this thread's A granules: pixel row r of the slab, columns c0 + i*GROUPS;
  // kind 0-8 a tap (offset aoff from the pixel's own row), 9 the bias
  // row's granule, 10 zeros, -1 no granule
  const int r = t % P::BK, c0 = t / P::BK;
  int kind[A_G], aoff[A_G];
#pragma unroll
  for (int i = 0; i < A_G; ++i) {
    const int c4 = c0 + i * GROUPS, k = m0 + 4 * c4;
    const int tap = k < k9 ? k / a.cin : 0;
    kind[i] = c4 >= P::BM / 4 ? -1 : k < k9 ? tap : k == k9 ? 9 : 10;
    aoff[i] = ((tap / 3 - 1) * a.w + tap % 3 - 1) * a.cin + (k - tap * a.cin);
  }
  // the pixel of row r in the next slab to copy, and its image position
  int p = slab0 * P::BK + r;
  int py = (p % (a.h * a.w)) / a.w, px = p % a.w;

  auto copy_slab = [&](int /*slab*/, int stage) {
    float* As = smem + stage * P::STAGE;
    float* Bs = As + P::A_STAGE;
    const bool vp = p < a.m;
    const int mask = vp ? tap_mask(py, px, a.h, a.w) : 0;
#pragma unroll
    for (int i = 0; i < A_G; ++i) {
      if (kind[i] < 0) continue;
      float* dst = As + r * P::SA + 4 * (c0 + i * GROUPS);
      if (avec) {
        if (kind[i] < 9) {
          const bool ok = (mask >> kind[i]) & 1;
          cp_async16z(dst, ok ? a.x + p * a.cin + aoff[i] : a.x, ok);
        } else {
          const float one = kind[i] == 9 && vp ? 1.f : 0.f;
          *reinterpret_cast<float4*>(dst) = make_float4(one, 0.f, 0.f, 0.f);
        }
        continue;
      }
      // cin not a multiple of 4: a granule may straddle taps
      const int k0 = m0 + 4 * (c0 + i * GROUPS);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j;
        if (k < k9) {
          const int tap = k / a.cin, c = k - tap * a.cin;
          const bool ok = (mask >> tap) & 1;
          cp_async4(dst + j, ok ? a.x + (p + (tap / 3 - 1) * a.w + tap % 3 - 1) * a.cin + c : a.x,
                    ok);
        } else {
          dst[j] = k == k9 && vp ? 1.f : 0.f;
        }
      }
    }
    // B: g's rows of the slab's pixels, lanes along n
    const int q0 = p - r;
    for (int gi = t; gi < B_G; gi += P::THREADS) {
      const int row = gi / B_COLS, gc = (gi % B_COLS) * 4, q = q0 + row, n = n0 + gc;
      float* dst = Bs + row * P::BN + gc;
      if (bvec) {
        const bool ok = q < a.m && n < a.cout;
        cp_async16z(dst, ok ? a.g + q * a.cout + n : a.g, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = q < a.m && n + j < a.cout;
          cp_async4(dst + j, ok ? a.g + q * a.cout + n + j : a.g, ok);
        }
      }
    }
    p += P::BK;
    px += P::BK;
    while (px >= a.w) {
      px -= a.w;
      if (++py == a.h) py = 0;
    }
  };

  const int warp = t / 32, lane = t % 32;
  const int tn = (warp % (P::NT / P::WN)) * P::WN + lane % P::WN;
  const int tm = (warp / (P::NT / P::WN)) * P::WM + lane / P::WN;
  float acc[P::TM][P::TN];
  gemm_slabs<P>(smem, nslabs, copy_slab, acc, tm, tn);

  // rows (tm + h*MT)*4 + {0..3} of column n: one float4 of ws[z][n]
  float* out = a.ws + static_cast<size_t>(blockIdx.z) * a.cout * a.ldw;
#pragma unroll
  for (int h2 = 0; h2 < P::TN / 4; ++h2)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + (tn + h2 * P::NT) * 4 + j;
      if (n >= a.cout) continue;
#pragma unroll
      for (int h = 0; h < P::TM / 4; ++h) {
        const int k = m0 + (tm + h * P::MT) * 4;
        if (k >= a.rows) continue;
        const int c = h2 * 4 + j;
        *reinterpret_cast<float4*>(out + static_cast<size_t>(n) * a.ldw + k) = make_float4(
            acc[h * 4][c], acc[h * 4 + 1][c], acc[h * 4 + 2][c], acc[h * 4 + 3][c]);
      }
    }
}

// dw[n][k] (k < 9*cin) and db[n] (k = 9*cin) = the sum over the splits of
// ws[z][n][k]: thread (x, y) of a block adds splits y, y + blockDim.y, ...
// in order, then thread (x, 0) adds the blockDim.y partial sums in order,
// so the result's bits do not change from run to run.
__global__ void conv3x3_wgrad_reduce(const float* ws, float* dw, float* db, int cout, int k9,
                                     int ldw, int splits) {
  float* part = dynamic_smem<float>();  // [blockDim.y][blockDim.x]
  const int rows = k9 + 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = i / rows, k = i - n * rows;
  float s = 0.f;
  if (i < cout * rows) {
    const float* src = ws + static_cast<size_t>(n) * ldw + k;
    const size_t stride = static_cast<size_t>(cout) * ldw;
#pragma unroll 4
    for (int z = threadIdx.y; z < splits; z += blockDim.y) s += src[z * stride];
  }
  part[threadIdx.y * blockDim.x + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || i >= cout * rows) return;
  for (int y = 1; y < blockDim.y; ++y) s += part[y * blockDim.x + threadIdx.x];
  if (k < k9)
    dw[static_cast<size_t>(n) * k9 + k] = s;
  else if (db != nullptr)
    db[n] = s;
}

// The forward's (and dgrad's) plans by code, in the order of
// ops/conv_cuda.py's PLANS: the halo plans (TH, TW, BN, BLOCKS), then the
// gather (BM, BN, TN, MIN_BLOCKS).
template <class H, class G>
int with_plan(int code, H&& halo, G&& gather) {
  switch (code) {
    case 0: return halo(Halo<8, 16, 128, 1>{});    // h128
    case 1: return halo(Halo<8, 16, 64, 3>{});     // h64
    case 2: return halo(Halo<16, 16, 32, 3>{});    // h32
    case 3: return halo(Halo<16, 32, 16, 3>{});    // h16
    case 4: return gather(Plan<256, 32, 8, 3>{});  // gather
    default: return -1;
  }
}

// The weight gradient's plans by code, in the order of ops/conv_cuda.py's
// WGRAD_PLANS: (BM, BN, TN, MIN_BLOCKS), A k-major (a slab is BK pixels,
// whose A rows are channels).
template <class F>
int with_wgrad_plan(int code, F&& f) {
  switch (code) {
    case 0: return f(Plan<128, 128, 8, 2>{});  // wide
    case 1: return f(Plan<128, 96, 8, 2>{});  // n96
    case 2: return f(Plan<128, 64, 8, 3>{});  // n64
    case 3: return f(Plan<128, 48, 4, 2>{});  // n48
    case 4: return f(Plan<256, 32, 8, 3>{});  // n32
    case 5: return f(Plan<256, 16, 4, 4>{});  // n16
    default: return -1;
  }
}

template <auto Kernel>
void opt_in_smem(int bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda; null where the driver does not offer it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A float32 tensor map of `rank` dimensions (innermost first), zero-filled
// out of bounds, no swizzle.
bool tensor_map(CUtensorMap* map, const float* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base), dims,
                strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Resolves the tensor-map encoder once, before any launch (and so before
// any CUDA graph capture).  Returns 0, or cudaErrorNotSupported where the
// driver lacks it.
extern "C" int ccvpe_conv3x3_init() {
  return encode_tiled() != nullptr ? 0 : static_cast<int>(cudaErrorNotSupported);
}

// x [batch][h][w][cin]; w [9 * cp][npad] with cp = cin rounded up to kBK,
// row ((j * 9 + ky * 3 + kx) * kBK + c) the weights of channel j * kBK + c
// at tap (ky, kx), npad a multiple of the plan's BN, at least cout; bias
// [cout] or null; out [batch*h*w][cout]; with splits > 1, ws
// [splits][batch*h*w][cout], each split taking `steps` K steps: chunks of
// kBK channels (a halo plan, cin a multiple of 4) or slabs (the gather).
// Every pointer 16-byte aligned.  Returns cudaErrorInvalidValue for
// arguments it does not take, else cudaGetLastError().
extern "C" int ccvpe_conv3x3(const float* x, const float* w, const float* bias, float* out,
                             float* ws, int batch, int h, int wd, int cin, int cout, int npad,
                             int relu, int plan, int splits, int steps, void* stream) {
  const long long m = static_cast<long long>(batch) * h * wd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || cin <= 0 || cout <= 0 || splits < 1 || splits > 65535 || steps < 1 ||
      m * cin > INT_MAX || m * cout * splits > INT_MAX || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = splits > 1 ? ws : out;
  const int chunks = (cin + kBK - 1) / kBK;
  const auto halo = [&](auto p) {
    using P = decltype(p);
    const long long tx = (wd + P::TW - 1) / P::TW, ty = (h + P::TH - 1) / P::TH;
    const long long tiles = batch * ty * tx * (npad / P::BN);
    if (cin % 4 || npad % P::BN || npad < cout || tiles > INT_MAX ||
        (splits - 1) * steps >= chunks || splits * steps < chunks)
      return static_cast<int>(cudaErrorInvalidValue);
    // x as [batch][h][w][cin], a box of the halo tile's rows, columns and a
    // chunk; w as [9 * cp][npad], a box of a chunk's 9 * kBK rows and BN columns
    const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(wd),
                                 static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(batch)};
    const cuuint64_t xstrides[3] = {4ull * cin, 4ull * cin * wd, 4ull * cin * wd * h};
    const cuuint32_t xbox[4] = {P::CK, P::HW, P::HH, 1};
    const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(npad), 9ull * kBK * chunks};
    const cuuint64_t wstrides[1] = {4ull * npad};
    const cuuint32_t wbox[2] = {P::BN, 9 * P::CK};
    CUtensorMap xmap, wmap;
    if (!tensor_map(&xmap, x, 4, xdims, xstrides, xbox) ||
        !tensor_map(&wmap, w, 2, wdims, wstrides, wbox))
      return static_cast<int>(cudaErrorInvalidValue);
    const HaloArgs a{bias, dst, h, wd, cout, static_cast<int>(m), chunks, steps,
                     static_cast<int>(tx), static_cast<int>(ty), npad / P::BN, relu};
    constexpr auto kernel = &conv3x3_halo_kernel<P>;
    opt_in_smem<kernel>(P::SMEM);
    kernel<<<dim3(static_cast<unsigned>(tiles), 1, splits), P::THREADS, P::SMEM, st>>>(xmap,
                                                                                     wmap, a);
    return 0;
  };
  const auto gather = [&](auto p) {
    using P = decltype(p);
    const long long tiles = (m + P::BM - 1) / P::BM * (npad / P::BN);
    const int total = 9 * chunks;
    if (npad % P::BN || npad < cout || tiles > INT_MAX || (splits - 1) * steps >= total ||
        splits * steps < total)
      return static_cast<int>(cudaErrorInvalidValue);
    ConvArgs a{x, w, bias, dst, h, wd, cin, cout, npad, static_cast<int>(m), steps, relu};
    constexpr auto kernel = &conv3x3_gemm_kernel<P>;
    opt_in_smem<kernel>(P::SMEM);
    kernel<<<dim3(static_cast<unsigned>(tiles), 1, splits), P::THREADS, P::SMEM, st>>>(a);
    return 0;
  };
  const int rc = with_plan(plan, halo, gather);
  if (rc < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rc > 0) return rc;
  if (splits > 1) {
    const int mn = static_cast<int>(m * cout);
    const int blocks = static_cast<int>((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
    conv3x3_splitk_reduce<<<blocks, 256, 0, st>>>(ws, bias, out, mn, cout, splits, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

// The direct kernel for cout 1 or 2: x as above with cin a multiple of 4,
// w [9*cin][cout] (k = (ky*3 + kx)*cin + c), out [batch*h*w][cout].
extern "C" int ccvpe_conv3x3_direct(const float* x, const float* w, const float* bias, float* out,
                                    int batch, int h, int wd, int cin, int cout, int relu,
                                    void* stream) {
  const long long m = static_cast<long long>(batch) * h * wd;
  const int smem = 9 * cin * cout * 4;
  if (m <= 0 || cin <= 0 || cin % 4 || m * cin > INT_MAX || smem > 48 * 1024 ||
      (cout != 1 && cout != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{x, w, bias, out, h, wd, cin, cout, cout, static_cast<int>(m), 0, relu};
  const unsigned blocks = static_cast<unsigned>((m + 255) / 256);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cout == 1)
    conv3x3_direct_kernel<1><<<blocks, 256, smem, st>>>(a);
  else
    conv3x3_direct_kernel<2><<<blocks, 256, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The weight and bias gradients of out = conv3x3(x, w) + bias: x
// [batch][h][w][cin], g [batch*h*w][cout] (the gradient of the conv's
// output), ws [splits][cout][ldw] with ldw >= 9*cin + 1 a multiple of 4, dw
// [cout][ky][kx][cin] (a channels_last weight), db [cout] or null.  Split z
// takes K slabs z*slabs .. of kBK pixels each.  Every pointer 16-byte
// aligned.  Returns cudaErrorInvalidValue for arguments it does not take,
// else cudaGetLastError().
extern "C" int ccvpe_conv3x3_wgrad(const float* x, const float* g, float* ws, float* dw, float* db,
                                   int batch, int h, int wd, int cin, int cout, int plan,
                                   int splits, int slabs, int ldw, void* stream) {
  const long long m = static_cast<long long>(batch) * h * wd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = 9LL * cin + 1, total = (m + kBK - 1) / kBK;
  if (m <= 0 || cin <= 0 || cout <= 0 || splits < 1 || splits > 65535 || slabs < 1 ||
      m * cin > INT_MAX || m * cout > INT_MAX || rows > INT_MAX || ldw < rows || ldw % 4 ||
      (splits - 1LL) * slabs >= total || static_cast<long long>(splits) * slabs < total ||
      static_cast<long long>(cout) * ldw > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = with_wgrad_plan(plan, [&](auto p) {
    using P = decltype(p);
    const long long tiles = (rows + P::BM - 1) / P::BM * ((cout + P::BN - 1) / P::BN);
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    WgradArgs a{x, g, ws, h, wd, cin, cout, static_cast<int>(m), static_cast<int>(rows), ldw,
                slabs};
    constexpr auto kernel = &conv3x3_wgrad_kernel<P>;
    opt_in_smem<kernel>(P::SMEM);
    kernel<<<dim3(static_cast<unsigned>(tiles), 1, splits), P::THREADS, P::SMEM, st>>>(a);
    return 0;
  });
  if (rc < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rc > 0) return rc;
  // the partial sums of a split go to threads y of a block; 256 threads
  const int zt = splits >= 8 ? 8 : splits >= 4 ? 4 : splits >= 2 ? 2 : 1;
  const dim3 block(256 / zt, zt);
  const long long outputs = cout * rows;
  conv3x3_wgrad_reduce<<<static_cast<unsigned>((outputs + block.x - 1) / block.x), block,
                         256 * sizeof(float), st>>>(ws, dw, db, cout, 9 * cin, ldw, splits);
  return static_cast<int>(cudaGetLastError());
}
