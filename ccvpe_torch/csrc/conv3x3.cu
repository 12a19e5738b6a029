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
// input at batch 8 for 1.2 GFLOP at most).
//
// conv3x3_gemm_kernel: an implicit GEMM.  M = B*H*W output pixels, N =
// Cout, K = 9 * Cin; C[m][n] = sum_k A[m][k] B[k][n], with A[m][k] the input
// pixel under one tap of pixel m (zero outside the image) and B the weight,
// repacked by the wrapper at each call to [K][N] (N zero-padded to the
// plan's BN; one copy, a few hundredths of the conv's time).
//   * K runs in slabs of BK = 8 channels of one tap: the nine taps of a
//     chunk of 8 channels, then the next chunk (Cin zero-padded to a whole
//     chunk).  A slab is one tap for the whole block, and the input rows
//     that the nine taps of a chunk read are the same few, so they come
//     from L1 after the first (all copies are cp.async.ca);
//   * a block computes a BM x BN tile of C; its threads each hold 8 x TN
//     float32 accumulators in registers (TN = 8 or 4), so one k step of a
//     thread is 8*TN FFMAs against 2 + TN/4 float4 reads of shared memory:
//     the inner loop is FFMA but for about 6 % (8x8) of loads;
//   * the A and B slabs go through a ring of three stages in dynamic shared
//     memory, the copies of slab s+2 in flight while slab s is computed.  A
//     tap outside the image zero-fills (cp.async's src-size 0); each copied
//     row's 9-bit tap validity is computed once per block;
//   * A's layout is the plan's: k-major ([BK][BM + 4]) from 4-byte copies,
//     a warp's lanes running over the channels of a pixel first (whole
//     32-byte sectors of x); or, where Cin is a multiple of 4, m-major
//     ([BM][BK + 4]) from 16-byte copies, a quarter of the copy
//     instructions, which the narrow tiles need (their A tile feeds few
//     columns, so its copies weigh more).  The padding of both layouts
//     spreads a quarter warp's reads and copies over the banks.  B is
//     copied in 16-byte granules;
//   * lanes of a warp cover 4 (or 8) thread rows x 8 (or 4) thread
//     columns; a thread's columns are tn*4 + {0..3} (+ BN/2 at TN = 8), its
//     rows tm*4 + {0..3} + {0, BM/2} (k-major) or tm + i*BM/8 (m-major),
//     so the float4 reads of a quarter warp hit distinct banks or broadcast;
//   * tiles are numbered with the N tile fastest, so the blocks that share
//     an A tile run together and read it from L2;
//   * epilogue: bias and the optional ReLU in registers, float4 stores
//     where Cout is a multiple of 4.
// The plans (with_plan below, the same table as ops/conv_cuda.py's PLANS)
// answer to the shapes, chosen in Python from times on the H100: 128x128
// where Cout is a multiple of 128; 96, 64, 48, 32 and 16 wide tiles for the
// narrow widths (VIGOR's 5 * 2^k widths 40, 80 and 160 pad to 48, 96 and
// 160, at most 20 % waste); and where the tiles give fewer blocks than the
// card has SMs (the 16x16 and 32x32 stages), a split of K over gridDim.z
// into a float32 workspace that conv3x3_splitk_reduce sums in a fixed
// order, adding the bias and the ReLU.
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
//     (stride 1, padding 1), no bias, no ReLU: conv3x3_gemm_kernel itself,
//     the wrapper packing w' as it packs w;
//   * wgrad, conv3x3_wgrad_kernel: a GEMM of M = 9*Cin + 1 rows (the nine
//     taps' input channels and a row of ones, whose sums are the bias
//     gradient), N = Cout, K = B*H*W pixels, on the forward's ring and
//     k-major tiles (the same six tile shapes, chosen by Cout), A the
//     forward's implicit gather of x's halo, B the rows of g.  K is split
//     over pixel ranges (gridDim.z) into a float32 workspace until the
//     tiles fill the card's resident slots (hundreds of splits at 512x512,
//     where M x N is one tile), and conv3x3_wgrad_reduce sums the splits in
//     a fixed order into the weight's channels_last layout [Cout][ky][kx][Cin]
//     and the bias, so a step's gradients are the same bits run to run.

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

constexpr int kBK = 8;  // K values (channels of one tap) of a slab

template <int BM_, int BN_, int TN_, int MIN_BLOCKS_, bool AM_>
struct Plan {
  static constexpr int BM = BM_, BN = BN_, BK = kBK, TM = 8, TN = TN_, STAGES = 3;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  // AM: A stored m-major ([BM][BK + 4]) from 16-byte copies of 4 channels;
  // else k-major ([BK][BM + 4]) from 4-byte copies
  static constexpr bool AM = AM_;
  static constexpr int MT = BM / TM, NT = BN / TN, THREADS = MT * NT;
  // a warp's thread columns and rows
  static constexpr int WN = NT % 8 == 0 ? 8 : NT % 4 == 0 ? 4 : NT, WM = 32 / WN;
  static constexpr int SA = AM ? BK + 4 : BM + 4;             // A row stride (floats)
  static constexpr int A_STAGE = AM ? BM * SA : BK * SA;
  static constexpr int STAGE = A_STAGE + BK * BN;             // floats of one ring stage
  static constexpr int SMEM = STAGES * STAGE * 4;
  static constexpr int A_VEC = AM ? 4 : 1;                    // channels of one A copy
  static constexpr int A_COLS = BK / A_VEC;                   // A copies of a tile row a slab
  static constexpr int A_ROW_STEP = THREADS / A_COLS;
  static constexpr int A_COPIES = (BM + A_ROW_STEP - 1) / A_ROW_STEP;  // of a thread a slab
  static constexpr int B_GRANULES = BK * BN / 4;
  static_assert(THREADS % 32 == 0 && MT % WM == 0 && NT % WN == 0, "warp layout");
  static_assert(THREADS % A_COLS == 0, "A copies");
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
// rows tm + i*MT (AM) or (tm + h*MT)*4 + j.
template <class P>
__device__ __forceinline__ void fma_slab(const float* As, const float* Bs,
                                         float (&acc)[P::TM][P::TN], int tm, int tn) {
  if constexpr (P::AM) {
#pragma unroll
    for (int kq = 0; kq < P::BK / 4; ++kq) {
      alignas(16) float av[P::TM][4];
#pragma unroll
      for (int r = 0; r < P::TM; ++r)
        *reinterpret_cast<float4*>(av[r]) =
            *reinterpret_cast<const float4*>(As + (tm + r * P::MT) * P::SA + kq * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        alignas(16) float bv[P::TN];
#pragma unroll
        for (int h = 0; h < P::TN / 4; ++h)
          *reinterpret_cast<float4*>(bv + 4 * h) = *reinterpret_cast<const float4*>(
              Bs + (kq * 4 + q) * P::BN + (tn + h * P::NT) * 4);
#pragma unroll
        for (int r = 0; r < P::TM; ++r)
#pragma unroll
          for (int j = 0; j < P::TN; ++j) acc[r][j] = fmaf(av[r][q], bv[j], acc[r][j]);
      }
    }
  } else {
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

template <class P>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS) conv3x3_gemm_kernel(ConvArgs a) {
  float* smem = dynamic_smem<float>();
  const int t = threadIdx.x;
  const int ntn = a.npad / P::BN;
  const int m0 = (blockIdx.x / ntn) * P::BM, n0 = (blockIdx.x % ntn) * P::BN;
  const int slab0 = blockIdx.z * a.slabs;
  const int chunks = (a.cin + P::BK - 1) / P::BK;
  const int nslabs = min(a.slabs, 9 * chunks - slab0);

  // A copies: this thread's column col (channel col * A_VEC of the slab)
  // and tile rows r0 + s * A_ROW_STEP
  const int col = t % P::A_COLS, r0 = t / P::A_COLS;
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
    const int q = slab0 + slab, tap = q % 9, c = (q / 9) * P::BK + col * P::A_VEC;
    const int off = ((tap / 3 - 1) * a.w + tap % 3 - 1) * a.cin + c;
#pragma unroll
    for (int s = 0; s < P::A_COPIES; ++s) {
      const int r = r0 + s * P::A_ROW_STEP;
      if (P::BM % P::A_ROW_STEP && r >= P::BM) break;
      const bool ok = ((mask[s] >> tap) & 1) && c < a.cin;
      const float* src = a.x + (ok ? base[s] + off : 0);
      if constexpr (P::AM)
        cp_async16z(As + r * P::SA + col * 4, src, ok);
      else
        cp_async4(As + col * P::SA + r, src, ok);
    }
    const float* src = a.wt + static_cast<size_t>(q) * P::BK * a.npad + n0;
    for (int g = t; g < P::B_GRANULES; g += P::THREADS) {
      const int row = g / (P::BN / 4), gc = (g % (P::BN / 4)) * 4;
      cp_async16(Bs + row * P::BN + gc, src + static_cast<size_t>(row) * a.npad + gc);
    }
  };

  // thread tile: columns (tn + h*NT)*4 + j; rows tm + i*MT (AM) or
  // (tm + h*MT)*4 + j
  const int warp = t / 32, lane = t % 32;
  const int tn = (warp % (P::NT / P::WN)) * P::WN + lane % P::WN;
  const int tm = (warp / (P::NT / P::WN)) * P::WM + lane / P::WN;

  float acc[P::TM][P::TN];
  gemm_slabs<P>(smem, nslabs, copy_slab, acc, tm, tn);

  // epilogue: a split of K leaves raw sums in its slice of the workspace
  const bool split = gridDim.z > 1;
  float* out = a.out + static_cast<size_t>(blockIdx.z) * a.m * a.cout;
  const bool vec = a.cout % 4 == 0;
#pragma unroll
  for (int h2 = 0; h2 < P::TN / 4; ++h2) {
    const int n = n0 + (tn + h2 * P::NT) * 4;
    if (n >= a.cout) continue;
    float bias[4] = {0.f, 0.f, 0.f, 0.f};
    if (!split && a.bias != nullptr)
#pragma unroll
      for (int j = 0; j < 4; ++j) bias[j] = n + j < a.cout ? a.bias[n + j] : 0.f;
#pragma unroll
    for (int r = 0; r < P::TM; ++r) {
      const int m = m0 + (P::AM ? tm + r * P::MT : (tm + (r / 4) * P::MT) * 4 + r % 4);
      if (m >= a.m) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[r][h2 * 4 + j] + bias[j];
        if (!split && a.relu) v[j] = fmaxf(v[j], 0.f);
      }
      float* dst = out + static_cast<size_t>(m) * a.cout + n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < a.cout) dst[j] = v[j];
      }
    }
  }
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
  static_assert(!P::AM && P::THREADS % P::BK == 0, "wgrad tiles are k-major");
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

// The GEMM plans by code, in the order of ops/conv_cuda.py's PLANS:
// (BM, BN, TN, MIN_BLOCKS, AM).
template <class F>
int with_plan(int code, F&& f) {
  switch (code) {
    case 0: return f(Plan<128, 128, 8, 2, false>{});  // wide
    case 1: return f(Plan<128, 96, 8, 2, true>{});    // n96
    case 2: return f(Plan<128, 64, 8, 3, false>{});   // n64
    case 3: return f(Plan<128, 48, 4, 2, true>{});    // n48
    case 4: return f(Plan<256, 32, 8, 3, false>{});   // n32
    case 5: return f(Plan<256, 16, 4, 4, true>{});    // n16
    default: return -1;
  }
}

// The weight gradient's plans by code, in the same order: the same tiles
// with A k-major (a slab is BK pixels, whose A rows are channels).
template <class F>
int with_wgrad_plan(int code, F&& f) {
  switch (code) {
    case 0: return f(Plan<128, 128, 8, 2, false>{});  // wide
    case 1: return f(Plan<128, 96, 8, 2, false>{});   // n96
    case 2: return f(Plan<128, 64, 8, 3, false>{});   // n64
    case 3: return f(Plan<128, 48, 4, 2, false>{});   // n48
    case 4: return f(Plan<256, 32, 8, 3, false>{});   // n32
    case 5: return f(Plan<256, 16, 4, 4, false>{});   // n16
    default: return -1;
  }
}

template <auto Kernel>
void opt_in_smem(int bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// x [batch][h][w][cin]; w [9 * cp][npad] with cp = cin rounded up to kBK,
// row ((j * 9 + ky * 3 + kx) * kBK + c) the weights of channel j * kBK + c
// at tap (ky, kx), npad a multiple of the plan's BN, at least cout; bias
// [cout] or null; out [batch*h*w][cout]; with splits > 1, ws
// [splits][batch*h*w][cout], each split taking `slabs` slabs.  Every
// pointer 16-byte aligned.  Returns cudaErrorInvalidValue for arguments it does not take,
// else cudaGetLastError().
extern "C" int ccvpe_conv3x3(const float* x, const float* w, const float* bias, float* out,
                             float* ws, int batch, int h, int wd, int cin, int cout, int npad,
                             int relu, int plan, int splits, int slabs, void* stream) {
  const long long m = static_cast<long long>(batch) * h * wd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || cin <= 0 || cout <= 0 || splits < 1 || splits > 65535 || slabs < 1 ||
      m * cin > INT_MAX || m * cout * splits > INT_MAX || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = with_plan(plan, [&](auto p) {
    using P = decltype(p);
    const long long tiles = (m + P::BM - 1) / P::BM * (npad / P::BN);
    const int total = 9 * ((cin + P::BK - 1) / P::BK);
    if (npad % P::BN || npad < cout || tiles > INT_MAX || (P::AM && cin % 4) ||
        (splits - 1) * slabs >= total ||
        splits * slabs < total)
      return static_cast<int>(cudaErrorInvalidValue);
    ConvArgs a{x, w, bias, splits > 1 ? ws : out, h, wd, cin, cout, npad, static_cast<int>(m),
               slabs, relu};
    constexpr auto kernel = &conv3x3_gemm_kernel<P>;
    opt_in_smem<kernel>(P::SMEM);
    kernel<<<dim3(static_cast<unsigned>(tiles), 1, splits), P::THREADS, P::SMEM, st>>>(a);
    return 0;
  });
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
