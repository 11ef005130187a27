// Eval-mode DenseNet dense block, BN folded from the running statistics.
//
// Replaces saunet_tpu/ops/pallas/dense_block.py::dense_block_fused (body
// _dense_block_kernel). Per layer l, on the concat x_cat[..., :C_l]:
//     u   = bf16(relu(x_cat * a1 + b1))          norm1 affine
//     t   = bf16(relu(u @ W1' + b2))             conv1 1x1, norm2 folded in
//     new = bf16(conv3x3(t, W2))                 conv2, zero boundary
//     x_cat[..., C_l:C_l + 32] = new             in place, never re-copied
// with f32 accumulation; the rounding points are the TPU kernel's.
//
// Bound: memory. The TPU kernel kept one image's whole concat in VMEM; here a
// block-1 concat (112^2 x 256 bf16, 6.4 MB per image) cannot live in shared
// memory, so the concat stays in device memory and each layer re-reads its
// live prefix (sum over layers of C_l channels), plus t's round trip
// (2 x 128 channels). Fusing (a) into (b), so t never reaches device memory,
// and wgmma/TMA pipelines are later work.
//
// Design, two launches per layer on the caller's stream:
//   (a) bottleneck_kernel: a 128-pixel x 128-channel output tile. K-chunks of
//       32 concat channels stream through shared memory; the prologue applies
//       a1/b1, ReLU and the bf16 rounding before the tile is stored. 8 warps
//       multiply with bf16 wmma 16x16x16 fragments into f32; the epilogue
//       adds b2, applies ReLU, rounds and stores t (N*H*W, 128).
//   (b) conv3x3_kernel: a 16x16-pixel output tile. Shared memory holds t with
//       a 1-pixel zero halo (18x18x128) and all 9 taps of W2 (9x128x32), about
//       181 KB of dynamic shared memory. 8 warps each own two output rows and
//       all 32 channels and accumulate 9 taps x 8 K-steps of wmma products;
//       the result is rounded and written at channel offset C_l of x_cat.
// The input is copied once into channels [0, C0) of x_cat.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int GROWTH = 32;
constexpr int HIDDEN = 128;

union Pack8 {
  uint4 v;
  bf16 h[8];
};

// ---- (a) bottleneck: t = relu((relu(x*a1 + b1)) @ W1' + b2) --------------
constexpr int A_BM = 128;
constexpr int A_BK = 32;
constexpr int A_THREADS = 256;
constexpr int A_LDA = A_BK + 8;       // bf16 elements per staged A row
constexpr int A_LDB = HIDDEN + 8;     // bf16 elements per staged B row
constexpr int A_LDC = HIDDEN + 4;     // f32 elements per epilogue row
constexpr int A_SMEM = A_BM * A_LDC * 4;  // epilogue reuses the A/B space
static_assert((A_BM * A_LDA + A_BK * A_LDB) * 2 <= A_SMEM, "smem");

__global__ void __launch_bounds__(A_THREADS)
bottleneck_kernel(const bf16* __restrict__ xcat, int cmax, int cl,
                  int m_total, const bf16* __restrict__ a1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w1,
                  const float* __restrict__ b2, bf16* __restrict__ t) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + A_BM * A_LDA;
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.x * A_BM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < cl; k0 += A_BK) {
    for (int v = tid; v < A_BM * (A_BK / 8); v += A_THREADS) {
      const int r = v / (A_BK / 8), q = v % (A_BK / 8);
      const int c = k0 + q * 8;
      const int m = m0 + r;
      Pack8 x, sa, sb, u;
      x.v = make_uint4(0, 0, 0, 0);
      if (m < m_total)
        x.v = *reinterpret_cast<const uint4*>(xcat + (size_t)m * cmax + c);
      sa.v = *reinterpret_cast<const uint4*>(a1 + c);
      sb.v = *reinterpret_cast<const uint4*>(b1 + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = __bfloat162float(x.h[e]) * __bfloat162float(sa.h[e])
                        + __bfloat162float(sb.h[e]);
        u.h[e] = __float2bfloat16(fmaxf(f, 0.0f));
      }
      *reinterpret_cast<uint4*>(as + r * A_LDA + q * 8) = u.v;
    }
    for (int v = tid; v < A_BK * (HIDDEN / 8); v += A_THREADS) {
      const int r = v / (HIDDEN / 8), q = v % (HIDDEN / 8);
      *reinterpret_cast<uint4*>(bs + r * A_LDB + q * 8) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)(k0 + r) * HIDDEN
                                          + q * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < A_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * 32 + i * 16) * A_LDA + kk,
                               A_LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * A_LDB + wn * 64 + j * 16,
                               A_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * A_LDC + wn * 64
                                  + j * 16,
                              acc[i][j], A_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int v = tid; v < A_BM * (HIDDEN / 8); v += A_THREADS) {
    const int r = v / (HIDDEN / 8), q = v % (HIDDEN / 8);
    const int m = m0 + r;
    if (m >= m_total) continue;
    Pack8 o;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o.h[e] = __float2bfloat16(
          fmaxf(cs[r * A_LDC + q * 8 + e] + b2[q * 8 + e], 0.0f));
    *reinterpret_cast<uint4*>(t + (size_t)m * HIDDEN + q * 8) = o.v;
  }
}

// ---- (b) 3x3 conv of t into the concat, in place -------------------------
constexpr int B_T = 16;                // output tile is B_T x B_T pixels
constexpr int B_H = B_T + 2;           // with its 1-pixel halo
constexpr int B_THREADS = 256;
constexpr int B_LDH = HIDDEN + 16;     // keeps every pixel row 32-B aligned
constexpr int B_LDW = GROWTH + 8;
constexpr int B_LDC = GROWTH + 4;
constexpr int B_SMEM_H = B_H * B_H * B_LDH * 2;
constexpr int B_SMEM = B_SMEM_H + 9 * HIDDEN * B_LDW * 2;
static_assert(8 * 32 * B_LDC * 4 <= B_SMEM_H, "epilogue reuses the halo");

__global__ void __launch_bounds__(B_THREADS)
conv3x3_kernel(const bf16* __restrict__ t, const bf16* __restrict__ w2,
               bf16* __restrict__ xcat, int h, int w, int cmax, int cl) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + B_SMEM_H);
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int x0 = blockIdx.x * B_T, y0 = blockIdx.y * B_T, n = blockIdx.z;

  for (int v = tid; v < B_H * B_H * (HIDDEN / 8); v += B_THREADS) {
    const int p = v / (HIDDEN / 8), q = v % (HIDDEN / 8);
    const int y = y0 - 1 + p / B_H, x = x0 - 1 + p % B_H;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (y >= 0 && y < h && x >= 0 && x < w)
      val = *reinterpret_cast<const uint4*>(
          t + (((size_t)n * h + y) * w + x) * HIDDEN + q * 8);
    *reinterpret_cast<uint4*>(hs + p * B_LDH + q * 8) = val;
  }
  // W2 arrives as (HIDDEN, 9 * GROWTH), column tap * GROWTH + o; stage it
  // as [tap][k][o].
  for (int v = tid; v < HIDDEN * 9 * (GROWTH / 8); v += B_THREADS) {
    const int k = v / (9 * GROWTH / 8), r = v % (9 * GROWTH / 8);
    const int tap = r / (GROWTH / 8), q = r % (GROWTH / 8);
    *reinterpret_cast<uint4*>(ws + (tap * HIDDEN + k) * B_LDW + q * 8) =
        *reinterpret_cast<const uint4*>(w2 + (size_t)k * 9 * GROWTH
                                        + tap * GROWTH + q * 8);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll 2
    for (int k0 = 0; k0 < HIDDEN; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], ws + (tap * HIDDEN + k0) * B_LDW
                                          + j * 16, B_LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // 16 consecutive output pixels of row 2*warp+i read halo row
        // 2*warp+i+dy from column dx on.
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(
            af, hs + ((warp * 2 + i + dy) * B_H + dx) * B_LDH + k0, B_LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // every warp is done with the halo; reuse it

  float* cw = cs + warp * 32 * B_LDC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cw + i * 16 * B_LDC + j * 16, acc[i][j], B_LDC,
                              wmma::mem_row_major);
  __syncwarp();
  const int y = y0 + warp * 2 + lane / 16, x = x0 + lane % 16;
  if (y < h && x < w) {
    const float* row = cw + lane * B_LDC;
    bf16* dst = xcat + (((size_t)n * h + y) * w + x) * cmax + cl;
#pragma unroll
    for (int q = 0; q < GROWTH / 8; ++q) {
      Pack8 o;
#pragma unroll
      for (int e = 0; e < 8; ++e) o.h[e] = __float2bfloat16(row[q * 8 + e]);
      *reinterpret_cast<uint4*>(dst + q * 8) = o.v;
    }
  }
}

}  // namespace

extern "C" int dense_block_growth() { return GROWTH; }
extern "C" int dense_block_hidden() { return HIDDEN; }

// x: (n, h, w, c0) bf16. xcat: (n, h, w, c0 + L*GROWTH) bf16 output.
// t: (n*h*w, HIDDEN) bf16 scratch. Folded operands as
// fold_dense_block_params returns them: a1, b1 (L, cmax) bf16;
// w1 (L, cmax, HIDDEN) bf16; b2 (L, HIDDEN) f32; w2 (L, HIDDEN, 9*GROWTH)
// bf16. All contiguous on the device; c0 a multiple of 32.
extern "C" int dense_block_forward(const void* x, void* xcat, void* t,
                                   const void* a1, const void* b1,
                                   const void* w1, const float* b2,
                                   const void* w2, int n, int h, int w,
                                   int c0, int num_layers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Above 48 KB of dynamic shared memory needs an opt-in, which belongs to
  // the current device; setting it on every call keeps each device right.
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, A_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               B_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cmax = c0 + num_layers * GROWTH;
  const int m_total = n * h * w;
  err = cudaMemcpy2DAsync(
      xcat, (size_t)cmax * sizeof(bf16), x, (size_t)c0 * sizeof(bf16),
      (size_t)c0 * sizeof(bf16), (size_t)m_total, cudaMemcpyDeviceToDevice,
      st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const bf16* a1p = static_cast<const bf16*>(a1);
  const bf16* b1p = static_cast<const bf16*>(b1);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  bf16* xc = static_cast<bf16*>(xcat);
  bf16* tp = static_cast<bf16*>(t);
  const dim3 grid_b((w + B_T - 1) / B_T, (h + B_T - 1) / B_T, n);
  for (int l = 0; l < num_layers; ++l) {
    const int cl = c0 + l * GROWTH;
    bottleneck_kernel<<<(m_total + A_BM - 1) / A_BM, A_THREADS, A_SMEM,
                        st>>>(xc, cmax, cl, m_total, a1p + (size_t)l * cmax,
                              b1p + (size_t)l * cmax,
                              w1p + (size_t)l * cmax * HIDDEN,
                              b2 + (size_t)l * HIDDEN, tp);
    conv3x3_kernel<<<grid_b, B_THREADS, B_SMEM, st>>>(
        tp, w2p + (size_t)l * HIDDEN * 9 * GROWTH, xc, h, w, cmax, cl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
