// Eval-mode shape stream of SAUNet, BN folded from the running statistics.
//
// Replaces saunet_tpu/ops/pallas/shape_stream.py::shape_stream_fused (body
// _shape_stream_kernel). From the packed (N, H, W, 67) bf16 input (channels
// 0:64 the resized d0 projection, 64/65/66 the three texture cues) to the
// (N, H, W, 1) f32 edge map, three stages i = 0, 1, 2 with C = 64, 32, 16
// channels entering and Cn = C / 2 leaving:
//     y   = bf16(relu(conv3x3(ss, W1') + b1))
//     ss  = bf16(relu(conv3x3(y, W2') + b2 + ss))          res block
//     ss  = bf16(ss @ Wd + bd)                             d_i
//     pre = bf16(bf16(ss * a_ss) + b_ss)
//     g   = bf16(relu(pre @ W1ss + (cue*a_cue + b_cue) * w1cue + b1g))
//     alpha = sigmoid(a2 * (g @ w2 + b2g) + bn2b)
//     ss  = bf16(bf16(ss * (alpha + 1)) @ Wg)              gate_i
// then edge = bf16(sigmoid(ss @ Wfuse)). Products accumulate in f32; the
// rounding points are the TPU kernel's. Every 3x3 conv pads with zeros.
//
// Bound: operations. 102 326 multiply-adds per pixel, 72% of them res1's two
// 64-channel convs, against 136 bytes of input and output: about 750 FLOP
// per byte, above the H100's 295 (bf16 tensor cores over HBM).
//
// Design. The TPU kernel ran all six convs on one VMEM-resident row band
// with a 6-row halo. An SM's 227 KB of shared memory holds one 64-channel
// bf16 map only over a small tile, and recomputing a 6-pixel halo at every
// stage would more than double res1's work at a 16x16 tile. So the stream
// runs as three launches, one per stage, each over 16x16-pixel output tiles
// with a 2-pixel halo, and the stage outputs (32 and 16 bf16 channels, the
// gates' rounding points) pass through device memory: 96 bytes a pixel more
// than one pass would move, far below the compute.
//
// One stage, one block per tile (512 threads at C = 64, else 256):
//   - X, the 20x20 region (tile + halo), C channels, zero outside the image.
//   - conv1 and conv2 with bf16 wmma 16x16x16 into f32. The region is
//     flattened row-major with pitch 20, so 16 consecutive output positions
//     read 16 consecutive rows of X for every tap (a tap is a constant
//     offset dy*20 + dx); positions that wrap a row are computed and never
//     read. The tap's weights (9 x C x C) sit in shared memory.
//   - conv1's output y is set to zero at positions outside the image, where
//     conv2 must see SAME padding (the bias would make it nonzero), and is
//     kept for the 18x18 positions conv2 reads. conv2 adds the residual and
//     overwrites X in place: each output reads only its own residual.
//   - the 1x1 tail (d_i, gate_i, and fuse + sigmoid in the last stage) on
//     CUDA cores, one thread per tile pixel, weights in shared memory as f32.
// Stage 0's 64-channel block takes 224 KB of shared memory: one block per
// SM. wgmma/TMA pipelines and a fused single pass are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <cstring>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int PACKED = 67;   // input channels per pixel
constexpr int CUE = 64;      // channel of stage 0's cue; stage i reads CUE + i
constexpr int FUSE_IN = 8;   // channels entering fuse
constexpr int NUM_OPS = 18;  // operands per stage, in the wrapper's order
constexpr int T = 16;        // output tile T x T pixels
constexpr int P = T + 4;     // the region's pitch: tile plus a 2-pixel halo
constexpr int PIXELS = T * T;  // the tail runs one thread per tile pixel

// A warp's unit of conv work is MT row tiles of 16 positions times C / NG
// output channels: 8 row groups for conv1, 7 for conv2, so one round of the
// block's warps (8, or 16 on two column groups at C = 64).
constexpr int MT = 3;

// conv1 computes y at flat region positions [Q1, Q1 + M1), every position
// whose 3x3 window lies in the region; conv2 at [Q2, Q2 + M2), those whose
// window lies in conv1's output. Both are padded to whole units; the
// padding rows compute garbage that is never read.
constexpr int round_unit(int v) {
  return (v + 16 * MT - 1) / (16 * MT) * 16 * MT;
}
constexpr int Q1 = P + 1;
constexpr int M1 = round_unit((P - 2) * P + (P - 2) - Q1 + 1);
constexpr int Q2 = 2 * P + 2;
constexpr int M2 = round_unit((P - 3) * P + (P - 3) - Q2 + 1);
constexpr int X_ROWS = Q1 + M1 + P + 1;  // the last row conv1 reads, plus 1
constexpr int Y_ROWS = M1;               // y is stored from row Q1 on
static_assert(Q2 - P - 1 >= Q1 && Q2 + M2 + P + 1 <= Q1 + M1,
              "conv2 reads only positions conv1 computed");
static_assert(Q2 + M2 <= X_ROWS, "conv2 writes inside X");

struct Stage {  // the layout of NUM_OPS pointers the wrapper passes
  const bf16* r_w1;
  const float* r_b1;
  const bf16* r_w2;
  const float* r_b2;
  const bf16* d_w;
  const float* d_b;
  const bf16* g_a_ss;
  const bf16* g_b_ss;
  const float* g_a_cue;
  const float* g_b_cue;
  const bf16* g_w1_ss;
  const float* g_w1_cue;
  const float* g_b1;
  const bf16* g_w2;
  const float* g_b2;
  const float* g_a2;
  const float* g_bn2b;
  const bf16* g_wg;
};
static_assert(sizeof(Stage) == NUM_OPS * sizeof(void*), "pointer layout");

union Pack8 {
  uint4 v;
  bf16 h[8];
};

union Pack2 {
  uint32_t v;
  bf16 h[2];
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

constexpr int round4(int v) { return (v + 3) / 4 * 4; }

template <int C>
struct Cfg {
  static constexpr int CN = C / 2;
  static constexpr int G = CN + 1;     // the gate's hidden channels
  static constexpr int GP = round4(G);  // padded to whole float4s
  // X and y rows are 32-byte multiples: a wmma tile may start at any row
  // (two-way bank conflicts on their ldmatrix, the least at that pitch).
  static constexpr int LDX = C == 64 ? 80 : C == 32 ? 48 : 16;
  static constexpr int LDW = C + 8;  // weight rows, conflict-free ldmatrix
  // Stage 0 fits one block per SM, so it runs 16 warps, each on half the
  // channels of a unit, to hide more latency; the smaller stages run 8
  // warps and fit more blocks per SM.
  static constexpr int THREADS = C == 64 ? 512 : 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int BLOCKS = C == 64 ? 1 : C == 32 ? 2 : 4;  // per SM
  static constexpr int NG = C == 64 ? 2 : 1;  // column groups of a unit
  static constexpr int NT = C / 16 / NG;      // 16-channel column tiles
  static constexpr int X_BYTES = align128(X_ROWS * LDX * 2);
  static constexpr int Y_BYTES = align128(Y_ROWS * LDX * 2);
  static constexpr int W_BYTES = align128(9 * C * LDW * 2);
  static constexpr int S_BYTES = WARPS * 256 * 4;  // a 16x16 f32 per warp
  static constexpr int SMEM = X_BYTES + Y_BYTES + W_BYTES + S_BYTES;
  // the tail's f32 operands, stored over the conv weights once both convs
  // are done, every array and row on a float4 boundary
  static constexpr int TAIL_FLOATS = C * CN + 3 * CN + CN * GP + 3 * GP
                                     + CN * CN + FUSE_IN + 8;
  static_assert(TAIL_FLOATS * 4 <= W_BYTES, "tail operands fit");
  static_assert(SMEM <= 232448, "one block's shared memory");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "an SM's shared memory");
};

// Copy the (9*C, C) bf16 conv weights into shared rows of LDW.
template <int C>
__device__ __forceinline__ void load_weights(bf16* ws,
                                             const bf16* __restrict__ wg) {
  constexpr int LDW = Cfg<C>::LDW;
  for (int v = threadIdx.x; v < 9 * C * (C / 8); v += Cfg<C>::THREADS) {
    const int row = v / (C / 8), q = v % (C / 8);
    *reinterpret_cast<uint4*>(ws + row * LDW + q * 8) =
        *reinterpret_cast<const uint4*>(wg + (size_t)row * C + q * 8);
  }
}

// One 3x3 conv over flat region positions [q0, q0 + m) from src (row q of
// the region at src row q - src_row0) with the weights in ws.
//   SECOND = false: dst[q] = bf16(relu(conv + bias)), zero outside the image.
//   SECOND = true:  dst[q] = bf16(relu(conv + bias + dst[q])), the residual
//                   read and overwritten in place.
template <int C, bool SECOND>
__device__ __forceinline__ void conv3x3(const bf16* src, int src_row0,
                                        const bf16* ws,
                                        const float* __restrict__ bias,
                                        bf16* dst, int dst_row0, int q0,
                                        int m, float* stage, int y0, int x0,
                                        int h, int w) {
  using K = Cfg<C>;
  constexpr int NT = K::NT, LDX = K::LDX, LDW = K::LDW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = stage + warp * 256;
  for (int u = warp; u < m / (16 * MT) * K::NG; u += K::WARPS) {
    const int qb = q0 + u / K::NG * 16 * MT;
    const int nb = u % K::NG * NT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][NT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3 - 1) * P + (tap % 3 - 1);
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            af[MT];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            bfr[NT];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          wmma::load_matrix_sync(
              af[i], src + (qb + i * 16 + off - src_row0) * LDX + k0, LDX);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          wmma::load_matrix_sync(
              bfr[j], ws + (tap * C + k0) * LDW + (nb + j) * 16, LDW);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
    }
    // epilogue through the warp's 16x16 staging tile: lane -> 8 channels of
    // one position
    const int row = lane / 2, col = lane % 2 * 8;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wmma::store_matrix_sync(sw, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int q = qb + i * 16 + row;
        const int o = (nb + j) * 16 + col;
        bf16* out = dst + (q - dst_row0) * LDX + o;
        Pack8 r;
        if (SECOND) {
          r.v = *reinterpret_cast<const uint4*>(out);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            r.h[e] = __float2bfloat16(fmaxf(
                sw[row * 16 + col + e] + bias[o + e]
                    + __bfloat162float(r.h[e]),
                0.0f));
        } else {
          const int gy = y0 - 2 + q / P, gx = x0 - 2 + q % P;
          const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            r.h[e] = __float2bfloat16(
                inside ? fmaxf(sw[row * 16 + col + e] + bias[o + e], 0.0f)
                       : 0.0f);
        }
        *reinterpret_cast<uint4*>(out) = r.v;
        __syncwarp();
      }
  }
}

// dst[r * ld + c] = src[r * cols + c] as f32 for c < cols, 0 for the padding
// columns up to ld.
template <typename S>
__device__ __forceinline__ void copy_f32(float* dst,
                                         const S* __restrict__ src, int rows,
                                         int cols, int ld) {
  for (int v = threadIdx.x; v < rows * ld; v += blockDim.x) {
    const int r = v / ld, c = v % ld;
    float val = 0.0f;
    if (c < cols) {
      if constexpr (sizeof(S) == 2)
        val = __bfloat162float(src[r * cols + c]);
      else
        val = src[r * cols + c];
    }
    dst[v] = val;
  }
}

// acc[0..N) += a * w[0..N), w on a float4 boundary in shared memory
template <int N>
__device__ __forceinline__ void axpy(float* acc, float a, const float* w) {
  static_assert(N % 4 == 0, "whole float4s");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(w)[q];
    acc[4 * q] += a * v.x;
    acc[4 * q + 1] += a * v.y;
    acc[4 * q + 2] += a * v.z;
    acc[4 * q + 3] += a * v.w;
  }
}

// One stage over one 16x16 tile. FIRST reads the packed input (67 channels
// a pixel); the others read the previous stage's C-channel output. LAST
// ends in fuse and the sigmoid and writes the edge map; the others write
// their Cn-channel output to `next`.
template <int C, bool FIRST, bool LAST>
__global__ void __launch_bounds__(Cfg<C>::THREADS, Cfg<C>::BLOCKS)
stage_kernel(const bf16* __restrict__ in, const bf16* __restrict__ packed,
             const Stage st, int cue_ch, const bf16* __restrict__ fuse_w,
             bf16* __restrict__ next, float* __restrict__ edge, int h, int w,
             bool pairs) {
  using K = Cfg<C>;
  constexpr int CN = K::CN, GP = K::GP, LDX = K::LDX, THREADS = K::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ys = reinterpret_cast<bf16*>(smem + K::X_BYTES);
  bf16* ws = reinterpret_cast<bf16*>(smem + K::X_BYTES + K::Y_BYTES);
  float* stage = reinterpret_cast<float*>(smem + K::X_BYTES + K::Y_BYTES
                                          + K::W_BYTES);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * T, y0 = blockIdx.y * T, n = blockIdx.z;

  // X: the region's C channels, zero outside the image and past the region
  if (FIRST && pairs) {
    // Two horizontally adjacent pixels (gx even) are 67 aligned 32-bit
    // words; with x0 and w even both lie inside the image or both outside.
    for (int v = tid; v < P * (P / 2) * PACKED; v += THREADS) {
      const int j = v % PACKED, pair = v / PACKED;
      const int r = pair / (P / 2), c = pair % (P / 2) * 2;
      const int gy = y0 - 2 + r, gx = x0 - 2 + c;
      Pack2 word;
      word.v = 0;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        word.v = reinterpret_cast<const uint32_t*>(
            in + (((size_t)n * h + gy) * w + gx) * PACKED)[j];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int px = (2 * j + e) / PACKED, ch = (2 * j + e) % PACKED;
        if (ch < C) xs[(r * P + c + px) * LDX + ch] = word.h[e];
      }
    }
  } else if (FIRST) {
    for (int v = tid; v < P * P * C; v += THREADS) {
      const int p = v / C, ch = v % C;
      const int gy = y0 - 2 + p / P, gx = x0 - 2 + p % P;
      bf16 val = __float2bfloat16(0.0f);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        val = in[(((size_t)n * h + gy) * w + gx) * PACKED + ch];
      xs[p * LDX + ch] = val;
    }
  } else {
    for (int v = tid; v < P * P * (C / 8); v += THREADS) {
      const int p = v / (C / 8), q = v % (C / 8);
      const int gy = y0 - 2 + p / P, gx = x0 - 2 + p % P;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        val = *reinterpret_cast<const uint4*>(
            in + (((size_t)n * h + gy) * w + gx) * C + q * 8);
      *reinterpret_cast<uint4*>(xs + p * LDX + q * 8) = val;
    }
  }
  for (int v = tid; v < (X_ROWS - P * P) * (LDX / 8); v += THREADS)
    *reinterpret_cast<uint4*>(xs + P * P * LDX + v * 8) =
        make_uint4(0, 0, 0, 0);
  load_weights<C>(ws, st.r_w1);
  __syncthreads();

  conv3x3<C, false>(xs, 0, ws, st.r_b1, ys, Q1, Q1, M1, stage, y0, x0, h, w);
  __syncthreads();
  load_weights<C>(ws, st.r_w2);
  __syncthreads();
  conv3x3<C, true>(ys, Q1, ws, st.r_b2, xs, 0, Q2, M2, stage, y0, x0, h, w);
  __syncthreads();

  // the tail's operands, as f32 over the conv weights, the gate's hidden
  // width padded with zeros to GP
  float* t_dw = reinterpret_cast<float*>(ws);  // (C, CN)
  float* t_db = t_dw + C * CN;
  float* t_ass = t_db + CN;
  float* t_bss = t_ass + CN;
  float* t_w1 = t_bss + CN;                    // (CN, GP)
  float* t_w1c = t_w1 + CN * GP;
  float* t_b1 = t_w1c + GP;
  float* t_w2 = t_b1 + GP;
  float* t_wg = t_w2 + GP;                     // (CN, CN)
  float* t_fuse = t_wg + CN * CN;
  float* t_sc = t_fuse + FUSE_IN;              // a_cue, b_cue, b2, a2, bn2b
  copy_f32(t_dw, st.d_w, C, CN, CN);
  copy_f32(t_db, st.d_b, 1, CN, CN);
  copy_f32(t_ass, st.g_a_ss, 1, CN, CN);
  copy_f32(t_bss, st.g_b_ss, 1, CN, CN);
  copy_f32(t_w1, st.g_w1_ss, CN, K::G, GP);
  copy_f32(t_w1c, st.g_w1_cue, 1, K::G, GP);
  copy_f32(t_b1, st.g_b1, 1, K::G, GP);
  copy_f32(t_w2, st.g_w2, 1, K::G, GP);
  copy_f32(t_wg, st.g_wg, CN, CN, CN);
  if (LAST) copy_f32(t_fuse, fuse_w, 1, FUSE_IN, FUSE_IN);
  if (tid == 0) {
    t_sc[0] = *st.g_a_cue;
    t_sc[1] = *st.g_b_cue;
    t_sc[2] = *st.g_b2;
    t_sc[3] = *st.g_a2;
    t_sc[4] = *st.g_bn2b;
  }
  __syncthreads();

  const int gy = y0 + tid / T, gx = x0 + tid % T;
  if (tid >= PIXELS || gy >= h || gx >= w) return;
  const size_t pix = ((size_t)n * h + gy) * w + gx;
  const bf16* xr = xs + ((tid / T + 2) * P + tid % T + 2) * LDX;
  float s[C];
#pragma unroll
  for (int q = 0; q < C / 8; ++q) {
    Pack8 r;
    r.v = *reinterpret_cast<const uint4*>(xr + q * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) s[q * 8 + e] = __bfloat162float(r.h[e]);
  }
  // d_i
  float d[CN];
#pragma unroll
  for (int o = 0; o < CN; ++o) d[o] = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k) axpy<CN>(d, s[k], t_dw + k * CN);
#pragma unroll
  for (int o = 0; o < CN; ++o) d[o] = bf16r(d[o] + t_db[o]);
  // gate_i; the padded hidden channels stay 0 and have w2 = 0
  const float cue = __bfloat162float(packed[pix * PACKED + CUE + cue_ch]);
  const float cuep = cue * t_sc[0] + t_sc[1];
  float g[GP];
#pragma unroll
  for (int j = 0; j < GP; ++j) g[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < CN; ++k)
    axpy<GP>(g, bf16r(bf16r(d[k] * t_ass[k]) + t_bss[k]), t_w1 + k * GP);
  float g2 = 0.0f;
#pragma unroll
  for (int j = 0; j < GP; ++j)
    g2 += bf16r(fmaxf(g[j] + cuep * t_w1c[j] + t_b1[j], 0.0f)) * t_w2[j];
  const float alpha = sigmoid(t_sc[3] * (g2 + t_sc[2]) + t_sc[4]);
  float o[CN];
#pragma unroll
  for (int j = 0; j < CN; ++j) o[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < CN; ++k)
    axpy<CN>(o, bf16r(d[k] * (alpha + 1.0f)), t_wg + k * CN);
  if (LAST) {
    static_assert(!LAST || CN == FUSE_IN, "fuse takes the last stage");
    float e = 0.0f;
#pragma unroll
    for (int k = 0; k < CN; ++k) e += bf16r(o[k]) * t_fuse[k];
    edge[pix] = bf16r(sigmoid(e));
  } else {
#pragma unroll
    for (int q = 0; q < CN / 8; ++q) {
      Pack8 r;
#pragma unroll
      for (int e = 0; e < 8; ++e) r.h[e] = __float2bfloat16(o[q * 8 + e]);
      *reinterpret_cast<uint4*>(next + pix * CN + q * 8) = r.v;
    }
  }
}

template <int C, bool FIRST, bool LAST>
cudaError_t launch(dim3 grid, cudaStream_t st, const bf16* in,
                   const bf16* packed, const Stage& s, int cue_ch,
                   const bf16* fuse_w, bf16* next, float* edge, int h,
                   int w, bool pairs) {
  auto* kernel = stage_kernel<C, FIRST, LAST>;
  // Above 48 KB of dynamic shared memory needs an opt-in, which belongs to
  // the current device; setting it on every call keeps each device right.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<C>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, Cfg<C>::THREADS, Cfg<C>::SMEM, st>>>(
      in, packed, s, cue_ch, fuse_w, next, edge, h, w, pairs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int shape_stream_operands() { return NUM_OPS; }

// packed: (n, h, w, 67) bf16. ss1: (n, h, w, 32) and ss2: (n, h, w, 16) bf16
// scratch. edge: (n, h, w) f32 output. ops: 3 * NUM_OPS stage operand
// pointers in Stage's order, then fuse_w (8,) bf16; all contiguous on the
// device, shapes as fold_shape_stream_params makes them.
extern "C" int shape_stream_forward(const void* packed, void* ss1, void* ss2,
                                    float* edge, const void* const* ops,
                                    int n, int h, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Stage s[3];
  for (int i = 0; i < 3; ++i)
    std::memcpy(&s[i], ops + i * NUM_OPS, sizeof(Stage));
  const bf16* fuse_w = static_cast<const bf16*>(ops[3 * NUM_OPS]);
  const bf16* x = static_cast<const bf16*>(packed);
  bf16* a = static_cast<bf16*>(ss1);
  bf16* b = static_cast<bf16*>(ss2);
  const dim3 grid((w + T - 1) / T, (h + T - 1) / T, n);
  // stage 0 reads pixel pairs as 32-bit words where they are aligned
  const bool pairs = w % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  cudaError_t err = launch<64, true, false>(grid, st, x, x, s[0], 0, nullptr,
                                            a, nullptr, h, w, pairs);
  if (err == cudaSuccess)
    err = launch<32, false, false>(grid, st, a, x, s[1], 1, nullptr, b,
                                   nullptr, h, w, false);
  if (err == cudaSuccess)
    err = launch<16, false, true>(grid, st, b, x, s[2], 2, fuse_w, nullptr,
                                  edge, h, w, false);
  return static_cast<int>(err);
}
