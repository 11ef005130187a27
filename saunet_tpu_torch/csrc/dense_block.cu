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
// Bound on this card: operations in principle (2 x (C_l*128 + 9*128*32)
// multiply-adds a pixel and layer; the four DenseNet-121 blocks at b64 and
// 224^2 are 1.25 ms at the bf16 tensor-core peak), but the TPU kernel kept
// one image's whole concat in VMEM, and a block-1 concat (112^2 x 256 bf16,
// 6.4 MB an image) does not fit in shared memory. So the concat stays in
// device memory and each layer re-reads its live prefix, about 4.6 GB per
// infer step (1.4 ms at 3.35 TB/s): the kernel is held by that stream and
// by how well the products hide it.
//
// Design: ONE launch per layer, the bottleneck fused into the 3x3 conv, so
// t never reaches device memory. A persistent grid (one 8-warp block per SM,
// about 189 KB of shared memory) walks over 14x14-pixel output tiles:
//   (a) bottleneck on the tile and its 1-pixel halo, 16x16 = 256 rows
//       (exactly 16 mma row tiles): the live prefix streams in 32-channel
//       K-chunks through two shared-memory stages. The next chunk's global
//       loads are in flight in registers while the tensor cores work on
//       this one; norm1's affine and the ReLU (in f32) and the bf16
//       rounding of u are applied as the chunk is stored, and W1's chunk
//       comes by cp.async. 8 warps of 64 rows x 64 hidden
//       channels, mma.sync m16n8k16 bf16 with f32 accumulators fed by
//       ldmatrix. The epilogue adds b2, applies the ReLU, zeroes halo
//       pixels outside the image (conv2's zero padding) and rounds t to
//       bf16 into shared memory: 256 x 128 bf16.
//   (b) 3x3 conv from that t: output row r of the tile is one 16-row mma
//       tile whose tap (dy, dx) reads t rows (r+dy)*16 + dx + i, the halo
//       flattened with pitch 16 (columns 14 and 15 of a row are computed
//       and dropped). W2 (9 taps x 32 x 128 bf16, 72 KB) is loaded once per
//       block and layer by cp.async and stays resident across tiles. 7 warps
//       of two output rows x 32 channels; the result is rounded and written
//       at channel offset C_l of x_cat.
// Shared-memory rows are 16-byte chunks XOR-swizzled by row, so every
// ldmatrix and every epilogue store is free of bank conflicts. W1 and W2
// arrive re-laid out once per model (ops/cuda/dense_block.py::
// kernel_layout): W1 as (HIDDEN, Cmax) and W2 as (9, GROWTH, HIDDEN), K
// contiguous, which is what ldmatrix reads as mma's B. The input is copied
// once into channels [0, C0) of x_cat.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int GROWTH = 32;
constexpr int HIDDEN = 128;
constexpr int THREADS = 256;
constexpr int TILE = 14;                   // output tile is TILE x TILE
constexpr int PITCH = TILE + 2;            // halo row, 16 pixels
constexpr int ROWS = PITCH * PITCH;        // bottleneck rows, 256
constexpr int T_ROWS = ROWS + 2;           // conv reads up to row 257
constexpr int KC = 32;                     // K-chunk, channels
constexpr int CONV_WARPS = TILE / 2;       // two output rows each

// shared memory, bytes
constexpr int T_BYTES = T_ROWS * HIDDEN * 2;          // t, 256 B a row
constexpr int W2_BYTES = 9 * GROWTH * HIDDEN * 2;     // W2, 256 B a row
constexpr int A_BYTES = ROWS * KC * 2;                // one A stage, 64 B
constexpr int W1_BYTES = HIDDEN * KC * 2;             // one W1 stage, 64 B
constexpr int OFF_W2 = T_BYTES;
constexpr int OFF_A = OFF_W2 + W2_BYTES;
constexpr int OFF_W1 = OFF_A + 2 * A_BYTES;
constexpr int OFF_AB = OFF_W1 + 2 * W1_BYTES;         // a1, b1 of layer
constexpr int SMEM_BASE = OFF_AB;                     // + 4 * C_l bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a 256-byte-row buffer (t, W2)
__device__ __forceinline__ int off256(int r, int c) {
  return r * 256 + ((c ^ (r & 7)) << 4);
}

// ... and in a 64-byte-row buffer (the A and W1 stages)
__device__ __forceinline__ int off64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// u = bf16(relu(x * a + b)) on 8 channels, in f32 and rounded once to
// bf16. The product of two bf16 values is exact in f32, so the fma gives
// the plain version's multiply-then-add bit for bit.
__device__ __forceinline__ uint4 affine_relu(uint4 x, uint4 a, uint4 b) {
  const bf162* xv = reinterpret_cast<const bf162*>(&x);
  const bf162* av = reinterpret_cast<const bf162*>(&a);
  const bf162* bv = reinterpret_cast<const bf162*>(&b);
  uint4 u;
  uint32_t* uv = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 xf = __bfloat1622float2(xv[e]);
    const float2 af = __bfloat1622float2(av[e]);
    const float2 bf = __bfloat1622float2(bv[e]);
    uv[e] = pack_bf16(fmaxf(__fmaf_rn(xf.x, af.x, bf.x), 0.0f),
                      fmaxf(__fmaf_rn(xf.y, af.y, bf.y), 0.0f));
  }
  return u;
}

struct Layer {
  const bf16* a1;   // (cmax) row of this layer
  const bf16* b1;
  const bf16* w1t;  // (HIDDEN, cmax)
  const float* b2;  // (HIDDEN)
  const bf16* w2t;  // (9, GROWTH, HIDDEN)
  bf16* xcat;       // (n, h, w, cmax)
  int n, h, w, cmax, cl, tiles_x, tiles_y;
};

__global__ void __launch_bounds__(THREADS, 1)
dense_layer_kernel(const Layer L) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* t_s = smem;
  unsigned char* w2_s = smem + OFF_W2;
  unsigned char* a_s = smem + OFF_A;
  unsigned char* w1_s = smem + OFF_W1;
  bf16* ab_s = reinterpret_cast<bf16*>(smem + OFF_AB);  // a1 | b1

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row, column pair
  const int cmax = L.cmax, cl = L.cl, h = L.h, w = L.w;
  const int nk = cl / KC;

  // once per block: W2 and the layer's a1/b1 by cp.async; t's two spare
  // rows (read only for dropped columns) zeroed
  for (int v = tid; v < 9 * GROWTH * (HIDDEN / 8); v += THREADS) {
    const int r = v >> 4, c = v & 15;
    cp_async16(smem_addr(w2_s + off256(r, c)), L.w2t + r * HIDDEN + c * 8);
  }
  for (int v = tid; v < cl / 8; v += THREADS) {
    cp_async16(smem_addr(ab_s + v * 8), L.a1 + v * 8);
    cp_async16(smem_addr(ab_s + cl + v * 8), L.b1 + v * 8);
  }
  cp_async_commit();
  for (int v = tid; v < 2 * 16; v += THREADS)
    *reinterpret_cast<uint4*>(t_s + (ROWS + v / 16) * 256 + (v % 16) * 16) =
        make_uint4(0, 0, 0, 0);

  // bottleneck warp tile: rows wm*64 .. +63, hidden channels wn*64 .. +63
  const int wm = warp >> 1, wn = warp & 1;
  // A staging: this thread's 8 channels q*8 .. +7 of rows tid/4 + 64 i
  const int q = tid & 3;
  const int tiles_img = L.tiles_x * L.tiles_y;
  const int tiles = L.n * tiles_img;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int img = tile / tiles_img;
    const int rem = tile - img * tiles_img;
    const int ty = rem / L.tiles_x;
    const int oy = ty * TILE, ox = (rem - ty * L.tiles_x) * TILE;
    const bf16* src[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 2) + 64 * i;
      const int y = oy - 1 + r / PITCH, x = ox - 1 + r % PITCH;
      src[i] = (y >= 0 && y < h && x >= 0 && x < w)
                   ? L.xcat + ((size_t)(img * h + y) * w + x) * cmax + q * 8
                   : nullptr;
    }
    uint4 ax[4];
    auto load_a = [&](int k0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ax[i] = src[i] ? *reinterpret_cast<const uint4*>(src[i] + k0)
                       : make_uint4(0, 0, 0, 0);
    };
    auto store_a = [&](int k0, int s) {
      const uint4 a = *reinterpret_cast<const uint4*>(ab_s + k0 + q * 8);
      const uint4 b = *reinterpret_cast<const uint4*>(ab_s + cl + k0 + q * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint4*>(a_s + s * A_BYTES
                                  + off64((tid >> 2) + 64 * i, q)) =
            affine_relu(ax[i], a, b);
    };
    auto load_w1 = [&](int k0, int s) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int v = tid + THREADS * j, r = v >> 2, c = v & 3;
        cp_async16(smem_addr(w1_s + s * W1_BYTES + off64(r, c)),
                   L.w1t + (size_t)r * cmax + k0 + c * 8);
      }
      cp_async_commit();
    };

    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    load_a(0);
    load_w1(0, 0);
    cp_async_wait_all();  // also W2 and a1/b1 on the first tile
    __syncthreads();      // a1/b1 visible; the previous conv is done with t
    store_a(0, 0);
    __syncthreads();

    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc & 1;
      const bool more = kc + 1 < nk;
      if (more) {  // next chunk in flight while this one is multiplied
        load_a((kc + 1) * KC);
        load_w1((kc + 1) * KC, s ^ 1);
      }
      const unsigned char* as = a_s + s * A_BYTES;
      const unsigned char* ws = w1_s + s * W1_BYTES;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t af[4][4], bfr[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wm * 64 + i * 16 + (lane & 15);
          ldmatrix_x4(smem_addr(as + off64(r, kk * 2 + (lane >> 4))), af[i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = wn * 64 + j * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(smem_addr(ws + off64(r, kk * 2 + ((lane >> 3) & 1))),
                      bfr[j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_bf16(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
            mma_bf16(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
          }
      }
      if (more) {
        store_a((kc + 1) * KC, s ^ 1);
        cp_async_wait_all();
      }
      __syncthreads();
    }

    // t = bf16(relu(acc + b2)), zero at halo pixels outside the image
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = wn * 64 + j * 8 + tq * 2;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(L.b2 + col));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = wm * 64 + i * 16 + g + hf * 8;
          const int y = oy - 1 + r / PITCH, x = ox - 1 + r % PITCH;
          const bool in = y >= 0 && y < h && x >= 0 && x < w;
          const float v0 = in ? fmaxf(acc[i][j][2 * hf] + bias.x, 0.0f) : 0.f;
          const float v1 =
              in ? fmaxf(acc[i][j][2 * hf + 1] + bias.y, 0.0f) : 0.f;
          *reinterpret_cast<uint32_t*>(t_s + off256(r, col >> 3)
                                       + (col & 7) * 2) = pack_bf16(v0, v1);
        }
    }
    __syncthreads();

    // 3x3 conv: warp w < 7 owns output rows 2w, 2w+1 and all 32 channels
    if (warp < CONV_WARPS) {
      float c2[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c2[i][j][e] = 0.0f;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - dy * 3;
#pragma unroll 4
        for (int kk = 0; kk < HIDDEN / 16; ++kk) {
          uint32_t af[2][4], bfr[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = (warp * 2 + i + dy) * PITCH + dx + (lane & 15);
            ldmatrix_x4(smem_addr(t_s + off256(r, kk * 2 + (lane >> 4))),
                        af[i]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r =
                tap * GROWTH + j * 16 + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(
                smem_addr(w2_s + off256(r, kk * 2 + ((lane >> 3) & 1))),
                bfr[j]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mma_bf16(c2[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
              mma_bf16(c2[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
            }
        }
      }
      // new channels, rounded, at offset cl of x_cat
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int y = oy + warp * 2 + i;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = g + hf * 8, x = ox + c;
          if (c >= TILE || y >= h || x >= w) continue;
          bf16* dst = L.xcat + ((size_t)(img * h + y) * w + x) * cmax + cl;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<uint32_t*>(dst + j * 8 + tq * 2) =
                pack_bf16(c2[i][j][2 * hf], c2[i][j][2 * hf + 1]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int dense_block_growth() { return GROWTH; }
extern "C" int dense_block_hidden() { return HIDDEN; }

// x: (n, h, w, c0) bf16. xcat: (n, h, w, c0 + L*GROWTH) bf16 output.
// Operands: a1, b1 (L, cmax) bf16 and b2 (L, HIDDEN) f32 as
// fold_dense_block_params returns them; w1t (L, HIDDEN, cmax) and w2t
// (L, 9, GROWTH, HIDDEN) bf16 as kernel_layout lays them out. All
// contiguous on the device; c0 a multiple of 32; n, h, w > 0.
extern "C" int dense_block_forward(const void* x, void* xcat, const void* a1,
                                   const void* b1, const void* w1t,
                                   const float* b2, const void* w2t, int n,
                                   int h, int w, int c0, int num_layers,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cmax = c0 + num_layers * GROWTH;
  const int smem_max = SMEM_BASE + 4 * (cmax - GROWTH);
  // Above 48 KB of dynamic shared memory needs an opt-in, which belongs to
  // the current device; setting it on every call keeps each device right.
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_max);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t m_total = (size_t)n * h * w;
  err = cudaMemcpy2DAsync(xcat, (size_t)cmax * sizeof(bf16), x,
                          (size_t)c0 * sizeof(bf16), (size_t)c0 * sizeof(bf16),
                          m_total, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  Layer L;
  L.xcat = static_cast<bf16*>(xcat);
  L.n = n, L.h = h, L.w = w, L.cmax = cmax;
  L.tiles_x = (w + TILE - 1) / TILE;
  L.tiles_y = (h + TILE - 1) / TILE;
  const long long tiles = (long long)n * L.tiles_x * L.tiles_y;
  const int grid = (int)(tiles < sms ? tiles : sms);
  for (int l = 0; l < num_layers; ++l) {
    L.cl = c0 + l * GROWTH;
    L.a1 = static_cast<const bf16*>(a1) + (size_t)l * cmax;
    L.b1 = static_cast<const bf16*>(b1) + (size_t)l * cmax;
    L.w1t = static_cast<const bf16*>(w1t) + (size_t)l * HIDDEN * cmax;
    L.b2 = b2 + (size_t)l * HIDDEN;
    L.w2t = static_cast<const bf16*>(w2t) + (size_t)l * 9 * GROWTH * HIDDEN;
    dense_layer_kernel<<<grid, THREADS, SMEM_BASE + 4 * L.cl, st>>>(L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
