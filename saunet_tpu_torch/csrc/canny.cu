// Canny-style edge map, one CUDA kernel for every image size.
//
// Replaces saunet_tpu/ops/pallas/canny.py::canny_edges_pallas (whole image
// in VMEM) and ::canny_edges_pallas_tiled (halo'd row bands above 220 000
// pixels). Both compute _canny_math: Sobel 3x3 with zero boundary and L1
// magnitude, 4-bin non-maximum suppression, double threshold, then ITERS
// rounds of 8-neighbour hysteresis clipped to the weak pixels, x255.
//
// Bound on this card: bytes. The operator reads one f32 and writes one f32
// per pixel, 8 bytes: 0.0077 ms at (64, 224, 224) and 3.35 TB/s; its ~124
// operations a pixel take less at the f32 rate. The first port (32x32
// tiles, byte planes, a block barrier per hysteresis round) ran at about 53x
// that bound: it staged 2.64x the tile in gray pixels, ran hysteresis over
// 2.25x, and chained 11 barriers in each of 3 136 small blocks, so latency,
// not bytes, set its pace.
//
// Design. A block owns a band of ROWS output rows (64, or 32 when the
// window is wider than 256 columns) across a window of up to 16 32-bit
// words of columns (512 columns; a wider image takes several windows, each
// with one word of halo on either side). Four phases, three barriers:
//   1. Sobel, L1 magnitude and direction bin for the band plus 9 rows on
//      either side: a thread takes four columns down 8 rows, each gray row
//      loaded once into registers by a 16-byte load (scalar loads only for
//      the two side columns and at the image edge). Into shared memory:
//      magnitude f32, direction a byte. Both are 0 outside the image,
//      where _canny_math zero-fills its derived planes.
//   2. Non-maximum suppression and the two thresholds for the band plus 8
//      rows on either side, one pixel a lane: __ballot_sync packs 32
//      columns of `weak` and of `strong` into one word each.
//   3. Hysteresis on the bit words. Each of ROWS / 16 warps owns 16 output
//      rows and holds a 32-row window (8 rows of halo on either side), one
//      row a lane, all of the row's words in registers. A round is an OR of
//      the rows above and below (__shfl_up/down_sync), of the +-1-bit
//      shifts carried across neighbouring words, an AND with `weak` and an
//      OR into `strong`: warp-synchronous, no block barrier. Rows past the
//      window read as 0; the error moves one row a round and stays in the
//      8-row halo. Boolean rounds are exact by construction.
//   4. 0 / 255 stored as float4 from the bits.
//
// Numerics: built with -fmad=false and written in _canny_math's order of
// operations, so the threshold comparisons match the plain PyTorch version
// (saunet_tpu_torch/ops/edge.py::canny_edges) bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ITERS = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WORDS = 16;  // a window's columns, 32 a word
constexpr int OUT_WORDS = 14;  // output words of a window in a wide image
constexpr int OUT_ROWS = 16;   // output rows of one hysteresis warp
constexpr int SLIDE = 8;       // magnitude rows a thread computes in a run
static_assert(OUT_ROWS + 2 * ITERS == 32, "a warp's window is 32 rows");

struct Geom {
  int rows;   // output rows of a band
  int nwin;   // words of the window
  int mw;     // magnitude plane width: the window plus 4 columns a side
  int mr;     // magnitude plane rows: the band plus 9 a side
  int br;     // bit plane rows: the band plus 8 a side
};

__host__ __device__ inline Geom geom(int rows, int nwin) {
  return {rows, nwin, 32 * nwin + 8, rows + 18, rows + 16};
}

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

// shared memory: mag (f32), dir (bytes), strong and weak bits, output bits
__host__ __device__ inline size_t smem_bytes(const Geom& g) {
  return align16(4 * g.mr * g.mw) + align16(g.mr * g.mw)
         + 4 * (2 * g.br + g.rows) * MAX_WORDS;
}

// gray at columns x-1 .. x+4 of row y, 0 outside the image; x is a
// multiple of 4, so the middle four are one 16-byte load where `vec`.
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         int y, int x, int h, int w,
                                         bool vec, float (&v)[6]) {
  if (y < 0 || y >= h) {
#pragma unroll
    for (int e = 0; e < 6; ++e) v[e] = 0.0f;
    return;
  }
  const float* row = src + (size_t)y * w;
  v[0] = x - 1 >= 0 && x - 1 < w ? __ldg(row + x - 1) : 0.0f;
  v[5] = x + 4 >= 0 && x + 4 < w ? __ldg(row + x + 4) : 0.0f;
  if (vec && x >= 0 && x + 4 <= w) {
    const float4 c = __ldg(reinterpret_cast<const float4*>(row + x));
    v[1] = c.x;
    v[2] = c.y;
    v[3] = c.z;
    v[4] = c.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[1 + e] = x + e >= 0 && x + e < w ? __ldg(row + x + e) : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
canny_kernel(const float* __restrict__ gray, float* __restrict__ out,
             int h, int w, float low, float high, int rows, int nwin,
             bool wide, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = geom(rows, nwin);
  float* mag = reinterpret_cast<float*>(smem);
  unsigned char* dir = smem + align16(4 * g.mr * g.mw);
  uint32_t* strong = reinterpret_cast<uint32_t*>(dir + align16(g.mr * g.mw));
  uint32_t* weak = strong + g.br * MAX_WORDS;
  uint32_t* done = weak + g.br * MAX_WORDS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.z, r0 = blockIdx.y * rows;
  const int nw = (w + 31) / 32;
  // the window's first word (may be -1: columns left of the image) and the
  // words it writes
  const int wb = wide ? OUT_WORDS * blockIdx.x - 1 : 0;
  const int ow0 = wide ? OUT_WORDS * blockIdx.x : 0;
  const int ow1 = wide ? min(ow0 + OUT_WORDS, nw) : nw;
  const float* src = gray + (size_t)n * h * w;

  // 1. Sobel, magnitude, direction: mag[r][c] is pixel (mr0 + r, mc0 + c).
  // A thread takes four columns down SLIDE rows, loading each gray row once.
  const int mr0 = r0 - 9, mc0 = 32 * wb - 4;
  const float tan225 = 0.4142135623730951f;
  const float tan675 = 2.414213562373095f;
  const int groups = g.mw / 4, runs = (g.mr + SLIDE - 1) / SLIDE;
  for (int i = tid; i < runs * groups; i += THREADS) {
    const int rs = i / groups * SLIDE, c4 = i - i / groups * groups;
    const int x = mc0 + 4 * c4;
    float gr[SLIDE + 2][6];
#pragma unroll
    for (int k = 0; k < SLIDE + 2; ++k)
      load_row(src, mr0 + rs - 1 + k, x, h, w, vec, gr[k]);
#pragma unroll
    for (int k = 0; k < SLIDE; ++k) {
      const int r = rs + k, y = mr0 + r;
      if (r >= g.mr) break;
      const float* up = gr[k];
      const float* mid = gr[k + 1];
      const float* dn = gr[k + 2];
      float m[4];
      uint32_t d4 = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float nn = up[e + 1], s = dn[e + 1];
        const float ee = mid[e + 2], ww = mid[e];
        const float ne = up[e + 2], nw_ = up[e];
        const float se = dn[e + 2], sw = dn[e];
        const float gx = (ne + 2.0f * ee + se) - (nw_ + 2.0f * ww + sw);
        const float gy = (sw + 2.0f * s + se) - (nw_ + 2.0f * nn + ne);
        const float ax = fabsf(gx), ay = fabsf(gy);
        const bool inside = y >= 0 && y < h && x + e >= 0 && x + e < w;
        m[e] = inside ? ax + ay : 0.0f;
        uint32_t d;
        if (ay <= tan225 * ax) d = 0;       // horizontal: left/right
        else if (ay >= tan675 * ax) d = 1;  // vertical: up/down
        else if (gx * gy >= 0.0f) d = 2;    // same sign: ul/dr
        else d = 3;                         // ur/dl
        d4 |= d << (8 * e);
      }
      *reinterpret_cast<float4*>(mag + r * g.mw + 4 * c4) =
          make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<uint32_t*>(dir + r * g.mw + 4 * c4) = d4;
    }
  }
  __syncthreads();

  // 2. NMS + double threshold, 32 columns a warp step: bit row r is image
  // row r0 - 8 + r, bit `lane` of word j is column 32 * (wb + j) + lane
  for (int item = warp; item < g.br * nwin; item += WARPS) {
    const int r = item / nwin, j = item - r * nwin;
    const int y = r0 - 8 + r, x = 32 * (wb + j) + lane;
    const float* mrow = mag + (r + 1) * g.mw + 32 * j + lane + 4;
    const float mv = mrow[0];
    bool keep;
    switch (dir[(r + 1) * g.mw + 32 * j + lane + 4]) {
      case 0: keep = mv >= mrow[-1] && mv >= mrow[1]; break;
      case 1: keep = mv >= mrow[-g.mw] && mv >= mrow[g.mw]; break;
      case 2: keep = mv >= mrow[-g.mw - 1] && mv >= mrow[g.mw + 1]; break;
      default: keep = mv >= mrow[-g.mw + 1] && mv >= mrow[g.mw - 1];
    }
    const float nms = keep ? mv : 0.0f;
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    const uint32_t s = __ballot_sync(0xffffffffu, inside && nms > high);
    const uint32_t wk = __ballot_sync(0xffffffffu, inside && nms > low);
    if (lane == 0) {
      strong[r * MAX_WORDS + j] = s;
      weak[r * MAX_WORDS + j] = wk;
    }
  }
  __syncthreads();

  // 3. hysteresis: warp k holds bit rows 16k .. 16k + 31, one a lane, and
  // keeps the middle 16 (output rows 16k .. 16k + 15 of the band)
  if (warp < rows / OUT_ROWS) {
    const int r = warp * OUT_ROWS + lane;
    uint32_t st[MAX_WORDS], wk[MAX_WORDS];
#pragma unroll
    for (int j = 0; j < MAX_WORDS; ++j) {
      st[j] = j < nwin ? strong[r * MAX_WORDS + j] : 0u;
      wk[j] = j < nwin ? weak[r * MAX_WORDS + j] : 0u;
    }
#pragma unroll 1
    for (int it = 0; it < ITERS; ++it) {
      uint32_t v[MAX_WORDS];
#pragma unroll
      for (int j = 0; j < MAX_WORDS; ++j) {
        uint32_t a = __shfl_up_sync(0xffffffffu, st[j], 1);
        uint32_t b = __shfl_down_sync(0xffffffffu, st[j], 1);
        if (lane == 0) a = 0u;
        if (lane == 31) b = 0u;
        v[j] = a | st[j] | b;
      }
#pragma unroll
      for (int j = 0; j < MAX_WORDS; ++j) {
        const uint32_t left = j > 0 ? v[j - 1] : 0u;
        const uint32_t right = j + 1 < MAX_WORDS ? v[j + 1] : 0u;
        const uint32_t grown = v[j] | (v[j] << 1) | (left >> 31)
                               | (v[j] >> 1) | (right << 31);
        st[j] |= grown & wk[j];
      }
    }
    if (lane >= ITERS && lane < ITERS + OUT_ROWS) {
#pragma unroll
      for (int j = 0; j < MAX_WORDS; ++j)
        if (j < nwin) done[(r - ITERS) * MAX_WORDS + j] = st[j];
    }
  }
  __syncthreads();

  // 4. x255, four columns a thread
  float* dst = out + (size_t)n * h * w;
  const int ox0 = 32 * ow0, ocols = min(32 * ow1, w) - ox0;
  const int out_groups = (ocols + 3) / 4;
  for (int i = tid; i < rows * out_groups; i += THREADS) {
    const int r = i / out_groups, c4 = i - r * out_groups;
    const int y = r0 + r, x = ox0 + 4 * c4;
    if (y >= h) continue;
    const uint32_t word = done[r * MAX_WORDS + x / 32 - wb] >> (x % 32);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (word >> e) & 1u ? 255.0f : 0.0f;
    float* p = dst + (size_t)y * w + x;
    if (vec && x + 4 <= w) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x + e < w) p[e] = v[e];
    }
  }
}

}  // namespace

extern "C" int canny_iters() { return ITERS; }

// gray, out: (n, h, w) f32, contiguous, on the device.
extern "C" int canny_forward(const float* gray, float* out, int n, int h,
                             int w, float low, float high, void* stream) {
  const int nw = (w + 31) / 32;
  const bool wide = nw > MAX_WORDS;
  const int nwin = wide ? MAX_WORDS : nw;
  const int tiles = wide ? (nw + OUT_WORDS - 1) / OUT_WORDS : 1;
  const int rows = nwin <= 8 ? 64 : 32;
  const size_t smem = smem_bytes(geom(rows, nwin));
  // Above 48 KB of dynamic shared memory needs an opt-in, which belongs to
  // the current device; setting it on every call keeps each device right.
  cudaError_t err = cudaFuncSetAttribute(
      canny_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte loads and stores need every row on a 16-byte boundary
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(gray) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(tiles, (h + rows - 1) / rows, n);
  canny_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      gray, out, h, w, low, high, rows, nwin, wide, vec);
  return static_cast<int>(cudaGetLastError());
}
