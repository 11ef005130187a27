// Canny-style edge map, one CUDA kernel for every image size.
//
// Replaces saunet_tpu/ops/pallas/canny.py::canny_edges_pallas (whole image
// in VMEM) and ::canny_edges_pallas_tiled (halo'd row bands above 220 000
// pixels). Both compute _canny_math: Sobel 3x3 with zero boundary and L1
// magnitude, 4-bin non-maximum suppression, double threshold, then ITERS
// rounds of 8-neighbour hysteresis clipped to the weak pixels, x255.
//
// Bound: memory. The operator reads one f32 and writes one f32 per pixel
// (8 bytes); everything in between is a few hundred integer/f32 ops per
// pixel. The XLA lowering re-reads device memory on every hysteresis round;
// the TPU kernels kept the image in VMEM instead.
//
// Design: the row-band idea of the tiled TPU kernel in two dimensions. One
// block owns a TILE x TILE output tile and stages the tile plus a halo of
// HALO = ITERS + 2 pixels (1 for Sobel, 1 for NMS, ITERS for hysteresis) in
// shared memory: gray, magnitude, direction code, weak and two ping-pong
// strong planes, about 30 KB. All stages and the ITERS hysteresis rounds run
// out of shared memory with a __syncthreads() between rounds; device memory
// sees one read of the halo'd tile and one write of the interior.
//
// The whole-image semantics zero-fill the DERIVED planes outside the image
// (magnitude, weak, strong); only the Sobel taps read zero-padded gray. Halo
// positions outside the image therefore get mag = weak = strong = 0.
//
// Numerics: built with -fmad=false and written in _canny_math's order of
// operations, so the threshold comparisons match the plain PyTorch version
// (saunet_tpu_torch/ops/edge.py::canny_edges) bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ITERS = 8;
constexpr int HALO = ITERS + 2;
constexpr int GS = TILE + 2 * HALO;  // gray plane: tile + 10 each side
constexpr int MS = GS - 2;           // magnitude/direction plane: + 9
constexpr int SS = MS - 2;           // nms/weak/strong planes: + 8
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
canny_kernel(const float* __restrict__ gray, float* __restrict__ out,
             int h, int w, float low, float high) {
  __shared__ float g[GS][GS];
  __shared__ float mag[MS][MS];
  __shared__ unsigned char dir[MS][MS];
  __shared__ unsigned char weak[SS][SS];
  __shared__ unsigned char strong[2][SS][SS];

  const int n = blockIdx.z;
  // global coordinates of g[0][0]
  const int gy0 = blockIdx.y * TILE - HALO;
  const int gx0 = blockIdx.x * TILE - HALO;
  const float* src = gray + (size_t)n * h * w;

  for (int i = threadIdx.x; i < GS * GS; i += THREADS) {
    const int r = i / GS, c = i % GS;
    const int y = gy0 + r, x = gx0 + c;
    g[r][c] = (y >= 0 && y < h && x >= 0 && x < w)
                  ? src[(size_t)y * w + x] : 0.0f;
  }
  __syncthreads();

  // Sobel + magnitude + direction bin; mag[r][c] sits at g[r + 1][c + 1].
  const float tan225 = 0.4142135623730951f;
  const float tan675 = 2.414213562373095f;
  for (int i = threadIdx.x; i < MS * MS; i += THREADS) {
    const int r = i / MS + 1, c = i % MS + 1;
    const int y = gy0 + r, x = gx0 + c;
    const float nn = g[r - 1][c], s = g[r + 1][c];
    const float e = g[r][c + 1], ww = g[r][c - 1];
    const float ne = g[r - 1][c + 1], nw = g[r - 1][c - 1];
    const float se = g[r + 1][c + 1], sw = g[r + 1][c - 1];
    const float gx = (ne + 2.0f * e + se) - (nw + 2.0f * ww + sw);
    const float gy = (sw + 2.0f * s + se) - (nw + 2.0f * nn + ne);
    const float ax = fabsf(gx), ay = fabsf(gy);
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    mag[r - 1][c - 1] = inside ? ax + ay : 0.0f;
    unsigned char d;
    if (ay <= tan225 * ax) d = 0;           // horizontal: left/right
    else if (ay >= tan675 * ax) d = 1;      // vertical: up/down
    else if (gx * gy >= 0.0f) d = 2;        // same sign: ul/dr
    else d = 3;                             // ur/dl
    dir[r - 1][c - 1] = d;
  }
  __syncthreads();

  // NMS + double threshold; strong[.][r][c] sits at mag[r + 1][c + 1].
  for (int i = threadIdx.x; i < SS * SS; i += THREADS) {
    const int r = i / SS, c = i % SS;
    const int mr = r + 1, mc = c + 1;
    const int y = gy0 + 2 + r, x = gx0 + 2 + c;
    const float m = mag[mr][mc];
    bool keep;
    switch (dir[mr][mc]) {
      case 0: keep = m >= mag[mr][mc - 1] && m >= mag[mr][mc + 1]; break;
      case 1: keep = m >= mag[mr - 1][mc] && m >= mag[mr + 1][mc]; break;
      case 2: keep = m >= mag[mr - 1][mc - 1] && m >= mag[mr + 1][mc + 1];
              break;
      default: keep = m >= mag[mr - 1][mc + 1] && m >= mag[mr + 1][mc - 1];
    }
    const float nms = keep ? m : 0.0f;
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    strong[0][r][c] = inside && nms > high;
    weak[r][c] = inside && nms > low;
  }

  // Hysteresis: s = max(s, dilate3x3(s) * weak), ITERS rounds. Positions
  // beyond the staged plane read as 0; their error moves in one pixel per
  // round and never reaches the tile interior.
  int cur = 0;
  for (int it = 0; it < ITERS; ++it) {
    __syncthreads();
    for (int i = threadIdx.x; i < SS * SS; i += THREADS) {
      const int r = i / SS, c = i % SS;
      unsigned char v = strong[cur][r][c];
      if (!v && weak[r][c]) {
        for (int dy = -1; dy <= 1 && !v; ++dy) {
          const int rr = r + dy;
          if (rr < 0 || rr >= SS) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            const int cc = c + dx;
            if (cc >= 0 && cc < SS && strong[cur][rr][cc]) { v = 1; break; }
          }
        }
      }
      strong[cur ^ 1][r][c] = v;
    }
    cur ^= 1;
  }
  __syncthreads();

  float* dst = out + (size_t)n * h * w;
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int r = i / TILE, c = i % TILE;
    const int y = blockIdx.y * TILE + r, x = blockIdx.x * TILE + c;
    if (y < h && x < w)
      dst[(size_t)y * w + x] =
          strong[cur][r + HALO - 2][c + HALO - 2] ? 255.0f : 0.0f;
  }
}

}  // namespace

extern "C" int canny_iters() { return ITERS; }

// gray, out: (n, h, w) f32, contiguous, on the device.
extern "C" int canny_forward(const float* gray, float* out, int n, int h,
                             int w, float low, float high, void* stream) {
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  canny_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      gray, out, h, w, low, high);
  return static_cast<int>(cudaGetLastError());
}
