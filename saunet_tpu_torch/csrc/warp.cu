// Per-image gather and the augmentation warp, one thread per output pixel.
//
// Replaces tools/exp_gather.py::probe (pl.pallas_call at :166), whose
// kernel bodies k_lane, k_sub and k_flat gather an (N, H, W) image along W,
// along H, or over the flat plane by int32 indices: the gather that the
// augmentation warp (saunet_tpu/data/augment.py::_warp_image_label_packed)
// is made of. Two entry points:
//
//   gather_image_forward: K5's function exactly. out[n, y, x] =
//     img[n, y, idx]      (lane),
//     img[n, idx, x]      (sublane),
//     img[n].flat[idx]    (flat),   idx = idx[n, y, x].
//   warp_forward: the warp itself. Bilinear image sample and nearest label
//     sample at float source coordinates (sy, sx), zero fill outside.
//
// Bound: memory. The gather reads an index and writes a value per pixel and
// reads the image once (12 bytes a pixel); the warp reads sy, sx, one image
// and one label value per pixel, since neighbouring pixels share their 2x2
// taps through L1/L2, and writes two values (24 bytes a pixel). A few dozen
// f32 operations per pixel are nothing beside that.
//
// Design: the TPU packed the 2x2 image patch and the label patch into one
// 8-lane bf16 row so that the warp became ONE gather, because gathers, not
// bytes, bounded it there. On Hopper a gather is an ordinary load, so each
// thread reads its 2x2 image and label taps directly; consecutive threads
// take consecutive output pixels, so the sy/sx reads and both writes
// coalesce and the taps of a warp fall on a few cache lines.
//
// Numerics of the warp, the reference's: each image tap rounds to bf16 (the
// reference's packed row), the bilinear combine runs in f32 in the order
//   (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)
// and a pixel is inside iff sy > -1, sy < H, sx > -1, sx < W. The label is
// the tap picked by fy >= 0.5 and fx >= 0.5 (round half up), 0 outside.
// Built with -fmad=false, so the plain PyTorch version
// (saunet_tpu_torch/ops/cuda/warp.py::warp_image_label_plain) matches it
// bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_kernel(const float* __restrict__ img, const int* __restrict__ idx,
              float* __restrict__ out, int h, int w, int mode,
              long long total) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= total) return;
  const long long plane = (long long)h * w;
  const long long n = i / plane;
  const int p = (int)(i - n * plane);
  const int y = p / w, x = p - (p / w) * w;
  const int k = idx[i];
  // indices are clamped into the image: nothing is read out of bounds
  long long src;
  if (mode == 0) {
    src = (long long)y * w + min(max(k, 0), w - 1);
  } else if (mode == 1) {
    src = (long long)min(max(k, 0), h - 1) * w + x;
  } else {
    src = min(max((long long)k, 0LL), plane - 1);
  }
  out[i] = img[n * plane + src];
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__global__ void __launch_bounds__(THREADS)
warp_kernel(const float* __restrict__ img, const int* __restrict__ lab,
            const float* __restrict__ sy, const float* __restrict__ sx,
            float* __restrict__ out_img, int* __restrict__ out_lab, int h,
            int w, long long total) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= total) return;
  const long long plane = (long long)h * w;
  const long long n = i / plane;
  const float y = sy[i], x = sx[i];
  const float y0f = floorf(y), x0f = floorf(x);
  const float fy = y - y0f, fx = x - x0f;
  float v = 0.0f;
  int l = 0;
  if (y > -1.0f && y < (float)h && x > -1.0f && x < (float)w) {
    const int y0 = (int)y0f, x0 = (int)x0f;
    const float* im = img + n * plane;
    const int* lb = lab + n * plane;
    float t[4];
    int tl[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yy = y0 + (k >> 1), xx = x0 + (k & 1);
      const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
      const long long o = (long long)yy * w + xx;
      t[k] = in ? bf16_round(im[o]) : 0.0f;
      tl[k] = in ? lb[o] : 0;
    }
    const float gx = 1.0f - fx;
    v = (1.0f - fy) * (gx * t[0] + fx * t[1]) + fy * (gx * t[2] + fx * t[3]);
    l = tl[(fy >= 0.5f ? 2 : 0) + (fx >= 0.5f ? 1 : 0)];
  }
  out_img[i] = v;
  out_lab[i] = l;
}

unsigned int blocks(long long total) {
  return (unsigned int)((total + THREADS - 1) / THREADS);
}

}  // namespace

// img, out: (n, h, w) f32; idx: (n, h, w) int32; mode 0 lane, 1 sublane,
// 2 flat. All contiguous, on the device.
extern "C" int gather_image_forward(const float* img, const int* idx,
                                    float* out, int n, int h, int w,
                                    int mode, void* stream) {
  const long long total = (long long)n * h * w;
  gather_kernel<<<blocks(total), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(img, idx, out, h, w,
                                                       mode, total);
  return static_cast<int>(cudaGetLastError());
}

// img, sy, sx, out_img: (n, h, w) f32; lab, out_lab: (n, h, w) int32.
extern "C" int warp_forward(const float* img, const int* lab, const float* sy,
                            const float* sx, float* out_img, int* out_lab,
                            int n, int h, int w, void* stream) {
  const long long total = (long long)n * h * w;
  warp_kernel<<<blocks(total), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(img, lab, sy, sx,
                                                     out_img, out_lab, h, w,
                                                     total);
  return static_cast<int>(cudaGetLastError());
}
