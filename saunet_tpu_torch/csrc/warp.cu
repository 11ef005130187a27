// Per-image gather and the augmentation warp, four output pixels a thread.
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
// f32 operations per pixel are nothing beside that: at b64 and 224^2 the
// bound is 0.023 ms for the warp and 0.0115 ms for a gather.
//
// Design: the TPU packed the 2x2 image patch and the label patch into one
// 8-lane bf16 row so that the warp became ONE gather, because gathers, not
// bytes, bounded it there. On Hopper a gather is an ordinary load, so the
// streams are what cost: each thread takes 4 consecutive output pixels of
// one image and reads sy and sx, and writes both outputs, as 16-byte
// vectors; the 2x2 taps come through the read-only path (__ldg), where the
// taps of neighbouring threads share cache lines. The grid is (tiles of a
// plane, image): the image comes from blockIdx.y and the index inside a
// plane is 32-bit, so no thread divides by the plane size; the warp divides
// by nothing, and the lane and sublane gathers divide once by W per 4
// pixels. The vector form is taken when W is a multiple of 4 and every
// pointer is 16-byte aligned (then 4 consecutive pixels from a multiple of 4
// lie in one row); otherwise each thread reads its 4 pixels one by one, and
// the last thread of a plane takes what is left of it.
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

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;  // pixels of a plane per block
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One output pixel of the warp, from its image's plane `im` and `lb`.
// Branch-free: the 8 tap loads go out at clamped addresses whether or not
// the pixel is inside, so a thread's 4 pixels keep 32 loads in flight, and
// the selects afterwards give exactly the reference's values.
__device__ __forceinline__ void warp_pixel(const float* __restrict__ im,
                                           const int* __restrict__ lb, int h,
                                           int w, float y, float x, float& v,
                                           int& l) {
  const bool inside = y > -1.0f && y < (float)h && x > -1.0f && x < (float)w;
  const float y0f = floorf(y), x0f = floorf(x);
  const float fy = y - y0f, fx = x - x0f;
  // clamping changes nothing inside, and keeps far or NaN coordinates
  // outside from overflowing the int conversion
  const int y0 = (int)fminf(fmaxf(y0f, -1.0f), (float)h);
  const int x0 = (int)fminf(fmaxf(x0f, -1.0f), (float)w);
  float t[4];
  int tl[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = y0 + (k >> 1), xx = x0 + (k & 1);
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const int o = min(max(yy, 0), h - 1) * w + min(max(xx, 0), w - 1);
    const float tv = __ldg(im + o);
    const int lv = __ldg(lb + o);
    t[k] = in ? bf16_round(tv) : 0.0f;
    tl[k] = in ? lv : 0;
  }
  const float gx = 1.0f - fx;
  const float vb =
      (1.0f - fy) * (gx * t[0] + fx * t[1]) + fy * (gx * t[2] + fx * t[3]);
  const int lt = fx >= 0.5f ? tl[1] : tl[0];
  const int lbt = fx >= 0.5f ? tl[3] : tl[2];
  v = inside ? vb : 0.0f;
  l = inside ? (fy >= 0.5f ? lbt : lt) : 0;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
warp_kernel(const float* __restrict__ img, const int* __restrict__ lab,
            const float* __restrict__ sy, const float* __restrict__ sx,
            float* __restrict__ out_img, int* __restrict__ out_lab, int n,
            int h, int w) {
  const int plane = h * w;
  const int p0 = blockIdx.x * TILE + threadIdx.x * PER_THREAD;
  if (p0 >= plane) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t o = (size_t)i * plane + p0;
    const float* im = img + (size_t)i * plane;
    const int* lb = lab + (size_t)i * plane;
    float y[PER_THREAD], x[PER_THREAD], v[PER_THREAD];
    int l[PER_THREAD];
    if (VEC) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(sy + o));
      const float4 b = __ldg(reinterpret_cast<const float4*>(sx + o));
      y[0] = a.x, y[1] = a.y, y[2] = a.z, y[3] = a.w;
      x[0] = b.x, x[1] = b.y, x[2] = b.z, x[3] = b.w;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k)
        warp_pixel(im, lb, h, w, y[k], x[k], v[k], l[k]);
      *reinterpret_cast<float4*>(out_img + o) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<int4*>(out_lab + o) =
          make_int4(l[0], l[1], l[2], l[3]);
    } else {
      const int m = min(PER_THREAD, plane - p0);
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        if (k < m) {
          warp_pixel(im, lb, h, w, __ldg(sy + o + k), __ldg(sx + o + k),
                     v[k], l[k]);
          out_img[o + k] = v[k];
          out_lab[o + k] = l[k];
        }
      }
    }
  }
}

// The source offset inside a plane of pixel (yy, xx) under MODE, with the
// index k clamped into the image: nothing is read out of bounds.
template <int MODE>
__device__ __forceinline__ int gather_src(int k, int yy, int xx, int h,
                                          int w, int plane) {
  if (MODE == 0) return yy * w + min(max(k, 0), w - 1);
  if (MODE == 1) return min(max(k, 0), h - 1) * w + xx;
  return min(max(k, 0), plane - 1);
}

template <bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const float* __restrict__ img, const int* __restrict__ idx,
              float* __restrict__ out, int n, int h, int w) {
  const int plane = h * w;
  const int p0 = blockIdx.x * TILE + threadIdx.x * PER_THREAD;
  if (p0 >= plane) return;
  // the flat mode needs no row; the others divide once per 4 pixels
  const int y0 = MODE == 2 ? 0 : p0 / w;
  const int x0 = p0 - y0 * w;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t o = (size_t)i * plane + p0;
    const float* im = img + (size_t)i * plane;
    if (VEC) {
      // 4 pixels of one row: x0 .. x0 + 3
      const int4 k = __ldg(reinterpret_cast<const int4*>(idx + o));
      float4 r;
      r.x = __ldg(im + gather_src<MODE>(k.x, y0, x0, h, w, plane));
      r.y = __ldg(im + gather_src<MODE>(k.y, y0, x0 + 1, h, w, plane));
      r.z = __ldg(im + gather_src<MODE>(k.z, y0, x0 + 2, h, w, plane));
      r.w = __ldg(im + gather_src<MODE>(k.w, y0, x0 + 3, h, w, plane));
      *reinterpret_cast<float4*>(out + o) = r;
    } else {
      const int m = min(PER_THREAD, plane - p0);
      int yy = y0, xx = x0;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        if (k < m) {
          out[o + k] = __ldg(im + gather_src<MODE>(__ldg(idx + o + k), yy,
                                                   xx, h, w, plane));
          if (++xx == w) xx = 0, ++yy;
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// (tiles of a plane, images): images beyond the grid's y limit are walked
// by a loop inside the kernel
bool grid_for(int n, int h, int w, dim3* grid) {
  const long long plane = (long long)h * w;
  if (plane > INT_MAX - TILE) return false;
  *grid = dim3((unsigned)((plane + TILE - 1) / TILE),
               (unsigned)(n < MAX_GRID_Y ? n : MAX_GRID_Y));
  return true;
}

template <bool VEC>
void launch_gather(dim3 grid, cudaStream_t st, const float* img,
                   const int* idx, float* out, int n, int h, int w,
                   int mode) {
  if (mode == 0)
    gather_kernel<VEC, 0><<<grid, THREADS, 0, st>>>(img, idx, out, n, h, w);
  else if (mode == 1)
    gather_kernel<VEC, 1><<<grid, THREADS, 0, st>>>(img, idx, out, n, h, w);
  else
    gather_kernel<VEC, 2><<<grid, THREADS, 0, st>>>(img, idx, out, n, h, w);
}

}  // namespace

// img, out: (n, h, w) f32; idx: (n, h, w) int32; mode 0 lane, 1 sublane,
// 2 flat. All contiguous, on the device; n, h, w > 0.
extern "C" int gather_image_forward(const float* img, const int* idx,
                                    float* out, int n, int h, int w,
                                    int mode, void* stream) {
  dim3 grid;
  if (mode < 0 || mode > 2 || !grid_for(n, h, w, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w % PER_THREAD == 0 && aligned16(img) && aligned16(idx)
      && aligned16(out))
    launch_gather<true>(grid, st, img, idx, out, n, h, w, mode);
  else
    launch_gather<false>(grid, st, img, idx, out, n, h, w, mode);
  return static_cast<int>(cudaGetLastError());
}

// img, sy, sx, out_img: (n, h, w) f32; lab, out_lab: (n, h, w) int32.
extern "C" int warp_forward(const float* img, const int* lab, const float* sy,
                            const float* sx, float* out_img, int* out_lab,
                            int n, int h, int w, void* stream) {
  dim3 grid;
  if (!grid_for(n, h, w, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w % PER_THREAD == 0 && aligned16(sy) && aligned16(sx)
      && aligned16(out_img) && aligned16(out_lab))
    warp_kernel<true><<<grid, THREADS, 0, st>>>(img, lab, sy, sx, out_img,
                                                out_lab, n, h, w);
  else
    warp_kernel<false><<<grid, THREADS, 0, st>>>(img, lab, sy, sx, out_img,
                                                 out_lab, n, h, w);
  return static_cast<int>(cudaGetLastError());
}
