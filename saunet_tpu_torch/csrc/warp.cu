// Per-image gather and the augmentation warp, four output pixels a thread.
//
// Replaces tools/exp_gather.py::probe (pl.pallas_call at :166), whose
// kernel bodies k_lane, k_sub and k_flat gather an (N, H, W) image along W,
// along H, or over the flat plane by int32 indices: the gather that the
// augmentation warp (saunet_tpu/data/augment.py::_warp_image_label_packed)
// is made of. Three entry points:
//
//   gather_image_forward: K5's function exactly. out[n, y, x] =
//     img[n, y, idx]      (lane),
//     img[n, idx, x]      (sublane),
//     img[n].flat[idx]    (flat),   idx = idx[n, y, x].
//   warp_forward: the warp itself. Bilinear image sample and nearest label
//     sample at float source coordinates (sy, sx), zero fill outside.
//   resample_forward: the paired transforms' resample
//     (saunet_tpu/data/transforms.py::_resample, K5's per-image flat gather
//     `_flat_gather` onto a coordinate grid of its own shape): C image
//     planes and one mask plane a sample, (H, W), sampled at (sy, sx) of
//     shape (Ho, Wo). See resample_kernel below for its numerics.
//
// Bound: memory. The gather reads an index and writes a value per pixel and
// reads the image once (12 bytes a pixel); the warp reads sy, sx, one image
// and one label value per pixel, since neighbouring pixels share their 2x2
// taps through L1/L2, and writes two values (24 bytes a pixel). A few dozen
// f32 operations per pixel are nothing beside that: at b64 and 224^2 the
// bound is 0.023 ms for the warp and 0.0115 ms for a gather. The resample
// reads sy and sx (8 bytes an output pixel), writes C image values and a
// mask value, and reads once each input pixel that its taps touch: at b64
// from 256^2 onto 224^2 with C = 1, 0.0254 ms for a grid that reads whole
// planes, less for a crop, which reads only its window (chip_smoke.py's
// resample_bytes counts them on the run's coordinates).
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

// One output pixel of the resample at (y, x) in a sample's planes: the 4
// bilinear taps' offsets and weights, and the nearest tap. The numerics are
// the unpacked samplers' (saunet_tpu/data/augment.py::
// _sample_bilinear_batched and _sample_nearest_batched): f32 taps, each 0
// where its pixel lies outside the image, combined in the order
//   (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)
// and the mask's tap at (rint(y), rint(x)), round half to even, 0 outside.
struct ResamplePixel {
  int o[4];       // tap offsets in a plane, clamped into it
  bool in[4];     // tap inside the image
  float fy, fx;   // fractions
  int on;         // nearest tap's offset, clamped
  bool in_n;      // nearest tap inside
};

__device__ __forceinline__ ResamplePixel resample_pixel(int h, int w, float y,
                                                        float x) {
  ResamplePixel p;
  const float y0 = floorf(y), x0 = floorf(x);
  p.fy = y - y0;
  p.fx = x - x0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float yy = y0 + (float)(k >> 1), xx = x0 + (float)(k & 1);
    p.in[k] = yy >= 0.0f && yy < (float)h && xx >= 0.0f && xx < (float)w;
    // clamping in float keeps far or NaN coordinates from overflowing the
    // int conversion
    p.o[k] = (int)fminf(fmaxf(yy, 0.0f), (float)(h - 1)) * w
             + (int)fminf(fmaxf(xx, 0.0f), (float)(w - 1));
  }
  const float yn = rintf(y), xn = rintf(x);
  p.in_n = yn >= 0.0f && yn < (float)h && xn >= 0.0f && xn < (float)w;
  p.on = (int)fminf(fmaxf(yn, 0.0f), (float)(h - 1)) * w
         + (int)fminf(fmaxf(xn, 0.0f), (float)(w - 1));
  return p;
}

__device__ __forceinline__ float resample_value(const float* __restrict__ im,
                                                const ResamplePixel& p) {
  float t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = __ldg(im + p.o[k]);
    t[k] = p.in[k] ? v : 0.0f;
  }
  const float gy = 1.0f - p.fy, gx = 1.0f - p.fx;
  return gy * (gx * t[0] + p.fx * t[1]) + p.fy * (gx * t[2] + p.fx * t[3]);
}

// Grid (tiles of an output plane, samples). Each thread takes 4 consecutive
// output pixels of one sample, reads their coordinates once, and writes
// them for each of the sample's C image planes and its mask plane. Bound:
// memory, as the warp (the taps of neighbouring pixels share cache lines).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
resample_kernel(const float* __restrict__ img, const int* __restrict__ mask,
                const float* __restrict__ sy, const float* __restrict__ sx,
                float* __restrict__ out_img, int* __restrict__ out_mask,
                int n, int c, int h, int w, int ho, int wo) {
  const int plane = h * w, oplane = ho * wo;
  const int p0 = blockIdx.x * TILE + threadIdx.x * PER_THREAD;
  if (p0 >= oplane) return;
  const int m = min(PER_THREAD, oplane - p0);
  for (int s = blockIdx.y; s < n; s += gridDim.y) {
    const size_t o = (size_t)s * oplane + p0;
    ResamplePixel px[PER_THREAD];
    if (VEC) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(sy + o));
      const float4 b = __ldg(reinterpret_cast<const float4*>(sx + o));
      px[0] = resample_pixel(h, w, a.x, b.x);
      px[1] = resample_pixel(h, w, a.y, b.y);
      px[2] = resample_pixel(h, w, a.z, b.z);
      px[3] = resample_pixel(h, w, a.w, b.w);
    } else {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k)
        if (k < m) px[k] = resample_pixel(h, w, __ldg(sy + o + k),
                                          __ldg(sx + o + k));
    }
    for (int ch = 0; ch < c; ++ch) {
      const size_t plane_i = (size_t)s * c + ch;
      const float* im = img + plane_i * plane;
      float* out = out_img + plane_i * oplane + p0;
      if (VEC) {
        *reinterpret_cast<float4*>(out) = make_float4(
            resample_value(im, px[0]), resample_value(im, px[1]),
            resample_value(im, px[2]), resample_value(im, px[3]));
      } else {
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k)
          if (k < m) out[k] = resample_value(im, px[k]);
      }
    }
    const int* mk = mask + (size_t)s * plane;
    int l[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (VEC || k < m) {
        const int v = __ldg(mk + px[k].on);
        l[k] = px[k].in_n ? v : 0;
      }
    }
    if (VEC) {
      *reinterpret_cast<int4*>(out_mask + o) = make_int4(l[0], l[1], l[2],
                                                         l[3]);
    } else {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k)
        if (k < m) out_mask[o + k] = l[k];
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

// img: (n, c, h, w) f32; mask: (n, h, w) int32; sy, sx: (n, ho, wo) f32;
// out_img: (n, c, ho, wo) f32; out_mask: (n, ho, wo) int32. All
// contiguous, on the device; n, c, h, w, ho, wo > 0.
extern "C" int resample_forward(const float* img, const int* mask,
                                const float* sy, const float* sx,
                                float* out_img, int* out_mask, int n, int c,
                                int h, int w, int ho, int wo, void* stream) {
  dim3 grid;
  if ((long long)h * w > INT_MAX || !grid_for(n, ho, wo, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wo % PER_THREAD == 0 && aligned16(sy) && aligned16(sx)
      && aligned16(out_img) && aligned16(out_mask))
    resample_kernel<true><<<grid, THREADS, 0, st>>>(
        img, mask, sy, sx, out_img, out_mask, n, c, h, w, ho, wo);
  else
    resample_kernel<false><<<grid, THREADS, 0, st>>>(
        img, mask, sy, sx, out_img, out_mask, n, c, h, w, ho, wo);
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
