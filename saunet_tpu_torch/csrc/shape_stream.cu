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
// Bound on this card: operations. 102 326 multiply-adds per pixel, 72% of
// them res1's two 64-channel convs, against 136 bytes of input and output:
// about 750 FLOP per byte, above the H100's 295 (bf16 tensor cores over
// HBM); 0.66 ms at (64, 224, 224) and 989 TFLOP/s.
//
// Design. The TPU kernel ran all six convs on one VMEM-resident row band;
// an SM's 227 KB holds a 64-channel bf16 map only over a small tile, so the
// stream runs as three launches, one per stage, and the stage outputs (32
// and 16 bf16 channels, the gates' rounding points) pass through device
// memory. Each launch is a persistent grid (as many blocks as fit on the
// SMs) walking 16 x 28-pixel output tiles; a block is three warpgroups.
//   - X: the tile's 20 x 32 region (a 2-pixel halo), zero outside the
//     image, flattened row-major with pitch 32 and stored as C / 8 planes
//     of 16-byte rows (channels 8k .. 8k + 7 of every position in plane k).
//     That is wgmma's no-swizzle K-major layout (8 rows of 16 bytes make a
//     128-byte core matrix, the next 8 channels one plane further), and it
//     lets a 64-row A operand start at any position: a 3x3 tap (dy, dx) is
//     the same matrix shifted by dy * 32 + dx rows, one descriptor address.
//   - conv1 and conv2 are implicit GEMMs on wgmma m64nCk16, A and B from
//     shared memory: M = 64 flat positions a warpgroup instruction, N = C
//     output channels, K = 9 taps x C. conv1 computes positions 33 .. 608
//     (9 chunks of 64), conv2 66 .. 577 (8 chunks): 2.43 products per
//     output pixel and conv against 2 for the bare convs, 1.21x (16 x 16
//     tiles with pitch 20 and 16-row mma tiles computed 1.41x). Positions
//     that wrap a row are computed and never read; the warpgroup with two
//     conv2 chunks repeats its last as a third, so that no branch lies
//     around a wgmma.
//   - The weights come by bulk copies (cp.async.bulk, completion on an
//     mbarrier) that one thread issues, in a layout made once per model at
//     fold time (ops/cuda/shape_stream.py: r_w1k, r_w2k). At C = 32 and 16
//     all 18 taps (36 and 9 KB) stay resident for the block's life. At
//     C = 64 (147 KB) they stream tap by tap (8 KB) from L2 through a ring
//     of 6, each copy issued as soon as every warp has released its stage,
//     so it overlaps the products of the taps before it and no tile waits
//     on a synchronous weight load. No warp is set aside for the copies: a
//     416-thread block would be allocated registers as 512 threads, 128 a
//     thread, where 384 threads get 168.
//   - conv1's output y is set to zero at positions outside the image, where
//     conv2 must see SAME padding, and goes to its own planes.
//   - conv2's result never returns to shared memory: each warp adds the
//     bias and the residual to its accumulators, rounds them to bf16 as the
//     A fragments of the 1x1 tail (d_i, the gate, g_wg, and fuse + sigmoid
//     in the last stage), and runs the tail on tensor cores, mma.sync
//     m16n8k16 on its three chunks of 16 positions at once (two, then one,
//     at C = 64), each product's accumulators turned into the next one's A
//     fragments in registers at the TPU kernel's rounding points; only the
//     order of f32 sums differs.
//   - The next tile's region streams in (cp.async) while the tails run:
//     X and y are free once conv2's products and residuals are read.
// Shared memory: 217 KB at C = 64 and 122 KB at C = 32 (one block per SM),
// 55 KB at C = 16 (two).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int PACKED = 67;   // input channels per pixel
constexpr int CUE = 64;      // channel of stage 0's cue; stage i reads CUE + i
constexpr int FUSE_IN = 8;   // channels entering fuse
constexpr int NUM_OPS = 18;  // operands per stage, in the wrapper's order
constexpr int TH = 16, TW = 28;     // output tile
constexpr int P = TW + 4;           // region pitch: tile plus a 2-pixel halo
constexpr int RR = TH + 4;          // region rows
constexpr int NWG = 3;              // warpgroups of a block
constexpr int WARPS = 4 * NWG;
constexpr int THREADS = 32 * WARPS;
constexpr int TAPS = 18;            // 9 for conv1, then 9 for conv2
static_assert(P == 32, "a warp loads one region row, a lane a position");

constexpr int round64(int v) { return (v + 63) / 64 * 64; }
// conv1 at flat positions [Q1, Q1 + M1): every position whose window lies
// in the region; conv2 at [Q2, Q2 + M2): the tile itself
constexpr int Q1 = P + 1;
constexpr int M1 = round64((TH + 2) * P + TW + 2 - Q1 + 1);
constexpr int Q2 = 2 * P + 2;
constexpr int M2 = round64((TH + 1) * P + TW + 1 - Q2 + 1);
constexpr int CH1 = M1 / 64, CH2 = M2 / 64;
constexpr int MAXCH = (CH1 + NWG - 1) / NWG;  // chunks of a warpgroup
constexpr int X_ROWS = Q1 + M1 + P + 1;        // the last row conv1 reads
constexpr int Y0 = Q1;                         // y row 0 is position Q1
constexpr int Y_ROWS = Q2 + M2 + P + 1 - Y0;   // the last row conv2 reads
static_assert(X_ROWS >= RR * P, "X holds the region");
static_assert(Y_ROWS >= M1, "y holds conv1's output");
static_assert(Q2 - P - 1 >= Q1, "conv2 reads only positions conv1 computed");
constexpr int PLANE_X = X_ROWS * 16, PLANE_Y = Y_ROWS * 16;  // bytes
constexpr int STAGING = 4352;  // bytes for one packed region row
static_assert(STAGING >= (P * PACKED * 2 + 32 + 15) / 16 * 16, "staging");
// stage 0 stages 17 of its 20 region rows at once in y: rows 0 .. 11 (one
// a warp) in slots 0 .. 11, rows 12 .. 16 in slots 12 .. 16; rows 17 .. 19
// follow in the slots of rows 5 .. 7 once those are unpacked
constexpr int SLOTS = 17;

struct Stage {  // the layout of NUM_OPS pointers the wrapper passes
  const bf16* r_w1k;  // (9, C/8, C, 8): tap, K chunk, out channel, 8 in
  const float* r_b1;
  const bf16* r_w2k;
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

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

template <int C>
struct Cfg {
  static constexpr int CN = C / 2;
  static constexpr int G = CN + 1;              // the gate's hidden width
  static constexpr int GP = (G + 7) / 8 * 8;    // padded to mma's n8
  static constexpr int KG = CN < 16 ? 16 : CN;  // the gate GEMMs' K
  static constexpr int LDD = C + 8, LDG = KG + 8;  // tail B rows (bf16)
  static constexpr int TAP_BYTES = C * C * 2;
  // All 18 taps (36 KB at C = 32) stay resident where they fit beside X
  // and y; at C = 64 (147 KB) they stream through a ring of 6.
  static constexpr bool RESIDENT = C <= 32;
  static constexpr int STAGES = RESIDENT ? TAPS : 6;
  static constexpr int BLOCKS = C == 16 ? 2 : 1;  // per SM
  // shared memory, bytes
  static constexpr int OFF_Y = align128(C / 8 * PLANE_X);
  static constexpr int OFF_RING = OFF_Y + align128(C / 8 * PLANE_Y);
  static constexpr int OFF_DW = OFF_RING + STAGES * TAP_BYTES;
  static constexpr int OFF_W1 = OFF_DW + align128(CN * LDD * 2);
  static constexpr int OFF_WG = OFF_W1 + align128(GP * LDG * 2);
  static constexpr int OFF_VEC = OFF_WG + align128(CN * LDG * 2);
  // f32 vectors: b1, b2 (C); d_b, a_ss, b_ss (CN); w1_cue, b1g, w2 (GP);
  // fuse (8); a_cue, b_cue, b2g, a2, bn2b (8)
  static constexpr int VEC_FLOATS = 2 * C + 3 * CN + 3 * GP + 16;
  static constexpr int OFF_CUE = OFF_VEC + align128(VEC_FLOATS * 4);
  // the cues of two tiles: the next tile's stream in while the tails read
  static constexpr int OFF_BAR = OFF_CUE + align128(2 * RR * P * 4);
  static constexpr int SMEM = OFF_BAR + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "one block's shared memory");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "an SM's shared memory");
  static_assert(C != 64 || SLOTS * STAGING <= C / 8 * PLANE_Y,
                "stage 0 stages its packed rows in y");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<bf162*>(&v));
}

// --- mbarriers and the bulk copy -------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that has
// not ended after about 2^32 cycles (seconds) traps: the launch then fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared without registers; bytes past src_bytes are 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle, K-major: start address,
// LBO = the byte step to the next 8 K elements (one plane), SBO = the step
// to the next 8 rows (128 bytes).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(128 >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across a wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] * B[16 x N], both from shared memory
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b);

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// --- mma.sync for the tail -------------------------------------------------

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

// acc[NT][4] += A (16 x 16*KS, fragments a) @ W, W^T in shared memory as
// rows of LD bf16 (row n holds W[:, n], K contiguous)
template <int KS, int NT, int LD>
__device__ __forceinline__ void tail_gemm(float (&acc)[NT][4],
                                          const uint32_t (&a)[KS][4],
                                          const bf16* wt, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const bf16* b = wt + (8 * nt + g) * LD + 16 * ks + 2 * t;
      mma_bf16(acc[nt], a[ks], *reinterpret_cast<const uint32_t*>(b),
               *reinterpret_cast<const uint32_t*>(b + 8));
    }
  }
}

// A fragments (16 rows x 16*KS) from NT accumulator tiles (16 x 8 each)
// through f(value, column, half): the layouts line up, n-tile 2k and 2k+1
// being K step k; missing tiles (K padded to 16) are zero.
template <int KS, int NT, typename F>
__device__ __forceinline__ void to_a(uint32_t (&a)[KS][4],
                                     const float (&v)[NT][4], int lane, F f) {
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nt = 2 * ks + (q >> 1), half = q & 1;
      if (nt < NT) {
        const int col = 8 * nt + 2 * t;
        a[ks][q] = pack_bf16(f(v[nt][2 * half], col, half),
                             f(v[nt][2 * half + 1], col + 1, half));
      } else {
        a[ks][q] = 0u;
      }
    }
}

// --- the stage kernel -------------------------------------------------------

struct Smem {
  unsigned char* x;
  unsigned char* y;
  unsigned char* ring;
  bf16* dwt;
  bf16* w1t;
  bf16* wgt;
  float* vec;
  float* cue;
  uint64_t* bar;  // full[STAGES], empty[STAGES]
};

template <int C>
__device__ __forceinline__ Smem carve(unsigned char* base) {
  using K = Cfg<C>;
  return {base,
          base + K::OFF_Y,
          base + K::OFF_RING,
          reinterpret_cast<bf16*>(base + K::OFF_DW),
          reinterpret_cast<bf16*>(base + K::OFF_W1),
          reinterpret_cast<bf16*>(base + K::OFF_WG),
          reinterpret_cast<float*>(base + K::OFF_VEC),
          reinterpret_cast<float*>(base + K::OFF_CUE),
          reinterpret_cast<uint64_t*>(base + K::OFF_BAR)};
}

// Once per block: the tail's operands. W^T rows (zero where K or N is
// padded) and f32 vectors (zero past their width).
template <int C, bool LAST>
__device__ void load_tail(const Smem& s, const Stage& st,
                          const bf16* __restrict__ fuse_w) {
  using K = Cfg<C>;
  constexpr int CN = K::CN, GP = K::GP, KG = K::KG;
  const bf16 zero = __float2bfloat16(0.0f);
  for (int v = threadIdx.x; v < CN * C; v += blockDim.x) {
    const int n = v / C, k = v % C;
    s.dwt[n * K::LDD + k] = st.d_w[k * CN + n];
  }
  for (int v = threadIdx.x; v < GP * KG; v += blockDim.x) {
    const int n = v / KG, k = v % KG;
    s.w1t[n * K::LDG + k] =
        n < K::G && k < CN ? st.g_w1_ss[k * K::G + n] : zero;
  }
  for (int v = threadIdx.x; v < CN * KG; v += blockDim.x) {
    const int n = v / KG, k = v % KG;
    s.wgt[n * K::LDG + k] = k < CN ? st.g_wg[k * CN + n] : zero;
  }
  float* b1 = s.vec;
  float* b2 = b1 + C;
  float* db = b2 + C;
  float* ass = db + CN;
  float* bss = ass + CN;
  float* w1c = bss + CN;
  float* b1g = w1c + GP;
  float* w2 = b1g + GP;
  float* fuse = w2 + GP;
  float* sc = fuse + 8;
  for (int v = threadIdx.x; v < C; v += blockDim.x) {
    b1[v] = st.r_b1[v];
    b2[v] = st.r_b2[v];
  }
  for (int v = threadIdx.x; v < CN; v += blockDim.x) {
    db[v] = st.d_b[v];
    ass[v] = __bfloat162float(st.g_a_ss[v]);
    bss[v] = __bfloat162float(st.g_b_ss[v]);
  }
  for (int v = threadIdx.x; v < GP; v += blockDim.x) {
    const bool live = v < K::G;
    w1c[v] = live ? st.g_w1_cue[v] : 0.0f;
    b1g[v] = live ? st.g_b1[v] : 0.0f;
    w2[v] = live ? __bfloat162float(st.g_w2[v]) : 0.0f;
  }
  if (threadIdx.x < FUSE_IN)
    fuse[threadIdx.x] = LAST ? __bfloat162float(fuse_w[threadIdx.x]) : 0.0f;
  if (threadIdx.x == 0) {
    sc[0] = *st.g_a_cue;
    sc[1] = *st.g_b_cue;
    sc[2] = *st.g_b2;
    sc[3] = *st.g_a2;
    sc[4] = *st.g_bn2b;
  }
}

struct Tile {
  int img, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int h, int w) {
  const int tx = (w + TW - 1) / TW, ty = (h + TH - 1) / TH;
  const int img = t / (tx * ty), rem = t % (tx * ty);
  return {img, rem / tx * TH, rem % tx * TW};
}

// The bytes of a region row of the packed input: its pixels inside the
// image are one contiguous run of 134-byte records, read as 16-byte chunks
// from `base` (the run starts `skew` bytes into the first).
struct Run {
  const char* base;
  int skew, chunks;
};

__device__ __forceinline__ Run row_run(const bf16* __restrict__ in, Tile tl,
                                       int r, int h, int w) {
  const int c_lo = max(0, 2 - tl.x0), c_hi = min(P, w - tl.x0 + 2);
  const int gy = tl.y0 - 2 + r;
  if (r >= RR || gy < 0 || gy >= h || c_lo >= c_hi) return {nullptr, 0, 0};
  const char* a0 = reinterpret_cast<const char*>(
      in + (((size_t)tl.img * h + gy) * w + tl.x0 - 2 + c_lo) * PACKED);
  const char* base = reinterpret_cast<const char*>(
      reinterpret_cast<uintptr_t>(a0) & ~uintptr_t(15));
  const int skew = static_cast<int>(a0 - base);
  return {base, skew, (skew + (c_hi - c_lo) * PACKED * 2 + 15) / 16};
}

// cp.async of a run into a staging slot, zero past the tensor's end
__device__ __forceinline__ void stage_run(unsigned char* slot, const Run& run,
                                          const bf16* end, int lane) {
  const char* e = reinterpret_cast<const char*>(end);
  for (int k = lane; k < run.chunks; k += 32) {
    const char* a = run.base + 16 * k;
    const long long left = e - a;  // under 16 at the tensor's end
    cp_async16(smem_u32(slot + 16 * k), a, left < 16 ? (int)left : 16);
  }
}

// Region row r of X (and its cues) from a staged run: lane c unpacks the
// record of position c (the first 64 channels and the cue), zero outside
// the image.
__device__ __forceinline__ void unpack_run(const Smem& s, float* cues,
                                           const unsigned char* slot,
                                           const Run& run, Tile tl, int r,
                                           int w, int cue_ch, int lane) {
  const int c_lo = max(0, 2 - tl.x0), c_hi = min(P, w - tl.x0 + 2);
  uint32_t words[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) words[j] = 0u;
  float cue = 0.0f;
  if (run.chunks > 0 && lane >= c_lo && lane < c_hi) {
    const int off = run.skew + (lane - c_lo) * PACKED * 2;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(slot + (off & ~3));
    const uint32_t sh = (off & 3) * 8;
    uint32_t prev = src[0];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t nxt = src[j + 1];
      words[j] = __funnelshift_r(prev, nxt, sh);
      prev = nxt;
    }
    cue = __bfloat162float(
        *reinterpret_cast<const bf16*>(slot + off + 2 * (CUE + cue_ch)));
  }
  const int row = r * P + lane;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    *reinterpret_cast<uint4*>(s.x + k * PLANE_X + row * 16) =
        make_uint4(words[4 * k], words[4 * k + 1], words[4 * k + 2],
                   words[4 * k + 3]);
  cues[row] = cue;
}

// A tile's X and cues come in two steps, so that the copies of the next
// tile overlap the tails of this one. issue_region starts the copies
// (cp.async): stage 0 into its staging slots in y, the other stages
// straight into the planes of X (a pixel's 8 channels are one 16-byte
// chunk of a plane row; zero-filled outside the image), their cues into
// `cue`. finish_region waits for them and writes X (stage 0 unpacks) and
// the cues. Warp cw owns region rows cw and cw + 12, lane c position c.
template <int C, bool FIRST>
__device__ __forceinline__ void issue_region(
    const Smem& s, const bf16* __restrict__ in,
    const bf16* __restrict__ packed, const bf16* packed_end, int cue_ch,
    Tile tl, int h, int w, int cw, int lane, float (&cue)[2]) {
  static_assert(!FIRST || C == 64, "stage 0 unpacks 64 channels");
  if constexpr (FIRST) {
    stage_run(s.y + cw * STAGING, row_run(in, tl, cw, h, w), packed_end,
              lane);
    if (cw + WARPS < SLOTS)
      stage_run(s.y + (cw + WARPS) * STAGING,
                row_run(in, tl, cw + WARPS, h, w), packed_end, lane);
  } else {
    const int gx = tl.x0 - 2 + lane;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = cw + WARPS * rr, gy = tl.y0 - 2 + r;
      if (r >= RR) break;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const size_t pix = ((size_t)tl.img * h + gy) * w + gx;
      const bf16* src = inside ? in + pix * C : in;
#pragma unroll
      for (int k = 0; k < C / 8; ++k)
        cp_async16(smem_u32(s.x + k * PLANE_X + (r * P + lane) * 16),
                   src + 8 * k, inside ? 16 : 0);
      cue[rr] = inside ? __bfloat162float(packed[pix * PACKED + CUE + cue_ch])
                       : 0.0f;
    }
  }
  cp_async_commit();
}

template <int C, bool FIRST>
__device__ __forceinline__ void finish_region(
    const Smem& s, float* cues, const bf16* __restrict__ in,
    const bf16* packed_end, int cue_ch, Tile tl, int h, int w, int cw,
    int lane, const float (&cue)[2]) {
  cp_async_wait_all();
  if constexpr (FIRST) {
    __syncwarp();
    unsigned char* slot = s.y + cw * STAGING;
    unpack_run(s, cues, slot, row_run(in, tl, cw, h, w), tl, cw, w, cue_ch,
               lane);
    const int r = cw + WARPS;
    if (r < SLOTS) {
      unpack_run(s, cues, s.y + r * STAGING, row_run(in, tl, r, h, w), tl, r,
                 w, cue_ch, lane);
    } else if (r < RR) {  // rows 17 .. 19, in this warp's first slot
      const Run run = row_run(in, tl, r, h, w);
      __syncwarp();
      stage_run(slot, run, packed_end, lane);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      unpack_run(s, cues, slot, run, tl, r, w, cue_ch, lane);
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (cw + WARPS * rr < RR) cues[(cw + WARPS * rr) * P + lane] = cue[rr];
  }
}

// The weights' source and how many taps this block consumes in all.
struct Feed {
  const bf16* w1k;
  const bf16* w2k;
  uint32_t total;
};

// Tap g (of this block's sequence) into its ring stage, by one thread.
template <int C>
__device__ __forceinline__ void issue_tap(const Smem& s, const Feed& feed,
                                          uint32_t g) {
  using K = Cfg<C>;
  const int stage = g % K::STAGES, tap = g % TAPS;
  const uint32_t full = smem_u32(s.bar) + 8 * stage;
  mbar_expect_tx(full, K::TAP_BYTES);
  bulk_copy(smem_u32(s.ring) + stage * K::TAP_BYTES,
            (tap < 9 ? feed.w1k : feed.w2k) + (tap % 9) * C * C,
            K::TAP_BYTES, full);
}

// This warp has read tap g's stage. Once every warp has, warp 0 refills
// the stage with tap g + STAGES, whose copy then overlaps the products of
// the taps in between. (ptxas reports this divergent wait as serializing
// the wgmmas (C7518); every thread waiting alike was slower still at
// C = 64, its registers spilling instead.)
template <int C>
__device__ __forceinline__ void release(const Smem& s, const Feed& feed,
                                        uint32_t g, int warp, int lane) {
  using K = Cfg<C>;
  const uint32_t empty = smem_u32(s.bar) + 8 * (K::STAGES + g % K::STAGES);
  if (lane == 0) {
    mbar_arrive(empty);
    if (warp == 0 && g + K::STAGES < feed.total) {
      mbar_wait(empty, (g / K::STAGES) & 1);
      issue_tap<C>(s, feed, g + K::STAGES);
    }
  }
  __syncwarp();
}

// One 3x3 conv: chunks wg, wg + NWG, ... of the NCH 64-row chunks at flat
// positions q0 + 64 * chunk, A from `src` (row 0 = position src_row0), the
// weights of taps g .. g + 8 from the ring. Returns with acc complete.
template <int C, int NCH>
__device__ __forceinline__ void conv_taps(float (&acc)[MAXCH][C / 2],
                                          const Smem& s, const Feed& feed,
                                          uint32_t src, int plane, int row0,
                                          uint32_t& g, int warp, int lane) {
  using K = Cfg<C>;
  const uint32_t full = smem_u32(s.bar);
  const uint32_t ring = smem_u32(s.ring);
  const int wg = warp / 4;
#pragma unroll
  for (int i = 0; i < MAXCH; ++i)
#pragma unroll
    for (int e = 0; e < C / 2; ++e) acc[i][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXCH; ++i) fence_acc(acc[i]);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap, ++g) {
    // resident taps are loaded once: their barriers complete phase 0 only
    const int stage = g % K::STAGES;
    mbar_wait(full + 8 * stage, K::RESIDENT ? 0 : (g / K::STAGES) & 1);
    const int off = (tap / 3 - 1) * P + (tap % 3 - 1);
    const uint32_t b0 = ring + stage * Cfg<C>::TAP_BYTES;
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < MAXCH; ++i) {
      // A chunk past NCH repeats the last one and its result is dropped:
      // a branch around wgmma would make ptxas serialize every wgmma.
      const int ch = min(wg + NWG * i, NCH - 1);
      const uint32_t a0 = src + (row0 + 64 * ch + off) * 16;
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wgmma<C>(acc[i], desc(a0 + 2 * ks * plane, plane),
                 desc(b0 + 2 * ks * C * 16, C * 16));
    }
    wgmma_commit();
    if (!K::RESIDENT && tap > 0) {
      wgmma_wait<1>();  // tap - 1 has read its stage: release it
      release<C>(s, feed, g - 1, warp, lane);
    }
  }
  wgmma_wait<0>();
  if (!K::RESIDENT) release<C>(s, feed, g - 1, warp, lane);
#pragma unroll
  for (int i = 0; i < MAXCH; ++i) fence_acc(acc[i]);
}

// The 1x1 tail on chunks C0 .. C1 - 1 of the warp's 16 conv2 positions
// (chunk c at positions qbase[c] + 0 .. 15), interleaved so that their
// dependency chains overlap: `a` holds their ss (bf16, the A fragments of
// d_i's product), `cues` the tile's cues by region position. Writes the
// Cn-channel output (or the edge in the last stage) of the positions that
// are tile pixels inside the image, in the chunks marked `keep`.
template <int C, bool LAST, int NCH, int C0, int C1>
__device__ __forceinline__ void tails(const Smem& s, const float* cues,
                                      Tile tl, bf16* __restrict__ next,
                                      float* __restrict__ edge, int h, int w,
                                      int lane,
                                      const uint32_t (&a)[NCH][C / 16][4],
                                      const int (&qbase)[NCH],
                                      const bool (&keep)[NCH]) {
  using K = Cfg<C>;
  constexpr int CN = K::CN, GP = K::GP;
  constexpr int KSG = K::KG / 16;
  const float* db = s.vec + 2 * C;
  const float* ass = db + CN;
  const float* bss = ass + CN;
  const float* w1c = bss + CN;
  const float* b1g = w1c + GP;
  const float* w2 = b1g + GP;
  const float* fuse = w2 + GP;
  const float* sc = fuse + 8;
  const int t = lane & 3;
  // d_i
  float d[NCH][CN / 8][4];
#pragma unroll
  for (int c = C0; c < C1; ++c) {
    tail_gemm<C / 16, CN / 8, K::LDD>(d[c], a[c], s.dwt, lane);
#pragma unroll
    for (int nt = 0; nt < CN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[c][nt][e] = bf16r(d[c][nt][e] + db[8 * nt + 2 * t + (e & 1)]);
  }
  // gate_i: g = relu(pre @ W1ss + cue' * w1cue + b1g), alpha per pixel
  float alpha[NCH][2];
  {
    float gacc[NCH][GP / 8][4];
#pragma unroll
    for (int c = C0; c < C1; ++c) {
      uint32_t pa[KSG][4];
      to_a(pa, d[c], lane, [&](float v, int col, int) {
        return bf16r(bf16r(v * ass[col]) + bss[col]);
      });
      tail_gemm<KSG, GP / 8, K::LDG>(gacc[c], pa, s.w1t, lane);
    }
#pragma unroll
    for (int c = C0; c < C1; ++c) {
      float cuep[2], g2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        cuep[hr] = cues[qbase[c] + (lane >> 2) + 8 * hr] * sc[0] + sc[1];
#pragma unroll
      for (int nt = 0; nt < GP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * t + (e & 1), hr = e >> 1;
          g2[hr] += bf16r(fmaxf(gacc[c][nt][e] + cuep[hr] * w1c[col]
                                + b1g[col], 0.0f)) * w2[col];
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        g2[hr] += __shfl_xor_sync(0xffffffffu, g2[hr], 1);
        g2[hr] += __shfl_xor_sync(0xffffffffu, g2[hr], 2);
        alpha[c][hr] = sigmoid(sc[3] * (g2[hr] + sc[2]) + sc[4]);
      }
    }
  }
  // the gate's conv on bf16(ss * (alpha + 1))
  float o[NCH][CN / 8][4];
#pragma unroll
  for (int c = C0; c < C1; ++c) {
    uint32_t ga[KSG][4];
    to_a(ga, d[c], lane, [&](float v, int, int hr) {
      return bf16r(v * (alpha[c][hr] + 1.0f));
    });
    tail_gemm<KSG, CN / 8, K::LDG>(o[c], ga, s.wgt, lane);
  }
#pragma unroll
  for (int c = C0; c < C1; ++c)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int q = qbase[c] + (lane >> 2) + 8 * hr;
      const int qr = q / P, qc = q % P;
      const int gy = tl.y0 + qr - 2, gx = tl.x0 + qc - 2;
      const bool valid = keep[c] && qr < TH + 2 && qc >= 2 && qc < TW + 2
                         && gy < h && gx < w;
      const size_t pix = ((size_t)tl.img * h + gy) * w + gx;
      if (LAST) {
        static_assert(!LAST || CN == FUSE_IN, "fuse takes the last stage");
        float e = bf16r(o[c][0][2 * hr]) * fuse[2 * t]
                  + bf16r(o[c][0][2 * hr + 1]) * fuse[2 * t + 1];
        e += __shfl_xor_sync(0xffffffffu, e, 1);
        e += __shfl_xor_sync(0xffffffffu, e, 2);
        if (valid && t == 0) edge[pix] = bf16r(sigmoid(e));
      } else if (valid) {
#pragma unroll
        for (int nt = 0; nt < CN / 8; ++nt)
          *reinterpret_cast<uint32_t*>(next + pix * CN + 8 * nt + 2 * t) =
              pack_bf16(o[c][nt][2 * hr], o[c][nt][2 * hr + 1]);
      }
    }
}

// One stage. FIRST reads the packed input (67 channels a pixel); the others
// read the previous stage's C-channel output. LAST ends in fuse and the
// sigmoid and writes the edge map; the others write their Cn-channel output
// to `next`.
template <int C, bool FIRST, bool LAST>
__global__ void __launch_bounds__(THREADS, Cfg<C>::BLOCKS)
stage_kernel(const bf16* __restrict__ in, const bf16* __restrict__ packed,
             const bf16* packed_end, const Stage st, int cue_ch,
             const bf16* __restrict__ fuse_w, bf16* __restrict__ next,
             float* __restrict__ edge, int n, int h, int w) {
  using K = Cfg<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve<C>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = n * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  const uint32_t full = smem_u32(s.bar), empty = full + 8 * K::STAGES;

  if (tid == 0) {
    for (int i = 0; i < K::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_tail<C, LAST>(s, st, fuse_w);
  __syncthreads();

  // the first STAGES taps (all 18 where they stay resident); the ring
  // refills as the taps are released (`release`)
  const Feed feed{st.r_w1k, st.r_w2k,
                  TAPS * static_cast<uint32_t>(
                      (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x)};
  if (tid == 0)
    for (uint32_t g = 0; g < K::STAGES && g < feed.total; ++g)
      issue_tap<C>(s, feed, g);

  const int wg = warp / 4, wq = warp % 4;
  const float* b1 = s.vec;
  const float* b2 = b1 + C;
  const uint32_t xs = smem_u32(s.x), ys = smem_u32(s.y);
  uint32_t g = 0;
  float cue[2];
  float* cues = s.cue;  // this tile's; the next tile's go to the other half
  issue_region<C, FIRST>(s, in, packed, packed_end, cue_ch,
                         tile_at(blockIdx.x, h, w), h, w, warp, lane, cue);
  finish_region<C, FIRST>(s, cues, in, packed_end, cue_ch,
                          tile_at(blockIdx.x, h, w), h, w, warp, lane, cue);
  fence_async_smem();
  __syncthreads();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, h, w);

    float acc[MAXCH][C / 2];
    // conv1 -> y: relu(conv + b1), zero outside the image
    conv_taps<C, CH1>(acc, s, feed, xs, PLANE_X, Q1, g, warp, lane);
#pragma unroll
    for (int i = 0; i < MAXCH; ++i) {
      const int ch = wg + NWG * i;
      if (ch >= CH1) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int q = Q1 + 64 * ch + 16 * wq + (lane >> 2) + 8 * hr;
        const int gy = tl.y0 - 2 + q / P, gx = tl.x0 - 2 + q % P;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int o = 8 * j + 2 * (lane & 3);
          const float v0 = fmaxf(acc[i][4 * j + 2 * hr] + b1[o], 0.0f);
          const float v1 = fmaxf(acc[i][4 * j + 2 * hr + 1] + b1[o + 1], 0.0f);
          *reinterpret_cast<uint32_t*>(s.y + j * PLANE_Y + (q - Y0) * 16
                                       + (lane & 3) * 4) =
              inside ? pack_bf16(v0, v1) : 0u;
        }
      }
    }
    fence_async_smem();
    __syncthreads();

    // conv2, then ss = relu(conv + b2 + ss) straight from the accumulators
    // into the A fragments of the tail's first product, and the tail
    conv_taps<C, CH2>(acc, s, feed, ys, PLANE_Y, Q2 - Y0, g, warp, lane);
    uint32_t ss[MAXCH][C / 16][4];
    int qbase[MAXCH];
    bool keep[MAXCH];
#pragma unroll
    for (int i = 0; i < MAXCH; ++i) {
      // the chunk past CH2 repeats the last one (conv_taps) and is dropped
      keep[i] = wg + NWG * i < CH2;
      qbase[i] = Q2 + 64 * min(wg + NWG * i, CH2 - 1) + 16 * wq;
      const int q0 = qbase[i] + (lane >> 2);
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) {
          const int nt = 2 * ks + (qd >> 1), hr = qd & 1;
          const int o = 8 * nt + 2 * (lane & 3);
          const float2 res = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              s.x + nt * PLANE_X + (q0 + 8 * hr) * 16
              + (lane & 3) * 4));
          ss[i][ks][qd] = pack_bf16(
              fmaxf(acc[i][4 * nt + 2 * hr] + b2[o] + res.x, 0.0f),
              fmaxf(acc[i][4 * nt + 2 * hr + 1] + b2[o + 1] + res.y, 0.0f));
        }
    }
    // X and y are read: the next tile's region streams in under the tails
    __syncthreads();
    const bool more = t + gridDim.x < tiles;
    const Tile tn = tile_at(t + gridDim.x, h, w);
    float* next_cues = s.cue + (cues == s.cue ? RR * P : 0);
    if (more)
      issue_region<C, FIRST>(s, in, packed, packed_end, cue_ch, tn, h, w,
                             warp, lane, cue);
    // two chunks interleaved, then the third, where 3 x 64 channels of
    // tail would not fit beside conv2's registers
    constexpr int SPLIT = C == 64 ? 2 : MAXCH;
    tails<C, LAST, MAXCH, 0, SPLIT>(s, cues, tl, next, edge, h, w, lane, ss,
                                    qbase, keep);
    tails<C, LAST, MAXCH, SPLIT, MAXCH>(s, cues, tl, next, edge, h, w, lane,
                                        ss, qbase, keep);
    if (more)
      finish_region<C, FIRST>(s, next_cues, in, packed_end, cue_ch, tn, h, w,
                              warp, lane, cue);
    cues = next_cues;
    fence_async_smem();
    __syncthreads();
  }
}

template <int C, bool FIRST, bool LAST>
cudaError_t launch(cudaStream_t stream, const bf16* in, const bf16* packed,
                   const bf16* packed_end, const Stage& s, int cue_ch,
                   const bf16* fuse_w, bf16* next, float* edge, int n, int h,
                   int w) {
  auto* kernel = stage_kernel<C, FIRST, LAST>;
  // Above 48 KB of dynamic shared memory needs an opt-in, which belongs to
  // the current device; setting it on every call keeps each device right.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<C>::SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, Cfg<C>::SMEM);
  if (err != cudaSuccess) return err;
  // a persistent grid: as many blocks as fit on the card, or one a tile
  const long long tiles =
      (long long)n * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < fit ? tiles : fit);
  kernel<<<grid, THREADS, Cfg<C>::SMEM, stream>>>(
      in, packed, packed_end, s, cue_ch, fuse_w, next, edge, n, h, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" int shape_stream_operands() { return NUM_OPS; }

// packed: (n, h, w, 67) bf16 on a 16-byte boundary. ss1: (n, h, w, 32) and
// ss2: (n, h, w, 16) bf16 scratch. edge: (n, h, w) f32 output. ops:
// 3 * NUM_OPS stage operand pointers in Stage's order, then fuse_w (8,)
// bf16; all contiguous on the device, shapes as fold_shape_stream_params
// makes them.
extern "C" int shape_stream_forward(const void* packed, void* ss1, void* ss2,
                                    float* edge, const void* const* ops,
                                    int n, int h, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Stage s[3];
  for (int i = 0; i < 3; ++i)
    std::memcpy(&s[i], ops + i * NUM_OPS, sizeof(Stage));
  const bf16* fuse_w = static_cast<const bf16*>(ops[3 * NUM_OPS]);
  const bf16* x = static_cast<const bf16*>(packed);
  const bf16* x_end = x + (size_t)n * h * w * PACKED;
  bf16* a = static_cast<bf16*>(ss1);
  bf16* b = static_cast<bf16*>(ss2);
  cudaError_t err = launch<64, true, false>(st, x, x, x_end, s[0], 0,
                                            nullptr, a, nullptr, n, h, w);
  if (err == cudaSuccess)
    err = launch<32, false, false>(st, a, x, x_end, s[1], 1, nullptr, b,
                                   nullptr, n, h, w);
  if (err == cudaSuccess)
    err = launch<16, false, true>(st, b, x, x_end, s[2], 2, fuse_w, nullptr,
                                  edge, n, h, w);
  return static_cast<int>(err);
}
