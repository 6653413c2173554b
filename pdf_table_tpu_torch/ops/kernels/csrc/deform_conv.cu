// Modulated deformable convolution (DCNv2) forward for Hopper (sm_90a).
//
// Replaces both back halves of pdf_table_tpu/ops/pallas/deform_blend.py
// (_blend_tap_fwd_impl, the tap-major kernel, and _blend_matmul_fwd_impl,
// the flat-kc kernel) AND the XLA quad gather that
// pdf_table_tpu/ops/deform_conv.py runs in front of them. The TPU left the
// gather in XLA only because Mosaic has no per-element gather; here it
// lives in the kernel, as in the reference's CUDA im2col op.
//
// out[p, co] = bias[co] + sum_t A[p, t, :] @ W[t][:, co], sums in f32.
// The sample point is ((h0+oy)*sh - ph + ky*dh + dy, ox*sw - pw + kx*dw +
// dx): ``h0`` is the first output row of the launch's row window, so that a
// launch computes output rows [h0, h0 + Ho) of the DCN over the whole x (a
// row-sharded caller's own rows; 0 and the whole Ho otherwise);
// its four bilinear corners q = (0,0), (0,1), (1,0), (1,1) carry
// w_q = ((lerp_y * lerp_x) * in_bounds_q) * mask, computed with
// non-contracted f32 operations in that order. A corner outside the image
// weighs 0 and is not read. Two roundings, chosen by the route the JAX
// package takes (deform_conv.py::flat_kc_route):
//
// - tap mode (pdft_deform_conv2d_fwd): A[p, t, :] = bf16(sum_q w_q *
//   x[corner_q]), blended in f32, one rounding: the reference op's
//   im2col-then-GEMM with the one rounding a bf16 tensor-core operand
//   needs. The TPU tap kernel instead rounds each corner's product
//   (deform_blend.py:163); that would take 4x the tensor-core work and is
//   no closer to the f32 reference.
// - flat-kc mode (pdft_deform_conv2d_flat_kc_fwd): the TPU flat-kc
//   kernel's arithmetic, A_q[p, t, :] = bf16(bf16(w_q) * x[corner_q]) and
//   out = sum_t sum_q A_q @ W[t]: four A sub-tiles against the same W[t]
//   tile, so the corner-replicated weights and the gathered g2 rows of the
//   TPU route never exist.
//
// Layouts (as pdf_table_tpu.ops.deform_conv.deform_conv2d): x NHWC,
// offset (B, Ho, Wo, 2K) f32 (dy, dx) pairs, mask (B, Ho, Wo, K) f32,
// weight (Kh, Kw, Cin, Cout), bias (Cout) f32 or null, out (B, Ho, Wo,
// Cout) f32. bf16 x and weight take the bf16 tensor-core body below; f32
// (neither TPU kernel takes it; JAX leaves the f32 DCN to XLA) takes the
// f32 body at the end of the file, the same design with the 3xTF32 split
// (tf32 wgmma on hi and lo operands), the column unrounded in f32.
//
// What bounds it: the compulsory bytes (x, offset, mask, W, out) at the
// 64-channel LORE levels, the operations (2 * P * K * Cin * Cout, or 4x
// that in flat-kc mode) at the 256/512-channel ones. What the card spends
// is the gather: every column reads four corner rows from L2/HBM.
//
// Design: a block owns 64 (one warpgroup) or 128 (two) output pixels and a
// tile of N = 64, 128 or 256 output channels, normally all of Cout, so
// each column is gathered once. The K loop walks (tap, 64 input channels):
// one step is one 128-byte swizzle row of bf16, so Cin % 64 == 0. Per tap
// each warpgroup writes its pixels' corner rows and weights to shared
// memory. Per step every thread issues 16-byte loads of the four corners
// of its (pixel, 8 channels), blends or scales them in f32, rounds to bf16
// and stores them into the A stage in the 128B-swizzled K-major layout the
// wgmma descriptor names, then fence.proxy.async. B, the step's W rows,
// is staged once per launch into the same swizzled layout (a small
// pre-pass), so one cp.async.bulk per step lands it in a 4-stage ring,
// completing on an mbarrier. The warpgroup then issues wgmma m64nNk16 on
// the step (4 in tap mode, 16 in flat-kc mode) with f32 accumulators in
// registers and gathers the next step into the other A stage while they
// run. The epilogue adds the bias and writes f32 rows, masking ragged
// pixels and channels. Where a shape gives fewer blocks than SMs, the
// wrapper picks 64-pixel blocks, then splits Cout across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

enum Mode { kTap = 0, kFlatKc = 1 };

constexpr int kStepC = 64;        // input channels per K step
constexpr int kRowsWG = 64;       // output pixels per warpgroup
constexpr int kTileBytes = kRowsWG * kStepC * 2;   // one A (sub-)tile
constexpr int kAStages = 2;
constexpr int kBStages = 4;
constexpr int kMaxSmem = 232448;

struct DcnArgs {
  const __nv_bfloat16* x;
  const float* offset;
  const float* mask;
  const __nv_bfloat16* wtile;   // B tiles: [step][Cout split][N][64]
  const float* bias;
  float* out;
  int B, H, W, Cin, Ho, Wo, Cout, Kh, Kw, sh, sw, ph, pw, dh, dw, h0;
};

__host__ __device__ constexpr int corners_of(int mode) {
  return mode == kFlatKc ? 4 : 1;
}

// dynamic shared memory: alignment slack, A stages, B ring, two per-tap
// corner tables (rows, weights), the B ring's barriers
__host__ __device__ constexpr size_t smem_bytes(int mode, int n, int wgs) {
  return 1024 + (size_t)kAStages * wgs * corners_of(mode) * kTileBytes
      + (size_t)kBStages * n * 128 + 2 * (size_t)wgs * kRowsWG * 32
      + kBStages * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (channels 8c .. 8c+7) of row r in a
// 128B-swizzled K-major tile whose base is 1024-byte aligned.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor of such a tile: start address, leading
// byte offset 1 (unused when swizzled), stride byte offset 1024 (eight
// 128-byte rows), layout 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16)
      | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// one bulk copy global -> shared that completes on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(Pending)
               : "memory");
}

// keeps the compiler from moving accumulator reads across the async
// wgmma region
template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)

// D[64 x N] += A[64 x 16] B[16 x N], A and B K-major in shared memory
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : F16(0), F16(16)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : F16(0), F16(16), F16(32), F16(48)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : F16(0), F16(16), F16(32), F16(48), F16(64), F16(80), F16(96), F16(112)
        : "l"(a), "l"(b), "r"(1));
  }
};

// D[64 x N] (+)= A[64 x 8] B[8 x N] in tf32, A and B K-major in shared
// memory (tf32 takes no transpose); ``scale_d`` 0 ignores D's old value
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : F16(0), F16(16)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : F16(0), F16(16), F16(32), F16(48)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef F16
#undef F4

// Corner rows and weights of pixel ``p`` at tap ``t`` (the rows of the
// four corners in x, 0 where the corner lies outside the image; flat-kc
// mode rounds the weights to bf16, as the TPU route's w4).
template <int MODE, class Args>
__device__ __forceinline__ void corner_table(const Args& a, long long p,
                                             long long P, int t, int4* rows,
                                             float4* wts) {
  int rq[4] = {0, 0, 0, 0};
  float wq[4] = {0.f, 0.f, 0.f, 0.f};
  if (p < P) {
    const int K = a.Kh * a.Kw;
    const long long hw = (long long)a.Ho * a.Wo;
    const int b = (int)(p / hw);
    const int r = (int)(p - b * hw);
    const int oy = r / a.Wo;
    const int ox = r - oy * a.Wo;
    const int ky = t / a.Kw;
    const int kx = t - ky * a.Kw;
    const float* off = a.offset + p * (2 * K) + 2 * t;
    const float sy =
        __fadd_rn((float)((a.h0 + oy) * a.sh - a.ph + ky * a.dh), off[0]);
    const float sx = __fadd_rn((float)(ox * a.sw - a.pw + kx * a.dw), off[1]);
    const float m = a.mask[p * K + t];
    const float y0f = floorf(sy);
    const float x0f = floorf(sx);
    const float wy = __fsub_rn(sy, y0f);
    const float wx = __fsub_rn(sx, x0f);
    const int y0 = (int)y0f;
    const int x0 = (int)x0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int yy = y0 + (q >> 1);
      const int xx = x0 + (q & 1);
      // an in-bounds corner's row is the one the TPU route's wrapped quad
      // stack reads; the others weigh 0
      const bool ok = yy >= 0 && yy < a.H && xx >= 0 && xx < a.W;
      const float ly = (q >> 1) ? wy : __fsub_rn(1.f, wy);
      const float lx = (q & 1) ? wx : __fsub_rn(1.f, wx);
      float w = ok ? __fmul_rn(__fmul_rn(ly, lx), m) : 0.f;
      if (MODE == kFlatKc) w = __bfloat162float(__float2bfloat16_rn(w));
      wq[q] = w;
      rq[q] = ok ? (b * a.H + yy) * a.W + xx : 0;
    }
  }
  *rows = make_int4(rq[0], rq[1], rq[2], rq[3]);
  *wts = make_float4(wq[0], wq[1], wq[2], wq[3]);
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// One warpgroup's A for one step: 64 pixels x 64 channels (x4 corners in
// flat-kc mode). Thread ``tw`` owns channel chunk tw % 8 of pixels
// tw / 8 + 16 i; 8 neighbouring threads read one corner row's 128 bytes.
template <int MODE>
__device__ __forceinline__ void gather_step(const __nv_bfloat16* __restrict__ x,
                                            int Cin, int c0, const int4* rows,
                                            const float4* wts, uint8_t* tile,
                                            int tw) {
  const int j = tw & 7;
  const int c = c0 + j * 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 u[2][4];
    float w[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tw >> 3) + 16 * (2 * h + i);
      const int4 rq = rows[r];
      const float4 wv = wts[r];
      const int rr[4] = {rq.x, rq.y, rq.z, rq.w};
      w[i][0] = wv.x; w[i][1] = wv.y; w[i][2] = wv.z; w[i][3] = wv.w;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        u[i][q] = w[i][q] != 0.f
            ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)rr[q] * Cin + c))
            : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tw >> 3) + 16 * (2 * h + i);
      if (MODE == kTap) {
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float f[8];
          unpack8(u[i][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = __fadd_rn(v[e], __fmul_rn(w[i][q], f[e]));
        }
        *reinterpret_cast<uint4*>(tile + sw128(r, j)) = pack8(v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float f[8];
          unpack8(u[i][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(w[i][q], f[e]);
          *reinterpret_cast<uint4*>(tile + q * kTileBytes + sw128(r, j)) =
              pack8(f);
        }
      }
    }
  }
}

template <int MODE, int N>
__global__ void __launch_bounds__(256, 1)
dcn_wgmma_kernel(const DcnArgs a) {
  constexpr int kCorners = corners_of(MODE);
  extern __shared__ uint8_t smem_raw[];
  const int wgs = blockDim.x / 128;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* s_a = smem;                                   // [stage][wg][q]
  uint8_t* s_b = s_a + kAStages * wgs * kCorners * kTileBytes;
  int4* s_rows = reinterpret_cast<int4*>(s_b + kBStages * N * 128);
  float4* s_wts = reinterpret_cast<float4*>(s_rows + 2 * wgs * kRowsWG);
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_wts + 2 * wgs * kRowsWG);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tw = tid & 127;
  const int K = a.Kh * a.Kw;
  const int cpt = a.Cin / kStepC;          // steps per tap
  const int nk = K * cpt;
  const long long P = (long long)a.B * a.Ho * a.Wo;
  const long long p_wg = (long long)blockIdx.x * (wgs * kRowsWG) + wg * kRowsWG;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const uint32_t b_bytes = N * 128;

  auto load_b = [&](int k) {
    const int s = k % kBStages;
    bulk_load(s_b + s * N * 128,
              a.wtile + ((size_t)k * nsplit + split) * N * kStepC, b_bytes,
              &bars[s]);
  };
  auto a_tile = [&](int stage) {
    return s_a + (stage * wgs + wg) * kCorners * kTileBytes;
  };
  auto table = [&](int t) {
    const int buf = (t & 1) * wgs * kRowsWG + wg * kRowsWG;
    if (tw < kRowsWG)
      corner_table<MODE>(a, p_wg + tw, P, t, &s_rows[buf + tw],
                         &s_wts[buf + tw]);
    wg_barrier(wg);
  };
  auto gather = [&](int k) {
    const int t = k / cpt;
    const int buf = (t & 1) * wgs * kRowsWG + wg * kRowsWG;
    gather_step<MODE>(a.x, a.Cin, (k - t * cpt) * kStepC, s_rows + buf,
                      s_wts + buf, a_tile(k & 1), tw);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kBStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < kBStages && k < nk; ++k) load_b(k);

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  table(0);
  gather(0);
  for (int k = 0; k < nk; ++k) {
    fence_proxy_async();   // this thread's A stores, visible to wgmma
    __syncthreads();       // A[k] complete; every wgmma of step k-2 done
    if (tid == 0 && k >= 2 && k + kBStages - 2 < nk)
      load_b(k + kBStages - 2);   // into the stage step k-2 used
    mbar_wait(&bars[k % kBStages], (k / kBStages) & 1);
    const uint32_t a0 = smem_u32(a_tile(k & 1));
    const uint32_t b0 = smem_u32(s_b + (k % kBStages) * N * 128);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kCorners; ++q)
#pragma unroll
      for (int kk = 0; kk < kStepC / 16; ++kk)
        Wgmma<N>::mma(acc, desc_sw128(a0 + q * kTileBytes + kk * 32),
                      desc_sw128(b0 + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();       // step k-1 done: its A stage is free
    fence_acc(acc);
    if (k + 1 < nk) {
      if ((k + 1) % cpt == 0) table((k + 1) / cpt);
      gather(k + 1);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator fragment: register 4j + i holds row w*16 + lane/4 (+8 for
  // i >= 2), column 8j + 2 (lane % 4) (+1 for odd i)
  const int lane = tw & 31;
  const long long p0 = p_wg + (tw >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int co = split * N + j * 8 + (lane & 3) * 2;
    if (co >= a.Cout) continue;
    const float b0 = a.bias != nullptr ? a.bias[co] : 0.f;
    const float b1 = a.bias != nullptr ? a.bias[co + 1] : 0.f;
    if (p0 < P)
      *reinterpret_cast<float2*>(a.out + p0 * a.Cout + co) =
          make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    if (p0 + 8 < P)
      *reinterpret_cast<float2*>(a.out + (p0 + 8) * a.Cout + co) =
          make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
}

// W (K, Cin, Cout) -> the B tiles the kernel copies per step: for step k
// (tap k / (Cin/64), channels 64 (k % (Cin/64)) ..) and Cout split s, an
// (N x 64) K-major tile in the 128B-swizzled layout, zero past Cout. One
// thread per (step, split, n, 16-byte chunk).
__global__ void stage_weight_kernel(const __nv_bfloat16* __restrict__ w,
                                    __nv_bfloat16* __restrict__ wtile, int K,
                                    int Cin, int Cout, int n, int nsplit) {
  const long long total = (long long)K * (Cin / kStepC) * nsplit * n * 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i & 7);
  const long long row = i >> 3;            // (step, split, n)
  const int nn = (int)(row % n);
  const long long tile = row / n;          // step * nsplit + split
  const int s = (int)(tile % nsplit);
  const long long k = tile / nsplit;       // step: (tap, 64-channel chunk)
  const int co = s * n + nn;
  const long long ci0 = k * kStepC + c * 8;   // row of W viewed (K*Cin, Cout)
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = co < Cout ? w[(ci0 + e) * Cout + co] : __float2bfloat16_rn(0.f);
  uint8_t* dst = reinterpret_cast<uint8_t*>(wtile) + tile * (n * 128)
      + nn * 128 + ((c ^ (nn & 7)) << 4);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

template <int MODE, int N>
cudaError_t launch_wgmma(const DcnArgs& a, int wgs, int nsplit,
                         cudaStream_t s) {
  const size_t smem = smem_bytes(MODE, N, wgs);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      dcn_wgmma_kernel<MODE, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long P = (long long)a.B * a.Ho * a.Wo;
  const long long rows = (long long)wgs * kRowsWG;
  const dim3 grid((unsigned)((P + rows - 1) / rows), (unsigned)nsplit);
  dcn_wgmma_kernel<MODE, N><<<grid, 128 * wgs, smem, s>>>(a);
  return cudaGetLastError();
}

int dcn_bf16(int mode, const void* x, const float* offset, const float* mask,
             const void* weight, const float* bias, float* out, void* wtile,
             int B, int H, int W, int Cin, int Ho, int Wo, int Cout, int Kh,
             int Kw, int sh, int sw, int ph, int pw, int dh, int dw, int h0,
             int n_tile, int wgs, void* stream) {
  const long long P = (long long)B * Ho * Wo;
  if (P <= 0 || Cout <= 0) return (int)cudaSuccess;
  if (Cin % kStepC != 0 || Cout % 8 != 0 || Cout > 256 ||
      (n_tile != 64 && n_tile != 128 && n_tile != 256) ||
      (wgs != 1 && wgs != 2))
    return (int)cudaErrorInvalidValue;
  const int nsplit = (Cout + n_tile - 1) / n_tile;
  const int K = Kh * Kw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)K * (Cin / kStepC) * nsplit * n_tile * 8;
  stage_weight_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(weight),
      static_cast<__nv_bfloat16*>(wtile), K, Cin, Cout, n_tile, nsplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const DcnArgs a{static_cast<const __nv_bfloat16*>(x), offset, mask,
                  static_cast<const __nv_bfloat16*>(wtile), bias, out,
                  B, H, W, Cin, Ho, Wo, Cout, Kh, Kw, sh, sw, ph, pw, dh, dw,
                  h0};
  switch (mode * 1000 + n_tile) {
    case kTap * 1000 + 64: return (int)launch_wgmma<kTap, 64>(a, wgs, nsplit, s);
    case kTap * 1000 + 128: return (int)launch_wgmma<kTap, 128>(a, wgs, nsplit, s);
    case kTap * 1000 + 256: return (int)launch_wgmma<kTap, 256>(a, wgs, nsplit, s);
    case kFlatKc * 1000 + 64: return (int)launch_wgmma<kFlatKc, 64>(a, wgs, nsplit, s);
    case kFlatKc * 1000 + 128: return (int)launch_wgmma<kFlatKc, 128>(a, wgs, nsplit, s);
    case kFlatKc * 1000 + 256: return (int)launch_wgmma<kFlatKc, 256>(a, wgs, nsplit, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32 tensor-core body (3xTF32)
// ---------------------------------------------------------------------------
//
// wgmma takes f32 data only as tf32 (m64nNk8.f32.tf32.tf32, both operands
// K-major in shared memory). One 128-byte swizzle row holds 32 f32
// channels, so a K step is (tap, 32 input channels) and a 16-byte chunk is
// 4 channels; the byte layout, sw128 and desc_sw128 are the bf16 body's,
// and a step is 4 k8 instructions per product. Each operand is split as
// v = hi + lo, hi = tf32_rna(v), lo = tf32_rna(v - hi), and the step
// computes A_lo B_hi + A_hi B_lo + A_hi B_hi (A_lo B_lo, ~2^-22 relative,
// is dropped): f32-class sums from tensor-core products.
//
// A (the columns): the block's threads blend the four corners in f32 as
// the bf16 tap mode does, split the column and store hi and lo into two A
// tiles. B: a pre-pass splits W once per launch into hi and lo tiles,
// 128B-swizzled and K-major; one cp.async.bulk per step lands both in a
// 2-stage ring that completes on an mbarrier, issued one step ahead.
//
// Accuracy: each step's 12 wgmma start from a zeroed accumulator, and the
// step's sum is added to a second f32 accumulator in registers, rounded to
// nearest. The tensor core's own adds into its accumulator are not taken
// to round to nearest: with truncating adds, one accumulator carried over
// all 9 * Cin / 8 * 3 k8 groups would drift past f32's error at the LORE
// depths (576 to 4608); 12 groups a step do not. The two accumulators
// limit a warpgroup to 128 output channels: a block of two warpgroups
// covers 256 channels of 64 pixels, both reading the same A tiles, so each
// column is gathered once for all of Cout up to 256. Where a shape gives
// fewer blocks than SMs, or a contraction deeper than 72 steps, the taps
// run in groups (blockIdx.z), each writing its sum to scratch, and a
// second pass adds the groups and the bias in order: more blocks for the
// small deep levels, and their sums in chains no longer than the others'.
//
// What bounds it: the operations at the three tf32 products' rate (a third
// of 494.7 TFLOP/s) at the 256/512-channel levels, the gather at the
// 64-channel ones: f32 corner rows are twice the bf16 body's bytes, and
// each block also copies 2 * n_tile * 128 bytes of split W a step from L2.

constexpr int kStepF = 32;                          // f32 channels per K step
constexpr int kTileF = kRowsWG * kStepF * 4;        // one A tile, hi or lo
constexpr int kBStagesF = 2;

struct F32Args {
  const float* x;
  const float* offset;
  const float* mask;
  const float* wtile;   // B tiles: [step][Cout split][hi, lo][n_tile][32]
  const float* bias;
  float* out;
  float* work;          // per tap group sums [group][P][Cout] (groups > 1)
  int B, H, W, Cin, Ho, Wo, Cout, Kh, Kw, sh, sw, ph, pw, dh, dw, h0;
  int tap_group;        // taps per group (blockIdx.z)
};

// dynamic shared memory: alignment slack, A stages (hi and lo per 64-pixel
// tile), the B ring (hi and lo), two per-tap corner tables, the barriers
__host__ __device__ constexpr size_t smem_bytes_f32(int n_tile, int wg_m) {
  return 1024 + (size_t)kAStages * wg_m * 2 * kTileF
      + (size_t)kBStagesF * 2 * n_tile * 128
      + 2 * (size_t)wg_m * kRowsWG * 32 + kBStagesF * 8;
}

// v rounded to tf32, to nearest with ties away from zero, low 13 bits 0
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xFFFFE000u);
}

// One step's A for the block: rows (64 per pixel warpgroup) x 32 channels,
// hi and lo. Item i = (pixel i / 8, chunk i % 8); a thread takes items
// tid, tid + nthreads, ... (rows * 8 / nthreads of them, 2 or 4), two at a
// time with their 8 corner loads in flight, 8 neighbouring threads reading
// one corner row's 128 bytes.
__device__ __forceinline__ void gather_step_tf32(
    const float* __restrict__ x, int Cin, int c0, const int4* rows,
    const float4* wts, uint8_t* stage, int items, int tid, int nthreads) {
  const int j = tid & 7;
  const int c = c0 + j * 4;
  for (int base = tid; base < items; base += 2 * nthreads) {
    float4 u[2][4];
    float w[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (base + i * nthreads) >> 3;
      const int4 rq = rows[r];
      const float4 wv = wts[r];
      const int rr[4] = {rq.x, rq.y, rq.z, rq.w};
      w[i][0] = wv.x; w[i][1] = wv.y; w[i][2] = wv.z; w[i][3] = wv.w;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        u[i][q] = w[i][q] != 0.f
            ? __ldg(reinterpret_cast<const float4*>(x + (size_t)rr[q] * Cin + c))
            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (base + i * nthreads) >> 3;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float f[4] = {u[i][q].x, u[i][q].y, u[i][q].z, u[i][q].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = __fadd_rn(v[e], __fmul_rn(w[i][q], f[e]));
      }
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32_rna(v[e]);
        lo[e] = tf32_rna(__fsub_rn(v[e], hi[e]));
      }
      uint8_t* tile = stage + (r >> 6) * 2 * kTileF + sw128(r & 63, j);
      *reinterpret_cast<float4*>(tile) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(tile + kTileF) =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// A block of wg_m x wg_n warpgroups (wg_m * wg_n <= 2) covers wg_m * 64
// output pixels and n_tile = wg_n * NW output channels of Cout split
// blockIdx.y, over the taps of group blockIdx.z; warpgroup wg takes pixel
// tile wg % wg_m and channel slice wg / wg_m. With one group it writes
// out + bias, else its group's sums into ``work``. The 64-channel body
// fits in 128 registers, so two of its blocks share an SM.
template <int NW>
__global__ void __launch_bounds__(256, NW == 64 ? 2 : 1)
dcn_tf32_kernel(const F32Args a, int wg_m) {
  extern __shared__ uint8_t smem_raw[];
  const int nthreads = blockDim.x;
  const int wg_n = nthreads / 128 / wg_m;
  const int n_tile = NW * wg_n;
  const int rows = wg_m * kRowsWG;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* s_a = smem;                                  // [stage][wm][hi, lo]
  uint8_t* s_b = s_a + kAStages * wg_m * 2 * kTileF;    // [stage][hi, lo]
  const uint32_t b_bytes = 2 * n_tile * 128;
  int4* s_rows = reinterpret_cast<int4*>(s_b + kBStagesF * b_bytes);
  float4* s_wts = reinterpret_cast<float4*>(s_rows + 2 * rows);
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_wts + 2 * rows);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tw = tid & 127;
  const int wm = wg % wg_m;
  const int wn = wg / wg_m;
  const int K = a.Kh * a.Kw;
  const int cpt = a.Cin / kStepF;          // steps per tap
  const int t0 = blockIdx.z * a.tap_group;
  const int k0 = t0 * cpt;                 // the group's first step
  const int nk = (min(K, t0 + a.tap_group) - t0) * cpt;
  const long long P = (long long)a.B * a.Ho * a.Wo;
  const long long p0 = (long long)blockIdx.x * rows;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;

  // k counts the group's steps from 0; the tables and W index taps and
  // steps from the kernel's first
  auto load_b = [&](int k) {
    const int s = k % kBStagesF;
    bulk_load(s_b + s * b_bytes,
              a.wtile + ((size_t)(k0 + k) * nsplit + split) * 2 * n_tile
                  * kStepF,
              b_bytes, &bars[s]);
  };
  auto table = [&](int t) {
    const int buf = (t & 1) * rows;
    if (tid < rows)
      corner_table<kTap>(a, p0 + tid, P, t, &s_rows[buf + tid],
                         &s_wts[buf + tid]);
    __syncthreads();
  };
  auto gather = [&](int k) {
    const int t = (k0 + k) / cpt;
    const int buf = (t & 1) * rows;
    gather_step_tf32(a.x, a.Cin, (k0 + k - t * cpt) * kStepF,
                            s_rows + buf, s_wts + buf,
                            s_a + (k & 1) * wg_m * 2 * kTileF, rows * 8, tid,
                            nthreads);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kBStagesF; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < kBStagesF && k < nk; ++k) load_b(k);

  float acc[NW / 2];
  float sum[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = sum[i] = 0.f;

  table(t0);
  gather(0);
  for (int k = 0; k < nk; ++k) {
    fence_proxy_async();   // this thread's A stores, visible to wgmma
    __syncthreads();       // A[k] complete; every wgmma of step k-1 done
    if (tid == 0 && k >= 1 && k + kBStagesF - 1 < nk)
      load_b(k + kBStagesF - 1);   // into the stage step k-1 used
    mbar_wait(&bars[k % kBStagesF], (k / kBStagesF) & 1);
    const uint32_t a_hi = smem_u32(s_a + ((k & 1) * wg_m + wm) * 2 * kTileF);
    const uint32_t a_lo = a_hi + kTileF;
    const uint32_t b_hi =
        smem_u32(s_b + (k % kBStagesF) * b_bytes) + wn * NW * 128;
    const uint32_t b_lo = b_hi + n_tile * 128;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStepF / 8; ++kk)   // the first starts from 0
      WgmmaTf32<NW>::mma(acc, desc_sw128(a_lo + kk * 32),
                         desc_sw128(b_hi + kk * 32), kk);
#pragma unroll
    for (int kk = 0; kk < kStepF / 8; ++kk)
      WgmmaTf32<NW>::mma(acc, desc_sw128(a_hi + kk * 32),
                         desc_sw128(b_lo + kk * 32), 1);
#pragma unroll
    for (int kk = 0; kk < kStepF / 8; ++kk)
      WgmmaTf32<NW>::mma(acc, desc_sw128(a_hi + kk * 32),
                         desc_sw128(b_hi + kk * 32), 1);
    wgmma_commit();
    if (k + 1 < nk) {      // gathered while the step's wgmma run
      if ((k0 + k + 1) % cpt == 0) table((k0 + k + 1) / cpt);
      gather(k + 1);
    }
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
  }

  // accumulator fragment as in the bf16 body
  const int lane = tw & 31;
  const long long q0 = p0 + wm * kRowsWG + (tw >> 5) * 16 + (lane >> 2);
  const bool pairs = (a.Cout & 1) == 0;
  const bool whole = gridDim.z == 1;
  float* dst = whole ? a.out : a.work + blockIdx.z * P * a.Cout;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int co = split * n_tile + wn * NW + j * 8 + (lane & 3) * 2;
    if (co >= a.Cout) continue;
    const bool two = co + 1 < a.Cout;
    const float b0 = whole && a.bias != nullptr ? a.bias[co] : 0.f;
    const float b1 = whole && a.bias != nullptr && two ? a.bias[co + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = q0 + 8 * h;
      if (p >= P) continue;
      float* o = dst + p * a.Cout + co;
      const float v0 = sum[4 * j + 2 * h] + b0;
      const float v1 = sum[4 * j + 2 * h + 1] + b1;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (two) o[1] = v1;
      }
    }
  }
}

// W (K, Cin, Cout) -> the B tiles the f32 body copies per step: for step k
// (tap k / (Cin/32), channels 32 (k % (Cin/32)) ..) and Cout split s, the
// hi tile and then the lo tile, each (n x 32) K-major and 128B-swizzled,
// zero past Cout. One thread per (step, split, 16-byte chunk, n), n
// fastest, so a warp reads 32 neighbouring output channels.
__global__ void stage_weight_tf32_kernel(const float* __restrict__ w,
                                         float* __restrict__ wtile, int K,
                                         int Cin, int Cout, int n,
                                         int nsplit) {
  const long long total = (long long)K * (Cin / kStepF) * nsplit * 8 * n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int nn = (int)(i % n);
  const long long r = i / n;
  const int c = (int)(r & 7);
  const long long tile = r >> 3;           // step * nsplit + split
  const int s = (int)(tile % nsplit);
  const long long k = tile / nsplit;       // step: (tap, 32-channel chunk)
  const int co = s * n + nn;
  const long long ci0 = k * kStepF + c * 4;   // row of W viewed (K*Cin, Cout)
  float hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = co < Cout ? w[(ci0 + e) * Cout + co] : 0.f;
    hi[e] = tf32_rna(v);
    lo[e] = tf32_rna(__fsub_rn(v, hi[e]));
  }
  uint8_t* dst = reinterpret_cast<uint8_t*>(wtile) + tile * (2 * n * 128)
      + nn * 128 + ((c ^ (nn & 7)) << 4);
  *reinterpret_cast<float4*>(dst) = make_float4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<float4*>(dst + n * 128) =
      make_float4(lo[0], lo[1], lo[2], lo[3]);
}

// out = (work[0] + work[1] + ...) + bias, the tap groups in order
__global__ void reduce_tf32_kernel(const float* __restrict__ work,
                                   const float* __restrict__ bias,
                                   float* __restrict__ out, long long n,
                                   int Cout, int groups) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = work[i];
  for (int g = 1; g < groups; ++g) v = __fadd_rn(v, work[g * n + i]);
  out[i] = bias != nullptr ? __fadd_rn(v, bias[i % Cout]) : v;
}

template <int NW>
cudaError_t launch_tf32(const F32Args& a, int wg_m, int wg_n, int nsplit,
                        int groups, cudaStream_t s) {
  const size_t smem = smem_bytes_f32(NW * wg_n, wg_m);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      dcn_tf32_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long P = (long long)a.B * a.Ho * a.Wo;
  const long long rows = (long long)wg_m * kRowsWG;
  const dim3 grid((unsigned)((P + rows - 1) / rows), (unsigned)nsplit,
                  (unsigned)groups);
  dcn_tf32_kernel<NW><<<grid, 128 * wg_m * wg_n, smem, s>>>(a, wg_m);
  return cudaGetLastError();
}

// n_tile 64 or 128: one warpgroup per 64 pixels (wgs of them); n_tile 256:
// two warpgroups on 64 pixels (wgs must be 1). The taps run in groups of
// tap_group, one blockIdx.z each; more than one group needs ``work``
// scratch of groups * P * Cout f32.
int dcn_f32(const void* x, const float* offset, const float* mask,
            const void* weight, const float* bias, float* out, void* wtile,
            void* work, int B, int H, int W, int Cin, int Ho, int Wo,
            int Cout, int Kh, int Kw, int sh, int sw, int ph, int pw, int dh,
            int dw, int h0, int n_tile, int wgs, int tap_group,
            void* stream) {
  const long long P = (long long)B * Ho * Wo;
  if (P <= 0 || Cout <= 0) return (int)cudaSuccess;
  const int K = Kh * Kw;
  const int wg_n = n_tile == 256 ? 2 : 1;
  const int groups = tap_group > 0 ? (K + tap_group - 1) / tap_group : 0;
  if (Cin % kStepF != 0 ||
      (n_tile != 64 && n_tile != 128 && n_tile != 256) ||
      (wgs != 1 && wgs != 2) || wgs * wg_n > 2 || groups < 1 ||
      (groups > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nsplit = (Cout + n_tile - 1) / n_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)K * (Cin / kStepF) * nsplit * 8 * n_tile;
  stage_weight_tf32_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(weight), static_cast<float*>(wtile), K, Cin,
      Cout, n_tile, nsplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const F32Args a{static_cast<const float*>(x), offset, mask,
                  static_cast<const float*>(wtile), bias, out,
                  static_cast<float*>(work), B, H, W, Cin, Ho, Wo, Cout, Kh,
                  Kw, sh, sw, ph, pw, dh, dw, h0, tap_group};
  e = n_tile == 64 ? launch_tf32<64>(a, wgs, wg_n, nsplit, groups, s)
                   : launch_tf32<128>(a, wgs, wg_n, nsplit, groups, s);
  if (e != cudaSuccess || groups == 1) return (int)e;
  const long long n = P * Cout;
  reduce_tf32_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(work), bias, out, n, Cout, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// Tap mode. dtype: 0 = float32 (the 3xTF32 tensor-core body: Cin % 32 ==
// 0, any Cout, n_tile in {64, 128, 256}, wgs in {1, 2} and 1 with n_tile
// 256, ``wtile`` scratch of 2*Kh*Kw*Cin*ceil(Cout/n_tile)*n_tile f32 for
// the split weights, taps in groups of tap_group >= 1 and, with more than
// one group, ``work`` scratch of groups*B*Ho*Wo*Cout f32), 1 = bfloat16
// (the bf16 tensor-core body; Cin % 64 == 0, Cout % 8 == 0, Cout <= 256,
// n_tile in {64, 128, 256}, wgs in {1, 2}, ``wtile`` scratch of
// Kh*Kw*Cin*ceil(Cout/n_tile)*n_tile bf16 for the staged weights; work and
// tap_group unused). Ho is the row window's height and h0 its first output
// row (0 and the whole Ho for the whole DCN). x must be 16-byte aligned.
// Returns the cudaError_t of the launch.
extern "C" int pdft_deform_conv2d_fwd(
    const void* x, const float* offset, const float* mask, const void* weight,
    const float* bias, float* out, void* wtile, void* work, int dtype, int B,
    int H, int W, int Cin, int Ho, int Wo, int Cout, int Kh, int Kw, int sh,
    int sw, int ph, int pw, int dh, int dw, int h0, int n_tile, int wgs,
    int tap_group, void* stream) {
  if (dtype == 1)
    return dcn_bf16(kTap, x, offset, mask, weight, bias, out, wtile, B, H, W,
                    Cin, Ho, Wo, Cout, Kh, Kw, sh, sw, ph, pw, dh, dw, h0,
                    n_tile, wgs, stream);
  if (dtype == 0)
    return dcn_f32(x, offset, mask, weight, bias, out, wtile, work, B, H, W,
                   Cin, Ho, Wo, Cout, Kh, Kw, sh, sw, ph, pw, dh, dw, h0,
                   n_tile, wgs, tap_group, stream);
  return (int)cudaErrorInvalidValue;
}

// Flat-kc mode: bf16 only, the same arguments and constraints as the bf16
// tap mode.
extern "C" int pdft_deform_conv2d_flat_kc_fwd(
    const void* x, const float* offset, const float* mask, const void* weight,
    const float* bias, float* out, void* wtile, int B, int H, int W, int Cin,
    int Ho, int Wo, int Cout, int Kh, int Kw, int sh, int sw, int ph, int pw,
    int dh, int dw, int h0, int n_tile, int wgs, void* stream) {
  return dcn_bf16(kFlatKc, x, offset, mask, weight, bias, out, wtile, B, H,
                  W, Cin, Ho, Wo, Cout, Kh, Kw, sh, sw, ph, pw, dh, dw, h0,
                  n_tile, wgs, stream);
}
