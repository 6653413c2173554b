// Modulated deformable convolution (DCNv2) forward for Hopper (sm_90a).
//
// Replaces pdf_table_tpu/ops/pallas/deform_blend.py::blend_matmul_tap (the
// tap-major Pallas back half: corner blend x modulation, implicit im2col and
// the per-tap contraction) AND the XLA quad gather that
// pdf_table_tpu/ops/deform_conv.py runs around it. The TPU left the gather in
// XLA only because Mosaic has no per-element gather; here it moves into the
// kernel, as the reference's CUDA im2col op did.
//
// out[p, co] = bias[co] + sum_t sum_ci col[p, t, ci] * W[t, ci, co]
// col[p, t, ci] = mask[p, t] * sum_q w_q(p, t) * x[corner_q(p, t), ci]
// with the sample point (oy*sh - ph + ky*dh + dy, ox*sw - pw + kx*dw + dx),
// its four bilinear corners, and a zero for every corner outside the image.
//
// Layouts (as pdf_table_tpu.ops.deform_conv.deform_conv2d): x NHWC (T),
// offset (B, Ho, Wo, 2K) f32 (dy, dx) pairs, mask (B, Ho, Wo, K) f32,
// weight (Kh, Kw, Cin, Cout) (T), bias (Cout) f32 or null, out (B, Ho, Wo,
// Cout) f32. T is float or __nv_bfloat16; sums are f32 either way.
//
// Design: one block per (64 output pixels, 64 output channels). The block
// walks the K taps and, inside each tap, Cin in chunks of 32. Per tap, 64
// threads compute the four corner rows and blend weights of their pixel
// into shared memory. Per chunk, every thread gathers 8 channels of one
// pixel from the four corners (16-byte loads in bf16), blends them in f32
// and writes them into the (32 x 64) column tile; the block stages the
// matching (32 x 64) slice of W[t] beside it; then each thread adds a
// 4 x 4 register tile of products. Nothing but the output leaves the SM.
//
// What bounds it: against the card's peaks, the compulsory bytes (x, offset,
// mask, W, out) and the operations (2*HW*9*Cin*Cout at the bf16 tensor-core
// rate) are of one order at LORE's shapes: bytes bound the 64-channel
// levels, operations the 256- and 512-channel ones. This first version runs
// the contraction as f32 FMAs on the CUDA cores (67 TFLOP/s at most) and
// re-gathers the column tile for every 64-channel output tile, so FMA issue
// bounds it, far above either. Moving the contraction onto wgmma with
// TMA-fed W tiles and an async-copy pipeline for the gather is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockP = 64;    // output pixels per block
constexpr int kBlockCo = 64;   // output channels per block
constexpr int kChunkC = 32;    // input channels per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kVec = 8;        // channels one thread gathers per corner

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_conv_fwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ offset,
                       const float* __restrict__ mask,
                       const T* __restrict__ weight,
                       const float* __restrict__ bias,
                       float* __restrict__ out,
                       int B, int H, int W, int Cin, int Ho, int Wo, int Cout,
                       int Kh, int Kw, int sh, int sw, int ph, int pw,
                       int dh, int dw) {
  __shared__ int s_row[4][kBlockP];      // corner pixel row in x, per tap
  __shared__ float s_w[4][kBlockP];      // blend weight x mask x in-bounds
  __shared__ __align__(16) float s_col[kChunkC][kBlockP];
  __shared__ __align__(16) float s_wt[kChunkC][kBlockCo];

  const int tid = threadIdx.x;
  const int K = Kh * Kw;
  const long long P = (long long)B * Ho * Wo;
  const long long p0 = (long long)blockIdx.x * kBlockP;
  const int co0 = blockIdx.y * kBlockCo;
  const int tx = tid & 15;   // output channels tx*4 .. tx*4+3
  const int ty = tid >> 4;   // output pixels ty*4 .. ty*4+3
  const int gp = tid & (kBlockP - 1);   // gather role: pixel
  const int gv = tid >> 6;              // gather role: 8-channel slice

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < K; ++t) {
    if (tid < kBlockP) {
      const long long p = p0 + tid;
      float wq[4] = {0.f, 0.f, 0.f, 0.f};
      int rq[4] = {0, 0, 0, 0};
      if (p < P) {
        const int b = (int)(p / ((long long)Ho * Wo));
        const int r = (int)(p - (long long)b * Ho * Wo);
        const int oy = r / Wo;
        const int ox = r - oy * Wo;
        const int ky = t / Kw;
        const int kx = t - ky * Kw;
        const float* off = offset + p * (2 * K) + 2 * t;
        const float sy = (float)(oy * sh - ph + ky * dh) + off[0];
        const float sx = (float)(ox * sw - pw + kx * dw) + off[1];
        const float m = mask[p * K + t];
        const float y0f = floorf(sy);
        const float x0f = floorf(sx);
        const float wy = sy - y0f;
        const float wx = sx - x0f;
        const int y0 = (int)y0f;
        const int x0 = (int)x0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int yy = y0 + (q >> 1);
          const int xx = x0 + (q & 1);
          const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
          const float w = ((q >> 1) ? wy : 1.f - wy) *
                          ((q & 1) ? wx : 1.f - wx) * m;
          wq[q] = ok ? w : 0.f;
          rq[q] = ok ? (b * H + yy) * W + xx : 0;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_w[q][tid] = wq[q];
        s_row[q][tid] = rq[q];
      }
    }
    __syncthreads();

    const T* wtap = weight + (size_t)t * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += kChunkC) {
      // gather + blend one (pixel, 8 channels) slice of the column tile
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = 0.f;
      const int c = c0 + gv * kVec;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = s_w[q][gp];
        if (w != 0.f) {
          float g[kVec];
          load8(x + (size_t)s_row[q][gp] * Cin + c, g);
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[j] = fmaf(w, g[j], v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) s_col[gv * kVec + j][gp] = v[j];
      // stage W[t][c0:c0+32][co0:co0+64]
#pragma unroll
      for (int i = 0; i < (kChunkC * kBlockCo) / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int k = e / kBlockCo;
        const int co = e - k * kBlockCo;
        s_wt[k][co] = (co0 + co < Cout)
            ? to_f32(wtap[(size_t)(c0 + k) * Cout + co0 + co]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kChunkC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&s_col[k][ty * 4]);
        const float4 bw = *reinterpret_cast<const float4*>(&s_wt[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < Cout)
        out[p * Cout + co] = acc[i][j] + (bias != nullptr ? bias[co] : 0.f);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and weight). Returns the cudaError_t of
// the launch (0 on success). Requires Cin % 32 == 0 and 16-byte aligned x.
extern "C" int pdft_deform_conv2d_fwd(
    const void* x, const float* offset, const float* mask, const void* weight,
    const float* bias, float* out, int dtype, int B, int H, int W, int Cin,
    int Ho, int Wo, int Cout, int Kh, int Kw, int sh, int sw, int ph, int pw,
    int dh, int dw, void* stream) {
  const long long P = (long long)B * Ho * Wo;
  if (P <= 0 || Cout <= 0) return (int)cudaSuccess;
  if (Cin % kChunkC != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((P + kBlockP - 1) / kBlockP),
                  (unsigned)((Cout + kBlockCo - 1) / kBlockCo));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    deform_conv_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), offset, mask,
        static_cast<const float*>(weight), bias, out, B, H, W, Cin, Ho, Wo,
        Cout, Kh, Kw, sh, sw, ph, pw, dh, dw);
  } else if (dtype == 1) {
    deform_conv_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), offset, mask,
        static_cast<const __nv_bfloat16*>(weight), bias, out, B, H, W, Cin,
        Ho, Wo, Cout, Kh, Kw, sh, sw, ph, pw, dh, dw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
