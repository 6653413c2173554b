// Flat-kc DCNv2 back half for Hopper (sm_90a): blend + contraction over
// gathered corner rows.
//
// Replaces pdf_table_tpu/ops/pallas/deform_blend.py::_blend_matmul_fwd_impl
// (body _kernel): out = ((w4 @ E) * g2) @ wrep with f32 sums, where E is the
// 0/1 channel-expansion matrix that deform_conv2d's tap-chunk branch passes
// (expand_matrix(T*4, Cin): one 1 per column, so (w4 @ E)[p, j] =
// w4[p, j / Cin]). The kernel indexes w4 instead of multiplying by E.
//
// out[p, co] = sum_j bf16(g2[p, j] * w4[p, j / cin]) * wrep[j, co]
//
// Layouts: g2 (Np, kc) bf16 gathered corner rows, corner-major per tap;
// w4 (Np, kc / cin) bf16 lerp x mask weights; wrep (kc, Cout) bf16 tap
// weights replicated over the 4 corners; out (Np, Cout) f32. The blended
// product is rounded to bf16 before the contraction, as the TPU kernel
// does (g_ref * w4e in bf16); products and sums are f32 on the tensor
// cores.
//
// Design: one block per (128 rows, 64 output channels) tile. The block
// walks kc in steps of 32, which divide cin, so each row takes one w4
// value per step. Per step every thread loads 16 bytes of g2 twice,
// scales and rounds them while storing into the (128 x 32) A tile in
// shared memory, and loads 16 bytes of the (32 x 64) wrep step beside it;
// then 8 warps (4 x 2, each 32 x 32) run bf16 -> f32 WMMA 16x16x16
// products. The epilogue goes through a per-warp 16 x 16 staging tile so
// ragged rows and channels are masked.
//
// What bounds it: bytes. At the LORE stride-4 shapes (kc = 1280 or 1024,
// Cout = 64) the kernel reads ~1.3 GB of g2 for 86 GFLOP: ~64 operations
// per byte, far below the ~295 the card needs before the tensor cores
// are the limit. So the design streams g2 once, 16-byte loads, and keeps
// the scaled tile and the accumulators on the SM. The staging is
// synchronous and there is no copy pipeline: at 80 registers a thread
// only 3 blocks of 256 threads fit on an SM, too few to hide the load
// latency, which leaves the kernel at ~2.4x its byte bound. A cp.async or
// TMA pipeline, then wgmma, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;          // rows per block
constexpr int kBN = 64;           // output channels per block
constexpr int kBK = 32;           // kc per step; divides cin
constexpr int kThreads = 256;     // 8 warps: 4 along rows x 2 along channels
constexpr int kLdA = kBK + 8;     // padded shared-memory row strides
constexpr int kLdB = kBN + 8;

__global__ void __launch_bounds__(kThreads)
blend_matmul_kernel(const __nv_bfloat16* __restrict__ g2,
                    const __nv_bfloat16* __restrict__ w4,
                    const __nv_bfloat16* __restrict__ wrep,
                    float* __restrict__ out,
                    int np, int kc, int k4, int cin, int cout) {
  __shared__ __align__(32) __nv_bfloat16 s_a[kBM * kLdA];
  __shared__ __align__(32) __nv_bfloat16 s_b[kBK * kLdB];
  __shared__ __align__(32) float s_c[kThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp & 3;    // rows wr*32 .. +32
  const int wc = warp >> 2;   // channels wc*32 .. +32
  const long long p0 = (long long)blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < kc; k0 += kBK) {
    const int q = k0 / cin;   // the tap-corner column of w4 for this step
    // A: 128 rows x 32 columns = 512 vectors of 8, two per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      const int r = v >> 2;
      const int c = (v & 3) * 8;
      const long long p = p0 + r;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (p < np) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            g2 + p * kc + k0 + c);
        const float w = __bfloat162float(w4[p * k4 + q]);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          // bf16 x bf16 is exact in f32; one rounding to bf16, as on the TPU
          o[e] = __floats2bfloat162_rn(f.x * w, f.y * w);
        }
      }
      *reinterpret_cast<uint4*>(&s_a[r * kLdA + c]) = packed;
    }
    // B: 32 rows x 64 channels = 256 vectors of 8, one per thread
    {
      const int r = tid >> 3;
      const int c = (tid & 7) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (co0 + c < cout)
        u = *reinterpret_cast<const uint4*>(
            wrep + (long long)(k0 + r) * cout + co0 + c);
      *reinterpret_cast<uint4*>(&s_b[r * kLdB + c]) = u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &s_a[(wr * 32 + i * 16) * kLdA + kk],
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &s_b[kk * kLdB + wc * 32 + j * 16],
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each 16 x 16 fragment through the warp's staging tile; lane
  // l writes row l / 2, channels (l % 2) * 8 .. +8
  float* stage = s_c[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long p = p0 + wr * 32 + i * 16 + (lane >> 1);
      const int co = co0 + wc * 32 + j * 16 + (lane & 1) * 8;
      if (p < np && co < cout) {
        const float* src = stage + (lane >> 1) * 16 + (lane & 1) * 8;
        float4* dst = reinterpret_cast<float4*>(out + p * cout + co);
        dst[0] = make_float4(src[0], src[1], src[2], src[3]);
        dst[1] = make_float4(src[4], src[5], src[6], src[7]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Requires cin % 32
// == 0, kc % cin == 0, cout % 8 == 0 and 16-byte aligned g2, wrep and out
// (the wrapper checks).
extern "C" int pdft_blend_matmul_fwd(const void* g2, const void* w4,
                                     const void* wrep, float* out, int np,
                                     int kc, int cin, int cout,
                                     void* stream) {
  if (np <= 0 || cout <= 0) return (int)cudaSuccess;
  if (cin % kBK != 0 || kc % cin != 0 || cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((np + kBM - 1) / kBM),
                  (unsigned)((cout + kBN - 1) / kBN));
  blend_matmul_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g2),
      static_cast<const __nv_bfloat16*>(w4),
      static_cast<const __nv_bfloat16*>(wrep), out, np, kc, kc / cin, cin,
      cout);
  return (int)cudaGetLastError();
}
