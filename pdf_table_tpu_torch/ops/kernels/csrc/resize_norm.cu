// Fused bilinear resize + per-channel normalize of uint8 canvases, for
// Hopper (sm_90a).
//
// Replaces pdf_table_tpu/ops/pallas/resize_norm.py:61
// (resize_normalize_pallas, body _kernel :45), which runs the separable
// resize as two dense MXU matmuls Wy @ img @ Wx^T with bf16 operands because
// Mosaic has no gather. Here each output pixel reads its 2x2 source taps
// directly: the nonzeros of Wy and Wx.
//
// out[n, o, p, c] = (v * scale - mean[c]) / std[c]
// v = sum over (i, j) in {y0, y1} x {x0, x1} of wy_i * wx_j * img[n, i, j, c']
// with c' = 2 - c when reverse (RGB -> BGR) else c, and per-axis tap tables
// built once on the host (resize_norm.py::resize_taps): half-pixel source
// coordinate clamped to [0, in - 1], i1 = min(i0 + 1, in - 1), weight f on
// i1 and 1 - f on i0.
//
// Layouts: img (N, H, W, 3) uint8 NHWC, out (N, Ho, Wo, 3) f32 NHWC,
// ytaps (Ho, 2) int32, yfrac (Ho) f32, xtaps (Wo, 2) int32, xfrac (Wo) f32.
//
// What bounds it: bytes. Per output pixel it does about 60 f32 operations
// against 12 bytes written and ~4 read, some 4 per byte where the card's
// f32 rate over its memory rate is 20, and every source byte is read about
// once (downscale), so at the main
// shape (8 canvases 1280x960 -> 960x720) the compulsory traffic is 29.5 MB
// of uint8 in and 66.4 MB of f32 out: ~0.029 ms at 3.35 TB/s. The design
// keeps everything but the output out of device memory: no f32 copy of the
// canvas, no intermediate row pass. One thread per output pixel (all three
// channels): a warp covers 32 neighbouring output pixels of one row, so
// its 12 byte loads per thread fall on a few neighbouring 128-byte lines
// of two source rows, and its three 4-byte stores per thread write 384
// contiguous bytes. Wider (16-byte) stores and loads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;  // output columns per block
constexpr int kBlockY = 8;   // output rows per block

struct Norm {
  float scale;
  float mean[3];
  float std[3];
};

__global__ void __launch_bounds__(kBlockX * kBlockY)
resize_normalize_kernel(const uint8_t* __restrict__ img,
                        float* __restrict__ out,
                        const int2* __restrict__ ytaps,
                        const float* __restrict__ yfrac,
                        const int2* __restrict__ xtaps,
                        const float* __restrict__ xfrac, int H, int W, int Ho,
                        int Wo, Norm norm, int reverse) {
  const int p = blockIdx.x * kBlockX + threadIdx.x;  // output column
  const int o = blockIdx.y * kBlockY + threadIdx.y;  // output row
  const int n = blockIdx.z;
  if (p >= Wo || o >= Ho) return;

  const int2 ty = __ldg(ytaps + o);
  const int2 tx = __ldg(xtaps + p);
  const float fy = __ldg(yfrac + o);
  const float fx = __ldg(xfrac + p);
  const long long plane = (long long)n * H * W;
  const uint8_t* r0 = img + (plane + (long long)ty.x * W) * 3;
  const uint8_t* r1 = img + (plane + (long long)ty.y * W) * 3;
  const int c0 = tx.x * 3, c1 = tx.y * 3;
  float* dst = out + (((long long)n * Ho + o) * Wo + p) * 3;

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int s = reverse ? 2 - c : c;
    const float a00 = __ldg(r0 + c0 + s) * norm.scale;
    const float a01 = __ldg(r0 + c1 + s) * norm.scale;
    const float a10 = __ldg(r1 + c0 + s) * norm.scale;
    const float a11 = __ldg(r1 + c1 + s) * norm.scale;
    // rows first, then columns: the order of the plain version's einsums
    const float left = (1.f - fy) * a00 + fy * a10;
    const float right = (1.f - fy) * a01 + fy * a11;
    const float v = (1.f - fx) * left + fx * right;
    dst[c] = (v - norm.mean[c]) / norm.std[c];
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). mean/std are per
// output channel (after the optional channel reversal).
extern "C" int pdft_resize_normalize(
    const uint8_t* img, float* out, const int* ytaps, const float* yfrac,
    const int* xtaps, const float* xfrac, int N, int H, int W, int Ho, int Wo,
    float scale, float m0, float m1, float m2, float s0, float s1, float s2,
    int reverse, void* stream) {
  if (N <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaSuccess;
  if (H <= 0 || W <= 0 || N > 65535 || (Ho + kBlockY - 1) / kBlockY > 65535)
    return (int)cudaErrorInvalidValue;
  const Norm norm = {scale, {m0, m1, m2}, {s0, s1, s2}};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((Wo + kBlockX - 1) / kBlockX, (Ho + kBlockY - 1) / kBlockY,
                  N);
  resize_normalize_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      img, out, reinterpret_cast<const int2*>(ytaps), yfrac,
      reinterpret_cast<const int2*>(xtaps), xfrac, H, W, Ho, Wo, norm,
      reverse);
  return (int)cudaGetLastError();
}
