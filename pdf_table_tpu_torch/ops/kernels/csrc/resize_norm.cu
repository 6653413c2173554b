// Fused bilinear resize + per-channel normalize of uint8 canvases, for
// Hopper (sm_90a).
//
// Replaces pdf_table_tpu/ops/pallas/resize_norm.py:61
// (resize_normalize_pallas, body _kernel :45), which runs the separable
// resize as two dense MXU matmuls Wy @ img @ Wx^T with bf16 operands because
// Mosaic has no gather. Here each output value reads its 2x2 source taps
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
// What bounds it: bytes. Per output value it does about 25 instructions
// against 4 bytes written and ~1.3 read, and every source byte is needed
// about once (downscale), so at the main shape (8 canvases 1280x960 ->
// 960x720) the compulsory traffic is 29.5 MB of uint8 in and 66.4 MB of
// f32 out: ~0.029 ms at 3.35 TB/s. Nothing but the output goes to device
// memory: no f32 copy of the canvas, no intermediate row pass. What then
// decides the time is the number of memory instructions, so there are two
// bodies:
//
// - the vector body (resize_normalize_vec_kernel). A block owns a tile of
//   kVecRows output rows x 128 output pixels. It copies the source rows
//   and the byte span that the tile's taps reach into shared memory with
//   16-byte cp.async (the span's start is rounded down and its end up to
//   16 bytes; canvas rows are W * 3 bytes, a multiple of 16, so every copy
//   is aligned and stays inside its row). A thread then owns one float4 of
//   an output row: four consecutive values, which lie in two neighbouring
//   pixels. It keeps their tap offsets, weights and normalize constants in
//   registers, walks the tile's rows, reads its 16 taps a row as bytes
//   from shared memory and writes one 16-byte store, so a warp's store
//   instruction covers 512 contiguous bytes. The normalize is one
//   multiply-add with scale / std and -mean / std folded on the host.
//   Tiles of 8 to 64 rows with 1 to 8 thread rows were timed on an NVIDIA
//   H100 80GB HBM3 at 700 W: few threads that each walk many rows (192 a
//   block, 8 rows each) came out 10 % ahead of 384 or 768 threads, and
//   taller tiles lose at the larger canvases, whose source span grows
//   with the downscale. It
//   takes shapes with Wo % 4 == 0, W % 16 == 0, 16-byte aligned tensors
//   and a tile span that fits kVecSmemMax (resize_norm.py::vector_tile).
// - the scalar body (resize_normalize_kernel) for every other shape: one
//   thread per output pixel, twelve 1-byte loads from device memory, three
//   4-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;  // scalar body: output columns per block
constexpr int kBlockY = 8;   // scalar body: output rows per block

constexpr int kVecQuads = 96;  // float4s of an output row per block: 128 px
constexpr int kVecPixels = kVecQuads * 4 / 3;
constexpr int kVecRows = 16;   // output rows per block
constexpr int kVecTy = 2;      // thread rows; a thread walks kVecRows / kVecTy
constexpr int kVecSmemMax = 48 * 1024;  // a block's shared memory with no opt-in

struct Norm {
  float scale;
  float mean[3];
  float std[3];
};

// out = v * a[c] + b[c], with v blended from the raw bytes
struct Affine {
  float a[3];
  float b[3];
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// A byte as f32, exactly: 2^23 + b has b in its low mantissa bits.
__device__ __forceinline__ float byte_to_float(uint8_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.f;
}

__device__ __forceinline__ float pick3(const float (&v)[3], int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

__global__ void __launch_bounds__(kVecQuads * kVecTy)
resize_normalize_vec_kernel(const uint8_t* __restrict__ img,
                            float* __restrict__ out,
                            const int2* __restrict__ ytaps,
                            const float* __restrict__ yfrac,
                            const int2* __restrict__ xtaps,
                            const float* __restrict__ xfrac, int H, int W,
                            int Ho, int Wo, int pitch, Affine aff,
                            int reverse) {
  extern __shared__ __align__(16) uint8_t tile[];
  const int n = blockIdx.z;
  const int o0 = blockIdx.y * kVecRows;
  const int o1 = min(o0 + kVecRows, Ho);
  const int p0 = blockIdx.x * kVecPixels;
  const int p1 = min(p0 + kVecPixels, Wo);

  // the source rows and the byte span of a row that the tile's taps reach
  // (the tables are non-decreasing)
  const int y_lo = __ldg(ytaps + o0).x;
  const int rows = __ldg(ytaps + o1 - 1).y - y_lo + 1;
  const int b_lo = (__ldg(xtaps + p0).x * 3) & ~15;
  const int chunks = ((__ldg(xtaps + p1 - 1).y * 3 + 3 + 15 - b_lo) >> 4);
  const long long row_bytes = (long long)W * 3;
  const uint8_t* src = img + ((long long)n * H + y_lo) * row_bytes + b_lo;
  const int tid = threadIdx.y * kVecQuads + threadIdx.x;
  for (int i = tid; i < rows * chunks; i += kVecQuads * kVecTy) {
    const int r = i / chunks, c = i - r * chunks;
    cp_async16(tile + r * pitch + c * 16, src + r * row_bytes + c * 16);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // this thread's float4: values f0 .. f0 + 3 of an output row; value f is
  // channel f % 3 of pixel f / 3, so they lie in pixels pa and pa + 1
  const int f0 = (blockIdx.x * kVecQuads + threadIdx.x) * 4;
  if (f0 >= Wo * 3) return;
  const int pa = f0 / 3, ca = f0 - pa * 3;
  int off0[4], off1[4];
  float fx[4], gx[4], mul[4], add[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int wrap = ca + k >= 3;
    const int c = ca + k - 3 * wrap;
    const int p = pa + wrap;
    const int s = reverse ? 2 - c : c;
    const int2 tx = __ldg(xtaps + p);
    off0[k] = tx.x * 3 + s - b_lo;
    off1[k] = tx.y * 3 + s - b_lo;
    fx[k] = __ldg(xfrac + p);
    gx[k] = 1.f - fx[k];
    mul[k] = pick3(aff.a, c);
    add[k] = pick3(aff.b, c);
  }

  float* dst = out + ((long long)n * Ho * Wo) * 3 + f0;
  for (int o = o0 + threadIdx.y; o < o1; o += kVecTy) {
    const int2 ty = __ldg(ytaps + o);
    const float fy = __ldg(yfrac + o), gy = 1.f - fy;
    const uint8_t* r0 = tile + (ty.x - y_lo) * pitch;
    const uint8_t* r1 = tile + (ty.y - y_lo) * pitch;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // rows first, then columns: the order of the plain version's einsums
      const float left = gy * byte_to_float(r0[off0[k]]) +
                         fy * byte_to_float(r1[off0[k]]);
      const float right = gy * byte_to_float(r0[off1[k]]) +
                          fy * byte_to_float(r1[off1[k]]);
      v[k] = fmaf(gx[k] * left + fx[k] * right, mul[k], add[k]);
    }
    *reinterpret_cast<float4*>(dst + (long long)o * Wo * 3) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success). mean/std and
// a/b are per output channel (after the optional channel reversal).

// The scalar body: any shape.
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

// The vector body: out = blend(bytes) * a[c] + b[c]. ``pitch`` (bytes, a
// multiple of 16) and ``tile_rows`` bound every tile's source span; the
// wrapper computes them from the tap tables and checks the shape rule.
extern "C" int pdft_resize_normalize_vec(
    const uint8_t* img, float* out, const int* ytaps, const float* yfrac,
    const int* xtaps, const float* xfrac, int N, int H, int W, int Ho, int Wo,
    int pitch, int tile_rows, float a0, float a1, float a2, float b0,
    float b1, float b2, int reverse, void* stream) {
  if (N <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaSuccess;
  const long long smem = (long long)pitch * tile_rows;
  if (H <= 0 || W <= 0 || N > 65535 ||
      (Ho + kVecRows - 1) / kVecRows > 65535 || Wo % 4 != 0 || W % 16 != 0 ||
      pitch <= 0 || pitch % 16 != 0 || tile_rows <= 0 ||
      smem > kVecSmemMax || ((uintptr_t)img & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const Affine aff = {{a0, a1, a2}, {b0, b1, b2}};
  const dim3 block(kVecQuads, kVecTy);
  const dim3 grid((Wo + kVecPixels - 1) / kVecPixels,
                  (Ho + kVecRows - 1) / kVecRows, N);
  resize_normalize_vec_kernel<<<grid, block, (size_t)smem,
                                static_cast<cudaStream_t>(stream)>>>(
      img, out, reinterpret_cast<const int2*>(ytaps), yfrac,
      reinterpret_cast<const int2*>(xtaps), xfrac, H, W, Ho, Wo, pitch, aff,
      reverse);
  return (int)cudaGetLastError();
}

// The vector body's tile (rows, pixels, most shared memory), which the
// wrapper's shape rule must agree with.
extern "C" void pdft_resize_normalize_vec_tile(int* tile) {
  tile[0] = kVecRows;
  tile[1] = kVecPixels;
  tile[2] = kVecSmemMax;
}
