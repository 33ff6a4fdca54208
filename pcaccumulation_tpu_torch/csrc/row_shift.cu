// Row shift with one shift per (row, channel block): kernels K2 and K3.
//
// Replaces the TPU kernels pcaccumulation_tpu/ops/bilinear.py
// _row_shift_blocks_pallas (K2, wrapped by _make_row_shift_blocks and
// row_shift_blocks; its gradient is the same shift at -shifts) and
// _row_shift_pallas (K3, one shift per row, i.e. n_blocks = 1): for img
// [R, W, nb*C],
//   out[r, j, b*C + c] = (1 - f) * img[r, j + k, b*C + c] + f * img[r, j + k + 1, b*C + c]
// with one shift s per (r, b) (times `sign`, +1 or -1 for the gradient),
// k = floor(s) clipped to [-W, W], f = s - floor(s), and zero outside
// [0, W). The products and the sum are rounded separately (no fused
// multiply-add), as the plain version rounds them, so the two agree to the
// bit.
//
// What bounds it on an H100: bytes. It must read img once and write out
// once: 106 MB per shear pass at T=5 ([288, 288, 160] f32), 32 us at
// 3.35 TB/s; three flops per element.
//
// Design. One block per (row r, channel block b, tile of up to 32
// channels, tile of output positions); at the default shapes a tile of
// positions is the whole row (W = 288). The block reads its shift once and
// splits it into (k, f) itself (the wrapper launches nothing else),
// copies the part of the row's [W, C] source slab that its outputs read,
// [max(0, k), min(W, k + W + 1)), into shared memory with cp.async (16
// bytes a thread; 36 KB at C = 32), and computes every output from there:
// device memory is read once and the second tap costs a shared-memory
// load. Each thread owns a fixed channel lane and steps over positions, so
// the indices are 32-bit sums with no division per element; it loads both
// taps and stores its output as 16-byte vectors of 4 channels. Where C is
// not a multiple of 4 or a pointer is not 16-byte aligned, the same kernel
// runs one channel per thread (4-byte copies). Forward, gradient (-shifts)
// and K3 (n_blocks = 1) are this one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int CHANNEL_TILE = 32;          // channels per block
constexpr int SMEM_FLOATS = 48 * 1024 / 4;  // a block's slab: at most 48 KB

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

template <int VEC>
__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  }
}

__device__ __forceinline__ float lerp(float v0, float v1, float g, float f) {
  return __fadd_rn(__fmul_rn(v0, g), __fmul_rn(v1, f));
}

__device__ __forceinline__ float4 lerp(float4 v0, float4 v1, float g, float f) {
  return make_float4(lerp(v0.x, v1.x, g, f), lerp(v0.y, v1.y, g, f), lerp(v0.z, v1.z, g, f),
                     lerp(v0.w, v1.w, g, f));
}

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T zero();
template <>
__device__ __forceinline__ float4 zero<4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <>
__device__ __forceinline__ float zero<1>() {
  return 0.0f;
}

// grid (rows * n_blocks, channel tiles, position tiles); dynamic shared
// memory (j_tile + 1) * min(c_tile, C) floats
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    row_shift_kernel(const float* __restrict__ img, const float* __restrict__ shifts,
                     float* __restrict__ out, int w, int ctot, int n_blocks, float sign,
                     int c_tile, int j_tile) {
  using V = typename Vec<VEC>::T;
  extern __shared__ __align__(16) float slab[];
  const int rb = blockIdx.x;  // r * n_blocks + b
  const int r = rb / n_blocks;
  const int b = rb - r * n_blocks;
  const int c = ctot / n_blocks;
  const int c0 = blockIdx.y * c_tile;
  const int cw = min(c_tile, c - c0);  // channels of this tile
  const int j0 = blockIdx.z * j_tile;
  const int jn = min(j_tile, w - j0);  // output positions of this tile
  // as the wrapper's plain path splits it: k = clip(floor(s)), f = s - floor(s)
  const float sh = __fmul_rn(sign, shifts[rb]);
  const float kf = floorf(sh);
  const int k = (int)fminf(fmaxf(kf, (float)-w), (float)w);
  const float fr = __fsub_rn(sh, kf);
  const float g = __fsub_rn(1.0f, fr);
  const int base = j0 + k;  // the source of output j0; slab row i holds source base + i
  const int lo = max(base, 0);
  const int hi = min(base + jn + 1, w);

  const int lanes = cw / VEC;  // vectors per position
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int step = THREADS / lanes;  // positions per pass of the block
  const bool active = row < step;    // threads past the last whole position idle
  const size_t off = (size_t)r * w * ctot + (size_t)(b * c + c0 + lane * VEC);
  const float* src = img + off;
  float* dst = out + off;
  float* sl = slab + lane * VEC;
  if (active) {
    for (int s = lo + row; s < hi; s += step) copy_async<VEC>(sl + (s - base) * cw, src + s * ctot);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (!active) return;

  for (int i = row; i < jn; i += step) {
    const int s0 = base + i;
    const V v0 = (s0 >= 0 && s0 < w) ? *reinterpret_cast<const V*>(sl + i * cw) : zero<VEC>();
    const V v1 =
        (s0 + 1 >= 0 && s0 + 1 < w) ? *reinterpret_cast<const V*>(sl + (i + 1) * cw) : zero<VEC>();
    *reinterpret_cast<V*>(dst + (j0 + i) * ctot) = lerp(v0, v1, g, fr);
  }
}

}  // namespace

// img, out [rows, w, ctot] f32; shifts f32 [rows, n_blocks], used times
// sign; ctot % n_blocks == 0 and w * ctot < 2^31. Returns the launch's
// CUDA error, or 0.
extern "C" int row_shift_blocks_forward(const float* img, const float* shifts, float* out,
                                        long long rows, int w, int ctot, int n_blocks,
                                        float sign, void* stream) {
  if (rows <= 0 || w <= 0 || ctot <= 0) return 0;
  if (n_blocks <= 0 || ctot % n_blocks || (long long)w * ctot >= (1LL << 31) ||
      rows * n_blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int c = ctot / n_blocks;
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int c_tile = c < CHANNEL_TILE ? c : CHANNEL_TILE;  // a multiple of 4 on the vector path
  const int j_tile = min(w, SMEM_FLOATS / c_tile - 1);
  const dim3 grid((unsigned)(rows * n_blocks), (unsigned)((c + c_tile - 1) / c_tile),
                  (unsigned)((w + j_tile - 1) / j_tile));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(j_tile + 1) * c_tile * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    row_shift_kernel<4><<<grid, THREADS, smem, s>>>(img, shifts, out, w, ctot, n_blocks, sign,
                                                    c_tile, j_tile);
  } else {
    row_shift_kernel<1><<<grid, THREADS, smem, s>>>(img, shifts, out, w, ctot, n_blocks, sign,
                                                    c_tile, j_tile);
  }
  return (int)cudaGetLastError();
}
