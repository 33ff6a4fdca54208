// Row shift with one shift per (row, channel block): kernels K2 and K3, on
// float32 (`row_shift_blocks_forward`) or bfloat16
// (`row_shift_blocks_forward_bf16`) images.
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
//
// bfloat16. As the TPU kernel does (its f32 scratch slab, its f32 f), each
// tap is widened to float32 (exactly), the lerp runs in float32 with the
// same separately rounded products and sum, and the output is rounded to
// bf16 once, at the store. The slab holds the source's bf16 values: their
// float32 values are exact, so it is the f32 slab of the TPU kernel at
// half the bytes (up to 768 positions of 32 channels in 48 KB). A thread
// moves 16 bytes, 8 channels, where C % 8 == 0 and the pointers are 16-byte
// aligned; else one channel, copied into the slab by a plain load and store
// (cp.async moves 4, 8 or 16 bytes, not 2). The bound halves with the
// bytes: [288, 288, 352] bf16 is 117 MB in and out, 35 us at 3.35 TB/s.
// The bf16 gradient is this kernel at sign -1 on the bf16 cotangent: the
// same bytes and the same bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int CHANNEL_TILE = 32;      // channels per block
constexpr int SMEM_BYTES = 48 * 1024;  // a block's slab: at most 48 KB

// VEC consecutive values of element type E: the unit a thread copies,
// loads and stores (16 bytes where VEC > 1).
template <class E, int VEC>
struct alignas(sizeof(E) * VEC) Pack {
  E v[VEC];
};

// Copy one Pack from device memory into the slab: cp.async where it moves
// 4, 8 or 16 bytes, else a plain load and store.
template <class E, int VEC>
__device__ __forceinline__ void copy_to_slab(E* smem, const E* gmem) {
  constexpr int BYTES = sizeof(E) * VEC;
  if constexpr (BYTES == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else if constexpr (BYTES == 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  } else {
    *reinterpret_cast<Pack<E, VEC>*>(smem) = *reinterpret_cast<const Pack<E, VEC>*>(gmem);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class E>
__device__ __forceinline__ E from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// (1 - f) * v0 + f * v1 with the products and the sum rounded separately
// (no fused multiply-add), as the plain version rounds them.
__device__ __forceinline__ float lerp(float v0, float v1, float g, float f) {
  return __fadd_rn(__fmul_rn(v0, g), __fmul_rn(v1, f));
}

// grid (rows * n_blocks, channel tiles, position tiles); dynamic shared
// memory (j_tile + 1) * min(c_tile, C) elements of E
template <class E, int VEC>
__global__ void __launch_bounds__(THREADS)
    row_shift_kernel(const E* __restrict__ img, const float* __restrict__ shifts,
                     E* __restrict__ out, int w, int ctot, int n_blocks, float sign, int c_tile,
                     int j_tile) {
  using P = Pack<E, VEC>;
  extern __shared__ __align__(16) unsigned char slab_bytes[];
  E* slab = reinterpret_cast<E*>(slab_bytes);
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

  const int lanes = cw / VEC;  // packs per position
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const int step = THREADS / lanes;  // positions per pass of the block
  const bool active = row < step;    // threads past the last whole position idle
  const size_t off = (size_t)r * w * ctot + (size_t)(b * c + c0 + lane * VEC);
  const E* src = img + off;
  E* dst = out + off;
  E* sl = slab + lane * VEC;
  if (active) {
    for (int s = lo + row; s < hi; s += step)
      copy_to_slab<E, VEC>(sl + (s - base) * cw, src + s * ctot);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (!active) return;

  for (int i = row; i < jn; i += step) {
    const int s0 = base + i;
    const bool in0 = s0 >= 0 && s0 < w, in1 = s0 + 1 >= 0 && s0 + 1 < w;
    P v0, v1, o;
    if (in0) v0 = *reinterpret_cast<const P*>(sl + i * cw);
    if (in1) v1 = *reinterpret_cast<const P*>(sl + (i + 1) * cw);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_float<E>(lerp(in0 ? to_float(v0.v[j]) : 0.0f,
                                  in1 ? to_float(v1.v[j]) : 0.0f, g, fr));
    *reinterpret_cast<P*>(dst + (j0 + i) * ctot) = o;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One launch over img [rows, w, ctot] of element type E, VEC = the channels
// of a 16-byte vector (4 f32, 8 bf16) where C allows and the pointers are
// aligned, else 1.
template <class E>
int shift(const E* img, const float* shifts, E* out, long long rows, int w, int ctot,
          int n_blocks, float sign, void* stream) {
  constexpr int VEC = 16 / sizeof(E);
  if (rows <= 0 || w <= 0 || ctot <= 0) return 0;
  if (n_blocks <= 0 || ctot % n_blocks || (long long)w * ctot >= (1LL << 31) ||
      rows * n_blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int c = ctot / n_blocks;
  const bool vec = c % VEC == 0 && aligned16(img) && aligned16(out);
  const int c_tile = c < CHANNEL_TILE ? c : CHANNEL_TILE;  // a multiple of VEC on the vector path
  const int j_tile = min(w, SMEM_BYTES / (int)sizeof(E) / c_tile - 1);
  const dim3 grid((unsigned)(rows * n_blocks), (unsigned)((c + c_tile - 1) / c_tile),
                  (unsigned)((w + j_tile - 1) / j_tile));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(j_tile + 1) * c_tile * sizeof(E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    row_shift_kernel<E, VEC><<<grid, THREADS, smem, s>>>(img, shifts, out, w, ctot, n_blocks,
                                                         sign, c_tile, j_tile);
  } else {
    row_shift_kernel<E, 1><<<grid, THREADS, smem, s>>>(img, shifts, out, w, ctot, n_blocks,
                                                       sign, c_tile, j_tile);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// img, out [rows, w, ctot] f32; shifts f32 [rows, n_blocks], used times
// sign; ctot % n_blocks == 0 and w * ctot < 2^31. Returns the launch's
// CUDA error, or 0.
extern "C" int row_shift_blocks_forward(const float* img, const float* shifts, float* out,
                                        long long rows, int w, int ctot, int n_blocks,
                                        float sign, void* stream) {
  return shift<float>(img, shifts, out, rows, w, ctot, n_blocks, sign, stream);
}

// The same on bf16 images (img, out bf16; shifts f32): the lerp in float32,
// rounded to bf16 once at the store. At sign -1 on a bf16 cotangent it is
// the bf16 gradient of K2 and K3, as the TPU kernel's VJP is its forward at
// -shifts on the cotangent's dtype (ops/bilinear.py:481-486).
extern "C" int row_shift_blocks_forward_bf16(const void* img, const float* shifts, void* out,
                                             long long rows, int w, int ctot, int n_blocks,
                                             float sign, void* stream) {
  return shift<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(img), shifts,
                              static_cast<__nv_bfloat16*>(out), rows, w, ctot, n_blocks, sign,
                              stream);
}
