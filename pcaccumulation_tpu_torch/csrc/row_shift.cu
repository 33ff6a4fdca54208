// Row shift with one shift per (row, channel block), forward.
//
// Replaces the TPU kernel pcaccumulation_tpu/ops/bilinear.py
// (_row_shift_blocks_pallas, wrapped by _make_row_shift_blocks and
// row_shift_blocks): for img [R, W, nb*C],
//   out[r, j, b*C + c] = (1 - f) * img[r, j + k, b*C + c] + f * img[r, j + k + 1, b*C + c]
// with one (k, f) per (r, b), zero outside [0, W), k already clipped to
// [-W, W] and f = s - floor(s) by the caller. The lerp is in f32.
//
// What bounds it on an H100: bytes. It must read img once and write out
// once; at the default config ([288, 288, 160] f32 per shear pass) that is
// about 106 MB, 32 us at 3.35 TB/s. The arithmetic is three flops per
// element.
//
// Design. The TPU version stages each row block in VMEM and reads the
// shifted window with a scalar-prefetched dynamic slice. A whole
// [W, nb*C] row is 184 KB at T=5 and 405 KB at T=11, more than a block's
// 227 KB of shared memory, so here each thread computes one output element
// straight from device memory: neighbouring threads hold neighbouring
// channels, so both taps of a warp are contiguous reads, and the second
// tap of one row is the first tap of the next and comes from L1/L2. The
// products and the sum are rounded separately (no fused multiply-add), as
// the plain version rounds them. n_blocks is an argument, so nb = 1 (one
// shift per row) is the same kernel.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void row_shift_blocks_kernel(const float* __restrict__ img,
                                        const int* __restrict__ ki,
                                        const float* __restrict__ f,
                                        float* __restrict__ out,
                                        long long rows, int w, int ctot,
                                        int n_blocks) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= rows * w * (long long)ctot) return;
  const int ch = (int)(idx % ctot);
  const long long rj = idx / ctot;
  const int j = (int)(rj % w);
  const long long r = rj / w;
  const int b = ch / (ctot / n_blocks);

  const int k = ki[r * n_blocks + b];
  const float fr = f[r * n_blocks + b];
  const int s0 = j + k;
  const float* row = img + r * w * (long long)ctot + ch;
  const float v0 = (s0 >= 0 && s0 < w) ? row[(long long)s0 * ctot] : 0.0f;
  const float v1 = (s0 + 1 >= 0 && s0 + 1 < w) ? row[(long long)(s0 + 1) * ctot] : 0.0f;
  out[idx] = __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, fr)), __fmul_rn(v1, fr));
}

}  // namespace

// img, out [rows, w, ctot] f32; ki int32, f f32 [rows, n_blocks];
// ctot % n_blocks == 0. Returns the launch's CUDA error, or 0.
extern "C" int row_shift_blocks_forward(const float* img, const int* ki,
                                        const float* f, float* out,
                                        long long rows, int w, int ctot,
                                        int n_blocks, void* stream) {
  const long long total = rows * w * (long long)ctot;
  if (total <= 0) return 0;
  const unsigned int blocks = (unsigned int)((total + THREADS - 1) / THREADS);
  row_shift_blocks_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      img, ki, f, out, rows, w, ctot, n_blocks);
  return (int)cudaGetLastError();
}
