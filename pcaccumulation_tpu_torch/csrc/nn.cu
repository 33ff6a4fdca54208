// Nearest neighbour over valid reference points, batched over problems.
//
// Replaces the TPU kernel pcaccumulation_tpu/kernels/chamfer.py
// (_nn_kernel, launched by nn_pallas): for every asked-for query a[p, i]
// the squared distance to the nearest of the references b[p, 0:count[p]]
// and that reference's index, the first one on ties:
//   d2[p, i] = min_j |a[p, i] - b[p, j]|^2,  idx[p, i] = order[p, first argmin j].
// The caller packs each problem's valid references to the front of its row
// in their original order (so the first-index rule carries over) and hands
// over `order`, the original index of each packed reference, which the
// kernel applies. Optionally it also packs the asked-for queries to the
// front (qidx: the original index of each packed query, a permutation of
// the row; qcount: how many are asked for); a query that is not asked for
// gets (1e30, 0), and so does every query of a problem with no valid
// reference. Distances are the difference form sum (a - b)^2 in float32
// fused multiply-adds: no tensor cores (the JAX kernel's Precision.HIGHEST)
// and no centring, exact to about one ulp of the distance.
//
// What bounds it on an H100: operations. Every (asked-for query, valid
// reference) pair costs 3 subtractions, 3 multiplications and 2 additions
// (8 flops: one multiply, two fused multiply-adds and the subtractions);
// the bytes are only the points. At the ego ICP shape (4 problems of about
// 18,000 asked-for queries against about 18,000 valid references) that is
// 1.0e10 flops per call, 0.16 ms at 67 TFLOP/s float32. Since the float32
// rate counts a fused multiply-add as two flops, every other instruction
// per pair (compare, select, shared-memory load, loop) costs as much issue
// time as an arithmetic one.
//
// Design, against that:
// - Register tiling: a thread holds 8 queries, so one 16-byte shared-memory
//   broadcast of a reference serves 8 pairs. Block-uniform: a block whose
//   slice of queries is short (the instance problems) runs 1, 2 or 4.
// - The minimum costs half an instruction per pair, not a compare and two
//   selects: distances are non-negative, so their bit patterns order as the
//   floats do, and Hopper's three-way integer min (__vimin3_s32, a DPX
//   instruction) folds two distances into the running minimum at once. A
//   thread notes, per group of 32 references, whether the group lowered its
//   minimum. After the walk it computes the winning group's 32 distances
//   again, bit for bit the same, and takes the first reference that equals
//   the minimum. Since a later group must be strictly smaller to win, that
//   is the first argmin over the ascending walk.
// - Enough blocks: a problem's references are cut into slices of 2048, one
//   block per (1024 queries, slice, problem). A block copies its slice
//   (32 KB) into shared memory once with cp.async, padded with +inf points
//   to a whole group (their distance never wins), so the walk and the
//   winning group's second look read shared memory only. The caller sizes
//   the grid by the largest query and reference counts (read to the host
//   once, when it packs), so nearly every block has work. With one slice
//   the block writes the result itself; with several, each writes its
//   slice's (minimum, packed index), and a second launch merges them in
//   slice order with a strict < (the first argmin again). Either fills the
//   queries not asked for.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int QPT = 8;                   // queries a thread holds, at most
constexpr int QUERIES = THREADS * QPT;   // queries per block
constexpr int SLICE = 2048;              // references per block, all in shared memory
constexpr int GROUP = 32;                // references per minimum-tracking group
constexpr float BIG = 1e30f;             // the distance with no reference

__device__ __forceinline__ float dist2(float ax, float ay, float az, float4 r) {
  const float dx = __fsub_rn(ax, r.x);
  const float dy = __fsub_rn(ay, r.y);
  const float dz = __fsub_rn(az, r.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// Queries q0 + q*THREADS + threadIdx.x (q < NQ) of problem p against the
// `len` references staged in `slab` (padded with +inf to a whole group):
// each thread's minimum distance and the slab index of its first argmin (0
// if no distance is below BIG).
template <int NQ>
__device__ __forceinline__ void scan(const float* __restrict__ a, const float4* slab,
                                     const int* __restrict__ qidx, int n, int p, int q0,
                                     int nqry, int len, float* best, int* best_j) {
  float qx[NQ], qy[NQ], qz[NQ];
  int grp[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = q0 + q * THREADS + threadIdx.x;
    qx[q] = qy[q] = qz[q] = 0.0f;
    if (i < nqry) {
      const int src = qidx ? qidx[(size_t)p * n + i] : i;
      const float* ap = a + ((size_t)p * n + src) * 3;
      qx[q] = ap[0];
      qy[q] = ap[1];
      qz[q] = ap[2];
    }
    best[q] = BIG;
    grp[q] = -1;
  }
  const int groups = (len + GROUP - 1) / GROUP;
  for (int g0 = 0; g0 < groups * GROUP; g0 += GROUP) {
    float before[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) before[q] = best[q];
#pragma unroll 8
    for (int jj = 0; jj < GROUP; jj += 2) {
      const float4 r0 = slab[g0 + jj];
      const float4 r1 = slab[g0 + jj + 1];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        // non-negative floats order as their bit patterns: one three-way
        // integer min (a Hopper DPX instruction) takes two pairs
        best[q] = __int_as_float(__vimin3_s32(__float_as_int(best[q]),
                                              __float_as_int(dist2(qx[q], qy[q], qz[q], r0)),
                                              __float_as_int(dist2(qx[q], qy[q], qz[q], r1))));
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (best[q] < before[q]) grp[q] = g0;
    }
  }
  // the winning group again, bit for bit: the first reference at the minimum
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    int j = 0;
    if (grp[q] >= 0) {
#pragma unroll
      for (int jj = GROUP - 1; jj >= 0; --jj) {
        if (dist2(qx[q], qy[q], qz[q], slab[grp[q] + jj]) == best[q]) j = grp[q] + jj;
      }
    }
    best_j[q] = j;
  }
}

// grid (query tiles, slices, problems)
__global__ void __launch_bounds__(THREADS)
    nn_kernel(const float* __restrict__ a, const float4* __restrict__ refs,
              const int* __restrict__ count, const int* __restrict__ order,
              const int* __restrict__ qidx, const int* __restrict__ qcount,
              float* __restrict__ d2_out, int* __restrict__ idx_out, int2* __restrict__ part,
              int n, int m) {
  __shared__ __align__(16) float4 slab[SLICE];
  const int p = blockIdx.z;
  const int q0 = blockIdx.x * QUERIES;
  const int nqry = qcount ? min(qcount[p], n) : n;
  const int r0 = blockIdx.y * SLICE;
  const int len = min(SLICE, min(count[p], m) - r0);  // references of this slice
  const bool final_pass = gridDim.y == 1;
  // rows of THREADS queries of this block that are asked for (block-uniform)
  const int rows = q0 < nqry ? min(QPT, (nqry - q0 + THREADS - 1) / THREADS) : 0;

  float best[QPT];
  int best_j[QPT];
#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    best[q] = BIG;
    best_j[q] = 0;
  }
  if (rows > 0 && len > 0) {
    const float4* src = refs + (size_t)p * m + r0;
    const int padded = (len + GROUP - 1) / GROUP * GROUP;
    for (int e = threadIdx.x; e < padded; e += THREADS) {
      if (e < len) {
        const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(slab + e));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + e));
      } else {
        const float inf = __int_as_float(0x7f800000);
        slab[e] = make_float4(inf, inf, inf, 0.0f);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (rows > 4) {
      scan<8>(a, slab, qidx, n, p, q0, nqry, len, best, best_j);
    } else if (rows > 2) {
      scan<4>(a, slab, qidx, n, p, q0, nqry, len, best, best_j);
    } else if (rows > 1) {
      scan<2>(a, slab, qidx, n, p, q0, nqry, len, best, best_j);
    } else {
      scan<1>(a, slab, qidx, n, p, q0, nqry, len, best, best_j);
    }
  } else if (!final_pass) {
    return;  // the merge reads no slice past the count
  }
#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    const int i = q0 + q * THREADS + threadIdx.x;
    if (q >= rows || i >= nqry) break;
    if (final_pass) {
      const size_t dst = (size_t)p * n + (qidx ? qidx[(size_t)p * n + i] : i);
      d2_out[dst] = best[q];
      idx_out[dst] = order[(size_t)p * m + best_j[q]];
    } else {
      part[((size_t)blockIdx.y * gridDim.z + p) * n + i] =
          make_int2(__float_as_int(best[q]), r0 + best_j[q]);
    }
  }
  if (final_pass) {  // the queries not asked for, spread over the problem's blocks
    for (int i = nqry + blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
      const size_t dst = (size_t)p * n + qidx[(size_t)p * n + i];
      d2_out[dst] = BIG;
      idx_out[dst] = 0;
    }
  }
}

// the slices' minima merged in slice order; the queries not asked for
// filled; grid (ceil(n / 256), problems)
__global__ void nn_merge_kernel(const int2* __restrict__ part, const int* __restrict__ count,
                                const int* __restrict__ order, const int* __restrict__ qidx,
                                const int* __restrict__ qcount, float* __restrict__ d2_out,
                                int* __restrict__ idx_out, int problems, int n, int m) {
  const int p = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nqry = qcount ? min(qcount[p], n) : n;
  const size_t dst = (size_t)p * n + (qidx ? qidx[(size_t)p * n + i] : i);
  if (i >= nqry) {
    d2_out[dst] = BIG;
    idx_out[dst] = 0;
    return;
  }
  const int slices = (min(count[p], m) + SLICE - 1) / SLICE;
  float best = BIG;
  int best_j = 0;
  for (int s = 0; s < slices; ++s) {
    const int2 v = part[((size_t)s * problems + p) * n + i];
    const float d = __int_as_float(v.x);
    if (d < best) {
      best = d;
      best_j = v.y;
    }
  }
  d2_out[dst] = best;
  idx_out[dst] = order[(size_t)p * m + best_j];
}

}  // namespace

// a [problems, n, 3] f32; refs [problems, m, 4] f32, each problem's valid
// references first (x, y, z, unused); count [problems] int32, how many;
// order [problems, m] int32, the original index of each packed reference;
// qidx [problems, n] int32 and qcount [problems] int32 likewise for the
// asked-for queries, or both null (every query asked for). n_rows and
// m_rows are the largest query and reference counts (they size the grid);
// slice must be 2048. d2 [problems, n] f32 and idx [problems, n] int32 are
// written; part holds ceil(m_rows / slice) * problems * n int2 of scratch,
// or is null when m_rows <= slice. Returns the first launch error, or 0.
extern "C" int nn_forward(const float* a, const float* refs, const int* count, const int* order,
                          const int* qidx, const int* qcount, float* d2, int* idx, int* part,
                          int problems, int n, int m, int n_rows, int m_rows, int slice,
                          void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  const int slices = (m_rows + SLICE - 1) / SLICE;
  if (slice != SLICE || n_rows <= 0 || n_rows > n || m_rows <= 0 || m_rows > m ||
      problems > 65535 || slices > 65535 || (slices > 1 && part == nullptr) ||
      (qidx == nullptr) != (qcount == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((n_rows + QUERIES - 1) / QUERIES), (unsigned)slices,
                  (unsigned)problems);
  nn_kernel<<<grid, THREADS, 0, s>>>(a, reinterpret_cast<const float4*>(refs), count, order, qidx,
                                     qcount, d2, idx, reinterpret_cast<int2*>(part), n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const dim3 grid2((unsigned)((n + 255) / 256), (unsigned)problems);
  nn_merge_kernel<<<grid2, 256, 0, s>>>(reinterpret_cast<const int2*>(part), count, order, qidx,
                                        qcount, d2, idx, problems, n, m);
  return (int)cudaGetLastError();
}
