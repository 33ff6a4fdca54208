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
//   winning group's second look read shared memory only.
// - No count read to the host, so that a traced graph (torch.export) can
//   hold the call: the caller passes the capacities (n queries, m
//   references per problem) and, on the device, each problem's counts and
//   the largest of them (`top`, which its packing computes). The work is
//   the blocks of a host-sized grid would do with the largest counts read
//   back: (query tile, slice, problem) items over ceil(top_q / 1024) x
//   ceil(top_r / 2048) x problems. A resident grid (as many blocks as the
//   card holds at once, never more than the capacities' items) walks that
//   range, which the blocks compute from `top`, block-uniformly; an item
//   past its problem's own query count or reference slices is skipped.
//   (On an H100, a grid of every capacity item, most of them exiting at
//   once, took 0.53 ms at the ego ICP shape against 0.34 ms: the empty
//   blocks queue behind the working ones.)
// - A problem whose references fit in one slice is written by its slice-0
//   items directly; a problem with several slices writes each slice's
//   (minimum, packed index) to scratch, and a second launch, made whenever
//   the capacity spans several slices, merges them in slice order with a
//   strict < (the first argmin again) and passes over the one-slice
//   problems. The queries not asked for are filled by whichever writes the
//   problem's result.

#include <cuda_runtime.h>

#include <algorithm>

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

// one item: the queries [q0, q0 + QUERIES) of problem p against slice sl
// of its references; block-uniform
__device__ __forceinline__ void nn_item(const float* __restrict__ a,
                                        const float4* __restrict__ refs,
                                        const int* __restrict__ order,
                                        const int* __restrict__ qidx, float* __restrict__ d2_out,
                                        int* __restrict__ idx_out, int2* __restrict__ part,
                                        float4* slab, int n, int m, int problems, int p,
                                        int tile, int sl, int nref, int nqry, int qblocks,
                                        bool final_pass) {
  const int q0 = tile * QUERIES;
  const int r0 = sl * SLICE;
  const int len = min(SLICE, nref - r0);  // references of this slice (0 if none)
  // rows of THREADS queries of this item that are asked for
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
    __syncthreads();  // every thread is done with the previous item's slab
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
      part[((size_t)sl * problems + p) * n + i] = make_int2(__float_as_int(best[q]), r0 + best_j[q]);
    }
  }
  if (final_pass) {  // the queries not asked for, spread over the problem's tiles
    for (int i = nqry + tile * THREADS + threadIdx.x; i < n; i += qblocks * THREADS) {
      const size_t dst = (size_t)p * n + qidx[(size_t)p * n + i];
      d2_out[dst] = BIG;
      idx_out[dst] = 0;
    }
  }
}

// a resident 1-D grid over the items (query tile, slice, problem), tile
// fastest, of ceil(top_q / QUERIES) x ceil(top_r / SLICE) x problems
__global__ void __launch_bounds__(THREADS)
    nn_kernel(const float* __restrict__ a, const float4* __restrict__ refs,
              const int* __restrict__ count, const int* __restrict__ order,
              const int* __restrict__ top, const int* __restrict__ qidx,
              const int* __restrict__ qcount, const int* __restrict__ qtop,
              float* __restrict__ d2_out, int* __restrict__ idx_out, int2* __restrict__ part,
              int problems, int n, int m) {
  __shared__ __align__(16) float4 slab[SLICE];
  const int top_r = min(*top, m);
  const int top_q = qtop ? min(*qtop, n) : n;
  const int tiles = max(1, (top_q + QUERIES - 1) / QUERIES);
  const int slices = max(1, (top_r + SLICE - 1) / SLICE);
  const long long items = (long long)tiles * slices * problems;
  for (long long v = blockIdx.x; v < items; v += gridDim.x) {
    const int tile = (int)(v % tiles);
    const int sl = (int)((v / tiles) % slices);
    const int p = (int)(v / ((long long)tiles * slices));
    const int nref = min(count[p], m);
    const int nqry = qcount ? min(qcount[p], n) : n;
    // one slice: the slice-0 items write the result (decided per problem)
    const bool final_pass = nref <= SLICE;
    // the tiles that hold asked-for queries; at least one, which writes
    // the problem's queries not asked for when none is
    const int qblocks = max(1, (nqry + QUERIES - 1) / QUERIES);
    if (tile >= qblocks || (final_pass ? sl > 0 : sl * SLICE >= nref)) continue;
    nn_item(a, refs, order, qidx, d2_out, idx_out, part, slab, n, m, problems, p, tile, sl, nref,
            nqry, qblocks, final_pass);
  }
}

// the slices' minima of the problems with several merged in slice order,
// their queries not asked for filled; grid (ceil(n / 256), problems)
__global__ void nn_merge_kernel(const int2* __restrict__ part, const int* __restrict__ count,
                                const int* __restrict__ order, const int* __restrict__ qidx,
                                const int* __restrict__ qcount, float* __restrict__ d2_out,
                                int* __restrict__ idx_out, int problems, int n, int m) {
  const int p = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nref = min(count[p], m);
  if (i >= n || nref <= SLICE) return;  // one slice: nn_kernel wrote it
  const int nqry = qcount ? min(qcount[p], n) : n;
  const size_t dst = (size_t)p * n + (qidx ? qidx[(size_t)p * n + i] : i);
  if (i >= nqry) {
    d2_out[dst] = BIG;
    idx_out[dst] = 0;
    return;
  }
  const int slices = (nref + SLICE - 1) / SLICE;
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
// top [1] int32, the largest count; qidx [problems, n] int32, qcount
// [problems] int32 and qtop [1] int32 likewise for the asked-for queries,
// or all three null (every query asked for). Nothing is read to the host;
// slice must be 2048. d2 [problems, n] f32 and idx [problems, n] int32 are
// written; part holds ceil(m / slice) * problems * n int2 of scratch, or
// is null when m <= slice. Returns the first launch error, or 0.
extern "C" int nn_forward(const float* a, const float* refs, const int* count, const int* order,
                          const int* top, const int* qidx, const int* qcount, const int* qtop,
                          float* d2, int* idx, int* part, int problems, int n, int m, int slice,
                          void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  const int slices = (m + SLICE - 1) / SLICE;
  if (slice != SLICE || m <= 0 || top == nullptr || problems > 65535 ||
      (slices > 1 && part == nullptr) || (qidx == nullptr) != (qcount == nullptr) ||
      (qidx == nullptr) != (qtop == nullptr))
    return (int)cudaErrorInvalidValue;
  // as many blocks as the card holds at once (asked once per device)
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = std::max(1, sms * per_sm);
  }
  const long long capacity_items =
      (long long)((n + QUERIES - 1) / QUERIES) * slices * problems;
  const unsigned blocks = (unsigned)std::min<long long>(capacity_items, resident[dev]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nn_kernel<<<blocks, THREADS, 0, s>>>(a, reinterpret_cast<const float4*>(refs), count, order,
                                       top, qidx, qcount, qtop, d2, idx,
                                       reinterpret_cast<int2*>(part), problems, n, m);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const dim3 grid2((unsigned)((n + 255) / 256), (unsigned)problems);
  nn_merge_kernel<<<grid2, 256, 0, s>>>(reinterpret_cast<const int2*>(part), count, order, qidx,
                                        qcount, d2, idx, problems, n, m);
  return (int)cudaGetLastError();
}
