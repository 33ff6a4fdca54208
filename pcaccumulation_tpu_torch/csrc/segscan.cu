// Segment reduce-broadcast over SORTED segment ids, forward, op max or sum.
//
// Replaces the TPU kernel pcaccumulation_tpu/kernels/segscan.py
// (_scan_block_kernel + _total_block_kernel, launched by _seg_pool_impl):
// for non-decreasing ids, out[i] = reduce(x[j] for all j with ids[j] == ids[i]).
//
// What bounds it on an H100: bytes. Each launch pair must read x once
// ([N, C] f32), read ids once and write out once; at the default config
// (x [90000, 32] f32) that is about 23 MB, 7 us at 3.35 TB/s. The
// arithmetic is one compare or add per element.
//
// Design. The TPU version carries a (segment id, value) pair across grid
// steps, which is exact only because the TPU grid runs in order. CUDA
// blocks run in no order, so this version keys a table by the first ROW of
// each run of equal ids (table [N, C], allocated and filled with the op's
// identity by the caller):
//   1. segpool_reduce: one thread per (tile of TILE rows, column) walks its
//      rows once, reducing each run of equal ids in a register. A run that
//      lies wholly inside the tile is stored directly; the tile's first
//      and last run may be shared with neighbouring tiles and are merged
//      with one atomic each (max: an int/uint atomic on the float's bits,
//      exact; sum: atomicAdd, order-dependent rounding).
//   2. segpool_broadcast: the same walk writes out[i] = table[start(i)].
// The start row of a tile's first run comes from a binary search over the
// sorted ids (O(log N) per tile), so both passes are linear in N for any
// run length: the padded tail of a sample (one segment of tens of
// thousands of rows) costs its rows once plus one atomic per tile, not
// O(L^2). A tile's thread reads one column, so the 32 threads of a warp
// read one 128-byte row per step when C = 32.
// Max is order-independent, so the result equals the plain version bit
// for bit; sum differs from it only by the order of its additions.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // rows one thread walks
constexpr int THREADS = 256;  // threads per block

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  // With the sign bit clear, a float orders like its bits as a signed int
  // (and every stored negative float is a negative int); with the sign bit
  // set it orders in reverse of its bits as an unsigned int.
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// First row j <= r with ids[j] == ids[r] (ids non-decreasing).
__device__ __forceinline__ long long run_start(const int* __restrict__ ids,
                                               long long r) {
  const int key = ids[r];
  long long lo = 0, hi = r;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ids[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool IS_MAX>
__device__ __forceinline__ void flush(float* __restrict__ table, long long start,
                                      int c, int col, float acc, bool shared) {
  float* dst = table + start * c + col;
  if (!shared) {
    *dst = acc;
  } else if (IS_MAX) {
    atomic_max_f32(dst, acc);
  } else {
    atomicAdd(dst, acc);
  }
}

template <bool IS_MAX>
__global__ void segpool_reduce(const float* __restrict__ x,
                               const int* __restrict__ ids,
                               float* __restrict__ table, long long n, int c) {
  const long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n_tiles = (n + TILE - 1) / TILE;
  if (gid >= n_tiles * c) return;
  const long long tile = gid / c;
  const int col = (int)(gid % c);
  const long long r0 = tile * TILE;
  const long long r1 = min(r0 + TILE, n);

  long long start = run_start(ids, r0);
  int cur = ids[r0];
  float acc = x[r0 * c + col];
  for (long long r = r0 + 1; r < r1; ++r) {
    const int id = ids[r];
    const float v = x[r * c + col];
    if (id != cur) {
      // this run ends inside the tile: shared only if it began before it
      flush<IS_MAX>(table, start, c, col, acc, start < r0);
      start = r;
      cur = id;
      acc = v;
    } else {
      acc = IS_MAX ? fmaxf(acc, v) : acc + v;
    }
  }
  const bool continues = r1 < n && ids[r1] == cur;
  flush<IS_MAX>(table, start, c, col, acc, start < r0 || continues);
}

__global__ void segpool_broadcast(const float* __restrict__ table,
                                  const int* __restrict__ ids,
                                  float* __restrict__ out, long long n, int c) {
  const long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n_tiles = (n + TILE - 1) / TILE;
  if (gid >= n_tiles * c) return;
  const long long tile = gid / c;
  const int col = (int)(gid % c);
  const long long r0 = tile * TILE;
  const long long r1 = min(r0 + TILE, n);

  int cur = ids[r0];
  float val = table[run_start(ids, r0) * c + col];
  out[r0 * c + col] = val;
  for (long long r = r0 + 1; r < r1; ++r) {
    const int id = ids[r];
    if (id != cur) {
      cur = id;
      val = table[r * c + col];
    }
    out[r * c + col] = val;
  }
}

}  // namespace

// op: 0 = max, 1 = sum. table must hold the op's identity (-inf or 0) in
// every row. Returns the first CUDA error of the two launches, or 0.
extern "C" int segpool_forward(const float* x, const int* ids, float* table,
                               float* out, long long n, int c, int op,
                               void* stream) {
  if (n <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_threads = ((n + TILE - 1) / TILE) * c;
  const unsigned int blocks = (unsigned int)((n_threads + THREADS - 1) / THREADS);
  if (op == 0) {
    segpool_reduce<true><<<blocks, THREADS, 0, s>>>(x, ids, table, n, c);
  } else {
    segpool_reduce<false><<<blocks, THREADS, 0, s>>>(x, ids, table, n, c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segpool_broadcast<<<blocks, THREADS, 0, s>>>(table, ids, out, n, c);
  return (int)cudaGetLastError();
}
