// Segment reduce-broadcast over SORTED segment ids (kernel K1) and the
// gradient of its max, each as one C entry point of two launches. The
// forward takes float32 (`segpool_forward`) or bfloat16
// (`segpool_forward_bf16`) rows, and so does the gradient
// (`segpool_backward_max`, `segpool_backward_max_bf16`).
//
// Replaces the TPU kernels of pcaccumulation_tpu/kernels/segscan.py:
//   _seg_pool_impl (_scan_block_kernel + _total_block_kernel): for
//     non-decreasing ids, out[i] = reduce(x[j] for all j with ids[j] == ids[i]),
//     reduce = max or sum;
//   _seg_pool_bwd for max: with tie = (x == y), y the forward's output,
//     grad[i] = tie[i] ? (sum of g over the segment) / max(number of ties
//     in the segment, 1) : 0, a true division (the sum's gradient is the
//     forward's sum of g, the same entry point).
//
// What bounds it on an H100: bytes. The forward must read x and ids once
// and write out once (x [90000, 32] f32: 23 MB, 7 us at 3.35 TB/s; x
// [120000, 32] bf16: 15.8 MB, 4.7 us); the
// gradient reads x, y, g and ids once and writes once ([360000, 32]: 186 MB,
// 56 us; bf16 [480000, 32], the nuScenes train step's: 125 MB, 37 us). The
// arithmetic is one compare or add per element and payload.
//
// Design. The TPU version carries a (segment id, value) pair across grid
// steps, which is exact only because the TPU grid runs in order; CUDA
// blocks run in no order. Here one block owns a tile of 256 rows (times up
// to 32 columns) and there is no [N, C] table, no fill and no atomic:
//   A. seg_partials: each block reduces only the rows of its tile's first
//      run and last run, where they continue into a neighbouring tile (or
//      the tile is one run), into first[t] and last[t] (O(N/TILE * C)
//      scratch), and writes flags[t]: the tile is one run (WHOLE), its
//      first row continues the previous tile's run (LINK_L), its last row
//      continues into the next tile (LINK_R).
//   B. seg_tiles: each block loads its tile once (16-byte loads where C % 4
//      == 0 and the pointers are aligned, else one column per thread), and
//      reduces every run inside the tile with a segmented scan: each thread
//      scans 8 consecutive rows in registers, then takes its carry from the
//      groups before it through shared memory; every row of a run gets the
//      scan's value at the run's end row. A run that crosses a tile edge
//      gets the combination of the partials of its tiles a..b, found from
//      the flags (a block-wide search, 256 tiles per step), as
//      last[a] + first[a+1] + ... + first[b]. A tile that is one run reads
//      no x in B (the gradient reads its x for the tie mask). Where a run is
//      known whole (A's first and last runs, B's one-run tiles), the
//      gradient reads the forward's output y once per run, not per row.
// A run of L rows costs its L rows plus O((L / TILE)^2 * C) reads of
// partials, which stay in L2: for the 40,000-row tail of a sample, 157
// tiles each read 157 * 32 floats, 3.2 MB in all (the gradient: 157 * 64
// floats each, 6.3 MB).
//
// bfloat16. As the TPU kernel does (its f32 scratch and its f32 carry), a
// bf16 row is widened to float32 where it is loaded, every reduction and
// every partial stays float32, and the result is rounded to bf16 once, at
// the store (round to nearest even): a sum is not rounded per partial. The
// payload per thread is the f32 kernel's: 4 columns, here one 8-byte load
// of 4 bf16, so that the 8 lanes of a row group cover 32 columns, the
// pillar encoder's width, with every lane busy (a 16-byte load of 8 bf16
// would leave half the lanes of a row idle at C = 32 and double each
// thread's registers). Where C % 4 != 0 or a pointer is not 8-byte aligned,
// one column per thread.
//
// The gradient in bfloat16 (`segpool_backward_max_bf16`, the TPU kernel's
// `_seg_pool_bwd` on bf16 activations, the one the pillar encoder's
// backward runs under `precision.compute_dtype: bfloat16`): x, y and g are
// bf16 rows, widened where they are loaded; the tie mask compares the
// widened values (exact, so it is bf16's x == y); the sums of g and of the
// tie mask are float32 partials and float32 scans, the division is float32,
// and the result is rounded to bf16 once, at the store, as the TPU kernel
// casts `gs / max(nt, 1)` to x's dtype once. bf16 ties are common (values
// that differ in float32 round alike), so the tie count is not a corner
// case here. The loads are the forward's: 8-byte loads of 4 bf16.
//
// Fixed order of combination. Every order of addition here is a function
// of the ids alone: the in-thread scan runs over the rows in order, the
// carry over the groups in order, a crossing run's partials in an order
// fixed by (a, b) alone, which every tile of the run computes alike.
// So the output is bit-identical between two calls, for sum and for the
// gradient as well as for max, every row of a segment gets the same bits,
// and max equals the plain version bit for bit (max does not depend on the
// order); sum and the gradient differ from the plain version only by the
// order of their additions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;              // threads per block
constexpr int LANES = 8;                  // threads across a tile's columns
constexpr int GROUPS = THREADS / LANES;   // row groups of a block
constexpr int WARPS = THREADS / 32;
constexpr int K = 8;                      // consecutive rows per thread
constexpr int TILE = GROUPS * K;          // rows of a tile; the wrapper's TILE_ROWS

constexpr int WHOLE = 1, LINK_L = 2, LINK_R = 4;

struct Args {
  const void* x;   // float or __nv_bfloat16: the element type E of every row array
  const void* y;   // gradient only: the forward's output
  const void* g;   // gradient only: the cotangent
  const int* ids;
  void* out;       // E
  float* first;  // [n_tiles, P, c]
  float* last;   // [n_tiles, P, c]
  int* flags;    // [n_tiles]
  int n, c, n_tiles;
};

template <int N>
struct Arr {
  float v[N];
};

template <int VEC>
__device__ __forceinline__ void load_vec(float* dst, const float* p) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    dst[0] = q.x;
    dst[1] = q.y;
    dst[2] = q.z;
    dst[3] = q.w;
  } else {
    dst[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* src) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  } else {
    *p = src[0];
  }
}

// VEC bf16 values (VEC = 4: one 8-byte load) widened to float32, exactly.
template <int VEC>
__device__ __forceinline__ void load_vec(float* dst, const __nv_bfloat16* p) {
  if constexpr (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    dst[0] = lo.x;
    dst[1] = lo.y;
    dst[2] = hi.x;
    dst[3] = hi.y;
  } else {
    dst[0] = __bfloat162float(*p);
  }
}

// VEC float32 values rounded once to bf16 (to nearest even) and stored.
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* src) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(src[0], src[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(src[2], src[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    *p = __float2bfloat16_rn(src[0]);
  }
}

// The forward: the payload is VEC columns of x (element type E, float or
// __nv_bfloat16), widened to float32 and reduced by max or sum; the store
// rounds to E once.
template <int VEC, bool IS_MAX, class E>
struct Pool {
  static constexpr int P = 1;
  static constexpr int V = VEC;
  static constexpr int N = VEC;
  static constexpr int MIN_BLOCKS = 4;  // of the tile kernel on an SM: 64 registers
  using T = Arr<VEC>;
  __device__ static T identity() {
    T r;
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = IS_MAX ? __int_as_float(0xff800000) : 0.0f;
    return r;
  }
  __device__ static T combine(const T& a, const T& b) {
    T r;
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = IS_MAX ? fmaxf(a.v[j], b.v[j]) : __fadd_rn(a.v[j], b.v[j]);
    return r;
  }
  __device__ static T load(const Args& a, int row, int, int col, unsigned&, int) {
    T r;
    load_vec<VEC>(r.v, static_cast<const E*>(a.x) + row * a.c + col);
    return r;
  }
  __device__ static unsigned ties(const Args&, int, int, int, int) { return 0u; }
  __device__ static void store(const Args& a, int row, int col, const T& tot, unsigned, int) {
    store_vec<VEC>(static_cast<E*>(a.out) + row * a.c + col, tot.v);
  }
};

// The gradient of max: the payload is (g, tie) for VEC columns, summed in
// float32; the row's own tie bits are kept for the epilogue (bit k * VEC +
// j). y is the forward's output, one value per segment: where a caller
// knows that rows row and yrow lie in one segment, tie = (x[row] ==
// y[yrow]) reads y once per run instead of once per row. x, y, g and out
// have element type E (float or __nv_bfloat16), widened where loaded and
// rounded to E once at the store.
template <int VEC, class E>
struct MaxGrad {
  static constexpr int P = 2;
  static constexpr int V = VEC;
  static constexpr int N = 2 * VEC;
  static constexpr int MIN_BLOCKS = 2;  // 128 registers
  using T = Arr<2 * VEC>;
  __device__ static T identity() {
    T r;
#pragma unroll
    for (int j = 0; j < 2 * VEC; ++j) r.v[j] = 0.0f;
    return r;
  }
  __device__ static T combine(const T& a, const T& b) {
    T r;
#pragma unroll
    for (int j = 0; j < 2 * VEC; ++j) r.v[j] = __fadd_rn(a.v[j], b.v[j]);
    return r;
  }
  __device__ static unsigned ties(const Args& a, int row, int yrow, int col, int k) {
    float xv[VEC], yv[VEC];
    load_vec<VEC>(xv, static_cast<const E*>(a.x) + row * a.c + col);
    load_vec<VEC>(yv, static_cast<const E*>(a.y) + yrow * a.c + col);
    unsigned bits = 0u;
#pragma unroll
    for (int j = 0; j < VEC; ++j) bits |= (xv[j] == yv[j] ? 1u : 0u) << (k * VEC + j);
    return bits;
  }
  __device__ static T load(const Args& a, int row, int yrow, int col, unsigned& bits, int k) {
    T r;
    load_vec<VEC>(r.v, static_cast<const E*>(a.g) + row * a.c + col);
    const unsigned b = ties(a, row, yrow, col, k);
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[VEC + j] = (b >> (k * VEC + j)) & 1u ? 1.0f : 0.0f;
    bits |= b;
    return r;
  }
  __device__ static void store(const Args& a, int row, int col, const T& tot, unsigned bits, int k) {
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o[j] = (bits >> (k * VEC + j)) & 1u ? __fdiv_rn(tot.v[j], fmaxf(tot.v[VEC + j], 1.0f)) : 0.0f;
    store_vec<VEC>(static_cast<E*>(a.out) + row * a.c + col, o);
  }
};

template <class Op>
__device__ __forceinline__ void store_partial(float* dst, const Args& a, int t, int col,
                                              const typename Op::T& val) {
#pragma unroll
  for (int p = 0; p < Op::P; ++p)
#pragma unroll
    for (int j = 0; j < Op::V; ++j) dst[(t * Op::P + p) * a.c + col + j] = val.v[p * Op::V + j];
}

template <class Op>
__device__ __forceinline__ typename Op::T load_partial(const float* src, const Args& a, int t,
                                                       int col) {
  typename Op::T r;
#pragma unroll
  for (int p = 0; p < Op::P; ++p)
#pragma unroll
    for (int j = 0; j < Op::V; ++j) r.v[p * Op::V + j] = src[(t * Op::P + p) * a.c + col + j];
  return r;
}

// First index i in [0, n) with s[i] > key (s sorted), else n.
__device__ __forceinline__ int upper_bound(const int* s, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] > key) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// First index i in [0, n) with s[i] >= key (s sorted), else n.
__device__ __forceinline__ int lower_bound(const int* s, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] >= key) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Combine two payloads per thread, each over the groups, in a fixed order:
// the warp's groups pairwise by shuffles, then the warps in order through
// shared memory (sh: 2 * WARPS * LANES). Every thread gets its lane's two
// results. Called by the whole block, with sh free; leaves it free.
template <class Op>
__device__ __forceinline__ void reduce_groups(typename Op::T& u, typename Op::T& v,
                                              typename Op::T* sh) {
  using T = typename Op::T;
#pragma unroll
  for (int off = 16; off >= LANES; off >>= 1) {
    T ou, ov;
#pragma unroll
    for (int j = 0; j < Op::N; ++j) {
      ou.v[j] = __shfl_down_sync(0xffffffffu, u.v[j], off);
      ov.v[j] = __shfl_down_sync(0xffffffffu, v.v[j], off);
    }
    u = Op::combine(u, ou);
    v = Op::combine(v, ov);
  }
  const int w = threadIdx.x / 32, lane = threadIdx.x % LANES;
  if ((threadIdx.x & 31) < LANES) {
    sh[w * LANES + lane] = u;
    sh[(WARPS + w) * LANES + lane] = v;
  }
  __syncthreads();
  u = sh[lane];
  v = sh[WARPS * LANES + lane];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) {
    u = Op::combine(u, sh[i * LANES + lane]);
    v = Op::combine(v, sh[(WARPS + i) * LANES + lane]);
  }
  __syncthreads();
}

// The smallest thread index whose pred is true, or THREADS. Called by the
// whole block.
__device__ __forceinline__ int block_first(bool pred, int* swarp) {
  const unsigned b = __ballot_sync(0xffffffffu, pred);
  if ((threadIdx.x & 31) == 0) swarp[threadIdx.x / 32] = b ? (threadIdx.x & ~31) + __ffs(b) - 1 : THREADS;
  __syncthreads();
  int j = THREADS;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) j = min(j, swarp[w]);
  __syncthreads();
  return j;
}

// The largest tile k <= k0 that does not pass a run on to its left (not a
// WHOLE tile with LINK_L): where the run that tile k0 continues begins.
// flag0 is flags[k0], read ahead by the caller.
__device__ int walk_left(const Args& a, int k0, int flag0, int* swarp) {
  // the common case, a run that began in tile k0: no search
  if (k0 <= 0 || (flag0 & (WHOLE | LINK_L)) != (WHOLE | LINK_L)) return k0;
  for (int base = k0 - 1;; base -= THREADS) {
    const int k = base - (int)threadIdx.x;
    const bool stop = k <= 0 || (a.flags[k] & (WHOLE | LINK_L)) != (WHOLE | LINK_L);
    const int j = block_first(stop, swarp);
    if (j < THREADS) return base - j;
  }
}

// The smallest tile k >= k0 that does not pass a run on to its right.
__device__ int walk_right(const Args& a, int k0, int flag0, int* swarp) {
  if (k0 >= a.n_tiles - 1 || (flag0 & (WHOLE | LINK_R)) != (WHOLE | LINK_R)) return k0;
  for (int base = k0 + 1;; base += THREADS) {
    const int k = base + (int)threadIdx.x;
    const bool stop = k >= a.n_tiles - 1 || (a.flags[k] & (WHOLE | LINK_R)) != (WHOLE | LINK_R);
    const int j = block_first(stop, swarp);
    if (j < THREADS) return base + j;
  }
}

// The total of the run over tiles ka..kb: last[ka], first[ka+1..kb]. Each
// group takes every GROUPS-th tile in order, then `reduce_groups`: a
// function of (ka, kb) alone. Called by the whole block.
template <class Op>
__device__ typename Op::T span_total(const Args& a, int ka, int kb, int col, bool active,
                                     typename Op::T* sh) {
  typename Op::T acc = Op::identity();
  if (active) {
#pragma unroll 4
    for (int k = ka + (int)(threadIdx.x / LANES); k <= kb; k += GROUPS)
      acc = Op::combine(acc, load_partial<Op>(k == ka ? a.last : a.first, a, k, col));
  }
  typename Op::T unused = Op::identity();
  reduce_groups<Op>(acc, unused, sh);
  return acc;
}

// Launch A: the partials of the runs that cross a tile edge, and the flags.
template <class Op>
__global__ void __launch_bounds__(THREADS) seg_partials(Args a) {
  using T = typename Op::T;
  __shared__ int sid[TILE];
  __shared__ T sh[2 * WARPS * LANES];
  const int t = blockIdx.x;
  const int r0 = t * TILE;
  const int rn = min(TILE, a.n - r0);
  const int grp = threadIdx.x / LANES;
  const int col = blockIdx.y * (LANES * Op::V) + (threadIdx.x % LANES) * Op::V;
  const bool active = col < a.c;
  for (int i = threadIdx.x; i < rn; i += THREADS) sid[i] = a.ids[r0 + i];
  __syncthreads();
  const int id0 = sid[0], id1 = sid[rn - 1];
  const bool whole = id0 == id1;
  const bool link_l = r0 > 0 && a.ids[r0 - 1] == id0;
  const bool link_r = r0 + rn < a.n && a.ids[r0 + rn] == id1;
  if (blockIdx.y == 0 && threadIdx.x == 0)
    a.flags[t] = (whole ? WHOLE : 0) | (link_l ? LINK_L : 0) | (link_r ? LINK_R : 0);
  const bool do_first = whole || link_l, do_last = !whole && link_r;
  if (!do_first && !do_last) return;
  // the first run, rows [0, fe), and the last, rows [ls, rn), in one pass
  const int fe = whole ? rn : do_first ? upper_bound(sid, rn, id0) : 0;
  const int ls = do_last ? lower_bound(sid, rn, id1) : rn;
  T af = Op::identity(), al = Op::identity();
  unsigned unused = 0u;
  if (active) {
#pragma unroll 4
    for (int i = grp; i < fe; i += GROUPS) af = Op::combine(af, Op::load(a, r0 + i, r0, col, unused, 0));
#pragma unroll 4
    for (int i = ls + grp; i < rn; i += GROUPS)
      al = Op::combine(al, Op::load(a, r0 + i, r0 + ls, col, unused, 0));
  }
  reduce_groups<Op>(af, al, sh);
  if (grp == 0 && active) {
    if (do_first) store_partial<Op>(a.first, a, t, col, af);
    if (whole || do_last) store_partial<Op>(a.last, a, t, col, whole ? af : al);
  }
}

// Launch B: every run of the tile, reduced and written back once.
template <class Op>
__global__ void __launch_bounds__(THREADS, Op::MIN_BLOCKS) seg_tiles(Args a) {
  using T = typename Op::T;
  __shared__ int sid[TILE];
  __shared__ T sh[THREADS];
  __shared__ int shead[GROUPS];
  __shared__ int swarp[WARPS];
  const int t = blockIdx.x;
  const int r0 = t * TILE;
  const int rn = min(TILE, a.n - r0);
  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  const int col = blockIdx.y * (LANES * Op::V) + lane * Op::V;
  const bool active = col < a.c;
  for (int i = threadIdx.x; i < rn; i += THREADS) sid[i] = a.ids[r0 + i];
  const int f = a.flags[t];
  const int f_prev = t > 0 ? a.flags[t - 1] : 0;  // read ahead for the searches
  const int f_next = t + 1 < a.n_tiles ? a.flags[t + 1] : 0;
  __syncthreads();
  const bool whole = f & WHOLE, link_l = f & LINK_L, link_r = f & LINK_R;
  const int g0 = grp * K;  // the thread's first row in the tile

  if (whole) {  // one run: its total from the partials of its tiles
    const int ka = link_l ? walk_left(a, t - 1, f_prev, swarp) : t;
    const int kb = link_r ? walk_right(a, t + 1, f_next, swarp) : t;
    const T tot = span_total<Op>(a, ka, kb, col, active, sh);
    if (active) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (g0 + k < rn) Op::store(a, r0 + g0 + k, col, tot, Op::ties(a, r0 + g0 + k, r0, col, k), k);
      }
    }
    return;
  }

  // the tile's rows, loaded before the searches so that the loads overlap them
  T v[K];
  unsigned bits = 0u, head = 0u;  // bit k: row g0 + k starts a run inside the tile
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = g0 + k;
    const bool in = i < rn;
    if (!in || i == 0 || sid[i] != sid[i - 1]) head |= 1u << k;
    v[k] = in && active ? Op::load(a, r0 + i, r0 + i, col, bits, k) : Op::identity();
  }

  // the runs that cross the tile's left and right edges
  T tl = Op::identity(), tr = Op::identity();
  if (link_l) tl = span_total<Op>(a, walk_left(a, t - 1, f_prev, swarp), t, col, active, sh);
  if (link_r) tr = span_total<Op>(a, t, walk_right(a, t + 1, f_next, swarp), col, active, sh);

  // in-thread inclusive segmented scan
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (!((head >> k) & 1u)) v[k] = Op::combine(v[k - 1], v[k]);
  }
  // the carry from the groups before this one, over the groups in order
  sh[threadIdx.x] = v[K - 1];
  if (lane == 0) shead[grp] = head != 0u;
  __syncthreads();
  if (!(head & 1u)) {  // row g0 continues a run begun in an earlier group (grp > 0)
    int gs = grp - 1;
    while (!shead[gs]) --gs;
    T carry = sh[gs * LANES + lane];
    for (int gg = gs + 1; gg < grp; ++gg) carry = Op::combine(carry, sh[gg * LANES + lane]);
    bool seg0 = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k > 0 && ((head >> k) & 1u)) seg0 = false;
      if (seg0) v[k] = Op::combine(carry, v[k]);
    }
  }
  __syncthreads();
  // publish the value at the end of this group's first run, where it ends
  // in the group; a group whose last run continues reads it from there
  const int next = g0 + K;
  const bool next_head = next >= rn || sid[next] != sid[next - 1];
  const unsigned later = head & ~1u;
  const int e0 = later ? __ffs(later) - 2 : K - 1;  // the first run's last row
  if (later || next_head) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == e0) sh[threadIdx.x] = v[k];
    }
  }
  __syncthreads();
  T cur;
  if (next_head) {
    cur = v[K - 1];
  } else {
    const int e = upper_bound(sid, rn, sid[next - 1]) - 1;  // the run's last row
    cur = sh[(e / K) * LANES + lane];
  }
  if (!active) return;
  const int id0 = sid[0], id1 = sid[rn - 1];
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const int i = g0 + k;
    if (i < rn) {
      const int id = sid[i];
      const bool use_l = link_l && id == id0, use_r = link_r && id == id1;
      T val;  // selected per element: a reference to one of three would put them in local memory
#pragma unroll
      for (int j = 0; j < Op::P * Op::V; ++j) val.v[j] = use_l ? tl.v[j] : use_r ? tr.v[j] : cur.v[j];
      Op::store(a, r0 + i, col, val, bits, k);
    }
    if (k > 0 && ((head >> k) & 1u)) cur = v[k - 1];
  }
}

template <class Op>
int launch(const Args& a, cudaStream_t s) {
  const dim3 grid((unsigned)a.n_tiles, (unsigned)((a.c + LANES * Op::V - 1) / (LANES * Op::V)));
  seg_partials<Op><<<grid, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_tiles<Op><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, unsigned bytes = 16) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Carve the scratch (first, last, flags) and check the sizes; 0 or an error.
int prepare(Args& a, float* scratch, long long scratch_floats, int payload) {
  a.n_tiles = (a.n + TILE - 1) / TILE;
  const long long part = (long long)a.n_tiles * payload * a.c;
  if (scratch_floats < 2 * part + a.n_tiles) return (int)cudaErrorInvalidValue;
  a.first = scratch;
  a.last = scratch + part;
  a.flags = reinterpret_cast<int*>(scratch + 2 * part);
  // element offsets are 32-bit: n * c must fit
  if ((long long)a.n * a.c >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return 0;
}

// The forward on rows of element type E: 4 columns a thread where C % 4 ==
// 0 and x and out are aligned to 4 elements, else one.
template <class E>
int forward(const void* x, const int* ids, void* out, float* scratch, long long scratch_floats,
            int n, int c, int op, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  Args a{x, nullptr, nullptr, ids, out, nullptr, nullptr, nullptr, n, c, 0};
  const int rc = prepare(a, scratch, scratch_floats, 1);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = c % 4 == 0 && aligned(x, 4 * sizeof(E)) && aligned(out, 4 * sizeof(E));
  if (op == 0) return vec ? launch<Pool<4, true, E>>(a, s) : launch<Pool<1, true, E>>(a, s);
  return vec ? launch<Pool<4, false, E>>(a, s) : launch<Pool<1, false, E>>(a, s);
}

// The gradient of max on rows of element type E: 4 columns a thread where
// C % 4 == 0 and every row array is aligned to 4 elements, else one.
template <class E>
int backward_max(const void* x, const void* y, const void* g, const int* ids, void* out,
                 float* scratch, long long scratch_floats, int n, int c, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  Args a{x, y, g, ids, out, nullptr, nullptr, nullptr, n, c, 0};
  const int rc = prepare(a, scratch, scratch_floats, 2);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned al = 4 * sizeof(E);
  const bool vec = c % 4 == 0 && aligned(x, al) && aligned(y, al) && aligned(g, al) &&
                   aligned(out, al);
  return vec ? launch<MaxGrad<4, E>>(a, s) : launch<MaxGrad<1, E>>(a, s);
}

}  // namespace

// The forward. x [n, c] f32 contiguous, ids [n] int32 non-decreasing, out
// [n, c] contiguous; op 0 = max, 1 = sum. scratch holds
// at least n_tiles * (2 * c + 1) floats, n_tiles = ceil(n / 256). Two
// launches; returns the first CUDA error, or 0.
extern "C" int segpool_forward(const float* x, const int* ids, float* out, float* scratch,
                               long long scratch_floats, int n, int c, int op, void* stream) {
  return forward<float>(x, ids, out, scratch, scratch_floats, n, c, op, stream);
}

// The same on bf16 rows: x and out [n, c] bf16 contiguous, the scratch
// float32 as above; reduced in float32 and rounded once at the store.
extern "C" int segpool_forward_bf16(const void* x, const int* ids, void* out, float* scratch,
                                    long long scratch_floats, int n, int c, int op,
                                    void* stream) {
  return forward<__nv_bfloat16>(x, ids, out, scratch, scratch_floats, n, c, op, stream);
}

// The gradient of the max forward: x, y (its output) and g (the cotangent
// of y) and out [n, c] f32 contiguous.
// scratch holds at least n_tiles * (4 * c + 1) floats. Two launches;
// returns the first CUDA error, or 0.
extern "C" int segpool_backward_max(const float* x, const float* y, const float* g,
                                    const int* ids, float* out, float* scratch,
                                    long long scratch_floats, int n, int c, void* stream) {
  return backward_max<float>(x, y, g, ids, out, scratch, scratch_floats, n, c, stream);
}

// The same on bf16 rows: x, y, g and out [n, c] bf16 contiguous, the
// scratch float32 as above; g and the tie mask summed in float32, divided
// in float32 and rounded to bf16 once at the store.
extern "C" int segpool_backward_max_bf16(const void* x, const void* y, const void* g,
                                         const int* ids, void* out, float* scratch,
                                         long long scratch_floats, int n, int c,
                                         void* stream) {
  return backward_max<__nv_bfloat16>(x, y, g, ids, out, scratch, scratch_floats, n, c, stream);
}
