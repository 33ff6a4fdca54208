// Segment reduce-broadcast over SORTED segment ids (kernel K1) and the
// gradient of its max, each as one C entry point of two launches. The
// forward takes float32 (`segpool_forward`) or bfloat16
// (`segpool_forward_bf16`) rows, and so does the gradient
// (`segpool_backward_max`, `segpool_backward_max_bf16`). The design below
// (seg_partials + seg_tiles) runs float32 at every C and bf16 where C != 32
// or a pointer is not 16-byte aligned; bf16 rows of 32 columns (the pillar
// encoder's) take a design of their own for Hopper ("bfloat16 at C = 32",
// further down: bf_local + bf_fix).
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

// ---- diagnostics of the bf16 kernels (tools/ab_k1_bf16.py, chip_smoke.py) ----

// One launch of the two-launch design alone (phase 1: seg_partials, 2:
// seg_tiles, 3: both). The second launch reads only the scratch that a
// whole call left, so it is timed alone after one whole call.
template <class Op>
int launch_phase(const Args& a, cudaStream_t s, int phase) {
  const dim3 grid((unsigned)a.n_tiles, (unsigned)((a.c + LANES * Op::V - 1) / (LANES * Op::V)));
  if (phase & 1) seg_partials<Op><<<grid, THREADS, 0, s>>>(a);
  if (phase & 2) seg_tiles<Op><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Resident blocks per SM, registers, local (spill) bytes, shared bytes and
// threads of one kernel: 5 ints at out.
template <class Kern>
int kernel_info(Kern kernel, int dyn_smem, int* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  if (err == cudaSuccess && dyn_smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, dyn_smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = (int)at.sharedSizeBytes + dyn_smem;
  out[4] = THREADS;
  return 0;
}

// ---- bfloat16 at C = 32: the Hopper design ------------------------------
//
// The pillar encoder's rows are 32 bf16 (64 bytes), so a tile of 256 rows
// is 16 KB per row array, and the bf16 entry points take this path when
// C == 32 and every row array and the ids are 16-byte aligned (the
// two-launch seg_partials + seg_tiles, above, keep C != 32 and misaligned
// pointers). What the two-launch design measured on the card (PERF.md,
// K1's bf16 per-launch split): its two launches add up (no overlap), the
// second (seg_tiles) is two thirds of the time, and the gradient's
// seg_tiles holds 2 blocks per SM; a padded tail is read in launch A and
// again in launch B. This design:
//   1. bf_local, one pass over the rows, independent per tile: a persistent
//      block (grid = SMs x resident blocks, tiles in a static stride) keeps
//      a ring of 2 tiles in shared memory, each filled by cp.async.bulk
//      (the copy engine's 1-D bulk copy, TMA) completing on an mbarrier, so
//      the next tile's bytes arrive while this one scans and stores. It runs
//      seg_tiles' segmented scan on the tile (rows read from shared memory)
//      and writes every run that begins and ends inside the tile; a tile
//      that is one run (the padded tails) is only reduced. A run that
//      crosses a tile edge it does not write: it stores the run's part in
//      the tile (first[t], last[t]), the flags, the bounds of the tile's
//      first and last run and, for the gradient, the rows' tie bits (one
//      32-bit word a thread). So every row is read once; no tile waits for
//      another.
//   2. bf_fix, launched with programmatic dependent launch (PDL: set up as
//      bf_local's blocks finish; it waits at griddepcontrol.wait), writes
//      the rows of the crossing runs only, 4 tiles a block: a warp a tile
//      finds its runs' spans (warp_walk_*, 256 flags a step) and sums a
//      short span itself (warp_span); the block sums each distinct long span
//      once (span_total: the tiles of a tail share it); then every thread
//      writes its rows, the total broadcast or, for the gradient, tie ? sum
//      g / ties : 0 from the stored tie bits (divided once per run). It
//      reads no row array.
// The orders of addition are functions of the ids alone (in-thread, then
// the groups in order; a one-run tile by reduce_groups; a crossing run
// last[a] + first[a+1..b] by warp_span or span_total, chosen by b - a),
// never of the schedule or the ring.
// Not taken: 16-byte accesses (the rows are read from shared memory, 8
// bytes (4 bf16) a lane, so that a thread's registers stay at seg_tiles' 8
// rows x 4 columns); a third stage (no faster on the card); a cooperative
// grid barrier; second-level partials (the tails' partials stay in L2 and
// each bf_fix block sums a tail's once).

constexpr int BF_C = 32;                          // columns of this path
constexpr int BF_TILE_BYTES = TILE * BF_C * 2;    // one row array of a tile: 16 KB
constexpr int BF_IDS_BYTES = TILE * 4;

struct BfArgs {
  Args a;
  int* bounds;      // [n_tiles]: end of the first run | start of the last run << 16
  unsigned* tbits;  // [n_tiles, THREADS]: the gradient's tie bits, a word a thread
};

constexpr int BF_STAGES = 2;                      // tiles in flight per block (its ring)

// Per op: the row arrays staged (x; or x, y, g) and the ring's shared memory.
template <class Op>
struct Bf {
  static constexpr int ARR = Op::P == 2 ? 3 : 1;
  static constexpr int STAGE_BYTES = ARR * BF_TILE_BYTES + BF_IDS_BYTES;
  static constexpr int SMEM = BF_STAGES * STAGE_BYTES;
};

// The scratch of this path: first and last [n_tiles, P, C], flags and
// bounds [n_tiles], and for the gradient the tie bits [n_tiles, THREADS];
// the bf16 entry points take it at every C (seg_partials + seg_tiles use a
// prefix).
long long bf16_scratch_floats(int n, int c, int payload) {
  const long long n_tiles = (n + TILE - 1) / TILE;
  return n_tiles * (2LL * payload * c + 2 + (payload == 2 ? THREADS : 0));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0: tile t's row arrays and its ids (the whole 16-byte words of
// them; the last tile's remaining 1-3 ids are loaded by threads) into a
// stage, completing on bar.
template <int ARR>
__device__ void bf_fetch(const Args& a, unsigned char* stage, uint64_t* bar, int t) {
  const int r0 = t * TILE;
  const int rn = min(TILE, a.n - r0);
  const unsigned rows = (unsigned)rn * BF_C * 2, ids = ((unsigned)rn * 4) & ~15u;
  mbar_expect_tx(bar, ARR * rows + ids);
  const void* src[3] = {a.x, a.y, a.g};
#pragma unroll
  for (int p = 0; p < ARR; ++p)
    bulk_load(stage + p * BF_TILE_BYTES, static_cast<const char*>(src[p]) + (size_t)r0 * BF_C * 2,
              rows, bar);
  if (ids) bulk_load(stage + ARR * BF_TILE_BYTES, a.ids + r0, ids, bar);
}

// Launch 1: every tile's inner runs written, its crossing runs' parts kept.
template <class Op>
__global__ void __launch_bounds__(THREADS, Op::MIN_BLOCKS) bf_local(BfArgs b) {
  using T = typename Op::T;
  using B = Bf<Op>;
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ __align__(8) uint64_t bar[BF_STAGES];
  __shared__ T sh[THREADS];
  __shared__ int shead[GROUPS];
  __shared__ int sfe, sls;  // the end of the tile's first run, the start of its last
  const Args& a = b.a;
  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  const int col = lane * Op::V;
  const int g0 = grp * K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BF_STAGES; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < BF_STAGES; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < a.n_tiles) bf_fetch<B::ARR>(a, dsmem + s * B::STAGE_BYTES, &bar[s], t);
    }
  }
  for (int j = 0;; ++j) {
    const int t = blockIdx.x + j * gridDim.x;
    if (t >= a.n_tiles) break;
    const int s = j % BF_STAGES;
    unsigned char* st = dsmem + s * B::STAGE_BYTES;
    int* sid = reinterpret_cast<int*>(st + B::ARR * BF_TILE_BYTES);
    const int r0 = t * TILE;
    const int rn = min(TILE, a.n - r0);
    // the neighbours' ids, read while the tile is in flight
    const bool has_l = r0 > 0, has_r = r0 + rn < a.n;
    const int id_l = has_l ? a.ids[r0 - 1] : 0, id_r = has_r ? a.ids[r0 + rn] : 0;
    mbar_wait(&bar[s], (unsigned)(j / BF_STAGES) & 1u);
    if (rn & 3) {  // the last tile's ids past its whole 16-byte words
      const int i = (rn & ~3) + (int)threadIdx.x;
      if (i < rn) sid[i] = a.ids[r0 + i];
      __syncthreads();
    }
    Args as = a;  // the tile's rows in shared memory: row i at i * C
    as.x = st;
    as.y = st + BF_TILE_BYTES;
    as.g = st + 2 * BF_TILE_BYTES;
    const int id0 = sid[0], id1 = sid[rn - 1];
    const bool whole = id0 == id1;
    const bool link_l = has_l && id_l == id0, link_r = has_r && id_r == id1;
    if (threadIdx.x == 0)
      a.flags[t] = (whole ? WHOLE : 0) | (link_l ? LINK_L : 0) | (link_r ? LINK_R : 0);

    if (whole) {  // one run (a padded tail): its total, no scan
      T acc = Op::identity(), unused = Op::identity();
      unsigned bits = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = g0 + k;
        if (i < rn) acc = Op::combine(acc, Op::load(as, i, 0, col, bits, k));
      }
      reduce_groups<Op>(acc, unused, sh);  // over the groups in a fixed order
      if (link_l || link_r) {  // the tile's part of a longer run
        if (grp == 0 && link_l) store_partial<Op>(a.first, a, t, col, acc);
        if (grp == 0 && link_r) store_partial<Op>(a.last, a, t, col, acc);
        if (Op::P == 2) b.tbits[(size_t)t * THREADS + threadIdx.x] = bits;
        if (threadIdx.x == 0) b.bounds[t] = rn;
      } else {  // a run of exactly this tile
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (g0 + k < rn) Op::store(a, r0 + g0 + k, col, acc, bits, k);
        }
      }
      if (threadIdx.x == 0) {
        const int tn = t + BF_STAGES * gridDim.x;
        if (tn < a.n_tiles) bf_fetch<B::ARR>(a, st, &bar[s], tn);
      }
      continue;  // reduce_groups ended with a barrier: stage s and sh are free
    }

    T v[K];
    unsigned bits = 0u, head = 0u;  // bit k: row g0 + k starts a run inside the tile
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = g0 + k;
      const bool in = i < rn;
      if (!in || i == 0 || sid[i] != sid[i - 1]) head |= 1u << k;
      v[k] = in ? Op::load(as, i, i, col, bits, k) : Op::identity();
    }
    // in-thread inclusive segmented scan
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (!((head >> k) & 1u)) v[k] = Op::combine(v[k - 1], v[k]);
    }
    // the carry from the groups before this one, over the groups in order
    sh[threadIdx.x] = v[K - 1];
    if (lane == 0) shead[grp] = head != 0u;
    if (threadIdx.x == 0) {
      sfe = rn;
      sls = 0;
    }
    __syncthreads();
    if (lane == 0) {  // the tile's first head after row 0, and its last head
      const unsigned real = head & ((1u << min(max(rn - g0, 0), K)) - 1u);
      const unsigned inner = grp == 0 ? real & ~1u : real;
      if (inner) atomicMin(&sfe, g0 + __ffs(inner) - 1);
      if (real) atomicMax(&sls, g0 + 31 - __clz(real));
    }
    if (!(head & 1u)) {  // row g0 continues a run begun in an earlier group
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
    const int fe = sfe, ls = sls;  // the first run is rows [0, fe), the last [ls, rn)
    // inner runs written; a crossing run's part in the tile kept as a partial
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int i = g0 + k;
      if (i < rn) {
        if ((link_l && i < fe) || (link_r && i >= ls)) {
          if (i == 0 && link_l) store_partial<Op>(a.first, a, t, col, cur);
          if (i == rn - 1 && link_r) store_partial<Op>(a.last, a, t, col, cur);
        } else {
          Op::store(a, r0 + i, col, cur, bits, k);
        }
      }
      if (k > 0 && ((head >> k) & 1u)) cur = v[k - 1];
    }
    if (link_l || link_r) {
      if (Op::P == 2) b.tbits[(size_t)t * THREADS + threadIdx.x] = bits;
      if (threadIdx.x == 0) b.bounds[t] = fe | (ls << 16);
    }
    __syncthreads();  // every thread is done with stage s, sh, sfe and sls
    if (threadIdx.x == 0) {
      const int tn = t + BF_STAGES * gridDim.x;
      if (tn < a.n_tiles) bf_fetch<B::ARR>(a, st, &bar[s], tn);
    }
  }
  // this block's tiles are done: bf_fix may be launched (it waits for this
  // grid's end at griddepcontrol.wait). Triggered at the start instead, bf_fix's
  // waiting blocks cost ~3 us at [120000, 32] on the card.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The largest tile k <= k0 that does not pass a run on to its left (the
// tile where the run that tile k0 continues begins), found by one warp:
// lane l tests tiles base - 8l - j (j = 0..7), 256 a step. flag0 is
// flags[k0].
__device__ int warp_walk_left(const Args& a, int k0, int flag0, int l) {
  if (k0 <= 0 || (flag0 & (WHOLE | LINK_L)) != (WHOLE | LINK_L)) return k0;
  for (int base = k0 - 1;; base -= 256) {
    int hit = -1;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      const int k = base - 8 * l - j;
      if (k <= 0 || (a.flags[k] & (WHOLE | LINK_L)) != (WHOLE | LINK_L)) hit = k;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit >= 0 || base - 8 * l - 7 <= 0);
    if (m) return __shfl_sync(0xffffffffu, max(hit, 0), __ffs(m) - 1);
  }
}

// The smallest tile k >= k0 that does not pass a run on to its right.
__device__ int warp_walk_right(const Args& a, int k0, int flag0, int l) {
  const int last = a.n_tiles - 1;
  if (k0 >= last || (flag0 & (WHOLE | LINK_R)) != (WHOLE | LINK_R)) return k0;
  for (int base = k0 + 1;; base += 256) {
    int hit = -1;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      const int k = base + 8 * l + j;
      if (k >= last || (a.flags[k] & (WHOLE | LINK_R)) != (WHOLE | LINK_R)) hit = min(k, last);
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit >= 0);
    if (m) return __shfl_sync(0xffffffffu, hit, __ffs(m) - 1);
  }
}

// Spans of up to this many tiles are summed by one warp; longer ones (the
// padded tails) by the whole block (span_total).
constexpr int BF_SHORT_SPAN = 8;

// The total of the run over tiles ka..kb (last[ka], first[ka+1..kb]) for
// the V columns at col, over a short span, by one warp and no barrier: its
// row slots sub (0-3) take tiles ka + sub, ka + sub + 4, ... in order and
// combine pairwise (lane ^ 8, then ^ 16). A function of (ka, kb) alone,
// the same bits in every lane (addition and max commute).
template <class Op>
__device__ typename Op::T warp_span(const Args& a, int ka, int kb, int col, int sub) {
  using T = typename Op::T;
  T acc = Op::identity();
  for (int k = ka + sub; k <= kb; k += 4)
    acc = Op::combine(acc, load_partial<Op>(k == ka ? a.last : a.first, a, k, col));
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1) {
    T o;
#pragma unroll
    for (int j = 0; j < Op::N; ++j) o.v[j] = __shfl_xor_sync(0xffffffffu, acc.v[j], off);
    acc = Op::combine(acc, o);
  }
  return acc;
}

// The element type of an op's rows.
template <class Op>
struct ElemOf;
template <int VEC, bool IS_MAX, class E>
struct ElemOf<Pool<VEC, IS_MAX, E>> {
  using type = E;
};
template <int VEC, class E>
struct ElemOf<MaxGrad<VEC, E>> {
  using type = E;
};

// A run's total as every row of it is written: the forward's value, or the
// gradient's share sum g / max(ties, 1) (divided once per run and column,
// the division MaxGrad::store makes per row).
template <class Op>
__device__ typename Op::T bf_final(const typename Op::T& tot) {
  typename Op::T r = tot;
  if constexpr (Op::P == 2) {
#pragma unroll
    for (int j = 0; j < Op::V; ++j) r.v[j] = __fdiv_rn(tot.v[j], fmaxf(tot.v[Op::V + j], 1.0f));
  }
  return r;
}

// Row `row`'s V columns at col from a bf_final value: the value, or the
// share on the tie set and 0 off it (tie bit k * V + j of bits).
template <class Op>
__device__ void bf_store(const Args& a, int row, int col, const typename Op::T& fv, unsigned bits,
                         int k) {
  float o[Op::V];
#pragma unroll
  for (int j = 0; j < Op::V; ++j)
    o[j] = Op::P == 1 || ((bits >> (k * Op::V + j)) & 1u) ? fv.v[j] : 0.0f;
  store_vec<Op::V>(static_cast<typename ElemOf<Op>::type*>(a.out) + row * a.c + col, o);
}

constexpr int BF_FIX_TILES = 4;  // tiles of a bf_fix block

// Launch 2 (PDL after bf_local): the rows of the runs that cross a tile
// edge, BF_FIX_TILES tiles a block. Warp w < BF_FIX_TILES reads tile
// t0 + w's flags and bounds, finds its runs' spans (warp_walk_*) and sums
// the short ones (warp_span); the block sums each distinct long span once
// (span_total: the tiles of a tail share it); then all threads, laid out as
// bf_local's (each reads its own word of tie bits), write the rows tile by
// tile. No row array is read.
template <class Op>
__global__ void __launch_bounds__(THREADS) bf_fix(BfArgs b) {
  using T = typename Op::T;
  constexpr int NQ = 2 * BF_FIX_TILES;  // (tile, side) slots
  __shared__ T sh[2 * WARPS * LANES];
  __shared__ T sval[NQ][LANES];  // slot q = 2 * tile + side (0: rows [0, fe), 1: [ls, rn))
  __shared__ int sfe[BF_FIX_TILES], sls[BF_FIX_TILES];
  __shared__ int sreq[NQ][2];  // a long span (ka, kb) to sum, ka < 0: none
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const Args& a = b.a;
  const int w = threadIdx.x / 32, l = threadIdx.x & 31;
  const int lane = threadIdx.x % LANES, grp = threadIdx.x / LANES;
  const int col = lane * Op::V;
  const int t0 = blockIdx.x * BF_FIX_TILES;
  unsigned words[BF_FIX_TILES];  // this thread's tie words of the block's tiles
#pragma unroll
  for (int j = 0; j < BF_FIX_TILES; ++j)
    words[j] = Op::P == 2 && t0 + j < a.n_tiles ? b.tbits[(size_t)(t0 + j) * THREADS + threadIdx.x]
                                                : 0u;
  if (w < BF_FIX_TILES) {
    const int t = t0 + w;
    const bool valid = t < a.n_tiles;
    const int f = valid ? a.flags[t] : 0;
    const int f_prev = valid && t > 0 ? a.flags[t - 1] : 0;
    const int f_next = valid && t + 1 < a.n_tiles ? a.flags[t + 1] : 0;
    const int bd = valid ? b.bounds[t] : 0;
    const bool whole = f & WHOLE, link_l = f & LINK_L, link_r = f & LINK_R;
    const int rn = valid ? min(TILE, a.n - t * TILE) : 0;
    // rows [0, fe) take the left span's total (all of a one-run tile), rows
    // [ls, rn) the right one's
    const int fe = !(link_l || link_r) ? 0 : whole ? rn : link_l ? (bd & 0xffff) : 0;
    const int ls = whole || !link_r ? rn : (bd >> 16);
    const int ka = link_l ? warp_walk_left(a, t - 1, f_prev, l) : t;
    const int kb = link_r ? warp_walk_right(a, t + 1, f_next, l) : t;
    const int span[2][2] = {{ka, whole ? kb : t}, {t, kb}};
    const bool need[2] = {fe > 0, ls < rn};
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const bool is_long = need[side] && span[side][1] - span[side][0] >= BF_SHORT_SPAN;
      if (need[side] && !is_long) {
        const T v = bf_final<Op>(warp_span<Op>(a, span[side][0], span[side][1], col, l / LANES));
        if (l < LANES) sval[2 * w + side][l] = v;
      }
      if (l == 0) {
        sreq[2 * w + side][0] = is_long ? span[side][0] : -1;
        sreq[2 * w + side][1] = span[side][1];
      }
    }
    if (l == 0) {
      sfe[w] = fe;
      sls[w] = ls;
    }
  }
  __syncthreads();
  // the distinct long spans, each summed once by the whole block
  int qa[NQ], qb[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    qa[q] = sreq[q][0];
    qb[q] = sreq[q][1];
  }
  unsigned todo = 0u;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    bool first = qa[q] >= 0;
#pragma unroll
    for (int p = 0; p < q; ++p) first = first && !(qa[p] == qa[q] && qb[p] == qb[q]);
    todo |= first ? 1u << q : 0u;
  }
  if (todo) {
    for (unsigned m = todo; m; m &= m - 1) {  // block-uniform
      const int q = __ffs(m) - 1;
      const int ka = sreq[q][0], kb = sreq[q][1];
      const T v = bf_final<Op>(span_total<Op>(a, ka, kb, col, true, sh));
      if (grp == 0) {
#pragma unroll
        for (int p = 0; p < NQ; ++p)
          if (qa[p] == ka && qb[p] == kb) sval[p][lane] = v;
      }
    }
    __syncthreads();
  }
  const int g0 = grp * K;
#pragma unroll
  for (int j = 0; j < BF_FIX_TILES; ++j) {
    const int t = t0 + j;
    if (t >= a.n_tiles) break;
    const int fe = sfe[j], ls = sls[j];
    const int r0 = t * TILE;
    const int rn = min(TILE, a.n - r0);
    if (fe == 0 && ls >= rn) continue;
    const T vl = sval[2 * j][lane], vr = sval[2 * j + 1][lane];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = g0 + k;
      if (i < fe) bf_store<Op>(a, r0 + i, col, vl, words[j], k);
      else if (i >= ls && i < rn) bf_store<Op>(a, r0 + i, col, vr, words[j], k);
    }
  }
}

// Resident blocks per SM of a kernel at its shared memory (cached per
// device and kernel), times the SMs: the persistent grid.
template <class Kern>
int resident_grid(Kern kernel, int smem, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 0;
  if (cache[dev] > 0) return cache[dev];
  int sms = 0, blocks = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  const cudaFuncAttribute max_smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (smem > 48 * 1024 && cudaFuncSetAttribute(kernel, max_smem, smem) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem) != cudaSuccess)
    return 0;
  cache[dev] = sms * blocks;
  return cache[dev];
}

// The two launches of this path (phase 1: bf_local, 2: bf_fix, 3: both).
template <class Op>
int bf_launch(const BfArgs& b, cudaStream_t s, int phase) {
  static int local_grid[16];
  const int g1 = resident_grid(bf_local<Op>, Bf<Op>::SMEM, local_grid);
  if (g1 <= 0) {
    cudaGetLastError();
    return (int)cudaErrorLaunchOutOfResources;
  }
  if (phase & 1) {
    bf_local<Op><<<min(g1, b.a.n_tiles), THREADS, Bf<Op>::SMEM, s>>>(b);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (phase & 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((b.a.n_tiles + BF_FIX_TILES - 1) / BF_FIX_TILES));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, bf_fix<Op>, b);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The bf16 scratch check and, where C == 32 and the pointers are aligned,
// this path's arguments; false: seg_partials + seg_tiles.
bool bf_prepare(BfArgs& b, float* scratch, long long scratch_floats, int payload, int& rc) {
  Args& a = b.a;
  rc = 0;
  if (scratch_floats < bf16_scratch_floats(a.n, a.c, payload)) {
    rc = (int)cudaErrorInvalidValue;
    return false;
  }
  bool ok = a.c == BF_C && aligned(a.x) && aligned(a.ids) && aligned(a.out);
  if (payload == 2) ok = ok && aligned(a.y) && aligned(a.g);
  if (!ok) return false;
  rc = prepare(a, scratch, scratch_floats, payload);
  b.bounds = a.flags + a.n_tiles;
  b.tbits = reinterpret_cast<unsigned*>(b.bounds + a.n_tiles);
  return rc == 0;
}

// The bf16 forward (op 0 max, 1 sum) and gradient of max (op 2); design 0
// runs seg_partials + seg_tiles at every C, design 1 this path where it
// applies.
int bf16_call(int design, int op, int phase, const void* x, const void* y, const void* g,
              const int* ids, void* out, float* scratch, long long scratch_floats, int n, int c,
              void* stream) {
  using E = __nv_bfloat16;
  if (n <= 0 || c <= 0) return 0;
  const int payload = op == 2 ? 2 : 1;
  BfArgs b{{x, y, g, ids, out, nullptr, nullptr, nullptr, n, c, 0}, nullptr, nullptr};
  int rc = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (bf_prepare(b, scratch, scratch_floats, payload, rc)) {
      if (op == 0) return bf_launch<Pool<4, true, E>>(b, s, phase);
      if (op == 1) return bf_launch<Pool<4, false, E>>(b, s, phase);
      return bf_launch<MaxGrad<4, E>>(b, s, phase);
    }
    if (rc) return rc;
    if (phase != 3) return (int)cudaErrorInvalidValue;  // a phase alone: this path only
    return op == 2 ? backward_max<E>(x, y, g, ids, out, scratch, scratch_floats, n, c, stream)
                   : forward<E>(x, ids, out, scratch, scratch_floats, n, c, op, stream);
  }
  if (c % 4 != 0) return (int)cudaErrorInvalidValue;  // a phase alone: 4 columns a thread only
  rc = prepare(b.a, scratch, scratch_floats, payload);
  if (rc) return rc;
  if (op == 0) return launch_phase<Pool<4, true, E>>(b.a, s, phase);
  if (op == 1) return launch_phase<Pool<4, false, E>>(b.a, s, phase);
  return launch_phase<MaxGrad<4, E>>(b.a, s, phase);
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
  return bf16_call(1, op, 3, x, nullptr, nullptr, ids, out, scratch, scratch_floats, n, c, stream);
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
  return bf16_call(1, 2, 3, x, y, g, ids, out, scratch, scratch_floats, n, c, stream);
}


// The float32 scratch a bf16 entry point takes (at least): bf16_scratch_floats
// (payload 1: the forward, 2: the gradient of max). The float32 entry
// points take n_tiles * (2 * payload * c + 1).
extern "C" long long segpool_bf16_scratch_floats(int n, int c, int payload) {
  return bf16_scratch_floats(n, c, payload);
}

// Diagnostics: one phase of a bf16 design alone on the arguments of the
// entry points above (op 0 max, 1 sum, 2 the gradient of max; design 0 =
// seg_partials + seg_tiles at 4 columns a thread, 1 = the Hopper
// path, which needs C == 32 and aligned pointers for a phase alone; phase
// 1, 2 or 3 = both). Returns the first CUDA error, or 0.
extern "C" int segpool_bf16_phase(int design, int op, int phase, const void* x, const void* y,
                                  const void* g, const int* ids, void* out, float* scratch,
                                  long long scratch_floats, int n, int c, void* stream) {
  return bf16_call(design, op, phase, x, y, g, ids, out, scratch, scratch_floats, n, c, stream);
}

// Diagnostics: for each kernel of a bf16 design at C = 32 (the forward's
// two for max, then the gradient's two; design 0: seg_partials and
// seg_tiles, 1: bf_local and bf_fix), 5 ints (resident blocks per SM,
// registers, spill bytes, shared bytes, threads) at out. Returns the
// number of kernels, or minus a CUDA error.
extern "C" int segpool_bf16_kernel_info(int design, int* out, int cap) {
  using E = __nv_bfloat16;
  using F = Pool<4, true, E>;
  using G = MaxGrad<4, E>;
  if (design < 0 || design > 1 || cap < 20) return -(int)cudaErrorInvalidValue;
  int rc = design == 0 ? kernel_info(seg_partials<F>, 0, out)
                       : kernel_info(bf_local<F>, Bf<F>::SMEM, out);
  if (!rc)
    rc = design == 0 ? kernel_info(seg_tiles<F>, 0, out + 5) : kernel_info(bf_fix<F>, 0, out + 5);
  if (!rc)
    rc = design == 0 ? kernel_info(seg_partials<G>, 0, out + 10)
                     : kernel_info(bf_local<G>, Bf<G>::SMEM, out + 10);
  if (!rc)
    rc = design == 0 ? kernel_info(seg_tiles<G>, 0, out + 15) : kernel_info(bf_fix<G>, 0, out + 15);
  return rc ? -rc : 4;
}
