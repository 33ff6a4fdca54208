// pcacc_host: the port's native host-side sample preparation.
//
// Three plain C functions over numpy buffers, bound with ctypes
// (pcaccumulation_tpu_torch/native/host.py), built at first use with the
// host compiler into pcaccumulation_tpu_torch/_build/:
// - voxelize: one pass over the points with an open-addressing hash table,
//   pillar ids given first-come (the order in which their first point
//   arrives), so the prepared sample is the same on every host;
// - transform_filter: augmentation, crop and ground filter in one pass;
// - sort_by_key: a stable counting sort of the points by pillar id, the
//   order the segment pool on the card (kernels/segscan.py) requires.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Fixed-capacity 4D pillar voxelisation.
//
// points:   [n, 3] float32 (x, y, z)
// time_idx: [n] int32
// voxel:    [3] float32, range: [6] float32 (x0 y0 z0 x1 y1 z1)
// out_coords: [max_pillars, 3] int32 (t, y, x)
// out_p2v:    [n] int32 — pillar id in [0, max_pillars), or max_pillars if
//             the point is out of range / overflowed capacity
// out_valid_count: number of occupied pillars (<= max_pillars)
// returns 0 on success
int voxelize(const float* points, const int32_t* time_idx, int64_t n,
             const float* voxel, const float* range, int32_t n_sweeps,
             int32_t max_pillars, int32_t* out_coords, int32_t* out_p2v,
             int32_t* out_valid_count) {
  const float vx = voxel[0], vy = voxel[1], vz = voxel[2];
  const float x0 = range[0], y0 = range[1], z0 = range[2];
  const int64_t nx = (int64_t)std::lround((range[3] - range[0]) / vx);
  const int64_t ny = (int64_t)std::lround((range[4] - range[1]) / vy);
  const int64_t nz = (int64_t)std::lround((range[5] - range[2]) / vz);

  // open-addressing hash table: key -> pillar id
  int64_t cap = 1;
  while (cap < 2 * max_pillars) cap <<= 1;
  std::vector<int64_t> keys(cap, -1);
  std::vector<int32_t> vals(cap, -1);
  const int64_t mask = cap - 1;

  int32_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float px = points[i * 3 + 0];
    const float py = points[i * 3 + 1];
    const float pz = points[i * 3 + 2];
    const int64_t cx = (int64_t)std::floor((px - x0) / vx);
    const int64_t cy = (int64_t)std::floor((py - y0) / vy);
    const int64_t cz = (int64_t)std::floor((pz - z0) / vz);
    const int64_t t = time_idx[i];
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz ||
        t < 0 || t >= n_sweeps) {
      out_p2v[i] = max_pillars;
      continue;
    }
    const int64_t key = (t * ny + cy) * nx + cx;
    uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ull;
    int64_t slot = (int64_t)(h & (uint64_t)mask);
    int32_t id = -1;
    while (true) {
      if (keys[slot] == key) { id = vals[slot]; break; }
      if (keys[slot] == -1) {
        if (count >= max_pillars) { id = max_pillars; break; }
        keys[slot] = key;
        vals[slot] = count;
        out_coords[count * 3 + 0] = (int32_t)t;
        out_coords[count * 3 + 1] = (int32_t)cy;
        out_coords[count * 3 + 2] = (int32_t)cx;
        id = count;
        ++count;
        break;
      }
      slot = (slot + 1) & mask;
    }
    out_p2v[i] = id;
  }
  *out_valid_count = count;
  return 0;
}

// Fused augmentation + crop + ground filter.
//
// Applies points' = S * (R * p + t + noise), then writes a keep mask for
// |x|,|y| < crop_xy, z in (z_lo, z_hi) and z > ground_h.
// noise: [n, 3] pre-drawn uniform(-0.5, 0.5) * augment_noise (pass zeros to
// disable). tsfm: [16] row-major 4x4 (identity to disable).
int transform_filter(float* points, int64_t n, const float* tsfm, float scale,
                     const float* noise, float crop_xy, float z_lo, float z_hi,
                     float ground_h, uint8_t* keep) {
  const float r00 = tsfm[0], r01 = tsfm[1], r02 = tsfm[2], tx = tsfm[3];
  const float r10 = tsfm[4], r11 = tsfm[5], r12 = tsfm[6], ty = tsfm[7];
  const float r20 = tsfm[8], r21 = tsfm[9], r22 = tsfm[10], tz = tsfm[11];
  for (int64_t i = 0; i < n; ++i) {
    float x = points[i * 3], y = points[i * 3 + 1], z = points[i * 3 + 2];
    float nx_ = (r00 * x + r01 * y + r02 * z + tx + noise[i * 3]) * scale;
    float ny_ = (r10 * x + r11 * y + r12 * z + ty + noise[i * 3 + 1]) * scale;
    float nz_ = (r20 * x + r21 * y + r22 * z + tz + noise[i * 3 + 2]) * scale;
    points[i * 3] = nx_;
    points[i * 3 + 1] = ny_;
    points[i * 3 + 2] = nz_;
    keep[i] = (std::fabs(nx_) < crop_xy) && (std::fabs(ny_) < crop_xy) &&
              (nz_ > z_lo) && (nz_ < z_hi) && (nz_ > ground_h);
  }
  return 0;
}

// Stable counting sort by small-integer key: order_out receives the
// permutation that sorts keys ascending, equal keys keeping their input
// order. Keys are clamped into [0, n_buckets] (one shared overflow bucket
// — the voxeliser's invalid/overflow pillar ids, which must sort LAST).
// O(n + n_buckets) where an argsort is O(n log n).
int sort_by_key(const int32_t* keys, int64_t n, int32_t n_buckets,
                int32_t* order_out) {
  std::vector<int32_t> offsets(static_cast<size_t>(n_buckets) + 2, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t k = keys[i];
    if (k < 0) k = 0;
    if (k > n_buckets) k = n_buckets;
    ++offsets[k + 1];
  }
  for (size_t b = 1; b < offsets.size(); ++b) offsets[b] += offsets[b - 1];
  for (int64_t i = 0; i < n; ++i) {
    int32_t k = keys[i];
    if (k < 0) k = 0;
    if (k > n_buckets) k = n_buckets;
    order_out[offsets[k]++] = static_cast<int32_t>(i);
  }
  return 0;
}

}  // extern "C"
