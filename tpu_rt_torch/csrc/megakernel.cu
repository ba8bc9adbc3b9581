// Path-trace megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel built by tpu_rt/ops/pallas_megakernel.py:_make_kernel
// (launched by render_pallas) for the configurations the main render path
// and the small-mesh path run: sphere scenes of at most 64 spheres, beside
// at most 256 triangles or none, the v2 estimator with the optional
// dielectric (refraction) and next-event estimation (NEE), i.i.d. pixel
// jitter, pixel centres or the R2 lattice (stratify), a pinhole or
// thin-lens camera (DOF), sqrt gamma and clamp or the linear mean, and
// per-tile traced segment counts.
// Randomness is the counter hash of the JAX kernel's interpret mode
// (_hash_uniform), drawn in the same order, so this kernel can be held
// stream for stream against the JAX package and against the plain PyTorch
// version in tpu_rt_torch/ops/megakernel.py.
//
// What bounds it: FP32 throughput and instruction latency. The inputs are a
// (<= 64, 16) f32 attribute table (4 KB), a (<= 256, 21) f32 triangle table
// (21 KB) and 19 camera/background scalars; the only device-memory traffic
// is the 12 B/pixel colour store. Each path segment sweeps every sphere and
// triangle; with NEE each diffuse hit adds a shadow ray that sweeps them
// again up to its first blocker. The counting instantiations (kCount) count
// it per tile: path and shadow segments, the sphere and triangle tests of
// each, and the tests the warps issue; utils/roofline.py:
// megakernel_op_model turns the counts into the bound.
//
// What the design does about it (each step kept on an A/B on the card,
// PERF.md §6):
//   * a lane per (pixel, sample), or per few samples of a pixel: the lanes
//     of a warp hold `per_warp` pixels of `group` consecutive lanes each,
//     and a lane traces its pixel's samples s_lane, s_lane + group, ... in
//     rounds, `samples_per_lane` of them (1 with NEE; else as many as leave
//     the frame 8 waves of resident threads: 2 at 640x480/8spp), so a frame
//     has several times the threads of a thread-per-pixel loop and its last
//     wave is short. The pixel's sum is formed after each round by a
//     shuffle chain in sample order: every lane of the group adds the
//     group's samples in turn to its running sum, from 0.0f, as one thread
//     looping over the samples would, so the mean is bit for bit the plain
//     version's whatever spp (1, 3, 13: a warp's leftover lanes idle). A
//     path that dies leaves the bounce loop;
//   * a block is `kWarps * per_warp` pixels of one 4096-ray tile (a tile
//     spans `tile_blocks` blocks, the last one ragged), so the tile seed,
//     the tile mask and the segment slot are uniform per block;
//   * 4 blocks of 256 threads an SM, so at most 64 registers, in every
//     instantiation; the NEE ones are asked to (min_blocks) and spill 24
//     bytes to do so, and still run faster than at 3 blocks;
//   * each block stages the attribute table, camera and background into
//     shared memory once; every thread of a warp reads the same word in the
//     sweeps, which is a broadcast with no bank conflict (16-byte row reads
//     measured no faster);
//   * the sweep keeps only the winner's index and t, and reads the winner's
//     material from shared memory after the sweep;
//   * triangles (pallas_megakernel.py:345-394, 448-456): the triangle table
//     sits in shared memory beside the spheres; after the sphere sweep the
//     thread runs scalar Moller-Trumbore over them with a strict t < best,
//     so a sphere wins a tie and an earlier triangle a later one; a
//     triangle winner shades with its f32 face normal flipped to oppose the
//     ray. The sweep is a template branch: the sphere-only instantiation
//     keeps the instruction stream and shared memory it had;
//   * refraction, the thin lens and the R2 lattice (pallas_megakernel.py:
//     197-270, 490-523) live in the kFlags instantiations, as uniform
//     branches (path_common.cuh); the flag-free instantiations compile
//     without them. The R2 shift is drawn per (pixel, tile seed), keyed by
//     the per-tile seed without the sample term (salts 9001, 9002);
//   * next-event estimation (pallas_megakernel.py:403-424, 525-675) lives
//     in the kNee instantiations (with the flags as uniform branches): the
//     light pick reads the cdf the wrapper writes into attribute column 15
//     (the first row whose cdf reaches the draw), the light count rides a
//     4th background word, and the shadow ray sweeps the same shared-memory
//     spheres and triangles, stopping at the first blocker before the
//     light (MegaNee below);
//   * ``gamma`` = 0 stores the linear mean instead of sqrt gamma and clamp;
//   * no global state (no __constant__ symbol): a launch writes only its own
//     output and counts, so renders on two streams cannot race;
//   * segment counts: a sum over the lanes of a warp that arrive together,
//     then one integer atomicAdd into its tile's slot (add_tile_count), which
//     is exact and independent of order; the visit counts (kCount):
//     shared-memory atomics per block, then one 64-bit atomic per count and
//     block into the tile's slots;
//   * a band of rows (pallas_megakernel.py:818, 858-860, 894-896) is the
//     pixel offset row_offset * width: the hash's pixel id and the camera
//     coordinates are the full frame's (inv_h from its height), the tile
//     seed and the output index the band's own;
//   * the adaptive tile mask (pallas_megakernel.py:768-787, 916-919): the
//     test is uniform per block. A block whose tile is masked writes zeros
//     to its real pixels and returns at the top, before the shared-memory
//     loads (the caller zeroed its segment slot). It is one branch, not a
//     template instantiation.
//
// The grid covers n_tiles * 4096 pixels, like the TPU grid of 4096-ray
// tiles: pixels past the last one trace and count segments too (so the
// with_stats scaling is the JAX package's), but store nothing.
//
// Build without fast-math: the root selection relies on IEEE compares with
// the NaN of sqrt(negative) being false.

#include "path_common.cuh"

#include <atomic>

namespace {

constexpr int kBlock = 256;  // threads per block
constexpr int kWarps = kBlock / 32;
constexpr int kMaxSpheres = 64;
constexpr int kCols = 16;    // attribute columns (ops/intersect.py)
constexpr int kMaxTris = 256;
// triangle columns (ops/megakernel.py:_pack_tris): v0 0-2, e1 3-5, e2 6-8,
// normal 9-11, albedo 12-14, metallic 15, roughness 16, emission 17-19,
// ior 20
constexpr int kTriCols = 21;
// visit counters per ray kind (path, shadow): segments, sphere tests,
// triangle tests, and the tests the warps issue
constexpr int kVisitCols = 4;
constexpr int kVisitCounts = 2 * kVisitCols;

// Blocks of 256 threads an SM must hold at once: 4 (64 registers) for the
// NEE instantiations, whose 76 registers would allow 3; the others fit 4
// unasked. Chosen by the A/B on the card (PERF.md §6): occupancy pays
// there despite 24 spilled bytes.
constexpr int min_blocks(bool nee) { return nee ? 4 : 1; }

// The nearest root in [1e-3, inf) of the sphere row ``a`` (centre 0-2,
// radius 3) along (o, d), or NaN (the NaN of sqrt(negative) fails every
// compare, so misses fall out without a disc >= 0 test).
__device__ __forceinline__ float sphere_root(const float* a, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz) {
  const float ocx = ox - a[0];
  const float ocy = oy - a[1];
  const float ocz = oz - a[2];
  const float half_b = ocx * dx + ocy * dy + ocz * dz;
  const float cq = (ocx * ocx + ocy * ocy + ocz * ocz) - a[3] * a[3];
  const float sqrtd = sqrtf(half_b * half_b - cq);
  const float root0 = -half_b - sqrtd;
  return root0 >= 1e-3f ? root0 : sqrtd - half_b;
}

// Moller-Trumbore of the triangle row ``g`` (v0, e1, e2 in words 0-8)
// along (o, d).
__device__ __forceinline__ float tri_t(const float* g, float ox, float oy,
                                       float oz, float dx, float dy,
                                       float dz) {
  return mt_test(ox, oy, oz, dx, dy, dz, g[0], g[1], g[2], g[3], g[4], g[5],
                 g[6], g[7], g[8]);
}

// The visit counters (kCount): the block's kVisitCounts counters in shared
// memory, added to by shared-memory atomics, so the sweeps keep no counter
// in their registers; or nothing.
template <bool kCount>
struct Visits {
  unsigned long long* n;
  // one sphere (col 1) or triangle (col 2) test of ray kind ``kind``; the
  // warp's first active lane also counts it as a test the warps issued
  __device__ __forceinline__ void test(int kind, int col) const {
    atomicAdd(n + kind * kVisitCols + col, 1ull);
    if ((int)(threadIdx.x & 31) == __ffs(__activemask()) - 1)
      atomicAdd(n + kind * kVisitCols + 3, 1ull);
  }
};
template <>
struct Visits<false> {
  unsigned long long* n;
  __device__ __forceinline__ void test(int, int) const {}
};

// The megakernel's NEE light table: the shared-memory attribute rows, whose
// column 15 holds the uniform light cdf, and the rows the shadow ray sweeps.
template <bool kCount>
struct MegaNee {
  const float* attr;
  int n_spheres;
  const float* tris;
  int n_tris;
  float n_lights;
  Visits<kCount> vis;
  int segs;

  // the first row whose cdf reaches u (pallas_megakernel.py:549-558)
  __device__ __forceinline__ Light pick(float u) const {
    for (int n = 0; n < n_spheres; ++n) {
      const float* a = attr + n * kCols;
      if (a[15] >= u) return Light{a[0], a[1], a[2], a[3], a[9], a[10], a[11]};
    }
    return Light{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }

  // any sphere root or Moller-Trumbore t in [1e-3, t_edge) along (h, d)
  // (pallas_megakernel.py:613-657), spheres then triangles, up to the first
  // blocker
  __device__ __forceinline__ bool occluded(float hx, float hy, float hz,
                                           float dx, float dy, float dz,
                                           float t_edge) const {
    for (int n = 0; n < n_spheres; ++n) {
      vis.test(1, 1);
      const float* a = attr + n * kCols;
      const float root = sphere_root(a, hx, hy, hz, dx, dy, dz);
      if (root >= 1e-3f && root < t_edge && a[14] > 0.f) return true;
    }
    for (int n = 0; n < n_tris; ++n) {
      vis.test(1, 2);
      if (tri_t(tris + n * kTriCols, hx, hy, hz, dx, dy, dz) < t_edge)
        return true;
    }
    return false;
  }
};

template <bool kTris, bool kFlags, bool kNee, bool kCount>
__global__ void __launch_bounds__(kBlock, min_blocks(kNee))
megakernel(const float* __restrict__ attr_g, int n_spheres,
           const float* __restrict__ tris_g, int n_tris,
           const float* __restrict__ cam_g, const float* __restrict__ bg_g,
           uint32_t seed, uint32_t pixel_offset, int width, float inv_w,
           float inv_h, int spp, float inv_spp, int max_depth, int jitter,
           int refract, int dof, int stratify, int gamma, int group,
           int per_warp, int tile_blocks, const int* __restrict__ mask,
           float* __restrict__ out, int n_pix, int* __restrict__ segs,
           unsigned long long* __restrict__ visits) {
  // thread -> (tile, pixel of the tile, first sample): lane l of warp w
  // holds sample l % group of pixel l / group of the warp's per_warp
  const int tile = blockIdx.x / tile_blocks;
  const int lane = threadIdx.x & 31;
  const int pg = lane / group;
  const int s_lane = lane - pg * group;
  const int in_tile = (blockIdx.x - tile * tile_blocks) * (kWarps * per_warp) +
                      (threadIdx.x >> 5) * per_warp + pg;
  // a lane of the TPU grid (pixels past the last one included)
  const bool on_grid = pg < per_warp && in_tile < kTile;
  const int gid = tile * kTile + in_tile;
  const bool writes = on_grid && s_lane == 0 && gid < n_pix;
  if (mask != nullptr && mask[tile] == 0) {  // a skipped tile: zeros
    if (writes) {
      float* o = out + (size_t)gid * 3;
      o[0] = 0.f;
      o[1] = 0.f;
      o[2] = 0.f;
    }
    return;
  }

  __shared__ float attr[kMaxSpheres * kCols];
  __shared__ float tris[kTris ? kMaxTris * kTriCols : 1];
  __shared__ float cam[16];
  __shared__ float bg[4];  // background rgb, then (NEE) the light count
  __shared__ unsigned long long counts[kCount ? kVisitCounts : 1];

  for (int i = threadIdx.x; i < n_spheres * kCols; i += kBlock)
    attr[i] = attr_g[i];
  if constexpr (kTris) {
    for (int i = threadIdx.x; i < n_tris * kTriCols; i += kBlock)
      tris[i] = tris_g[i];
  }
  if (threadIdx.x < 16) cam[threadIdx.x] = cam_g[threadIdx.x];
  if (threadIdx.x < (kNee ? 4 : 3)) bg[threadIdx.x] = bg_g[threadIdx.x];
  if (kCount && threadIdx.x < kVisitCounts) counts[threadIdx.x] = 0;
  __syncthreads();

  const uint32_t flat = pixel_offset + (uint32_t)gid;
  const float px = (float)(flat % (uint32_t)width);
  const float py = (float)(flat / (uint32_t)width);
  // per-tile stream: seed + tile (int32 wrap in the JAX kernel)
  const uint32_t tile_seed = seed + (uint32_t)tile;

  const Sampling sm =
      make_sampling<kFlags>(jitter, stratify, dof, flat, tile_seed);
  const bool refr = kFlags && refract;
  const Visits<kCount> vis{counts};
  MegaNee<kCount> nee{attr, n_spheres, tris, kTris ? n_tris : 0,
                      kNee ? bg[3] : 0.f, vis, 0};

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  int seg_count = 0;

  for (int s0 = 0; s0 < spp; s0 += group) {
    const int s = s0 + s_lane;
    float cr = 0.f, cg = 0.f, cb = 0.f;
    if (on_grid && s < spp) {
      const uint32_t pix_mix =
          flat ^ ((tile_seed + (uint32_t)s * 7919u) * 2654435769u);
      Path p = primary_ray<kFlags>(load_camera(cam), px, py, inv_w, inv_h,
                                   pix_mix, s, sm);

      for (int k = 1; k <= max_depth; ++k) {
        ++seg_count;  // only live paths reach this point

        // ---- sweep all spheres; padding rows have inv_radius 0 ----
        float best_t = kTMax;
        int best = -1;
        for (int n = 0; n < n_spheres; ++n) {
          vis.test(0, 1);
          const float* a = attr + n * kCols;
          const float root =
              sphere_root(a, p.ox, p.oy, p.oz, p.dx, p.dy, p.dz);
          if (root >= 1e-3f && root < best_t && a[14] > 0.f) {
            best_t = root;
            best = n;
          }
        }

        // ---- then the triangles; padding rows have zero edges ----
        int best_tri = -1;
        if constexpr (kTris) {
          for (int n = 0; n < n_tris; ++n) {
            vis.test(0, 2);
            const float t =
                tri_t(tris + n * kTriCols, p.ox, p.oy, p.oz, p.dx, p.dy,
                      p.dz);
            if (t < best_t) {
              best_t = t;
              best_tri = n;
            }
          }
        }

        if (best < 0 && best_tri < 0) {  // miss: background, path ends
          p.cr = p.cr + p.tr * bg[0];
          p.cg = p.cg + p.tg * bg[1];
          p.cb = p.cb + p.tb * bg[2];
          break;
        }
        // the winner's material is read from shared memory after the sweep
        bool alive;
        if (kTris && best_tri >= 0) {
          // a triangle won: its face normal, flipped to oppose the ray
          const float* g = tris + best_tri * kTriCols;
          const float sgn =
              (p.dx * g[9] + p.dy * g[10] + p.dz * g[11]) < 0.f ? 1.f : -1.f;
          const Surface surf{g[9],  g[10], g[11], sgn,   g[12], g[13], g[14],
                             g[15], g[16], g[17], g[18], g[19], g[20]};
          alive = shade_hit<kFlags, kNee>(
              p, surf, best_t, k, pix_mix,
              bounce_salt(sm.primary, refr, kNee, k), refr, true, &nee,
              true);
        } else {
          const float* w = attr + best * kCols;
          const Surface surf{w[0], w[1], w[2], w[14], w[4],  w[5], w[6],
                             w[7], w[8], w[9], w[10], w[11], w[12]};
          alive = shade_hit<kFlags, kNee>(
              p, surf, best_t, k, pix_mix,
              bounce_salt(sm.primary, refr, kNee, k), refr, false, &nee);
        }
        if (!alive) break;
      }
      cr = p.cr;
      cg = p.cg;
      cb = p.cb;
    }
    // the pixel's samples of this round in sample order: every lane of the
    // group adds the group's lanes in turn (the leftover lanes of a warp
    // read lanes mod 32 and keep nothing); a lane that holds its pixel
    // alone adds its own sample, with no shuffle
    if (group == 1) {
      acc_r += cr;
      acc_g += cg;
      acc_b += cb;
    } else {
      const int n = min(group, spp - s0);
      for (int j = 0; j < n; ++j) {
        const int src = pg * group + j;
        acc_r += __shfl_sync(0xffffffffu, cr, src);
        acc_g += __shfl_sync(0xffffffffu, cg, src);
        acc_b += __shfl_sync(0xffffffffu, cb, src);
      }
    }
  }

  if (writes) {
    float* o = out + (size_t)gid * 3;
    if (gamma) {
      o[0] = fminf(fmaxf(sqrtf(fmaxf(acc_r * inv_spp, 0.f)), 0.f), 1.f);
      o[1] = fminf(fmaxf(sqrtf(fmaxf(acc_g * inv_spp, 0.f)), 0.f), 1.f);
      o[2] = fminf(fmaxf(sqrtf(fmaxf(acc_b * inv_spp, 0.f)), 0.f), 1.f);
    } else {  // the linear mean
      o[0] = acc_r * inv_spp;
      o[1] = acc_g * inv_spp;
      o[2] = acc_b * inv_spp;
    }
  }

  // ---- per-tile segment count: one atomic per warp ----
  add_tile_count(seg_count + nee.segs, segs, tile);
  if constexpr (kCount) {  // the segments, then one 64-bit atomic per
                           // counter and block
    atomicAdd(counts + 0, (unsigned long long)seg_count);
    atomicAdd(counts + kVisitCols, (unsigned long long)nee.segs);
    __syncthreads();
    if (threadIdx.x < kVisitCounts)
      atomicAdd(visits + (size_t)tile * kVisitCounts + threadIdx.x,
                counts[threadIdx.x]);
  }
}

// The current device's SM count, read from the runtime once per device:
// a launch is on the host's path, which sets the demo frame's time.
constexpr int kMaxDevices = 64;
int sm_count() {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < kMaxDevices) {
    sms = cached[dev].load(std::memory_order_relaxed);
    if (sms > 0) return sms;
  }
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev >= 0 && dev < kMaxDevices)
    cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// Samples a lane traces in turn: 1 with NEE, whose paths' work varies most,
// so that a lane per sample balances it; else the most, a power of two up
// to spp, that leave the frame 8 waves of the card's resident threads (4
// blocks of 256 a SM), which spreads a thread's set-up over its samples
// without a ragged last wave. Chosen by the A/B on the card (PERF.md §6):
// 2 at 640x480/8spp, 4 (a lane per pixel) at 1080p/4spp.
int samples_per_lane(int spp, int n_tiles, bool nee) {
  int m = 1;
  if (nee) return m;
  const int sms = sm_count();
  if (sms < 1) return m;
  const long long waves8 = 8LL * sms * 4 * kBlock;
  const long long samples = (long long)n_tiles * kTile * spp;
  while (2 * m <= spp && samples / (2 * m) >= waves8) m *= 2;
  return m;
}

template <bool kCount>
using KernelFn = decltype(&megakernel<false, false, false, kCount>);

// The instantiation for a launch: per mesh / no mesh, flag-free, kFlags or
// kNee (always with kFlags); the counting ones only with kFlags, whose
// flags are uniform branches.
template <bool kCount>
KernelFn<kCount> pick(bool tris, bool flags, bool nee) {
  if (nee)
    return tris ? megakernel<true, true, true, kCount>
                : megakernel<false, true, true, kCount>;
  if (kCount || flags)
    return tris ? megakernel<true, true, false, kCount>
                : megakernel<false, true, false, kCount>;
  if constexpr (!kCount)  // no flag-free counting instantiation
    return tris ? megakernel<true, false, false, false>
                : megakernel<false, false, false, false>;
  return nullptr;
}

}  // namespace

extern "C" {

// Launches the megakernel on `stream`. `out` is (n_pix, 3) f32, `segs`
// (n_tiles,) int32 and zeroed by the caller; `attr` (n_spheres, 16), `tris`
// (n_tris, 21) (or null with n_tris 0), `cam` (16,) and `bg` (3,) f32 on the
// device; with `nee`, attr column 15 holds the light cdf and `bg` (4,) ends
// with the light count. `refract`, `dof`, `stratify` and `nee` switch the
// optional flags on; `gamma` 0 stores the linear mean. A band of rows
// starts at pixel `pixel_offset` (row_offset * width) of the frame of
// `height` rows and holds n_pix pixels. `mask` is null or (n_tiles,) int32
// on the device: a tile with 0 writes zeros and counts no segment.
// `visits` null, or (n_tiles, 2, 4) int64 zeroed by the caller: then the
// counting instantiation runs and adds, per tile, for path and then shadow
// rays, the segments, the sphere and triangle tests (a shadow ray's up to
// its first blocker) and the tests the warps issued.
// Allocates nothing and does not synchronise. Returns cudaGetLastError() of
// the launch.
int tpurt_megakernel_launch(const float* attr, int n_spheres,
                            const float* tris, int n_tris, const float* cam,
                            const float* bg, int seed, int pixel_offset,
                            int width, int height, int spp, int max_depth,
                            int jitter, int refract, int dof, int stratify,
                            int nee, int gamma, int n_tiles, const int* mask,
                            float* out, int n_pix, int* segs, void* visits,
                            void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || n_tris < 0 ||
      n_tris > kMaxTris || (n_tris > 0 && tris == nullptr) || width < 1 ||
      height < 1 || spp < 1 || max_depth < 1 || n_tiles < 1 ||
      pixel_offset < 0 || n_pix < 1 || n_pix > n_tiles * kTile ||
      (long long)pixel_offset + n_pix > (long long)width * height)
    return (int)cudaErrorInvalidValue;
  const float inv_w = (float)(1.0 / (double)width);
  const float inv_h = (float)(1.0 / (double)height);
  const float inv_spp = (float)(1.0 / (double)spp);
  // a pixel's samples on `group` lanes (samples_per_lane a lane, in
  // rounds), `per_warp` pixels a warp
  const int m = samples_per_lane(spp, n_tiles, nee);
  const int group = min(32, (spp + m - 1) / m);
  const int per_warp = 32 / group;
  const int per_block = kWarps * per_warp;
  const int tile_blocks = (kTile + per_block - 1) / per_block;
  const long long blocks = (long long)n_tiles * tile_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool flags = refract || dof || stratify;
  const bool with_tris = n_tris > 0;
  cudaStream_t st = (cudaStream_t)stream;
#define TPURT_MEGA_ARGS                                                      \
  attr, n_spheres, tris, n_tris, cam, bg, (uint32_t)seed,                    \
      (uint32_t)pixel_offset, width, inv_w, inv_h, spp, inv_spp, max_depth,  \
      jitter, refract, dof, stratify, gamma, group, per_warp, tile_blocks,   \
      mask, out, n_pix, segs, static_cast<unsigned long long*>(visits)
  if (visits != nullptr)
    pick<true>(with_tris, flags, nee)<<<(unsigned)blocks, kBlock, 0, st>>>(
        TPURT_MEGA_ARGS);
  else
    pick<false>(with_tris, flags, nee)<<<(unsigned)blocks, kBlock, 0, st>>>(
        TPURT_MEGA_ARGS);
#undef TPURT_MEGA_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
