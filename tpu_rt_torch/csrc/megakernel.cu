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
// is the 12 B/pixel colour store. Each thread runs a divergent loop
// (samples x bounces x primitives) of dependent arithmetic and
// transcendentals.
//
// What the design does about it:
//   * one thread per pixel, samples and bounces looped inside the thread; a
//     path that dies leaves the bounce loop, so dead lanes cost nothing once
//     the whole warp is dead;
//   * each block stages the attribute table, camera and background into
//     shared memory once; every thread of a warp reads the same word in the
//     sphere sweep, which is a broadcast with no bank conflict;
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
//     without them. The R2 shift is drawn once per thread, keyed by the
//     per-tile seed without the sample term (salts 9001, 9002);
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
//     is exact and independent of order;
//   * a band of rows (pallas_megakernel.py:818, 858-860, 894-896) is the
//     pixel offset row_offset * width: the hash's pixel id and the camera
//     coordinates are the full frame's (inv_h from its height), the tile
//     seed and the output index the band's own;
//   * the adaptive tile mask (pallas_megakernel.py:768-787, 916-919): a
//     4096-ray tile spans kTile / kBlock whole blocks, so the test is
//     uniform per block. A block whose tile is masked writes zeros to its
//     real pixels and returns at the top, before the shared-memory loads
//     and the block reduction (the caller zeroed its segment slot). It is
//     one branch, not a template instantiation.
//
// The grid covers n_tiles * 4096 threads, like the TPU grid of 4096-ray
// tiles: lanes past the last pixel trace and count segments too (so the
// with_stats scaling is the JAX package's), but store nothing.
//
// Build without fast-math: the root selection relies on IEEE compares with
// the NaN of sqrt(negative) being false.

#include "path_common.cuh"

namespace {

constexpr int kBlock = 256;  // threads per block; divides kTile
constexpr int kMaxSpheres = 64;
constexpr int kCols = 16;    // attribute columns (ops/intersect.py)
constexpr int kMaxTris = 256;
// triangle columns (ops/megakernel.py:_pack_tris): v0 0-2, e1 3-5, e2 6-8,
// normal 9-11, albedo 12-14, metallic 15, roughness 16, emission 17-19,
// ior 20
constexpr int kTriCols = 21;

// The megakernel's NEE light table: the shared-memory attribute rows, whose
// column 15 holds the uniform light cdf, and the rows the shadow ray sweeps.
struct MegaNee {
  const float* attr;
  int n_spheres;
  const float* tris;
  int n_tris;
  float n_lights;
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
  // (pallas_megakernel.py:613-657)
  __device__ __forceinline__ bool occluded(float hx, float hy, float hz,
                                           float dx, float dy, float dz,
                                           float t_edge) const {
    for (int n = 0; n < n_spheres; ++n) {
      const float* a = attr + n * kCols;
      const float ocx = hx - a[0];
      const float ocy = hy - a[1];
      const float ocz = hz - a[2];
      const float half_b = ocx * dx + ocy * dy + ocz * dz;
      const float cq = (ocx * ocx + ocy * ocy + ocz * ocz) - a[3] * a[3];
      const float sqrtd = sqrtf(half_b * half_b - cq);
      const float root0 = -half_b - sqrtd;
      const float root = root0 >= 1e-3f ? root0 : sqrtd - half_b;
      if (root >= 1e-3f && root < t_edge && a[14] > 0.f) return true;
    }
    for (int n = 0; n < n_tris; ++n) {
      const float* g = tris + n * kTriCols;
      if (mt_test(hx, hy, hz, dx, dy, dz, g[0], g[1], g[2], g[3], g[4], g[5],
                  g[6], g[7], g[8]) < t_edge)
        return true;
    }
    return false;
  }
};

template <bool kTris, bool kFlags, bool kNee>
__global__ void __launch_bounds__(kBlock)
megakernel(const float* __restrict__ attr_g, int n_spheres,
           const float* __restrict__ tris_g, int n_tris,
           const float* __restrict__ cam_g, const float* __restrict__ bg_g,
           uint32_t seed, uint32_t pixel_offset, int width, float inv_w,
           float inv_h, int spp, float inv_spp, int max_depth, int jitter,
           int refract, int dof, int stratify, int gamma,
           const int* __restrict__ mask, float* __restrict__ out, int n_pix,
           int* __restrict__ segs) {
  const int gid = blockIdx.x * kBlock + threadIdx.x;
  const int tile = gid / kTile;
  if (mask != nullptr && mask[tile] == 0) {  // a skipped tile: zeros
    if (gid < n_pix) {
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

  for (int i = threadIdx.x; i < n_spheres * kCols; i += kBlock)
    attr[i] = attr_g[i];
  if constexpr (kTris) {
    for (int i = threadIdx.x; i < n_tris * kTriCols; i += kBlock)
      tris[i] = tris_g[i];
  }
  if (threadIdx.x < 16) cam[threadIdx.x] = cam_g[threadIdx.x];
  if (threadIdx.x < (kNee ? 4 : 3)) bg[threadIdx.x] = bg_g[threadIdx.x];
  __syncthreads();

  const uint32_t flat = pixel_offset + (uint32_t)gid;
  const float px = (float)(flat % (uint32_t)width);
  const float py = (float)(flat / (uint32_t)width);
  // per-tile stream: seed + tile (int32 wrap in the JAX kernel)
  const uint32_t tile_seed = seed + (uint32_t)tile;

  const Camera c = load_camera(cam);
  const Sampling sm =
      make_sampling<kFlags>(jitter, stratify, dof, flat, tile_seed);
  const bool refr = kFlags && refract;
  MegaNee nee{attr, n_spheres, tris, kTris ? n_tris : 0, kNee ? bg[3] : 0.f,
              0};

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  int seg_count = 0;

  for (int s = 0; s < spp; ++s) {
    const uint32_t pix_mix =
        flat ^ ((tile_seed + (uint32_t)s * 7919u) * 2654435769u);

    Path p = primary_ray<kFlags>(c, px, py, inv_w, inv_h, pix_mix, s, sm);

    for (int k = 1; k <= max_depth; ++k) {
      ++seg_count;  // only live paths reach this point

      // ---- sweep all spheres; padding rows have inv_radius 0 ----
      float best_t = kTMax;
      int best = -1;
      for (int n = 0; n < n_spheres; ++n) {
        const float* a = attr + n * kCols;
        const float ocx = p.ox - a[0];
        const float ocy = p.oy - a[1];
        const float ocz = p.oz - a[2];
        const float half_b = ocx * p.dx + ocy * p.dy + ocz * p.dz;
        const float cq = (ocx * ocx + ocy * ocy + ocz * ocz) - a[3] * a[3];
        // sqrt of a negative discriminant is NaN and fails every compare
        const float sqrtd = sqrtf(half_b * half_b - cq);
        const float root0 = -half_b - sqrtd;
        const float root = root0 >= 1e-3f ? root0 : sqrtd - half_b;
        if (root >= 1e-3f && root < best_t && a[14] > 0.f) {
          best_t = root;
          best = n;
        }
      }

      // ---- then the triangles; padding rows have zero edges ----
      int best_tri = -1;
      if constexpr (kTris) {
        for (int n = 0; n < n_tris; ++n) {
          const float* g = tris + n * kTriCols;
          const float t = mt_test(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, g[0],
                                  g[1], g[2], g[3], g[4], g[5], g[6], g[7],
                                  g[8]);
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
            bounce_salt(sm.primary, refr, kNee, k), refr, true, &nee, true);
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
    acc_r += p.cr;
    acc_g += p.cg;
    acc_b += p.cb;
  }

  if (gid < n_pix) {
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
// Allocates nothing and does not synchronise. Returns cudaGetLastError() of
// the launch.
int tpurt_megakernel_launch(const float* attr, int n_spheres,
                            const float* tris, int n_tris, const float* cam,
                            const float* bg, int seed, int pixel_offset,
                            int width, int height, int spp, int max_depth,
                            int jitter, int refract, int dof, int stratify,
                            int nee, int gamma, int n_tiles, const int* mask,
                            float* out, int n_pix, int* segs, void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || n_tris < 0 ||
      n_tris > kMaxTris || (n_tris > 0 && tris == nullptr) || width < 1 ||
      height < 1 || spp < 1 || max_depth < 1 || n_tiles < 1 ||
      pixel_offset < 0 || n_pix < 1 || n_pix > n_tiles * kTile ||
      (long long)pixel_offset + n_pix > (long long)width * height)
    return (int)cudaErrorInvalidValue;
  const float inv_w = (float)(1.0 / (double)width);
  const float inv_h = (float)(1.0 / (double)height);
  const float inv_spp = (float)(1.0 / (double)spp);
  const int blocks = n_tiles * (kTile / kBlock);
  const bool flags = refract || dof || stratify;
  auto kernel =
      nee ? (n_tris > 0 ? megakernel<true, true, true>
                        : megakernel<false, true, true>)
          : n_tris > 0 ? (flags ? megakernel<true, true, false>
                                : megakernel<true, false, false>)
                       : (flags ? megakernel<false, true, false>
                                : megakernel<false, false, false>);
  kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      attr, n_spheres, tris, n_tris, cam, bg, (uint32_t)seed,
      (uint32_t)pixel_offset, width, inv_w, inv_h, spp, inv_spp, max_depth,
      jitter, refract, dof, stratify, gamma, mask, out, n_pix, segs);
  return (int)cudaGetLastError();
}

}  // extern "C"
