// Cluster-engine path tracer for large scenes, NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel built by tpu_rt/ops/pallas_cluster.py:567
// _make_kernel (launched by render_cluster) for sphere scenes with or
// without a triangle mesh: the v2 estimator with the optional dielectric
// (refraction) and next-event estimation (NEE), pixel jitter, pixel centres
// or the R2 lattice (stratify), a pinhole or thin-lens camera (DOF), sqrt
// gamma and clamp or the linear mean, per-tile traced segment counts, and
// the implicit
// 3-level Morton hierarchy of tpu_rt_torch/ops/cluster.py:build_clusters
// (super-supers -> supers of 8 -> clusters of C spheres, plus G "global"
// spheres swept for every ray), and a second such hierarchy of triangles
// (build_tri_clusters, with its own globals: the largest-area triangles).
// Randomness is the JAX kernel's interpret-mode counter hash, drawn in the
// same order over the same 32 x 128 screen blocks (stream id
// pyi * width + pxi over the padded grid, seed + tile * spp + s), so the
// kernel can be held stream for stream against the plain PyTorch version.
//
// What bounds it: instruction issue of a divergent per-ray walk. Per bounce
// every ray tests the G globals and the S2 super-super boxes of each table;
// what it tests beyond that depends on the scene and the ray (crossed supers
// x 8 child boxes, crossed clusters x C primitives). The tables are small
// (10k spheres: 0.9 MB; 100k: 7.4 MB; 100k triangles: 9.4 MB) and stay in
// L2; device-memory traffic is the 12 B/pixel colour store. At frames of a
// few waves of blocks, the slowest blocks (rays that cross the most
// clusters) set the time, since each thread loops over all of its pixel's
// samples.
//
// What the design does about it, simply:
//   * one thread per lane of the padded screen-block grid; samples and
//     bounces loop inside the thread, and a dead path leaves the loop;
//   * a stackless walk: for each super-super whose box the ray crosses
//     (slab test bounded by the ray's running best t, AND the box's
//     validity flag), each crossed super, each crossed cluster (box from the
//     last row of the cluster's block), sweep its C spheres. Visiting in
//     storage order (near to far, from order_clusters) lets early hits prune
//     later boxes, and resolves ties as the TPU kernel does;
//   * a block is a 16 x 16 pixel patch and a warp an 8 x 4 patch of one
//     screen block, so the rays of a warp cross mostly the same boxes and
//     read the same table words (broadcast loads);
//   * globals, camera and background in shared memory; the tables read-only
//     from device memory through the read-only cache; the winner is kept as
//     a pointer to its packed row plus a triangle flag, and unpacked (bf16
//     pairs: << 16 and & 0xFFFF0000) once, after the search;
//   * with a mesh, the search per bounce is the TPU kernel's, in its order
//     (ties depend on it): sphere globals, triangle globals (Moller-Trumbore
//     from shared memory), the sphere walk, then the same walk over the
//     triangle hierarchy, pruned by the running best t. A triangle winner's
//     bf16 face normal n is encoded as the TPU kernel encodes it
//     (pallas_cluster.py:915-924): centre (o + d t) - n and 1/r the sign
//     that opposes n to the ray, so the sphere shading's (h - c) * (1/r)
//     forms the normal with the same roundings. The triangle path is a
//     template branch: without a mesh the kernel is the sphere kernel;
//   * refraction, the thin lens and the R2 lattice (pallas_cluster.py:
//     1199-1247, 1375-1406) live in the kFlags instantiations as uniform
//     branches (path_common.cuh); the winner's ior is the bf16 high half of
//     its (rgh, ior) word. The R2 shift is keyed by seed + tile * spp,
//     without the sample term, as the TPU kernel keys it across its spp
//     grid steps. Refracted rays start inside spheres: the slab test clamps
//     its entry at 1e-3 and the sphere test keeps the far root, so the walk
//     needs no change for them;
//   * next-event estimation (pallas_cluster.py:1257-1321, 1408-1520) lives
//     in the kNee instantiations (with the flags as uniform branches): the
//     light table of ops/cluster.py:light_table (n_lights_max rows of
//     cx cy cz r*lw er eg eb cdf, then the light count) is staged into
//     shared memory; a diffuse lane's shadow ray tests the globals and
//     walks both hierarchies again with its best t seeded at the light's
//     entry t less 1e-3, so the slab tests prune every box beyond the
//     light, and stops at its first hit (ClusterNee below). Only lanes
//     whose light is in front of the surface walk;
//   * ``gamma`` = 0 stores the linear mean instead of sqrt gamma and clamp;
//   * segment counts: one integer atomic per block into its tile's slot;
//   * a band of rows (pallas_cluster.py:627-659, 1726-1729, 1850-1860):
//     rows and its first row row0 are multiples of 32; the grid covers the
//     band's screen blocks, pixel rows start at row0, and every stream is
//     keyed by the frame's tile (row0 / 32) * blocks_x + tile, so stitched
//     bands equal the full frame stream for stream. The launch folds the
//     band's first tile into the seed (seed + tile0 * spp, uint32 wrap as
//     the int32 sum), so the kernel keeps the band's own tile, which is
//     also the segment slot and the mask index, and no more values live
//     across the path loop than without bands;
//   * the adaptive tile mask (pallas_cluster.py:1565-1580, 1808-1812): a
//     screen block spans 16 CUDA blocks, so the test is uniform per block.
//     A block whose screen block is masked writes zeros to its in-frame
//     pixels and returns at the top, before the shared-memory loads and
//     their barrier (the caller zeroed its segment slot). It is one
//     branch, not a template instantiation.
//
// Not done here, and left to later work: warp-cooperative traversal (one
// box or sphere per lane), and staging cluster blocks into shared memory
// with cp.async or TMA.

#include "path_common.cuh"

namespace {

constexpr int kSublanes = 32;  // rows of a screen block
constexpr int kLanes = 128;    // columns of a screen block
constexpr int kBlock = 256;    // a 16 x 16 patch; 16 blocks per screen block
constexpr int kFanout = 8;
constexpr int kMaxGlobal = 64;
constexpr int kCols = 16;      // words of a packed sphere or triangle row
constexpr int kMaxLights = 64; // rows of the NEE light table
constexpr int kLightCols = 8;  // cx cy cz r*lw er eg eb cdf

struct Ray {
  float ox, oy, oz;
  float ix, iy, iz;  // 1 / direction, with |d| clamped to >= 1e-20
};

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : (d >= 0.f ? 1e-20f : -1e-20f));
}

// Slab test of the box at b = [lo xyz, hi xyz, flag] against one ray,
// bounded by [1e-3, best_t] (pallas_cluster.py slab6); an empty box (flag 0,
// inverted bounds) is never crossed.
__device__ __forceinline__ bool crosses(const float* __restrict__ b,
                                        const Ray& r, float best_t) {
  if (!(__ldg(b + 6) > 0.f)) return false;
  const float tx0 = (__ldg(b + 0) - r.ox) * r.ix;
  const float tx1 = (__ldg(b + 3) - r.ox) * r.ix;
  const float ty0 = (__ldg(b + 1) - r.oy) * r.iy;
  const float ty1 = (__ldg(b + 4) - r.oy) * r.iy;
  const float tz0 = (__ldg(b + 2) - r.oz) * r.iz;
  const float tz1 = (__ldg(b + 5) - r.oz) * r.iz;
  const float enter = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                            fmaxf(fminf(tz0, tz1), 1e-3f));
  const float exit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fminf(fmaxf(tz0, tz1), best_t));
  return exit >= enter;
}

template <bool kReadOnly>
__device__ __forceinline__ float word(const int* p) {
  if constexpr (kReadOnly) return __int_as_float(__ldg(p));
  return __int_as_float(*p);
}

// The nearest hit so far: its t, its packed row (word f at row[f * stride])
// and whether that row is a triangle's.
struct Best {
  float t;
  const int* row;
  int stride;
  bool tri;
};

// Sphere test of the packed row at ``row``: the NaN-propagating root select
// and the inv_r > 0 validity test. A strictly nearer root replaces the
// winner, so the first of equal roots in visit order wins.
template <bool kReadOnly>
__device__ __forceinline__ void test_sphere(const int* row, int stride,
                                            const Path& p, Best& best) {
  const float ocx = p.ox - word<kReadOnly>(row);
  const float ocy = p.oy - word<kReadOnly>(row + stride);
  const float ocz = p.oz - word<kReadOnly>(row + 2 * stride);
  const float rad = word<kReadOnly>(row + 3 * stride);
  const float half_b = ocx * p.dx + ocy * p.dy + ocz * p.dz;
  const float cq = (ocx * ocx + ocy * ocy + ocz * ocz) - rad * rad;
  // sqrt of a negative discriminant is NaN and fails every compare
  const float sqrtd = sqrtf(half_b * half_b - cq);
  const float root0 = -half_b - sqrtd;
  const float root = root0 >= 1e-3f ? root0 : sqrtd - half_b;
  if (root >= 1e-3f && root < best.t &&
      word<kReadOnly>(row + 4 * stride) > 0.f)
    best = Best{root, row, stride, false};
}

// Moller-Trumbore of the packed triangle row at ``row`` (words 0-8: v0, e1,
// e2); rows with zero edges never hit. A strictly nearer t wins.
template <bool kReadOnly>
__device__ __forceinline__ void test_triangle(const int* row, int stride,
                                              const Path& p, Best& best) {
  const auto w = [&](int f) { return word<kReadOnly>(row + f * stride); };
  const float t = mt_test(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, w(0), w(1),
                          w(2), w(3), w(4), w(5), w(6), w(7), w(8));
  if (t < best.t) best = Best{t, row, stride, true};
}

// One table's hierarchy, in storage order, with no stack: each crossed
// super-super, each of its crossed supers, each of their crossed clusters
// (box from the last row of the cluster's block), whose C rows are tested.
// With kAny it returns true as soon as a cluster gave a hit.
template <bool kTri, bool kAny = false>
__device__ __forceinline__ bool walk(const float* __restrict__ ss_boxes,
                                     int n_ss,
                                     const float* __restrict__ super_boxes,
                                     const int* __restrict__ attr, int C,
                                     const Ray& r, const Path& p, Best& best) {
  const int block_words = (C * kCols / kLanes + 1) * kLanes;
  const int box_word = C * kCols;  // the cluster box: first word of the last row
  for (int a = 0; a < n_ss; ++a) {
    if (!crosses(ss_boxes + a * 8, r, best.t)) continue;
    for (int sp = a * kFanout; sp < (a + 1) * kFanout; ++sp) {
      if (!crosses(super_boxes + sp * 8, r, best.t)) continue;
      for (int c = sp * kFanout; c < (sp + 1) * kFanout; ++c) {
        const int* blk = attr + (size_t)c * block_words;
        if (!crosses(reinterpret_cast<const float*>(blk + box_word), r,
                     best.t))
          continue;
        for (int j = 0; j < C; ++j) {
          if constexpr (kTri)
            test_triangle<true>(blk + j, C, p, best);
          else
            test_sphere<true>(blk + j, C, p, best);
        }
        if constexpr (kAny) {
          if (best.row != nullptr) return true;
        }
      }
    }
  }
  return false;
}

// The cluster engine's NEE light table and shadow test: the pick reads the
// shared-memory light rows; a shadow ray is blocked when the globals or a
// walk of either hierarchy, seeded with best t = t_edge, finds a hit
// (pallas_cluster.py:1498-1506).
template <bool kTris>
struct ClusterNee {
  const float* lights;  // n_lights_max rows of kLightCols
  int n_lights_max;
  float n_lights;
  const int* glob;
  int n_global;
  const int* tglob;
  int n_tri_global;
  const float* ss_boxes;
  int n_ss;
  const float* super_boxes;
  const int* attr;
  int C;
  const float* tss_boxes;
  int n_tri_ss;
  const float* tsuper_boxes;
  const int* tattr;
  int tri_C;
  int segs;

  // the first row whose cdf reaches u (pallas_cluster.py:1433-1442)
  __device__ __forceinline__ Light pick(float u) const {
    for (int n = 0; n < n_lights_max; ++n) {
      const float* l = lights + n * kLightCols;
      if (l[7] >= u) return Light{l[0], l[1], l[2], l[3], l[4], l[5], l[6]};
    }
    return Light{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }

  __device__ __forceinline__ bool occluded(float hx, float hy, float hz,
                                           float dx, float dy, float dz,
                                           float t_edge) const {
    Path s{};
    s.ox = hx; s.oy = hy; s.oz = hz;
    s.dx = dx; s.dy = dy; s.dz = dz;
    Best best{t_edge, nullptr, 1, false};
    for (int g = 0; g < n_global; ++g)
      test_sphere<false>(glob + g * kCols, 1, s, best);
    if constexpr (kTris) {
      for (int g = 0; g < n_tri_global; ++g)
        test_triangle<false>(tglob + g * kCols, 1, s, best);
    }
    if (best.row != nullptr) return true;
    const Ray r{hx, hy, hz, safe_inv(dx), safe_inv(dy), safe_inv(dz)};
    if (walk<false, true>(ss_boxes, n_ss, super_boxes, attr, C, r, s, best))
      return true;
    if constexpr (kTris)
      return walk<true, true>(tss_boxes, n_tri_ss, tsuper_boxes, tattr,
                              tri_C, r, s, best);
    return false;
  }
};

struct Pixel {
  int x, y;
};

// thread -> (tile, sub, lane): block b of a tile covers rows
// (b / 8) * 16 + [0, 16) and lanes (b % 8) * 16 + [0, 16); warp w of the
// block rows (w / 2) * 4 + [0, 4) and lanes (w % 2) * 8 + [0, 8). Returns
// the frame pixel (column, row) of the thread, in a band from row0.
__device__ __forceinline__ Pixel pixel_of(int blocks_x, int row0) {
  const int tile = blockIdx.x / 16;
  const int patch = blockIdx.x % 16;
  const int warp = threadIdx.x >> 5;
  const int i = threadIdx.x & 31;
  const int sub = (patch / 8) * 16 + (warp / 2) * 4 + i / 8;
  const int lane = (patch % 8) * 16 + (warp % 2) * 8 + i % 8;
  return Pixel{(tile % blocks_x) * kLanes + lane,
               row0 + (tile / blocks_x) * kSublanes + sub};
}

template <bool kTris, bool kFlags, bool kNee>
__global__ void __launch_bounds__(kBlock)
cluster_kernel(const int* __restrict__ glob_g, int n_global,
               const float* __restrict__ ss_boxes, int n_ss,
               const float* __restrict__ super_boxes,
               const int* __restrict__ attr, int C,
               const int* __restrict__ tglob_g, int n_tri_global,
               const float* __restrict__ tss_boxes, int n_tri_ss,
               const float* __restrict__ tsuper_boxes,
               const int* __restrict__ tattr, int tri_C,
               const float* __restrict__ cam_g, const float* __restrict__ bg_g,
               const float* __restrict__ lights_g, int n_lights_max,
               uint32_t seed, int row0, int width, int row_end, int blocks_x,
               float inv_w, float inv_h, int spp, float inv_spp,
               int max_depth, int jitter, int refract, int dof,
               int stratify, int gamma, const int* __restrict__ mask,
               float* __restrict__ out, int* __restrict__ segs) {
  if (mask != nullptr && mask[blockIdx.x / 16] == 0) {  // skipped: zeros
    const Pixel px = pixel_of(blocks_x, row0);
    if (px.x < width && px.y < row_end) {
      float* o = out + ((size_t)(px.y - row0) * width + px.x) * 3;
      o[0] = 0.f;
      o[1] = 0.f;
      o[2] = 0.f;
    }
    return;
  }

  __shared__ int glob[kMaxGlobal * kCols];
  __shared__ int tglob[kTris ? kMaxGlobal * kCols : 1];
  __shared__ float lights[kNee ? kMaxLights * kLightCols + 1 : 1];
  __shared__ float cam[16];
  __shared__ float bg[3];

  for (int i = threadIdx.x; i < n_global * kCols; i += kBlock)
    glob[i] = glob_g[i];
  if constexpr (kTris) {
    for (int i = threadIdx.x; i < n_tri_global * kCols; i += kBlock)
      tglob[i] = tglob_g[i];
  }
  if constexpr (kNee) {
    // the rows, then the light count
    for (int i = threadIdx.x; i <= n_lights_max * kLightCols; i += kBlock)
      lights[i] = lights_g[i];
  }
  if (threadIdx.x < 16) cam[threadIdx.x] = cam_g[threadIdx.x];
  if (threadIdx.x < 3) bg[threadIdx.x] = bg_g[threadIdx.x];
  __syncthreads();

  // the pixel is derived again here, after the loads, rather than kept
  // from the mask test: so the path loop's registers are those it had
  // before the mask (ptxas, chip_smoke [2])
  const int tile = blockIdx.x / 16;  // the band's own screen block
  const Pixel pix = pixel_of(blocks_x, row0);
  const int pxi = pix.x;
  const int pyi = pix.y;
  const uint32_t flat = (uint32_t)pyi * (uint32_t)width + (uint32_t)pxi;
  const float px = (float)pxi;
  const float py = (float)pyi;

  const Camera c = load_camera(cam);
  // the R2 shift's stream: seed + tile * spp, without the sample term
  // (seed holds the band's first tile)
  const Sampling sm = make_sampling<kFlags>(
      jitter, stratify, dof, flat, seed + (uint32_t)tile * (uint32_t)spp);
  const bool refr = kFlags && refract;
  ClusterNee<kTris> nee{lights, n_lights_max,
                        kNee ? lights[n_lights_max * kLightCols] : 0.f, glob,
                        n_global, tglob, n_tri_global, ss_boxes, n_ss,
                        super_boxes, attr, C, tss_boxes, n_tri_ss,
                        tsuper_boxes, tattr, tri_C, 0};

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  int seg_count = 0;

  for (int s = 0; s < spp; ++s) {
    // per-tile, per-sample stream seed (int32 wrap in the JAX kernel)
    const uint32_t seed_s = seed + (uint32_t)tile * (uint32_t)spp + (uint32_t)s;
    const uint32_t pix_mix = flat ^ (seed_s * 2654435769u);

    Path p = primary_ray<kFlags>(c, px, py, inv_w, inv_h, pix_mix, s, sm);

    for (int k = 1; k <= max_depth; ++k) {
      ++seg_count;  // only live paths reach this point

      Best best{kTMax, nullptr, 1, false};
      // ---- globals: dense sweeps from shared memory ----
      for (int g = 0; g < n_global; ++g)
        test_sphere<false>(glob + g * kCols, 1, p, best);
      if constexpr (kTris) {
        for (int g = 0; g < n_tri_global; ++g)
          test_triangle<false>(tglob + g * kCols, 1, p, best);
      }

      // ---- the hierarchies, spheres then triangles ----
      const Ray r{p.ox, p.oy, p.oz, safe_inv(p.dx), safe_inv(p.dy),
                  safe_inv(p.dz)};
      walk<false>(ss_boxes, n_ss, super_boxes, attr, C, r, p, best);
      if constexpr (kTris)
        walk<true>(tss_boxes, n_tri_ss, tsuper_boxes, tattr, tri_C, r, p,
                   best);

      if (best.row == nullptr) {  // miss: background, path ends
        p.cr = p.cr + p.tr * bg[0];
        p.cg = p.cg + p.tg * bg[1];
        p.cb = p.cb + p.tb * bg[2];
        break;
      }
      // unpack the winner's packed row (generic loads: shared or global);
      // its materials are 5 bf16-pair words, at word 5 of a sphere row and
      // word 11 of a triangle row
      const int ws = best.stride;
      const int* m = best.row + ((kTris && best.tri) ? 11 : 5) * ws;
      const uint32_t p0 = (uint32_t)m[0];
      const uint32_t p1 = (uint32_t)m[ws];
      const uint32_t p2 = (uint32_t)m[2 * ws];
      const uint32_t p3 = (uint32_t)m[3 * ws];
      const uint32_t p4 = (uint32_t)m[4 * ws];
      float cx, cy, cz, ir;
      if (kTris && best.tri) {
        // the bf16 face normal, encoded as the TPU kernel does
        const uint32_t n0 = (uint32_t)best.row[9 * ws];
        const uint32_t n1 = (uint32_t)best.row[10 * ws];
        const float nx = __uint_as_float(n0 << 16);
        const float ny = __uint_as_float(n0 & 0xFFFF0000u);
        const float nz = __uint_as_float(n1 << 16);
        ir = (p.dx * nx + p.dy * ny + p.dz * nz) < 0.f ? 1.f : -1.f;
        cx = (p.ox + p.dx * best.t) - nx;
        cy = (p.oy + p.dy * best.t) - ny;
        cz = (p.oz + p.dz * best.t) - nz;
      } else {
        cx = __int_as_float(best.row[0]);
        cy = __int_as_float(best.row[ws]);
        cz = __int_as_float(best.row[2 * ws]);
        ir = __int_as_float(best.row[4 * ws]);
      }
      const Surface surf{
          cx, cy, cz, ir,
          __uint_as_float(p0 << 16), __uint_as_float(p0 & 0xFFFF0000u),
          __uint_as_float(p1 << 16), __uint_as_float(p1 & 0xFFFF0000u),
          __uint_as_float(p2 << 16),
          __uint_as_float(p3 << 16), __uint_as_float(p3 & 0xFFFF0000u),
          __uint_as_float(p4 << 16), __uint_as_float(p2 & 0xFFFF0000u)};
      if (!shade_hit<kFlags, kNee>(p, surf, best.t, k, pix_mix,
                                   bounce_salt(sm.primary, refr, kNee, k),
                                   refr, false, &nee, kTris && best.tri))
        break;
    }
    acc_r += p.cr;
    acc_g += p.cg;
    acc_b += p.cb;
  }

  if (pxi < width && pyi < row_end) {
    float* o = out + ((size_t)(pyi - row0) * width + pxi) * 3;
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

  // ---- per-tile segment count: one atomic per block ----
  add_block_count<kBlock>(seg_count + nee.segs, segs, tile);
}

}  // namespace

extern "C" {

// Launches the cluster kernel on `stream`. `glob` is (n_global, 16) int32
// words, `ss_boxes` (n_ss, 8) and `super_boxes` (8 n_ss, 8) f32, `attr`
// (64 n_ss, C/8 + 1, 128) int32 words; the `t`-prefixed triangle tables
// have the same layout (n_tri_ss 0 and null pointers: no mesh); `cam` (16,)
// and `bg` (3,) f32, all on the device; with `nee`, `lights` is the
// (8 n_lights_max + 1,) f32 light table (ops/cluster.py:light_table).
// A band of `rows` rows from frame row `row0` (both multiples of 32 unless
// the band is the whole frame) of the frame of `height` rows: `out` is
// (rows, width, 3) f32; `segs` (n_tiles,) int32, zeroed by the caller,
// with n_tiles = ceil(width/128) * ceil(rows/32); `mask` null or
// (n_tiles,) int32 on the device, a screen block with 0 writing zeros and
// counting no segment. `refract`, `dof`, `stratify` and `nee` switch the
// optional flags on; `gamma` 0 stores the linear mean. Allocates nothing
// and does not synchronise. Returns cudaGetLastError() of the launch.
int tpurt_cluster_launch(const int* glob, int n_global, const float* ss_boxes,
                         int n_ss, const float* super_boxes, const int* attr,
                         int cluster_size, const int* tglob, int n_tri_global,
                         const float* tss_boxes, int n_tri_ss,
                         const float* tsuper_boxes, const int* tattr,
                         int tri_cluster_size, const float* cam,
                         const float* bg, const float* lights,
                         int n_lights_max, int seed, int row0, int rows,
                         int width, int height, int spp, int max_depth,
                         int jitter, int refract, int dof, int stratify,
                         int nee, int gamma, const int* mask, float* out,
                         int* segs, void* stream) {
  if (n_global < 0 || n_global > kMaxGlobal || n_ss < 1 ||
      cluster_size < 8 || cluster_size % 8 != 0 || n_tri_ss < 0 ||
      (n_tri_ss > 0 &&
       (n_tri_global < 0 || n_tri_global > kMaxGlobal ||
        tri_cluster_size < 8 || tri_cluster_size % 8 != 0 ||
        tss_boxes == nullptr || tsuper_boxes == nullptr ||
        tattr == nullptr || (n_tri_global > 0 && tglob == nullptr))) ||
      (nee && (lights == nullptr || n_lights_max < 0 ||
               n_lights_max > kMaxLights)) ||
      width < 1 || height < 1 || spp < 1 || max_depth < 1 || rows < 1 ||
      row0 < 0 || row0 % kSublanes != 0 || row0 + rows > height ||
      (rows != height && rows % kSublanes != 0))
    return (int)cudaErrorInvalidValue;
  const int blocks_x = (width + kLanes - 1) / kLanes;
  const int blocks_y = (rows + kSublanes - 1) / kSublanes;
  const float inv_w = (float)(1.0 / (double)width);
  const float inv_h = (float)(1.0 / (double)height);
  const float inv_spp = (float)(1.0 / (double)spp);
  const int blocks = blocks_x * blocks_y * (kTile / kBlock);
  // the streams' seed with the band's first tile folded in
  const uint32_t seed_band =
      (uint32_t)seed +
      (uint32_t)((row0 / kSublanes) * blocks_x) * (uint32_t)spp;
  const bool flags = refract || dof || stratify;
  auto kernel =
      nee ? (n_tri_ss > 0 ? cluster_kernel<true, true, true>
                          : cluster_kernel<false, true, true>)
          : n_tri_ss > 0 ? (flags ? cluster_kernel<true, true, false>
                                  : cluster_kernel<true, false, false>)
                         : (flags ? cluster_kernel<false, true, false>
                                  : cluster_kernel<false, false, false>);
  kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      glob, n_global, ss_boxes, n_ss, super_boxes, attr, cluster_size, tglob,
      n_tri_global, tss_boxes, n_tri_ss, tsuper_boxes, tattr,
      tri_cluster_size, cam, bg, lights, n_lights_max, seed_band, row0,
      width, row0 + rows, blocks_x, inv_w, inv_h, spp, inv_spp, max_depth,
      jitter, refract, dof, stratify, gamma, mask, out, segs);
  return (int)cudaGetLastError();
}

}  // extern "C"
