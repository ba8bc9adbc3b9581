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
// every ray tests the G globals of each table and then walks the boxes its
// ray crosses; what it visits depends on the scene and the ray, and the
// counting instantiations (kCount) count it: slab tests per level and
// primitive tests per kind, for path and shadow rays apart, plus the
// primitive tests the warps issue. utils/roofline.py:cluster_op_model turns
// the counts into the bound. The tables are small (10k spheres: 0.9 MB;
// 100k: 7.4 MB; 100k triangles: 9.4 MB) and stay in L2; device-memory
// traffic is the 12 B/pixel colour store and the per-sample scratch.
//
// What the design does about it:
//   * one thread per (lane of the padded screen-block grid, sample): the
//     grid's y is the sample within a chunk of samples, so a frame has
//     spp times the blocks of a thread-per-pixel loop and no thread runs a
//     pixel's samples in turn (the slowest threads set a frame's time).
//     Each thread writes its sample's radiance to a scratch plane that the
//     wrapper allocates, of a fixed size whatever spp: a frame with more
//     samples than the scratch holds runs as several chunks in turn. After
//     each chunk a second kernel (cluster_kernel_mean) adds the chunk's
//     samples, in sample order, to each pixel's running sum (0.0f before
//     the first, kept in the output between chunks), as one thread looping
//     over all the samples would, and the last chunk's writes the mean;
//   * the sphere table near to far for each ray, one lane per ray, at
//     every level: a level keeps a bit mask of its children still to
//     visit; each round slab-tests the masked children against the ray's
//     running best t (dropping those it no longer crosses) and descends
//     into the one of least entry t, the lower index on equal entries, so
//     a bounce or shadow ray that starts on a surface visits what lies
//     near its origin first. The super-super
//     level does this for each chunk of 32 super-supers in storage order.
//     Under each cluster a fourth level, of the port's own, holds a box per
//     8 rows (ops/cluster.py:group_boxes, padded to stay conservative), so
//     a ray tests the rows of the groups it crosses, not all C: at terrain
//     10k that cut the triangle tests per segment from 339 to 45;
//   * the triangle table's rows by the warp (warp_walk): a lane's own walk
//     left 9.7 of 32 lanes in each warp-issued triangle test at terrain
//     10k, so in the triangle instantiations every lane runs every bounce
//     (alive in place of break) and the warp meets before the triangle
//     walk. Each lane walks its ray's boxes as above, but each loop of the
//     walk runs while any lane has a round left in it, so the lanes meet
//     at every round of the group level; there teams of 8 lanes test the
//     chosen groups, 4 a pass, a row a lane, and hand each ray its least
//     (t, key), so a ray visits what it visited before. Lanes whose paths
//     have ended serve in the teams. The triangle instantiations ask for 4
//     blocks an SM (64 registers; at 80, 3 blocks, a terrain batch took
//     14% longer). NEE's shadow rays are gathered the same way:
//     shade_hit stores a diffuse lane's ray and its three products
//     (ClusterNee::defer), and after it returns the warp walks the stored
//     rays and the lane adds its products where nothing blocks the ray;
//   * the winner is the least (t, key) over everything the search tests:
//     key = class << 28 | storage index, class 0 sphere globals, 1 sphere
//     rows, 2 triangle globals, 3 triangle rows. It is the dense sweep's
//     first minimum in that order (spheres ahead of triangles, then storage
//     order) whatever the visit order, so every image equals the plain
//     version bit for bit; the winner's row is found from its key after the
//     search and unpacked once (bf16 pairs: << 16 and & 0xFFFF0000);
//   * shadow rays (NEE) are any-hit: they return at the first primitive
//     with t in [1e-3, t_edge), globals included (in the triangle walk at
//     the first group with one);
//   * the super-super and super boxes of both tables are staged into
//     shared memory when they fit (32 KB: 113 super-supers, 460k
//     primitives at C = 64; past it they are read from device memory
//     through the same pointers), beside the globals, camera, background
//     and the NEE light table; the cluster blocks stay in device memory
//     (read-only cache);
//   * a block is a 16 x 16 pixel patch and a warp an 8 x 4 patch of one
//     screen block, so the rays of a warp cross mostly the same boxes and
//     read the same table words (broadcast loads);
//   * with a mesh, a triangle winner's bf16 face normal n is encoded as the
//     TPU kernel encodes it (pallas_cluster.py:915-924): centre (o + d t) -
//     n and 1/r the sign that opposes n to the ray, so the sphere shading's
//     (h - c) * (1/r) forms the normal with the same roundings. The
//     triangle path is a template branch: without a mesh the kernel is the
//     sphere kernel;
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
//     walks both hierarchies with best t fixed at the light's entry t less
//     1e-3, so the slab tests prune every box beyond the light
//     (ClusterNee below). Only lanes whose light is in front of the surface
//     walk;
//   * ``gamma`` = 0 stores the linear mean instead of sqrt gamma and clamp;
//   * segment counts: one integer atomic per warp into its tile's slot
//     (add_tile_count);
//     the visit counts (kCount): shared-memory atomics per block, then one
//     64-bit atomic per count and block into the tile's slots;
//   * a band of rows (pallas_cluster.py:627-659, 1726-1729, 1850-1860):
//     rows and its first row row0 are multiples of 32; the grid covers the
//     band's screen blocks, pixel rows start at row0, and every stream is
//     keyed by the frame's tile (row0 / 32) * blocks_x + tile, so stitched
//     bands equal the full frame stream for stream. The launch folds the
//     band's first tile into the seed (seed + tile0 * spp, uint32 wrap as
//     the int32 sum), so the kernel keeps the band's own tile, which is
//     also the segment slot and the mask index;
//   * the adaptive tile mask (pallas_cluster.py:1565-1580, 1808-1812): a
//     screen block spans 16 CUDA blocks per sample, so the test is uniform
//     per block. A block whose screen block is masked returns at the top,
//     before the shared-memory loads and their barrier; the mean pass
//     writes zeros to its pixels (the caller zeroed its segment slot). It
//     is one branch, not a template instantiation.
//
// Not done here, and left to later work: the warp's tests for the sphere
// table, and staging cluster blocks into shared memory with cp.async or
// TMA.

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
constexpr int kBoxWords = 8;   // lo xyz, hi xyz, flag, 0
// staged boxes of both tables, at most: with the static arrays (10.4 KB at
// most) under the 48 KB a block takes without opting in; with a mesh the
// triangle walk's 2 KB of results follow them
constexpr int kStageBytes = 32 * 1024;
constexpr int kKeyShift = 28;  // key = class << 28 | storage index
// visit counters per ray kind (path, shadow): slab tests at the
// super-super, super, cluster and group levels, sphere and triangle tests
// (globals included), and the primitive tests the warps issue (the
// triangle tests in the triangle instantiations)
constexpr int kVisitCols = 7;
constexpr int kGroup = 8;  // primitives under one group box
constexpr int kVisitCounts = 2 * kVisitCols;

struct Ray {
  float ox, oy, oz;
  float ix, iy, iz;  // 1 / direction, with |d| clamped to >= 1e-20
};

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : (d >= 0.f ? 1e-20f : -1e-20f));
}

template <bool kLdg>
__device__ __forceinline__ float fword(const float* p) {
  if constexpr (kLdg) return __ldg(p);
  return *p;
}

// Slab test of the box at b = [lo xyz, hi xyz, flag] against one ray,
// bounded by [1e-3, best_t] (pallas_cluster.py slab6): the entry t if the
// ray crosses it, else -1 (no entry is below 1e-3). An empty box (flag 0,
// inverted bounds) is never crossed.
template <bool kLdg>
__device__ __forceinline__ float slab(const float* b, const Ray& r,
                                      float best_t) {
  if (!(fword<kLdg>(b + 6) > 0.f)) return -1.f;
  const float tx0 = (fword<kLdg>(b + 0) - r.ox) * r.ix;
  const float tx1 = (fword<kLdg>(b + 3) - r.ox) * r.ix;
  const float ty0 = (fword<kLdg>(b + 1) - r.oy) * r.iy;
  const float ty1 = (fword<kLdg>(b + 4) - r.oy) * r.iy;
  const float tz0 = (fword<kLdg>(b + 2) - r.oz) * r.iz;
  const float tz1 = (fword<kLdg>(b + 5) - r.oz) * r.iz;
  const float enter = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                            fmaxf(fminf(tz0, tz1), 1e-3f));
  const float exit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fminf(fmaxf(tz0, tz1), best_t));
  return exit >= enter ? enter : -1.f;
}

// slab of a box in device memory on a 16-byte boundary (the triangle
// walk's cluster and group boxes), read as two 16-byte words: the same
// arithmetic, so the same entry t, in 2 load instructions in place of 7.
__device__ __forceinline__ float slab_v(const float* b, const Ray& r,
                                        float best_t) {
  // lo xyz and hi x, then hi yz, the flag and 0
  const float4 w0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 w1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float tx0 = (w0.x - r.ox) * r.ix;
  const float tx1 = (w0.w - r.ox) * r.ix;
  const float ty0 = (w0.y - r.oy) * r.iy;
  const float ty1 = (w1.x - r.oy) * r.iy;
  const float tz0 = (w0.z - r.oz) * r.iz;
  const float tz1 = (w1.y - r.oz) * r.iz;
  const float enter = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                            fmaxf(fminf(tz0, tz1), 1e-3f));
  const float exit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fminf(fmaxf(tz0, tz1), best_t));
  return w1.z > 0.f && exit >= enter ? enter : -1.f;
}

template <bool kReadOnly>
__device__ __forceinline__ float word(const int* p) {
  if constexpr (kReadOnly) return __int_as_float(__ldg(p));
  return __int_as_float(*p);
}

// The nearest hit so far: its t and its key (class << 28 | storage
// index; -1 before any hit, so nothing equal to the starting t replaces
// it).
struct Best {
  float t;
  int key;
};

// Whether (t, key) is a better hit than ``best``: nearer, or as near and
// earlier in the dense sweep's order. NaN fails.
__device__ __forceinline__ bool better(float t, int key, const Best& best) {
  return t < best.t || (t == best.t && key < best.key);
}

// Sphere test of the packed row at ``row``: the NaN-propagating root select
// and the inv_r > 0 validity test. Nearest-hit (kAny false): a better
// (t, key) replaces the winner. Any-hit (kAny): true for a root in
// [1e-3, best.t).
template <bool kReadOnly, bool kAny>
__device__ __forceinline__ bool test_sphere(const int* row, int stride,
                                            const Path& p, Best& best,
                                            int key) {
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
  if constexpr (kAny) {
    return root >= 1e-3f && root < best.t &&
           word<kReadOnly>(row + 4 * stride) > 0.f;
  } else {
    if (root >= 1e-3f && better(root, key, best) &&
        word<kReadOnly>(row + 4 * stride) > 0.f)
      best = Best{root, key};
    return false;
  }
}

// Moller-Trumbore of the packed triangle row at ``row`` (words 0-8: v0, e1,
// e2); rows with zero edges never hit (NaN). As test_sphere.
template <bool kReadOnly, bool kAny>
__device__ __forceinline__ bool test_triangle(const int* row, int stride,
                                              const Path& p, Best& best,
                                              int key) {
  const auto w = [&](int f) { return word<kReadOnly>(row + f * stride); };
  const float t = mt_test(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, w(0), w(1),
                          w(2), w(3), w(4), w(5), w(6), w(7), w(8));
  if constexpr (kAny) {
    return t < best.t;
  } else {
    if (better(t, key, best)) best = Best{t, key};
    return false;
  }
}

// The visit counters (kCount): the block's kVisitCounts counters in shared
// memory, added to by shared-memory atomics, so the walk keeps no counter
// in its registers and the timed instantiations' registers stay as they
// are; or nothing.
template <bool kCount>
struct Visits {
  unsigned long long* n;
  __device__ __forceinline__ void add(int i, int k) const {
    atomicAdd(n + i, (unsigned long long)k);
  }
  // one primitive test of ray kind ``kind``; the warp's first active lane
  // also counts it as a test the warps issued
  __device__ __forceinline__ void prim(int i, int kind) const {
    atomicAdd(n + i, 1ull);
    if ((int)(threadIdx.x & 31) == __ffs(__activemask()) - 1)
      atomicAdd(n + kind * kVisitCols + 6, 1ull);
  }
};
template <>
struct Visits<false> {
  unsigned long long* n;
  __device__ __forceinline__ void add(int, int) const {}
  __device__ __forceinline__ void prim(int, int) const {}
};

// One hierarchy's tables: the globals (shared memory), the super-super and
// super boxes (shared memory when staged, else device memory), the cluster
// blocks and the group boxes (device memory).
struct Table {
  const int* glob;
  int n_global;
  const float* ss;
  const float* super;
  int n_ss;
  const int* attr;
  int C;
  const float* group;  // (K, C / 8, 8): a box per 8 rows of a cluster
};

// The next child to visit in a round of a level: slab-tests the children
// whose bit is set in ``m`` (boxes at ``boxes + i * kBoxWords``) against
// best_t, clears those the ray no longer crosses, and returns the one of
// least entry t (the lowest index on equal entries), or -1. kVec: the
// boxes lie in device memory on 16-byte boundaries (slab_v).
template <bool kLdg, bool kVec = false>
__device__ __forceinline__ int next_child(const float* boxes, uint32_t& m,
                                          const Ray& r, float best_t) {
  int c = -1;
  float ec = 0.f;
  for (uint32_t b = m; b != 0u; b &= b - 1u) {
    const int i = __ffs(b) - 1;
    float e;
    if constexpr (kVec)
      e = slab_v(boxes + i * kBoxWords, r, best_t);
    else
      e = slab<kLdg>(boxes + i * kBoxWords, r, best_t);
    if (e < 0.f) {
      m &= ~(1u << i);
    } else if (c < 0 || e < ec) {
      c = i;
      ec = e;
    }
  }
  return c;
}

// The globals of one table, in storage order (class cls). Any-hit returns
// true at the first hit. kWarp false counts the tests but not as tests the
// warps issued (the sphere tests of the triangle kernels, whose warp column
// counts triangle tests).
template <bool kTri, bool kAny, bool kCount, bool kWarp = true>
__device__ __forceinline__ bool sweep_globals(const Table& T, int cls,
                                              const Path& p, Best& best,
                                              const Visits<kCount>& vis) {
  constexpr int kind = kAny ? 1 : 0;
  constexpr int col = kind * kVisitCols + (kTri ? 5 : 4);
  for (int g = 0; g < T.n_global; ++g) {
    if constexpr (kWarp) vis.prim(col, kind);
    else vis.add(col, 1);
    const int key = (cls << kKeyShift) | g;
    if constexpr (kTri) {
      if (test_triangle<false, kAny>(T.glob + g * kCols, 1, p, best, key))
        return true;
    } else {
      if (test_sphere<false, kAny>(T.glob + g * kCols, 1, p, best, key))
        return true;
    }
  }
  return false;
}

// The sphere table's hierarchy (class cls), one lane per ray, near to far:
// super-supers in chunks of 32 (storage order between chunks), then their
// supers, then their clusters (box from the last row of the cluster's
// block), then the cluster's groups of 8 rows (chunks of 32 groups), each
// level by rounds of next_child; a group's 8 rows are tested in storage
// order. Any-hit returns true at the first hit. kWarp as sweep_globals.
template <bool kAny, bool kCount, bool kWarp = true>
__device__ __forceinline__ bool walk(const Table& T, int cls, const Ray& r,
                                     const Path& p, Best& best,
                                     const Visits<kCount>& vis) {
  constexpr int kind = kAny ? 1 : 0;
  constexpr int c0 = kind * kVisitCols;
  const int C = T.C;
  const int block_words = (C * kCols / kLanes + 1) * kLanes;
  const int box_word = C * kCols;  // the cluster box: first word of the last row
  for (int base = 0; base < T.n_ss; base += 32) {
    const int n = min(32, T.n_ss - base);
    uint32_t ms = n == 32 ? 0xffffffffu : (1u << n) - 1u;
    while (ms != 0u) {
      vis.add(c0 + 0, __popc(ms));
      const int a = next_child<false>(T.ss + base * kBoxWords, ms, r, best.t);
      if (a < 0) break;
      ms &= ~(1u << a);
      const int s0 = (base + a) * kFanout;  // its first super
      uint32_t mp = 0xffu;
      while (mp != 0u) {
        vis.add(c0 + 1, __popc(mp));
        const int s = next_child<false>(T.super + s0 * kBoxWords, mp, r,
                                        best.t);
        if (s < 0) break;
        mp &= ~(1u << s);
        const int k0 = (s0 + s) * kFanout;  // its first cluster
        uint32_t mc = 0xffu;
        while (mc != 0u) {
          vis.add(c0 + 2, __popc(mc));
          // the cluster boxes lie block_words apart, in the blocks' last rows
          int c = -1;
          float ec = 0.f;
          for (uint32_t b = mc; b != 0u; b &= b - 1u) {
            const int i = __ffs(b) - 1;
            const float e = slab<true>(
                reinterpret_cast<const float*>(
                    T.attr + (size_t)(k0 + i) * block_words + box_word),
                r, best.t);
            if (e < 0.f) {
              mc &= ~(1u << i);
            } else if (c < 0 || e < ec) {
              c = i;
              ec = e;
            }
          }
          if (c < 0) break;
          mc &= ~(1u << c);
          const int k = k0 + c;
          const int* blk = T.attr + (size_t)k * block_words;
          const int key0 = (cls << kKeyShift) | (k * C);
          const int n_groups = C / kGroup;
          const float* gbox = T.group + (size_t)k * n_groups * kBoxWords;
          for (int gb = 0; gb < n_groups; gb += 32) {
            const int ng = min(32, n_groups - gb);
            uint32_t mg = ng == 32 ? 0xffffffffu : (1u << ng) - 1u;
            while (mg != 0u) {
              vis.add(c0 + 3, __popc(mg));
              const int g = next_child<true>(gbox + gb * kBoxWords, mg, r,
                                             best.t);
              if (g < 0) break;
              mg &= ~(1u << g);
              const int j0 = (gb + g) * kGroup;
              for (int j = j0; j < j0 + kGroup; ++j) {
                if constexpr (kWarp) vis.prim(c0 + 4, kind);
                else vis.add(c0 + 4, 1);
                if (test_sphere<true, kAny>(blk + j, C, p, best, key0 + j))
                  return true;
              }
            }
          }
        }
      }
    }
  }
  return false;
}

// ---- the triangle table's walk: each lane its own boxes, the warp the rows ----
//
// Each lane walks its ray's triangle hierarchy as the sphere walk does,
// near to far by rounds of next_child at every level, but every loop of the
// walk runs while any lane of the warp has a round left in it, so the
// lanes meet at each round of the group level. There the warp tests the
// groups its lanes chose, 4 at a time: team t of kTeam lanes takes the
// t-th choosing lane's ray and group, a row a lane; the least (t, key) of
// the team (a selection, so exact), or whether a row blocks the ray, goes
// back to that lane, which merges it into its best and walks on. So a ray
// visits what the sphere walk's rule visits, and lanes whose paths have
// ended serve in the teams.
constexpr int kTeam = 8;  // lanes that test one group's rows together
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// The rows of the groups the lanes in ``chose`` chose (``grp`` in cluster
// ``k``), a pass of 32 / kTeam teams at a time; each such lane merges its
// group's result into ``best`` (nearest-hit) or learns whether a row
// blocks its ray (any-hit: returned). ``res``: the warp's 32 results.
template <bool kAny, bool kCount>
__device__ __forceinline__ bool test_groups(const Table& T, int cls,
                                            const Path& p, Best& best,
                                            uint32_t chose, int k, int grp,
                                            Best* res,
                                            const Visits<kCount>& vis) {
  constexpr int c0 = (kAny ? 1 : 0) * kVisitCols;
  const int lane = threadIdx.x & 31;
  const int j = lane % kTeam;
  const int tbase = lane - j;  // the team's first lane
  const int block_words = (T.C * kCols / kLanes + 1) * kLanes;
  for (uint32_t wait = chose; wait != 0u;) {
    uint32_t m = wait;
    for (int q = 0; q < lane / kTeam; ++q) m &= m - 1u;
    const bool has = m != 0u;
    const int src = has ? __ffs(m) - 1 : lane;
    for (int q = 0; q < 32 / kTeam; ++q) wait &= wait - 1u;
    Path tp{};
    tp.ox = __shfl_sync(kFullWarp, p.ox, src);
    tp.oy = __shfl_sync(kFullWarp, p.oy, src);
    tp.oz = __shfl_sync(kFullWarp, p.oz, src);
    tp.dx = __shfl_sync(kFullWarp, p.dx, src);
    tp.dy = __shfl_sync(kFullWarp, p.dy, src);
    tp.dz = __shfl_sync(kFullWarp, p.dz, src);
    const int tk = __shfl_sync(kFullWarp, k, src);
    const int row = __shfl_sync(kFullWarp, grp, src) * kGroup + j;
    const int* const rp = T.attr + (size_t)tk * block_words + row;
    if constexpr (kAny) {
      Best edge{__shfl_sync(kFullWarp, best.t, src), -1};
      const bool hit = has && test_triangle<true, true>(rp, T.C, tp, edge, 0);
      const bool any = (__ballot_sync(kFullWarp, hit) >> tbase) & 0xffu;
      if (has && j == 0) res[src] = Best{0.f, any ? 1 : 0};
    } else {
      Best c{__int_as_float(0x7f800000), 0x7fffffff};  // none: (inf, max)
      if (has)
        test_triangle<true, false>(rp, T.C, tp, c,
                                   (cls << kKeyShift) | (tk * T.C + row));
      // the team's least t, then its first lane at that t: the least key
      float t_min = c.t;
      for (int o = 1; o < kTeam; o <<= 1)
        t_min = fminf(t_min, __shfl_xor_sync(kFullWarp, t_min, o));
      const uint32_t at =
          (__ballot_sync(kFullWarp, c.t == t_min) >> tbase) & 0xffu;
      const int key = __shfl_sync(kFullWarp, c.key, tbase + __ffs(at) - 1);
      if (has && j == 0) res[src] = Best{t_min, key};
    }
    if (has && j == 0) vis.add(c0 + 5, kGroup);
    if (lane == 0) vis.add(c0 + 6, 1);
  }
  __syncwarp();
  bool blocked = false;
  if ((chose >> lane) & 1u) {
    const Best g = res[lane];
    if constexpr (kAny) {
      blocked = g.key != 0;
    } else if (better(g.t, g.key, best)) {
      best = g;
    }
  }
  __syncwarp();  // every lane has read its result before the next pass
  return blocked;
}

// The walk of the triangle table (class cls) for the rays of the lanes with
// ``want``, every lane of the warp taking part (call it converged): ``r``/
// ``p`` are each lane's ray, ``best`` its running best. Nearest-hit: best
// becomes the least (t, key) over best and every row the walk tests.
// Any-hit (best t = t_edge): returns whether a row has t in [1e-3,
// best.t). ``res``: the warp's 32 results in shared memory. Counts the slab
// tests as walk() does, a group's 8 rows as 8 triangle tests (any-hit too)
// and each pass of the teams as one warp-issued test.
template <bool kAny, bool kCount>
__device__ __forceinline__ bool warp_walk(const Table& T, int cls,
                                          const Ray& r, const Path& p,
                                          Best& best, bool want, Best* res,
                                          const Visits<kCount>& vis) {
  constexpr int c0 = (kAny ? 1 : 0) * kVisitCols;
  const int C = T.C;
  const int G = C / kGroup;
  const int block_words = (C * kCols / kLanes + 1) * kLanes;
  const int box_word = C * kCols;  // the cluster box: first word of the last row
  bool walking = want;  // false once an any-hit ray is blocked
  for (int base = 0; base < T.n_ss; base += 32) {
    uint32_t ms = walking ? low_bits(T.n_ss - base) : 0u;
    while (__any_sync(kFullWarp, ms != 0u)) {
      int a = -1;
      if (ms != 0u) {
        vis.add(c0 + 0, __popc(ms));
        a = next_child<false>(T.ss + base * kBoxWords, ms, r, best.t);
        if (a >= 0) ms &= ~(1u << a);
      }
      const int s0 = (base + a) * kFanout;  // its first super
      uint32_t mp = a >= 0 ? 0xffu : 0u;
      while (__any_sync(kFullWarp, mp != 0u)) {
        int s = -1;
        if (mp != 0u) {
          vis.add(c0 + 1, __popc(mp));
          s = next_child<false>(T.super + s0 * kBoxWords, mp, r, best.t);
          if (s >= 0) mp &= ~(1u << s);
        }
        const int k0 = (s0 + s) * kFanout;  // its first cluster
        uint32_t mc = s >= 0 ? 0xffu : 0u;
        while (__any_sync(kFullWarp, mc != 0u)) {
          int c = -1;
          if (mc != 0u) {
            vis.add(c0 + 2, __popc(mc));
            // the cluster boxes lie block_words apart, in the blocks' last
            // rows
            float ec = 0.f;
            for (uint32_t b = mc; b != 0u; b &= b - 1u) {
              const int i = __ffs(b) - 1;
              const float e = slab_v(
                  reinterpret_cast<const float*>(
                      T.attr + (size_t)(k0 + i) * block_words + box_word),
                  r, best.t);
              if (e < 0.f) {
                mc &= ~(1u << i);
              } else if (c < 0 || e < ec) {
                c = i;
                ec = e;
              }
            }
            if (c >= 0) mc &= ~(1u << c);
          }
          const int k = c >= 0 ? k0 + c : 0;
          const float* gbox = T.group + (size_t)k * G * kBoxWords;
          for (int gb = 0; gb < G; gb += 32) {
            uint32_t mg = walking && c >= 0 ? low_bits(G - gb) : 0u;
            while (__any_sync(kFullWarp, mg != 0u)) {
              int g = -1;
              if (mg != 0u) {
                vis.add(c0 + 3, __popc(mg));
                g = next_child<true, true>(gbox + gb * kBoxWords, mg, r,
                                           best.t);
                if (g >= 0) mg &= ~(1u << g);
              }
              if (test_groups<kAny>(T, cls, p, best,
                                    __ballot_sync(kFullWarp, g >= 0), k,
                                    gb + g, res, vis)) {
                walking = false;  // blocked: the walk stops here
                ms = mp = mc = mg = 0u;
              }
            }
          }
        }
      }
    }
  }
  return want && !walking;
}

// A diffuse lane's shadow ray, held for the warp's walk (triangle kernels):
// origin, direction, t_edge and the three products shade_hit formed.
struct ShadowRay {
  bool on;
  float ox, oy, oz, dx, dy, dz, t_edge;
  float cr, cg, cb;
};

// The cluster engine's NEE light table and shadow test: the pick reads the
// shared-memory light rows. Without a mesh a shadow ray is blocked when the
// globals or a walk of the sphere hierarchy, with best t fixed at t_edge,
// finds a hit (pallas_cluster.py:1498-1506); it stops at the first. With a
// mesh (kDeferred) shade_hit stores the ray in ``shadow`` and the kernel
// traces it: the sphere parts in its lane, the triangle walk with the warp.
template <bool kTris, bool kCount>
struct ClusterNee {
  static constexpr bool kDeferred = kTris;
  const float* lights;  // n_lights_max rows of kLightCols
  int n_lights_max;
  float n_lights;
  Table sph;
  Visits<kCount> vis;  // the block's counters (kCount)
  int segs;
  ShadowRay shadow;  // kDeferred: the ray of this bounce, if any

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
    Best best{t_edge, -1};
    if (sweep_globals<false, true>(sph, 0, s, best, vis)) return true;
    const Ray r{hx, hy, hz, safe_inv(dx), safe_inv(dy), safe_inv(dz)};
    if (walk<true>(sph, 1, r, s, best, vis)) return true;
    return false;
  }

  __device__ __forceinline__ void defer(float hx, float hy, float hz,
                                        float dx, float dy, float dz,
                                        float t_edge, float cr, float cg,
                                        float cb) {
    shadow = ShadowRay{true, hx, hy, hz, dx, dy, dz, t_edge, cr, cg, cb};
  }
};

// The winner's shading attributes, from its key, in a kernel with a mesh.
// (The sphere-only kernels keep this code inline in their bounce loop: as
// a call it changed their compiled code.)
__device__ __forceinline__ Surface winner_surface(
    const Best& best, const Path& p, const int* glob, const int* tglob,
    const int* attr, const int* tattr, int C, int tri_C) {
  // the winner's packed row from its key (generic loads: shared or
  // global); its materials are 5 bf16-pair words, at word 5 of a sphere
  // row and word 11 of a triangle row
  const int cls = best.key >> kKeyShift;
  const int idx = best.key & ((1 << kKeyShift) - 1);
  const bool is_tri = cls >= 2;
  const int* row;
  int ws;
  if ((cls & 1) == 0) {  // a global
    row = (is_tri ? tglob : glob) + idx * kCols;
    ws = 1;
  } else {
    ws = is_tri ? tri_C : C;
    row = (is_tri ? tattr : attr) +
          (size_t)(idx / ws) * ((ws * kCols / kLanes + 1) * kLanes) +
          idx % ws;
  }
  const int* m = row + (is_tri ? 11 : 5) * ws;
  const uint32_t p0 = (uint32_t)m[0];
  const uint32_t p1 = (uint32_t)m[ws];
  const uint32_t p2 = (uint32_t)m[2 * ws];
  const uint32_t p3 = (uint32_t)m[3 * ws];
  const uint32_t p4 = (uint32_t)m[4 * ws];
  float cx, cy, cz, ir;
  if (is_tri) {
    // the bf16 face normal, encoded as the TPU kernel does
    const uint32_t n0 = (uint32_t)row[9 * ws];
    const uint32_t n1 = (uint32_t)row[10 * ws];
    const float nx = __uint_as_float(n0 << 16);
    const float ny = __uint_as_float(n0 & 0xFFFF0000u);
    const float nz = __uint_as_float(n1 << 16);
    ir = (p.dx * nx + p.dy * ny + p.dz * nz) < 0.f ? 1.f : -1.f;
    cx = (p.ox + p.dx * best.t) - nx;
    cy = (p.oy + p.dy * best.t) - ny;
    cz = (p.oz + p.dz * best.t) - nz;
  } else {
    cx = __int_as_float(row[0]);
    cy = __int_as_float(row[ws]);
    cz = __int_as_float(row[2 * ws]);
    ir = __int_as_float(row[4 * ws]);
  }
  return Surface{
      cx, cy, cz, ir,
      __uint_as_float(p0 << 16), __uint_as_float(p0 & 0xFFFF0000u),
      __uint_as_float(p1 << 16), __uint_as_float(p1 & 0xFFFF0000u),
      __uint_as_float(p2 << 16),
      __uint_as_float(p3 << 16), __uint_as_float(p3 & 0xFFFF0000u),
      __uint_as_float(p4 << 16), __uint_as_float(p2 & 0xFFFF0000u)};
}

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

// One (pixel, sample) per thread: sample s0 + blockIdx.y of the frame.
// Writes the sample's radiance to scratch plane (blockIdx.y, channel),
// indexed by the thread's place in the grid.
// The triangle instantiations ask for 4 blocks an SM (64 registers); the
// others for no minimum (0), as they always have.
template <bool kTris, bool kFlags, bool kNee, bool kCount>
__global__ void __launch_bounds__(kBlock, kTris ? 4 : 0)
cluster_kernel(const int* __restrict__ glob_g, int n_global,
               const float* __restrict__ ss_boxes, int n_ss,
               const float* __restrict__ super_boxes,
               const int* __restrict__ attr, int C,
               const float* __restrict__ group_boxes,
               const int* __restrict__ tglob_g, int n_tri_global,
               const float* __restrict__ tss_boxes, int n_tri_ss,
               const float* __restrict__ tsuper_boxes,
               const int* __restrict__ tattr, int tri_C,
               const float* __restrict__ tgroup_boxes,
               const float* __restrict__ cam_g, const float* __restrict__ bg_g,
               const float* __restrict__ lights_g, int n_lights_max,
               uint32_t seed, int row0, int width, int blocks_x,
               float inv_w, float inv_h, int spp, int s0, int max_depth,
               int jitter,
               int refract, int dof, int stratify, int stage,
               const int* __restrict__ mask, float* __restrict__ scratch,
               int* __restrict__ segs,
               unsigned long long* __restrict__ visits) {
  const int tile = blockIdx.x / 16;  // the band's own screen block
  if (mask != nullptr && mask[tile] == 0) return;  // skipped: the mean zeroes

  __shared__ int glob[kMaxGlobal * kCols];
  __shared__ int tglob[kTris ? kMaxGlobal * kCols : 1];
  __shared__ float lights[kNee ? kMaxLights * kLightCols + 1 : 1];
  __shared__ float cam[16];
  __shared__ float bg[3];
  __shared__ unsigned long long counts[kCount ? kVisitCounts : 1];
  extern __shared__ float boxes[];  // staged: ss, super, tri ss, tri super

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
  const int sph_words = n_ss * (1 + kFanout) * kBoxWords;
  if (stage) {
    for (int i = threadIdx.x; i < n_ss * kBoxWords; i += kBlock)
      boxes[i] = ss_boxes[i];
    for (int i = threadIdx.x; i < n_ss * kFanout * kBoxWords; i += kBlock)
      boxes[n_ss * kBoxWords + i] = super_boxes[i];
    if constexpr (kTris) {
      for (int i = threadIdx.x; i < n_tri_ss * kBoxWords; i += kBlock)
        boxes[sph_words + i] = tss_boxes[i];
      for (int i = threadIdx.x; i < n_tri_ss * kFanout * kBoxWords;
           i += kBlock)
        boxes[sph_words + n_tri_ss * kBoxWords + i] = tsuper_boxes[i];
    }
  }
  if (threadIdx.x < 16) cam[threadIdx.x] = cam_g[threadIdx.x];
  if (threadIdx.x < 3) bg[threadIdx.x] = bg_g[threadIdx.x];
  if (kCount && threadIdx.x < kVisitCounts) counts[threadIdx.x] = 0;
  __syncthreads();

  const Table sph{glob, n_global,
                  stage ? boxes : ss_boxes,
                  stage ? boxes + n_ss * kBoxWords : super_boxes,
                  n_ss, attr, C, group_boxes};
  const Table tri{tglob, n_tri_global,
                  stage ? boxes + sph_words : tss_boxes,
                  stage ? boxes + sph_words + n_tri_ss * kBoxWords
                        : tsuper_boxes,
                  n_tri_ss, tattr, tri_C, tgroup_boxes};

  const int s = s0 + (int)blockIdx.y;
  const Pixel pix = pixel_of(blocks_x, row0);
  const uint32_t flat = (uint32_t)pix.y * (uint32_t)width + (uint32_t)pix.x;

  const Camera c = load_camera(cam);
  // the R2 shift's stream: seed + tile * spp, without the sample term
  // (seed holds the band's first tile)
  const Sampling sm = make_sampling<kFlags>(
      jitter, stratify, dof, flat, seed + (uint32_t)tile * (uint32_t)spp);
  const bool refr = kFlags && refract;
  Visits<kCount> vis{counts};
  ClusterNee<kTris, kCount> nee{
      lights, n_lights_max,
      kNee ? lights[n_lights_max * kLightCols] : 0.f, sph, vis, 0};

  // per-tile, per-sample stream seed (int32 wrap in the JAX kernel)
  const uint32_t seed_s = seed + (uint32_t)tile * (uint32_t)spp + (uint32_t)s;
  const uint32_t pix_mix = flat ^ (seed_s * 2654435769u);

  Path p = primary_ray<kFlags>(c, (float)pix.x, (float)pix.y, inv_w, inv_h,
                               pix_mix, s, sm);
  int seg_count = 0;

  if constexpr (kTris) {
    // every lane runs every bounce (alive in place of break), so that the
    // warp tests the triangles together; lanes whose paths have ended serve
    // in its teams. This warp's results lie past the staged boxes.
    const int stage_words =
        stage ? sph_words + n_tri_ss * (1 + kFanout) * kBoxWords : 0;
    Best* const res =
        reinterpret_cast<Best*>(boxes + stage_words) + (threadIdx.x & ~31u);
    bool alive = true;
    for (int k = 1; k <= max_depth; ++k) {
      Best best{kTMax, -1};
      Ray r{};
      if (alive) {
        ++seg_count;
        sweep_globals<false, false, kCount, false>(sph, 0, p, best, vis);
        sweep_globals<true, false>(tri, 2, p, best, vis);
        r = Ray{p.ox, p.oy, p.oz, safe_inv(p.dx), safe_inv(p.dy),
                safe_inv(p.dz)};
        walk<false, kCount, false>(sph, 1, r, p, best, vis);
      }
      warp_walk<false>(tri, 3, r, p, best, alive, res, vis);
      if (alive) {
        if (best.key < 0) {  // miss: background, path ends
          p.cr = p.cr + p.tr * bg[0];
          p.cg = p.cg + p.tg * bg[1];
          p.cb = p.cb + p.tb * bg[2];
          alive = false;
        } else {
          alive = shade_hit<kFlags, kNee>(
              p, winner_surface(best, p, glob, tglob, attr, tattr, C, tri_C),
              best.t, k, pix_mix, bounce_salt(sm.primary, refr, kNee, k),
              refr, false, &nee, (best.key >> kKeyShift) >= 2);
        }
      }
      if constexpr (kNee) {  // this bounce's shadow rays
        const ShadowRay sh = nee.shadow;
        nee.shadow.on = false;
        Path s{};
        Ray sr{};
        Best sb{};
        bool blocked = false;
        if (sh.on) {
          s.ox = sh.ox; s.oy = sh.oy; s.oz = sh.oz;
          s.dx = sh.dx; s.dy = sh.dy; s.dz = sh.dz;
          sb = Best{sh.t_edge, -1};
          blocked = sweep_globals<false, true, kCount, false>(sph, 0, s, sb,
                                                             vis) ||
                    sweep_globals<true, true>(tri, 2, s, sb, vis);
          sr = Ray{sh.ox, sh.oy, sh.oz, safe_inv(sh.dx), safe_inv(sh.dy),
                   safe_inv(sh.dz)};
          blocked = blocked ||
                    walk<true, kCount, false>(sph, 1, sr, s, sb, vis);
        }
        blocked = warp_walk<true>(tri, 3, sr, s, sb, sh.on && !blocked, res,
                                  vis) ||
                  blocked;
        if (sh.on && !blocked) {
          p.cr = p.cr + sh.cr;
          p.cg = p.cg + sh.cg;
          p.cb = p.cb + sh.cb;
        }
      }
    }
  } else {
    for (int k = 1; k <= max_depth; ++k) {
      ++seg_count;  // only live paths reach this point

      Best best{kTMax, -1};
      // ---- globals: dense sweeps from shared memory ----
      sweep_globals<false, false>(sph, 0, p, best, vis);

      // ---- the hierarchy ----
      const Ray r{p.ox, p.oy, p.oz, safe_inv(p.dx), safe_inv(p.dy),
                  safe_inv(p.dz)};
      walk<false>(sph, 1, r, p, best, vis);

      if (best.key < 0) {  // miss: background, path ends
        p.cr = p.cr + p.tr * bg[0];
        p.cg = p.cg + p.tg * bg[1];
        p.cb = p.cb + p.tb * bg[2];
        break;
      }
      // the winner's packed row from its key (generic loads: shared or
      // global); its materials are 5 bf16-pair words, at word 5 of a sphere
      // row and word 11 of a triangle row
      const int cls = best.key >> kKeyShift;
      const int idx = best.key & ((1 << kKeyShift) - 1);
      const bool is_tri = kTris && cls >= 2;
      const int* row;
      int ws;
      if ((cls & 1) == 0) {  // a global
        row = (is_tri ? tglob : glob) + idx * kCols;
        ws = 1;
      } else {
        ws = is_tri ? tri_C : C;
        row = (is_tri ? tattr : attr) +
              (size_t)(idx / ws) * ((ws * kCols / kLanes + 1) * kLanes) +
              idx % ws;
      }
      const int* m = row + (is_tri ? 11 : 5) * ws;
      const uint32_t p0 = (uint32_t)m[0];
      const uint32_t p1 = (uint32_t)m[ws];
      const uint32_t p2 = (uint32_t)m[2 * ws];
      const uint32_t p3 = (uint32_t)m[3 * ws];
      const uint32_t p4 = (uint32_t)m[4 * ws];
      float cx, cy, cz, ir;
      if (is_tri) {
        // the bf16 face normal, encoded as the TPU kernel does
        const uint32_t n0 = (uint32_t)row[9 * ws];
        const uint32_t n1 = (uint32_t)row[10 * ws];
        const float nx = __uint_as_float(n0 << 16);
        const float ny = __uint_as_float(n0 & 0xFFFF0000u);
        const float nz = __uint_as_float(n1 << 16);
        ir = (p.dx * nx + p.dy * ny + p.dz * nz) < 0.f ? 1.f : -1.f;
        cx = (p.ox + p.dx * best.t) - nx;
        cy = (p.oy + p.dy * best.t) - ny;
        cz = (p.oz + p.dz * best.t) - nz;
      } else {
        cx = __int_as_float(row[0]);
        cy = __int_as_float(row[ws]);
        cz = __int_as_float(row[2 * ws]);
        ir = __int_as_float(row[4 * ws]);
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
                                   refr, false, &nee, is_tri))
        break;
    }
  }

  // this sample's radiance, plane (blockIdx.y, channel), coalesced by
  // thread
  const size_t n_lanes = (size_t)gridDim.x * kBlock;
  const size_t g = (size_t)blockIdx.x * kBlock + threadIdx.x;
  const size_t plane = (size_t)blockIdx.y * 3;
  scratch[(plane + 0) * n_lanes + g] = p.cr;
  scratch[(plane + 1) * n_lanes + g] = p.cg;
  scratch[(plane + 2) * n_lanes + g] = p.cb;

  // ---- per-tile segment count: one atomic per warp ----
  add_tile_count(seg_count + nee.segs, segs, tile);
  if constexpr (kCount) {  // one 64-bit atomic per counter and block
    __syncthreads();
    if (threadIdx.x < kVisitCounts)
      atomicAdd(visits + (size_t)tile * kVisitCounts + threadIdx.x,
                counts[threadIdx.x]);
  }
}

// Each pixel's sum of one chunk's ``n`` samples (the grid of
// cluster_kernel without its sample axis), added in sample order to the
// running sum: 0.0f for the ``first`` chunk, else the one the previous
// chunk left in ``out``; so the sum is the one a thread looping over all of
// the pixel's samples forms. The ``last`` chunk writes the mean, with sqrt
// gamma and clamp or linear, the others the running sum; zeros for a
// masked screen block.
__global__ void __launch_bounds__(kBlock)
cluster_kernel_mean(const float* __restrict__ scratch, int n, int first,
                    int last, float inv_spp, int gamma,
                    const int* __restrict__ mask, int blocks_x, int row0,
                    int width, int row_end, float* __restrict__ out) {
  const Pixel px = pixel_of(blocks_x, row0);
  if (px.x >= width || px.y >= row_end) return;
  float* o = out + ((size_t)(px.y - row0) * width + px.x) * 3;
  if (mask != nullptr && mask[blockIdx.x / 16] == 0) {
    o[0] = 0.f;
    o[1] = 0.f;
    o[2] = 0.f;
    return;
  }
  const size_t n_lanes = (size_t)gridDim.x * kBlock;
  const size_t g = (size_t)blockIdx.x * kBlock + threadIdx.x;
  float acc_r = first ? 0.f : o[0];
  float acc_g = first ? 0.f : o[1];
  float acc_b = first ? 0.f : o[2];
  for (int s = 0; s < n; ++s) {
    acc_r += scratch[((size_t)s * 3 + 0) * n_lanes + g];
    acc_g += scratch[((size_t)s * 3 + 1) * n_lanes + g];
    acc_b += scratch[((size_t)s * 3 + 2) * n_lanes + g];
  }
  if (!last) {
    o[0] = acc_r;
    o[1] = acc_g;
    o[2] = acc_b;
  } else if (gamma) {
    o[0] = fminf(fmaxf(sqrtf(fmaxf(acc_r * inv_spp, 0.f)), 0.f), 1.f);
    o[1] = fminf(fmaxf(sqrtf(fmaxf(acc_g * inv_spp, 0.f)), 0.f), 1.f);
    o[2] = fminf(fmaxf(sqrtf(fmaxf(acc_b * inv_spp, 0.f)), 0.f), 1.f);
  } else {  // the linear mean
    o[0] = acc_r * inv_spp;
    o[1] = acc_g * inv_spp;
    o[2] = acc_b * inv_spp;
  }
}

template <bool kCount>
using KernelFn = decltype(&cluster_kernel<false, false, false, kCount>);

// The instantiation for a launch: per mesh / no mesh, flag-free, kFlags or
// kNee (always with kFlags); the counting ones only with kFlags, whose
// flags are uniform branches.
template <bool kCount>
KernelFn<kCount> pick(bool tris, bool flags, bool nee) {
  if (nee)
    return tris ? cluster_kernel<true, true, true, kCount>
                : cluster_kernel<false, true, true, kCount>;
  if (kCount || flags)
    return tris ? cluster_kernel<true, true, false, kCount>
                : cluster_kernel<false, true, false, kCount>;
  return tris ? cluster_kernel<true, false, false, kCount>
              : cluster_kernel<false, false, false, kCount>;
}

}  // namespace

extern "C" {

// Launches the cluster kernel and its mean pass on `stream`, once for each
// chunk of at most `chunk` samples (1 to 65535), in sample order. `glob` is
// (n_global, 16) int32 words, `ss_boxes` (n_ss, 8) and `super_boxes`
// (8 n_ss, 8) f32, `attr` (64 n_ss, C/8 + 1, 128) int32 words,
// `group_boxes` (64 n_ss, C/8, 8) f32 (ops/cluster.py:group_boxes); the
// `t`-prefixed triangle tables have the same layout (n_tri_ss 0 and null
// pointers: no mesh); `cam` (16,) and `bg` (3,) f32, all on the device;
// `tattr` and `tgroup_boxes` on 16-byte boundaries;
// with `nee`, `lights` is the (8 n_lights_max + 1,) f32 light table
// (ops/cluster.py:light_table). A band of `rows` rows from frame row `row0`
// (both multiples of 32 unless the band is the whole frame) of the frame of
// `height` rows: `out` is (rows, width, 3) f32; `scratch` (min(chunk,
// spp), 3, n_tiles * 4096) f32; `segs` (n_tiles,) int32, zeroed by the caller, with
// n_tiles = ceil(width/128) * ceil(rows/32); `mask` null or (n_tiles,)
// int32 on the device, a screen block with 0 writing zeros and counting no
// segment. `visits` null, or (n_tiles, 2, 7) int64 zeroed by the caller:
// then the counting instantiation runs and adds, per tile, for path and
// then shadow rays, the slab tests at the super-super, super, cluster and
// group levels, the sphere and triangle tests, and the primitive tests the
// warps issued (without a mesh sphere tests, with one triangle tests).
// `refract`, `dof`, `stratify` and `nee` switch the optional flags
// on; `gamma` 0 stores the linear mean. Allocates nothing and does not
// synchronise. Returns cudaGetLastError() of the launches.
int tpurt_cluster_launch(const int* glob, int n_global, const float* ss_boxes,
                         int n_ss, const float* super_boxes, const int* attr,
                         int cluster_size, const float* group_boxes,
                         const int* tglob, int n_tri_global,
                         const float* tss_boxes, int n_tri_ss,
                         const float* tsuper_boxes, const int* tattr,
                         int tri_cluster_size, const float* tgroup_boxes,
                         const float* cam,
                         const float* bg, const float* lights,
                         int n_lights_max, int seed, int row0, int rows,
                         int width, int height, int spp, int chunk,
                         int max_depth,
                         int jitter, int refract, int dof, int stratify,
                         int nee, int gamma, const int* mask, float* out,
                         float* scratch, int* segs, void* visits,
                         void* stream) {
  if (n_global < 0 || n_global > kMaxGlobal || n_ss < 1 ||
      cluster_size < 8 || cluster_size % 8 != 0 || n_tri_ss < 0 ||
      (n_tri_ss > 0 &&
       (n_tri_global < 0 || n_tri_global > kMaxGlobal ||
        tri_cluster_size < 8 || tri_cluster_size % 8 != 0 ||
        tss_boxes == nullptr || tsuper_boxes == nullptr ||
        tattr == nullptr || tgroup_boxes == nullptr ||
        (n_tri_global > 0 && tglob == nullptr))) ||
      (nee && (lights == nullptr || n_lights_max < 0 ||
               n_lights_max > kMaxLights)) ||
      width < 1 || height < 1 || spp < 1 || chunk < 1 || chunk > 65535 ||
      max_depth < 1 ||
      rows < 1 || row0 < 0 || row0 % kSublanes != 0 || row0 + rows > height ||
      (rows != height && rows % kSublanes != 0) || scratch == nullptr ||
      group_boxes == nullptr)
    return (int)cudaErrorInvalidValue;
  // the triangle walk reads its cluster and group boxes 16 bytes at a time
  if (n_tri_ss > 0 && (reinterpret_cast<uintptr_t>(tattr) |
                       reinterpret_cast<uintptr_t>(tgroup_boxes)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // the storage index of a key: below 2^28 rows a table
  if ((long long)n_ss * kFanout * kFanout * cluster_size >= (1LL << kKeyShift) ||
      (long long)n_tri_ss * kFanout * kFanout * tri_cluster_size >=
          (1LL << kKeyShift))
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
  const bool tris = n_tri_ss > 0;
  const size_t stage_bytes =
      (size_t)(n_ss + n_tri_ss) * (1 + kFanout) * kBoxWords * sizeof(float);
  const int stage = stage_bytes <= (size_t)kStageBytes;
  // with a mesh, the triangle walk's results follow
  const size_t team_bytes = tris ? (size_t)kBlock * sizeof(Best) : 0;
  const size_t shmem = (stage ? stage_bytes : 0) + team_bytes;
  cudaStream_t st = (cudaStream_t)stream;
#define TPURT_CLUSTER_ARGS                                                   \
  glob, n_global, ss_boxes, n_ss, super_boxes, attr, cluster_size,         \
      group_boxes, tglob, n_tri_global, tss_boxes, n_tri_ss, tsuper_boxes,  \
      tattr, tri_cluster_size, tgroup_boxes, cam, bg, lights, n_lights_max, \
      seed_band, row0,                                                      \
      width, blocks_x, inv_w, inv_h, spp, s0, max_depth, jitter, refract,   \
      dof, stratify, stage, mask, scratch, segs,                            \
      static_cast<unsigned long long*>(visits)
  for (int s0 = 0; s0 < spp; s0 += chunk) {
    const int n = min(chunk, spp - s0);
    const dim3 grid(blocks, n);
    if (visits != nullptr)
      pick<true>(tris, flags, nee)<<<grid, kBlock, shmem, st>>>(
          TPURT_CLUSTER_ARGS);
    else
      pick<false>(tris, flags, nee)<<<grid, kBlock, shmem, st>>>(
          TPURT_CLUSTER_ARGS);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cluster_kernel_mean<<<blocks, kBlock, 0, st>>>(
        scratch, n, s0 == 0, s0 + n == spp, inv_spp, gamma, mask, blocks_x,
        row0, width, row0 + rows, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
#undef TPURT_CLUSTER_ARGS
  return (int)cudaSuccess;
}

}  // extern "C"
