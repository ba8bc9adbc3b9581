// Native host-side BVH builder + traversal oracle.
//
// The runtime-side native component of the framework (the role the
// reference's C++ core plays around its compute: BVHBuilder,
// cpp_raytracer/raytracer_core.cpp:26-145, and SceneIntersector,
// :150-274). A copy of tpu_rt/native/bvh_builder.cpp. The device path
// builds its own LBVH (tpu_rt_torch/ops/bvh.py); this builder serves the
// host runtime:
//   * instant scene-edit feedback paths (selection raycasts, previews)
//     without a device round-trip,
//   * an independent C++ oracle the device traversal is cross-checked
//     against in tests,
//   * export of DFS-ordered nodes + skip links consumable by the device
//     traversal.
//
// Design notes vs the reference builder: same split policy (longest axis,
// median by centroid, leaves of <= 4 primitives) but children are linked
// during emission in DFS order — the reference assigned them in a second
// BFS-numbered pass over DFS-emitted nodes, which mislinks any tree deeper
// than two levels (SURVEY.md §2.4). Skip links are derived from the DFS
// structure so traversal needs no stack at all.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Box {
  float mn[3];
  float mx[3];

  Box() {
    for (int a = 0; a < 3; ++a) {
      mn[a] = FLT_MAX;
      mx[a] = -FLT_MAX;
    }
  }
  void grow(const Box& o) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], o.mn[a]);
      mx[a] = std::max(mx[a], o.mx[a]);
    }
  }
  float center(int a) const { return 0.5f * (mn[a] + mx[a]); }
};

// Flat node, DFS preorder. For internal nodes the left child is implicitly
// the next node; `right_or_first` holds the right child index. For leaves it
// holds the first primitive slot and `count` > 0.
struct FlatNode {
  Box box;
  int32_t right_or_first;
  int32_t count;  // 0 = internal
  int32_t skip;   // node index to jump to when this subtree is culled
};

struct Builder {
  const Box* prim_boxes;
  std::vector<int32_t> order;  // permuted primitive indices
  std::vector<FlatNode> nodes;
  int leaf_size;

  int build_range(int begin, int end) {
    const int node_index = static_cast<int>(nodes.size());
    nodes.emplace_back();

    Box bounds;
    for (int i = begin; i < end; ++i) bounds.grow(prim_boxes[order[i]]);
    nodes[node_index].box = bounds;

    const int span = end - begin;
    if (span <= leaf_size) {
      nodes[node_index].right_or_first = begin;
      nodes[node_index].count = span;
      return node_index;
    }

    int axis = 0;
    float best = bounds.mx[0] - bounds.mn[0];
    for (int a = 1; a < 3; ++a) {
      const float extent = bounds.mx[a] - bounds.mn[a];
      if (extent > best) {
        best = extent;
        axis = a;
      }
    }
    const int mid = begin + span / 2;
    std::nth_element(
        order.begin() + begin, order.begin() + mid, order.begin() + end,
        [this, axis](int32_t lhs, int32_t rhs) {
          return prim_boxes[lhs].center(axis) < prim_boxes[rhs].center(axis);
        });

    nodes[node_index].count = 0;
    build_range(begin, mid);  // left = node_index + 1 by construction
    nodes[node_index].right_or_first = build_range(mid, end);
    return node_index;
  }

  void assign_skips(int node, int skip_to) {
    FlatNode& fn = nodes[node];
    fn.skip = skip_to;
    if (fn.count == 0) {
      const int right = fn.right_or_first;
      assign_skips(node + 1, right);  // left subtree skips to right child
      assign_skips(right, skip_to);
    }
  }
};

inline bool slab_hit(const Box& b, const float o[3], const float inv_d[3],
                     float t_min, float t_max) {
  // Running-interval slab test (AABB::intersect, raytracer_core.h:132-153).
  for (int a = 0; a < 3; ++a) {
    float t0 = (b.mn[a] - o[a]) * inv_d[a];
    float t1 = (b.mx[a] - o[a]) * inv_d[a];
    if (t0 > t1) std::swap(t0, t1);
    t_min = std::max(t_min, t0);
    t_max = std::min(t_max, t1);
    if (t_max <= t_min) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Builds the BVH over n primitive AABBs given as (n,3) mins and maxs.
// Outputs (caller-allocated, capacity 2n-1 nodes / n indices):
//   out_bounds : (2n-1, 6) float  [min xyz, max xyz], DFS order
//   out_meta   : (2n-1, 3) int32  [right_or_first, count, skip]
//   out_order  : (n,) int32 permuted primitive indices
// Returns the node count, or -1 on bad input.
int32_t tpurt_bvh_build(const float* bb_min, const float* bb_max, int32_t n,
                        int32_t leaf_size, float* out_bounds,
                        int32_t* out_meta, int32_t* out_order) {
  if (n <= 0 || leaf_size <= 0) return -1;

  std::vector<Box> boxes(n);
  for (int i = 0; i < n; ++i) {
    for (int a = 0; a < 3; ++a) {
      boxes[i].mn[a] = bb_min[i * 3 + a];
      boxes[i].mx[a] = bb_max[i * 3 + a];
    }
  }

  Builder b;
  b.prim_boxes = boxes.data();
  b.leaf_size = leaf_size;
  b.order.resize(n);
  for (int i = 0; i < n; ++i) b.order[i] = i;
  b.nodes.reserve(2 * n - 1);
  b.build_range(0, n);
  b.assign_skips(0, static_cast<int>(b.nodes.size()));

  const int node_count = static_cast<int>(b.nodes.size());
  for (int i = 0; i < node_count; ++i) {
    const FlatNode& fn = b.nodes[i];
    for (int a = 0; a < 3; ++a) {
      out_bounds[i * 6 + a] = fn.box.mn[a];
      out_bounds[i * 6 + 3 + a] = fn.box.mx[a];
    }
    out_meta[i * 3 + 0] = fn.right_or_first;
    out_meta[i * 3 + 1] = fn.count;
    out_meta[i * 3 + 2] = fn.skip;
  }
  for (int i = 0; i < n; ++i) out_order[i] = b.order[i];
  return node_count;
}

// Stackless closest-hit sphere traversal over a built BVH.
// centers (n,3), radii (n,): primitive data in ORIGINAL order.
// rays: origins/directions (r,3). Outputs per ray: t (T_MAX on miss) and
// the original primitive index (-1 on miss).
void tpurt_bvh_intersect_spheres(
    const float* bounds, const int32_t* meta, const int32_t* order,
    int32_t node_count, const float* centers, const float* radii,
    const float* origins, const float* directions, int32_t n_rays,
    float t_min, float t_max, float* out_t, int32_t* out_prim) {
  for (int r = 0; r < n_rays; ++r) {
    const float* o = origins + r * 3;
    const float* d = directions + r * 3;
    float inv_d[3];
    for (int a = 0; a < 3; ++a) {
      const float da = d[a];
      inv_d[a] = 1.0f / (std::fabs(da) > 1e-20f ? da
                                                : (da >= 0 ? 1e-20f : -1e-20f));
    }

    float closest = t_max;
    int32_t best = -1;
    int32_t node = 0;
    while (node < node_count) {
      const float* nb = bounds + node * 6;
      Box box;
      for (int a = 0; a < 3; ++a) {
        box.mn[a] = nb[a];
        box.mx[a] = nb[3 + a];
      }
      const int32_t count = meta[node * 3 + 1];
      const int32_t skip = meta[node * 3 + 2];
      if (!slab_hit(box, o, inv_d, t_min, closest)) {
        node = skip;
        continue;
      }
      if (count > 0) {
        const int32_t first = meta[node * 3 + 0];
        for (int32_t k = 0; k < count; ++k) {
          const int32_t prim = order[first + k];
          const float* c = centers + prim * 3;
          const float rad = radii[prim];
          // stable oc-form quadratic (raytracer_core.h:194-207)
          float oc[3] = {o[0] - c[0], o[1] - c[1], o[2] - c[2]};
          const float a2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
          const float half_b = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2];
          const float cq =
              oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - rad * rad;
          const float disc = half_b * half_b - a2 * cq;
          if (disc < 0) continue;
          const float sq = std::sqrt(disc);
          float root = (-half_b - sq) / a2;
          if (root < t_min || root > closest) {
            root = (-half_b + sq) / a2;
            if (root < t_min || root > closest) continue;
          }
          closest = root;
          best = prim;
        }
        node = skip;
      } else {
        node = node + 1;  // enter left child
      }
    }
    out_t[r] = best >= 0 ? closest : t_max;
    out_prim[r] = best;
  }
}

}  // extern "C"
