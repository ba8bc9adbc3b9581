"""The yardstick of the kernels' rooflines: the work a batch's inputs need,
whatever implements it, and the card's published peaks.

Operations are float32 operations: each add, multiply, compare, min or
max, square root, division or transcendental counts one; the hash's integer
operations are not counted. A batch's operations are its traced segments
(the program's own count of live path bounces and shadow rays) times a
per-segment cost that depends on the scene's primitive counts alone (its
spheres and its triangles), plus the primary rays and the per-pixel mean.
The nearest-hit search of one segment costs the least of two designs: a
flat sweep of every primitive, or a binary hierarchy over all of them (one
box test per level and ``LEAF_TESTS`` tests of the dearer primitive the
scene holds). Which primitives a walk visits, or where it exits early, is
never counted, so a redesign of the walk does not move its own yardstick.
Bytes are the sphere and triangle tables, the camera and the batch's
image, each counted once.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

SPHERE_TEST_OPS = 24  # oc 3, half_b 5, |oc|^2 - r^2 7, disc 2, sqrt,
                      # 2 roots, 4 compares
TRI_TEST_OPS = 52     # Moller-Trumbore: o - v0 3, p = d x e2 9, det 5,
                      # |det| compare 1, 1/det, u 6, q 9, v 6, t 6,
                      # u >= 0, v >= 0, u + v, <= 1, t >= t_min, t < best
SLAB_TEST_OPS = 26    # flag, 6 sub, 6 mul, 6 min/max, enter 3, exit 3,
                      # compare
LEAF_TESTS = 2        # primitive tests at the leaf of a hierarchy
SHADE_OPS = 62        # emission 6, hit point 6, normal 6, unit ball 18,
                      # scatter 23, throughput 3
PRIMARY_OPS = 33      # jitter to a unit camera ray
PIXEL_OPS = 15        # mean, sqrt gamma and clamp of 3 channels
NEE_OPS = 120         # a shadow ray's estimator, its search apart: cosine
                      # sampler 8, suppression 11, pick 1, cone and basis
                      # 76, light entry 23, gate 6, contribution 15
SPHERE_ROW_BYTES = 64  # 16 float32 words a sphere
TRI_ROW_BYTES = 64     # 16 words a triangle: v0, e1, e2 in float32, the
                       # normal and materials as bfloat16 pairs (the
                       # cluster engine's row; the megakernel reads 21
                       # float32 words)
CAMERA_BYTES = 64
PIXEL_BYTES = 12       # float32 RGB


def search_ops(n_prims: int, n_tris: int = 0) -> int:
    """Operations of one nearest-hit (or any-hit) search over ``n_prims``
    spheres and ``n_tris`` triangles."""
    n_s, n_t = int(n_prims), int(n_tris)
    if not n_t:
        n_s = max(1, n_s)
    n = n_s + n_t
    levels = math.ceil(math.log2(n)) if n > 1 else 0
    leaf = TRI_TEST_OPS if n_t else SPHERE_TEST_OPS
    return min(n_s * SPHERE_TEST_OPS + n_t * TRI_TEST_OPS,
               levels * SLAB_TEST_OPS + LEAF_TESTS * leaf)


def batch_ops(segments: int, n_pix: int, spp: int, n_prims: int,
              nee: bool, n_tris: int = 0) -> int:
    """The least float32 operations of one batch of ``segments`` traced
    segments in a scene of ``n_prims`` spheres and ``n_tris`` triangles.
    With NEE the count holds path and shadow segments, at most one shadow
    segment per path segment; the split that costs least is taken."""
    rays = n_pix * spp
    search = search_ops(n_prims, n_tris)

    def cost(shadow):
        path = segments - shadow
        return (path * search + max(path - rays, 0) * SHADE_OPS
                + shadow * (search + NEE_OPS) + rays * PRIMARY_OPS
                + n_pix * PIXEL_OPS)

    return min(cost(0), cost(segments // 2)) if nee else cost(0)


def batch_bytes(n_pix: int, n_prims: int, n_tris: int = 0) -> int:
    """Bytes one batch must move: the sphere and triangle tables and the
    camera read once, the image written once."""
    return (n_prims * SPHERE_ROW_BYTES + n_tris * TRI_ROW_BYTES
            + CAMERA_BYTES + n_pix * PIXEL_BYTES)


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, what bounds it) at the published peaks."""
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
