"""Wavefront path-tracing integrator: the lax engine, in plain PyTorch.

Counterpart of ``tpu_rt/ops/integrator.py``. The whole wavefront of R rays
advances through the bounce loop together as struct-of-arrays tensors,
with a boolean ``active`` mask in place of per-ray control flow; the loop
stops when ``max_depth`` is reached or every lane is dead, after one
guaranteed pass. Random draws come from JAX's threefry streams
(``core/rng.py``), split and folded in the JAX package's order (``split(k,
5)`` per bounce, ``fold_in(k, 101 / 102)`` for NEE), so the same key draws
the same samples.

Estimator modes:
  * ``v2`` (default): unbiased Russian roulette with throughput
    compensation after 3 bounces, a deterministic metal-or-diffuse branch.
  * ``v1``: the old core the reference GUI shipped: fixed p = 0.8 roulette
    without compensation once three or more bounces remain, a metal branch
    taken with probability ``metallic``, face-flipped shading normals.

``enable_refraction=True`` makes spheres with metallic == 0, roughness ==
0 and ior > 1 glass (refraction with Schlick-weighted reflection).

No kernel: the JAX function is plain ``jnp``/``lax`` (no ``pallas_call``),
and so is this one plain torch, on the card or the CPU as its tensors lie.

``key`` may also be a batch of S keys, (S, 2), with R a multiple of S:
lanes [s R/S, (s+1) R/S) then draw from key s exactly what a call with
that key alone would draw, so a frame traces all its samples in one call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng as rngmod
from ..core import vecmath as vm
from ..core.camera import TWO_PI
from ..core.types import SphereScene
from ..utils import profiling
from .intersect import attribute_matrix, combine_hits, intersect_brute, _fetch

# Roulette starts strictly after this many bounces.
RR_START_DEPTH = 3
# v2 roulette clamp.
RR_P_MIN, RR_P_MAX = 0.1, 0.95
# v1 fixed continue probability.
V1_RR_P = 0.8
# NEE's 1/pi, as XLA multiplies by it
_INV_PI = float(np.float32(1.0 / np.pi))


def _draw(fn, k: torch.Tensor, R: int, tail=()) -> torch.Tensor:
    """``fn(k, (R,) + tail)`` for one key; for a batch of S keys, each key's
    ``(R / S,) + tail`` draw, stacked along the lanes to R."""
    if k.dim() == 1:
        return fn(k, (R,) + tuple(tail))
    out = fn(k, (R // k.shape[0],) + tuple(tail))
    return out.reshape((R,) + out.shape[2:])


def _scatter_directions(key, d, normal, roughness, cosine=False):
    """Metal and diffuse scatter directions for the whole wavefront, from
    one unit-ball draw (the branches are exclusive per lane).

    metal:   normalize(reflect(normalize(d), n) + roughness * ball)
    diffuse: normalize(n + ball flipped onto n's side); with ``cosine``,
             the exact cosine sampler normalize(n + normalize(ball))
             (n itself where that sum vanishes)."""
    ball = _draw(rngmod.unit_ball, key, d.shape[0])
    refl = vm.reflect(vm.normalize(d), normal)
    metal_dir = vm.normalize(refl + ball * roughness[..., None])
    if cosine:
        cd = normal + vm.normalize(ball)
        degenerate = (vm.length_squared(cd) < 1e-12)[..., None]
        diffuse_dir = torch.where(degenerate, normal, vm.normalize(cd))
    else:
        side = (vm.dot(ball, normal) > 0.0)[..., None]
        diffuse_dir = vm.normalize(normal + torch.where(side, ball, -ball))
    return metal_dir, diffuse_dir


def _sample_light_cone(k_light, k_cone, attr, light_cdf, hp):
    """Pick one emissive sphere per lane from ``light_cdf`` and sample the
    cone it subtends from ``hp``. Returns (dir, weight = 2 pi (1 -
    cos_max) = 1 / pdf, emission, light id, inside); lanes inside the light
    sphere are flagged (the cone is undefined there)."""
    R = hp.shape[0]
    u_l = _draw(rngmod.uniform, k_light, R)
    sel_ge = light_cdf[None, :] >= u_l[:, None]
    first = torch.cumsum(sel_ge.to(torch.int32), dim=-1) == 1
    lat = _fetch((sel_ge & first).to(torch.float32), attr)
    lc, lr = lat[:, 0:3], lat[:, 3]
    le, lid = lat[:, 9:12], lat[:, 13]

    to_l = lc - hp
    d2 = torch.clamp_min(vm.length_squared(to_l), 1e-12)
    sin2_max = (lr * lr) / d2
    inside = sin2_max >= 1.0
    cos_max = vm.sqrt(torch.clamp(1.0 - sin2_max, 0.0, 1.0))

    xi = _draw(rngmod.uniform, k_cone, R, (2,))
    cos_t = 1.0 - xi[:, 0] * (1.0 - cos_max)
    sin_t = vm.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * xi[:, 1]

    w = to_l * vm.rsqrt(d2)[:, None]
    # orthonormal basis around w (branchless pick of the less-aligned axis)
    profiling.count("uploads", 2)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=hp.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=hp.device)
    a = torch.where((torch.abs(w[:, 0]) > 0.9)[:, None], ey[None, :],
                    ex[None, :])
    t1 = vm.normalize(vm.cross(a, w))
    t2 = vm.cross(w, t1)
    dir_l = (w * cos_t[:, None]
             + t1 * (sin_t * torch.cos(phi))[:, None]
             + t2 * (sin_t * torch.sin(phi))[:, None])
    weight = TWO_PI * (1.0 - cos_max)
    return dir_l, weight, le, lid, inside


def _dielectric_directions(key, d, normal, ior):
    """Glass scatter: refract, or reflect with Schlick's probability;
    entering rays use eta = 1/ior, exiting ones ior."""
    ud = vm.normalize(d)
    front = (vm.dot(ud, normal) < 0.0)[..., None]
    n_eff = torch.where(front, normal, -normal)
    eta = torch.where(front[..., 0], 1.0 / ior, ior)

    can_refract, refracted = vm.refract(ud, n_eff, eta)
    cosine = torch.clamp_max(-vm.dot(ud, n_eff), 1.0)
    reflect_prob = torch.where(can_refract, vm.schlick(cosine, ior),
                               torch.ones_like(cosine))
    xi = _draw(rngmod.uniform, key, d.shape[0])
    use_reflect = (xi < reflect_prob)[..., None]
    refl = vm.reflect(ud, n_eff)
    return vm.normalize(torch.where(use_reflect, refl, refracted))


def trace(
    scene: SphereScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    key: torch.Tensor,
    max_depth: int = 4,
    mode: str = "v2",
    enable_refraction: bool = False,
    with_stats: bool = False,
    mesh=None,
    use_bvh: bool = False,
    nee: bool = False,
    diffuse_sampling: str = "ball",
):
    """Trace R rays to completion; returns (R, 3) linear radiance (and,
    with ``with_stats``, the number of ray segments traced, shadow rays
    included, as a 0-d int64 tensor).

    ``mesh`` adds a TriangleMesh (the nearer surface shades);
    ``use_bvh=True`` intersects both geometries through their LBVH instead
    of the dense sweeps. ``nee=True`` (v2 only) adds next-event estimation
    at diffuse hits towards one uniformly picked emissive sphere (sampled
    by the solid angle it subtends), suppressing sphere emission on the
    BSDF path after a diffuse bounce; it forces the exact cosine sampler,
    which ``diffuse_sampling="cosine"`` selects alone."""
    if mode not in ("v1", "v2"):
        raise ValueError(f"unknown integrator mode {mode!r}")
    if diffuse_sampling not in ("ball", "cosine"):
        raise ValueError(f"unknown diffuse_sampling {diffuse_sampling!r}")
    if nee and mode != "v2":
        raise ValueError("nee=True requires mode='v2'")
    cosine = nee or diffuse_sampling == "cosine"
    R = origins.shape[0]
    dev = origins.device
    if max_depth < 1:
        # the reference's bounce loop never runs: black
        zero = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        segs0 = torch.zeros((), dtype=torch.int64, device=dev)
        return (zero, segs0) if with_stats else zero
    attr = attribute_matrix(scene)
    if use_bvh:
        from .bvh import intersect_spheres_bvh_hit, scene_lbvh

        bvh = scene_lbvh(scene)
    if mesh is not None:
        if use_bvh:
            from .triangle import intersect_mesh_bvh_hit, mesh_lbvh

            tri_bvh = mesh_lbvh(mesh)
        else:
            from .triangle import intersect_mesh_brute, tri_attribute_matrix

            tri_attr = tri_attribute_matrix(mesh)
    bg = scene.background

    if nee:
        # uniform pick over emissive spheres by a cumulative mask
        em_max = scene.emission.amax(dim=-1)
        is_light = scene.valid & (em_max > 0.0) & (scene.radius > 0.0)
        lw = is_light.to(torch.float32)
        n_lights = lw.sum()
        light_cdf = torch.cumsum(lw, dim=0) / torch.clamp_min(n_lights, 1.0)

    def scene_hit(o_, d_):
        """Closest hit over both geometries and the per-lane "winner is a
        triangle" flag (triangle emission is not in the light cdf, and a
        triangle winning a shadow ray always occludes)."""
        if use_bvh:
            h_ = intersect_spheres_bvh_hit(scene, bvh, o_, d_)
        else:
            h_ = intersect_brute(scene, o_, d_, attr=attr)
        if mesh is None:
            return h_, torch.zeros_like(h_.hit)
        if use_bvh:
            mh = intersect_mesh_bvh_hit(mesh, tri_bvh, o_, d_)
        else:
            mh = intersect_mesh_brute(mesh, o_, d_, attr=tri_attr)
        return combine_hits(h_, mh), mh.hit & (mh.t < h_.t)

    def body(depth, o, d, thr, col, act, k, segs, no_emit):
        depth = depth + 1
        k, k_ball, k_rr, k_branch, k_glass = rngmod.split(k, 5).unbind(-2)

        segs = segs + act.sum()
        h, is_tri_hit = scene_hit(o, d)

        # a miss adds the background through the throughput; the lane dies
        miss = act & ~h.hit
        col = col + torch.where(miss[:, None], thr * bg[None, :], 0.0)
        act = act & h.hit

        normal = h.normal
        if mode == "v1":
            # v1 flips the shading normal to oppose the ray
            front = (vm.dot(d, normal) < 0.0)[:, None]
            normal = torch.where(front, normal, -normal)

        # under NEE a lane whose last scatter was diffuse has its sphere
        # light from the shadow ray; triangle emission and a sphere hit
        # from inside (its exit: normal along the ray) still emit
        if nee:
            exit_hit = vm.dot(d, h.normal) > 0.0
            emit_ok = act & ~(no_emit & ~is_tri_hit & ~exit_hit)
        else:
            emit_ok = act
        col = col + torch.where(emit_ok[:, None], thr * h.emission, 0.0)

        # Russian roulette (after emission, before scatter)
        xi_rr = _draw(rngmod.uniform, k_rr, R)
        if mode == "v2":
            if depth > RR_START_DEPTH:
                p = torch.clamp(thr.amax(dim=-1), RR_P_MIN, RR_P_MAX)
                act = act & ~(xi_rr >= p)
                thr = torch.where(act[:, None], thr / p[:, None], thr)
        else:
            # v1: continue iff fewer than 3 bounces remain or xi < 0.8,
            # without compensation (biased, kept for parity)
            remaining = max_depth - (depth - 1)
            if remaining >= RR_START_DEPTH:
                act = act & ~(xi_rr >= V1_RR_P)

        hp = o + d * h.t[:, None]
        metal_dir, diffuse_dir = _scatter_directions(
            k_ball, d, normal, h.roughness, cosine=cosine)
        if mode == "v2":
            is_metal = h.metallic > 0.0
        else:
            is_metal = _draw(rngmod.uniform, k_branch, R) < h.metallic
        new_d = torch.where(is_metal[:, None], metal_dir, diffuse_dir)

        if enable_refraction:
            glass_dir = _dielectric_directions(k_glass, d, h.normal, h.ior)
            is_glass = ((h.metallic <= 0.0) & (h.roughness <= 0.0)
                        & (h.ior > 1.0))
            new_d = torch.where(is_glass[:, None], glass_dir, new_d)
            is_specular = is_metal | is_glass
        else:
            is_specular = is_metal

        if nee:
            # one shadow ray per diffuse lane to a point of its light:
            # thr * albedo/pi * cos * Le * (1 / pdf) * n_lights
            diffuse_lane = act & ~is_specular
            dir_l, weight, le, lid, inside = _sample_light_cone(
                rngmod.fold_in(k, 101), rngmod.fold_in(k, 102), attr,
                light_cdf, hp)
            sh, sh_is_tri = scene_hit(hp, dir_l)
            visible = sh.hit & ~sh_is_tri & (sh.object_id == lid)
            ndl = vm.dot(normal, dir_l)
            gate = (diffuse_lane & visible & ~inside & (ndl > 0.0)
                    & (n_lights > 0.0))
            contrib = (thr * h.albedo
                       * (ndl * weight * (n_lights * _INV_PI))[:, None] * le)
            col = col + torch.where(gate[:, None], contrib, 0.0)
            segs = segs + diffuse_lane.sum()
            no_emit = diffuse_lane

        thr = thr * h.albedo
        o = torch.where(act[:, None], hp, o)
        d = torch.where(act[:, None], new_d, d)
        return depth, o, d, thr, col, act, k, segs, no_emit

    act0 = torch.isfinite(directions.sum(dim=-1))
    state = (0, origins, directions,
             torch.ones((R, 3), dtype=torch.float32, device=dev),
             torch.zeros((R, 3), dtype=torch.float32, device=dev),
             act0, key, torch.zeros((), dtype=torch.int64, device=dev),
             torch.zeros_like(act0))
    # one guaranteed pass, then until max_depth or every lane is dead
    state = body(*state)
    while state[0] < max_depth and bool(state[5].any()):
        state = body(*state)
    color, segments = state[4], state[7]
    if with_stats:
        return color, segments
    return color
