// Device helpers shared by the path-trace kernels (megakernel.cu,
// cluster.cu): the JAX kernels' interpret-mode counter hash, the scalar
// Moller-Trumbore test, the primary ray (pixel jitter, pixel centres or the
// R2 lattice; pinhole or thin lens), the v2 bounce after a nearest hit
// (emission, Russian roulette, metal, diffuse or dielectric scatter), and
// the salt order both kernels draw in.
//
// The optional flags (refraction, thin lens, R2 stratification) live in
// the instantiations with kFlags = true, where each is a uniform runtime
// branch; kFlags = false compiles the flag-free kernel, whose instruction
// stream has none of them. Next-event estimation (NEE) lives in the
// instantiations with kNee = true (always beside kFlags = true): the
// cosine diffuse sampler, one shadow ray per diffuse hit towards a light
// picked by the kernel's light table, and the post-diffuse suppression of
// sphere emission (shade_hit).
//
// Build without fast-math: the sphere test's root selection relies on IEEE
// compares with the NaN of sqrt(negative) being false. Build without FMA
// contraction (--fmad=false, kernels/build.py), so each product and sum
// rounds as in the plain PyTorch versions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;  // rays per TPU tile: 32 sublanes x 128 lanes
constexpr int kRRStart = 3;  // Russian roulette after bounce 3
constexpr float kTMax = 1e10f;
constexpr float kTwoPi = 6.2831853071795864f;
// R2 lattice steps (1/p, 1/p^2 for the plastic number p), rounded to f32 as
// JAX rounds tpu_rt/ops/pallas_megakernel.py:R2_ALPHA_U/V
constexpr float kR2AlphaU = 0.7548776662466927f;
constexpr float kR2AlphaV = 0.5698402909980532f;
// 1/pi as the JAX kernels' NEE estimator writes it, rounded to f32
constexpr float kInvPi = 0.3183098861837907f;

// Counter hash U[0,1): tpu_rt/ops/pallas_megakernel.py:_hash_uniform in
// uint32 arithmetic (the JAX version wraps int32; signed overflow is UB in
// C++, unsigned wrap is not). The multipliers are the int32 constants
// -1640531527, -2048144789, -1028477387 read as uint32. ``pix_mix`` is
// pix ^ (seed * 2654435769u).
__device__ __forceinline__ float hash_uniform(uint32_t pix_mix, uint32_t salt) {
  uint32_t h = pix_mix + salt * 40503u;
  h ^= h >> 16;
  h *= 2246822507u;
  h ^= h >> 13;
  h *= 3266489909u;
  h ^= h >> 16;
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float inv_len(float x, float y, float z) {
  // lax.rsqrt(max(., 1e-20)); 1/sqrt keeps the rounding of the CPU versions
  return 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
}

// Scalar Moller-Trumbore of the ray (o, d) against the triangle (v0, e1, e2)
// in the JAX kernels' order of operations. Returns the hit's t if the
// determinant exceeds 1e-9 in magnitude, u, v >= 0, u + v <= 1 and
// t >= 1e-3, else NaN (which fails every compare). Zero edges (padding
// rows) give det == 0 and never hit.
__device__ __forceinline__ float mt_test(float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float v0x, float v0y, float v0z,
                                         float e1x, float e1y, float e1z,
                                         float e2x, float e2y, float e2z) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool okd = fabsf(det) > 1e-9f;
  const float inv = 1.0f / (okd ? det : 1.0f);
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  const bool ok = okd && u >= 0.f && v >= 0.f && u + v <= 1.f && t >= 1e-3f;
  return ok ? t : __int_as_float(0x7fc00000);
}

// Salts follow the JAX kernels' call-site counter over their unrolled
// trace: the primary ray draws ``primary`` salts (2 for i.i.d. jitter, plus
// 2 for the lens); bounce k then draws one RR salt when k > kRRStart, 3
// unit-ball salts, one dielectric salt when refraction is on, and with NEE
// the light pick, then the two cone draws (each drawn for every material,
// as the JAX kernels draw them for every lane). Returns the salt drawn last
// before bounce k. Derived from k, never carried, so a path that ends early
// cannot shift another's stream.
__device__ __forceinline__ uint32_t bounce_salt(uint32_t primary,
                                                bool refract, bool nee,
                                                int k) {
  const int rr_before = k - 1 > kRRStart ? k - 1 - kRRStart : 0;
  return primary +
         ((refract ? 4u : 3u) + (nee ? 3u : 0u)) * (uint32_t)(k - 1) +
         (uint32_t)rr_before;
}

struct Path {
  float ox, oy, oz;  // origin
  float dx, dy, dz;  // unit direction
  float tr, tg, tb;  // throughput
  float cr, cg, cb;  // radiance gathered so far
  bool no_emit;      // NEE: the last scatter was diffuse
};

// A light of the NEE pick: centre, radius, emission (zeros when no row of
// the table is picked, as the JAX kernels' initial planes).
struct Light {
  float cx, cy, cz, r, er, eg, eb;
};

// The light table of the kernels without NEE: never called.
struct NoNee {};

// Whether a light table defers its shadow rays (a member kDeferred that is
// true): shade_hit then hands a diffuse lane's shadow ray and its three
// products to nee->defer instead of tracing it, and the kernel traces the
// stored rays and adds the products of the unblocked ones after shade_hit
// returns. Other tables (NoNee, K1's, the sphere-only cluster kernels')
// trace it inside shade_hit through nee->occluded.
template <class Nee, class = void>
struct Defers {
  static constexpr bool value = false;
};
template <class Nee>
struct Defers<Nee, decltype(void(Nee::kDeferred))> {
  static constexpr bool value = Nee::kDeferred;
};

// The winner of a nearest-hit search: centre, 1/radius, shading attributes.
// (A megakernel triangle winner carries its face normal in cx..cz and the
// sign that turns it against the ray in ir; see shade_hit's face_normal.)
struct Surface {
  float cx, cy, cz, ir;
  float ar, ag, ab, met, rgh;
  float er, eg, eb;
  float ior;
};

// The 16 packed camera scalars (ops/megakernel.py:_pack_camera): position,
// forward, right, up, tan(fov/2) * aspect, tan(fov/2), aperture, focus.
struct Camera {
  float px, py, pz, fx, fy, fz, rx, ry, rz, ux, uy, uz;
  float tf_aspect, tf, aperture, focus;
};

__device__ __forceinline__ Camera load_camera(const float* c) {
  return Camera{c[0], c[1],  c[2],  c[3],  c[4],  c[5],  c[6],  c[7],
                c[8], c[9], c[10], c[11], c[12], c[13], c[14], c[15]};
}

// How a kernel draws its primary rays. ``jitter``: i.i.d. pixel jitter
// (else pixel centres); ``stratify`` (only with jitter): the R2 lattice
// under the per-pixel shift (shift_u, shift_v) instead; ``dof``: the thin
// lens. ``primary`` is the number of salts the primary ray draws.
struct Sampling {
  int jitter, stratify, dof;
  float shift_u, shift_v;
  uint32_t primary;
};

// The sampling of pixel stream ``flat``. With stratify, its one
// Cranley-Patterson shift for all samples is drawn at salts 9001 and 9002
// of the stream ``key``: the kernel's per-tile seed without the sample term
// (ops/megakernel.py:stratify_shift).
template <bool kFlags>
__device__ __forceinline__ Sampling make_sampling(int jitter, int stratify,
                                                  int dof, uint32_t flat,
                                                  uint32_t key) {
  const bool strat = kFlags && stratify && jitter;
  const bool lens = kFlags && dof;
  Sampling sm{jitter, strat, lens, 0.f, 0.f,
              (jitter && !strat ? 2u : 0u) + (lens ? 2u : 0u)};
  if (strat) {
    const uint32_t mix = flat ^ (key * 2654435769u);
    sm.shift_u = hash_uniform(mix, 9001u);
    sm.shift_v = hash_uniform(mix, 9002u);
  }
  return sm;
}

// The primary ray of sample ``s`` through pixel (px, py), in the JAX
// kernels' order of operations (pallas_megakernel.py:229-270,
// pallas_cluster.py:1199-1247): the pixel offset (jitter at salts 1, 2;
// or the R2 lattice point frac(shift + s * alpha); or the centre), the
// pinhole direction, then the thin lens: the focal point
// o + d * (focus / max(d . fwd, 1e-6)), the lens point
// (aperture sqrt(xi0), 2 pi xi1) drawn at the next two salts, and the
// direction from the lens point to the focal point.
template <bool kFlags>
__device__ __forceinline__ Path primary_ray(const Camera& c, float px,
                                            float py, float inv_w,
                                            float inv_h, uint32_t pix_mix,
                                            int s, const Sampling& sm) {
  float xu = 0.5f, xv = 0.5f;
  uint32_t salt = 0;
  if (kFlags && sm.stratify) {
    const float sf = (float)s;
    xu = sm.shift_u + sf * kR2AlphaU;
    xu = xu - floorf(xu);
    xv = sm.shift_v + sf * kR2AlphaV;
    xv = xv - floorf(xv);
  } else if (sm.jitter) {
    xu = hash_uniform(pix_mix, 1u);
    xv = hash_uniform(pix_mix, 2u);
    salt = 2u;
  }
  const float u = (px + xu) * inv_w;
  const float v = (py + xv) * inv_h;
  const float vx = (u - 0.5f) * 2.0f * c.tf_aspect;
  const float vy = (0.5f - v) * 2.0f * c.tf;
  const float dx = c.fx + c.rx * vx + c.ux * vy;
  const float dy = c.fy + c.ry * vx + c.uy * vy;
  const float dz = c.fz + c.rz * vx + c.uz * vy;
  const float inv = inv_len(dx, dy, dz);
  Path p{c.px, c.py, c.pz, dx * inv, dy * inv, dz * inv,
         1.f, 1.f, 1.f, 0.f, 0.f, 0.f, false};
  if (kFlags && sm.dof) {
    const float cosf_ = p.dx * c.fx + p.dy * c.fy + p.dz * c.fz;
    const float tfoc = c.focus / fmaxf(cosf_, 1e-6f);
    const float fpx = p.ox + p.dx * tfoc;
    const float fpy = p.oy + p.dy * tfoc;
    const float fpz = p.oz + p.dz * tfoc;
    const float r_l = c.aperture * sqrtf(hash_uniform(pix_mix, salt + 1u));
    const float ph = kTwoPi * hash_uniform(pix_mix, salt + 2u);
    const float lx = r_l * cosf(ph);
    const float ly = r_l * sinf(ph);
    p.ox = p.ox + c.rx * lx + c.ux * ly;
    p.oy = p.oy + c.ry * lx + c.uy * ly;
    p.oz = p.oz + c.rz * lx + c.uz * ly;
    const float ex = fpx - p.ox, ey = fpy - p.oy, ez = fpz - p.oz;
    const float il = inv_len(ex, ey, ez);
    p.dx = ex * il;
    p.dy = ey * il;
    p.dz = ez * il;
  }
  return p;
}


// Bounce k of a path whose ray hit ``w`` at ``t``: emission, Russian
// roulette after bounce kRRStart (p = clamp(max throughput, 0.1, 0.95),
// survivors compensated), then a metal mirror with roughness jitter or a
// diffuse normal + hemisphere-flipped unit-ball point; with ``refract`` (in
// the kFlags instantiations) a dielectric (metallic <= 0, roughness <= 0,
// ior > 1) instead refracts or reflects by Schlick's probability
// (pallas_megakernel.py:490-523). Returns false when roulette ends the
// path. The normal is (hit - c) * ir, or with ``face_normal`` c * ir (a
// face normal times the sign that opposes it to the ray); callers that
// never pass it compile to the sphere arithmetic.
//
// With kNee (pallas_megakernel.py:403-424, 467-479, 525-675): a hit after a
// diffuse scatter adds no emission, unless a triangle won (``tri_winner``;
// triangles are not in the light table) or the ray starts inside the
// winning sphere (|o - c|^2 ir^2 < 1: an enclosing light no shadow ray
// reaches); diffuse lanes sample normalize(n + unit-ball direction), the
// exact cosine density; and every diffuse lane (glass is specular) picks
// a light ``nee->pick(u)``, samples the cone it subtends, and adds
// tr * albedo * cos * Le * (solid angle) * n_lights / pi unless the light
// is behind the surface, encloses the hit, or ``nee->occluded`` finds a
// primitive before the light's entry t less 1e-3 (a table that defers
// receives the ray, t_edge and the three products through ``nee->defer``;
// the caller adds the products unless the ray is blocked, and nothing
// touches p.c in between, so the sums round as here). Each diffuse lane adds
// one segment to ``nee->segs`` (its shadow ray, traced or not).
template <bool kFlags, bool kNee = false, class Nee = NoNee>
__device__ __forceinline__ bool shade_hit(Path& p, const Surface& w, float t,
                                          int k, uint32_t pix_mix,
                                          uint32_t salt, bool refract,
                                          bool face_normal = false,
                                          Nee* nee = nullptr,
                                          bool tri_winner = false) {
  bool emit = true;
  if constexpr (kNee) {
    if (p.no_emit && !tri_winner) {
      const float ex = p.ox - w.cx;
      const float ey = p.oy - w.cy;
      const float ez = p.oz - w.cz;
      const float eoc2 = ex * ex + ey * ey + ez * ez;
      emit = eoc2 * (w.ir * w.ir) < 1.0f;  // inside the winner: exempt
    }
  }
  if (emit) {
    p.cr = p.cr + p.tr * w.er;
    p.cg = p.cg + p.tg * w.eg;
    p.cb = p.cb + p.tb * w.eb;
  }

  if (k > kRRStart) {
    const float xi = hash_uniform(pix_mix, ++salt);
    const float q = fminf(fmaxf(fmaxf(p.tr, fmaxf(p.tg, p.tb)), 0.1f), 0.95f);
    if (!(xi < q)) return false;
    const float comp = 1.0f / q;
    p.tr *= comp; p.tg *= comp; p.tb *= comp;
  }

  // hit point + outward normal
  const float hx = p.ox + p.dx * t;
  const float hy = p.oy + p.dy * t;
  const float hz = p.oz + p.dz * t;
  const float nx = face_normal ? w.cx * w.ir : (hx - w.cx) * w.ir;
  const float ny = face_normal ? w.cy * w.ir : (hy - w.cy) * w.ir;
  const float nz = face_normal ? w.cz * w.ir : (hz - w.cz) * w.ir;

  // uniform point in the unit ball: direction x cbrt radius
  const float u1 = hash_uniform(pix_mix, salt + 1u);
  const float u2 = hash_uniform(pix_mix, salt + 2u);
  const float u3 = hash_uniform(pix_mix, salt + 3u);
  const float bz0 = 1.0f - 2.0f * u1;
  const float r_xy = sqrtf(fmaxf(1.0f - bz0 * bz0, 0.0f));
  const float phi = kTwoPi * u2;
  const float rad = expf(logf(fmaxf(u3, 1e-12f)) * (1.0f / 3.0f));
  const float bx = r_xy * cosf(phi) * rad;
  const float by = r_xy * sinf(phi) * rad;
  const float bz = bz0 * rad;

  float ndx, ndy, ndz;
  bool diffuse = !(w.met > 0.f);
  if (!diffuse) {  // metal: mirror + roughness jitter
    const float d_dot_n = p.dx * nx + p.dy * ny + p.dz * nz;
    const float mx = p.dx - 2.0f * d_dot_n * nx + bx * w.rgh;
    const float my = p.dy - 2.0f * d_dot_n * ny + by * w.rgh;
    const float mz = p.dz - 2.0f * d_dot_n * nz + bz * w.rgh;
    const float inv = inv_len(mx, my, mz);
    ndx = mx * inv; ndy = my * inv; ndz = mz * inv;
  } else if constexpr (kNee) {
    // the exact cosine sampler: normal + unit-sphere direction, or the
    // normal itself where the sum vanishes
    const float is = inv_len(bx, by, bz);
    const float cdx = nx + bx * is;
    const float cdy = ny + by * is;
    const float cdz = nz + bz * is;
    const float l2 = cdx * cdx + cdy * cdy + cdz * cdz;
    if (l2 < 1e-12f) {
      ndx = nx; ndy = ny; ndz = nz;
    } else {
      const float inv = inv_len(cdx, cdy, cdz);
      ndx = cdx * inv; ndy = cdy * inv; ndz = cdz * inv;
    }
  } else {  // diffuse: normal + ball point flipped into the hemisphere
    const float sgn = (bx * nx + by * ny + bz * nz) > 0.f ? 1.f : -1.f;
    const float fx = nx + bx * sgn;
    const float fy = ny + by * sgn;
    const float fz = nz + bz * sgn;
    const float inv = inv_len(fx, fy, fz);
    ndx = fx * inv; ndy = fy * inv; ndz = fz * inv;
  }

  if (kFlags && refract) {  // the dielectric, front-face aware
    const float cos_in = p.dx * nx + p.dy * ny + p.dz * nz;
    const bool front = cos_in < 0.f;
    const float sgn_n = front ? 1.f : -1.f;
    const float nex = nx * sgn_n, ney = ny * sgn_n, nez = nz * sgn_n;
    const float eta = front ? 1.0f / w.ior : w.ior;
    const float dt = p.dx * nex + p.dy * ney + p.dz * nez;
    const float disc = 1.0f - eta * eta * (1.0f - dt * dt);
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float cosine = fminf(-dt, 1.0f);
    float r0 = (1.0f - w.ior) / (1.0f + w.ior);
    r0 = r0 * r0;
    const float omc = 1.0f - cosine;
    const float omc2 = omc * omc;
    const float schlick = r0 + (1.0f - r0) * omc2 * omc2 * omc;
    const float reflect_prob = disc > 0.f ? schlick : 1.0f;
    const bool use_refl = hash_uniform(pix_mix, salt + 4u) < reflect_prob;
    if (w.met <= 0.f && w.rgh <= 0.f && w.ior > 1.0f) {
      float gx, gy, gz;
      if (use_refl) {
        gx = p.dx - 2.0f * dt * nex;
        gy = p.dy - 2.0f * dt * ney;
        gz = p.dz - 2.0f * dt * nez;
      } else {
        gx = (p.dx - nex * dt) * eta - nex * sq;
        gy = (p.dy - ney * dt) * eta - ney * sq;
        gz = (p.dz - nez * dt) * eta - nez * sq;
      }
      const float inv = inv_len(gx, gy, gz);
      ndx = gx * inv; ndy = gy * inv; ndz = gz * inv;
      diffuse = false;  // glass is specular for NEE
    }
  }

  if constexpr (kNee) {
    p.no_emit = diffuse;
    if (diffuse) {
      ++nee->segs;
      // the pick and cone draws follow the dielectric salt
      const uint32_t ns = salt + (refract ? 4u : 3u);
      const Light L = nee->pick(hash_uniform(pix_mix, ns + 1u));
      // the cone the light subtends from the hit point
      const float tlx = L.cx - hx;
      const float tly = L.cy - hy;
      const float tlz = L.cz - hz;
      const float d2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-12f);
      const float sin2 = (L.r * L.r) / d2;
      const bool inside = sin2 >= 1.0f;
      const float cos_max = sqrtf(fminf(fmaxf(1.0f - sin2, 0.0f), 1.0f));
      const float xi1 = hash_uniform(pix_mix, ns + 2u);
      const float xi2 = hash_uniform(pix_mix, ns + 3u);
      const float cos_t = 1.0f - xi1 * (1.0f - cos_max);
      const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
      const float phi_l = kTwoPi * xi2;
      const float inv_dl = 1.0f / sqrtf(d2);
      const float wx = tlx * inv_dl;
      const float wy = tly * inv_dl;
      const float wz = tlz * inv_dl;
      // orthonormal basis around w (branchless axis pick)
      const bool big = fabsf(wx) > 0.9f;
      const float ax = big ? 0.0f : 1.0f;
      const float ay = big ? 1.0f : 0.0f;
      float t1x = ay * wz;  // cross(a, w), az == 0
      float t1y = -ax * wz;
      float t1z = ax * wy - ay * wx;
      const float it = inv_len(t1x, t1y, t1z);
      t1x = t1x * it; t1y = t1y * it; t1z = t1z * it;
      const float t2x = wy * t1z - wz * t1y;
      const float t2y = wz * t1x - wx * t1z;
      const float t2z = wx * t1y - wy * t1x;
      const float sc = sin_t * cosf(phi_l);
      const float ss = sin_t * sinf(phi_l);
      const float ldx = wx * cos_t + t1x * sc + t2x * ss;
      const float ldy = wy * cos_t + t1y * sc + t2y * ss;
      const float ldz = wz * cos_t + t1z * sc + t2z * ss;
      const float weight = kTwoPi * (1.0f - cos_max);  // 1 / pdf(omega)
      // t to the light's entry along the shadow ray
      const float lox = hx - L.cx;
      const float loy = hy - L.cy;
      const float loz = hz - L.cz;
      const float lhb = lox * ldx + loy * ldy + loz * ldz;
      const float lcq = lox * lox + loy * loy + loz * loz - L.r * L.r;
      const float ldisc = lhb * lhb - lcq;
      const float lsq = sqrtf(fmaxf(ldisc, 0.0f));
      const float lt0 = -lhb - lsq;
      const float lt1 = -lhb + lsq;
      const float t_light = lt0 >= 1e-3f ? lt0 : lt1;
      const bool light_ok = ldisc >= 0.0f && t_light >= 1e-3f;
      const float ndl = nx * ldx + ny * ldy + nz * ldz;
      // the light's own entry root is t_light, so the strict margin
      // keeps it from occluding itself
      if constexpr (Defers<Nee>::value) {
        if (light_ok && !inside && ndl > 0.0f && nee->n_lights > 0.0f) {
          const float scale = ndl * weight * (nee->n_lights * kInvPi);
          nee->defer(hx, hy, hz, ldx, ldy, ldz, t_light - 1e-3f,
                     p.tr * w.ar * scale * L.er, p.tg * w.ag * scale * L.eg,
                     p.tb * w.ab * scale * L.eb);
        }
      } else if (light_ok && !inside && ndl > 0.0f && nee->n_lights > 0.0f &&
          !nee->occluded(hx, hy, hz, ldx, ldy, ldz, t_light - 1e-3f)) {
        const float scale = ndl * weight * (nee->n_lights * kInvPi);
        p.cr = p.cr + p.tr * w.ar * scale * L.er;
        p.cg = p.cg + p.tg * w.ag * scale * L.eg;
        p.cb = p.cb + p.tb * w.ab * scale * L.eb;
      }
    }
  }

  p.tr *= w.ar; p.tg *= w.ag; p.tb *= w.ab;
  p.ox = hx; p.oy = hy; p.oz = hz;
  p.dx = ndx; p.dy = ndy; p.dz = ndz;
  return true;
}

// Adds each thread's count into segs[tile]: the lanes of a warp that reach
// this point together sum their counts (redux.sync over __activemask()),
// and the first of them adds the sum with one integer atomic. It needs no
// barrier and no lane outside the active mask, so it is exact however the
// warp arrives here (a block reduction with full-warp shuffles and a
// barrier at this point lost or garbled a warp's count on rare frames of
// the cluster kernel). Integer sums: exact and independent of order.
__device__ __forceinline__ void add_tile_count(int count, int* segs,
                                               int tile) {
  const unsigned m = __activemask();
  const int sum = __reduce_add_sync(m, count);
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) atomicAdd(segs + tile, sum);
}

}  // namespace
