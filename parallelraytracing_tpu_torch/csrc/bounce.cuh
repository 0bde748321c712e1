// One bounce of one path on Hopper (sm_90a): the closest-hit fold over the
// sphere, quad and triangle kinds and the shading step after it.  Shared
// by the fused trace kernel (trace.cu: every bounce of a ray in one
// launch) and the segment kernel (segment.cu: n bounces over a compacted
// queue), so the two run the same arithmetic and render the same bits.
//
// The counterpart of parallelraytracing_tpu/ops/pallas_trace.py
// _make_bounce_step on its constant-sky, NEE-off, untextured subset: the
// sphere, quad and triangle closest-hit bodies (sph_body, quad_body,
// make_tri_body), the three per-kind walks of `clustered` (threaded SAH
// tree, linear cluster scan behind a root pretest, plain loop for tiny
// kinds), the deferred shading normal, sky, emission, the branchless
// Lambertian / metal / dielectric block and the PCG streams.
//
// The tables are the JAX package's (C, N) column layout in read-only
// global memory (every table of the repo's scenes fits in the H100's
// 50 MB L2); the walk is per ray, so a ray enters only the boxes it hits.
// Per-ray walks give the same winner as the TPU's whole-tile walk: the
// fold keeps the lexicographic minimum of (t, ordinal), which does not
// depend on visit order, and a box a ray misses holds no primitive that
// ray hits at t <= best_t.
//
// Numerics: built WITHOUT --use_fast_math and WITH -fmad=false (see
// ops/_build.py).  The kernels are held to plain PyTorch versions that
// round every multiply and add on their own; contracting them into FMAs
// moves last bits, and a path tracer turns a last-bit difference at a
// grazing hit into a different path.  Division and sqrtf are IEEE-rounded
// (nvcc's default -prec-div=true -prec-sqrt=true), the TPU kernel's rsqrt
// is written 1.0f / sqrtf(x), and sin and cos are taken in float64 and
// rounded to float: the plain versions compute the same (ops/ieee.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The scene as both kernels read it; ops/_build.py mirrors this layout in
// ctypes.  n_tri is 0 when the triangle kind holds only never-hit pads.
struct PrtScene {
  const float* sph;     // (6, n_sph): cx cy cz r2 mid ord
  const float* sph_cl;  // (8, M) tree or (6, n_cl + 1) linear
  int n_sph, sph_cl_rows, sph_cl_cols;
  const float* quad;  // (14, n_quad): n(3) cn us(3) cu vs(3) cv mid ord
  const float* quad_cl;
  int n_quad, quad_cl_rows, quad_cl_cols;
  const float* tri;  // (27, n_tri): ng(3) p0ng e1(3) e2(3) e2xp0(3)
                     // p0xe1(3) mid ord n0(3) n1(3) n2(3)
  const float* tri_cl;
  int n_tri, tri_cl_rows, tri_cl_cols;
  const float* mats;  // (5, n_mats): mtype c(3) extra
  int n_mats;
  int csize;      // primitives per linear cluster, sphere and quad kinds
  int tri_csize;  // primitives per linear cluster, triangle kind
  float t_min, t_cap;  // t_cap = t_max, or +inf when t_max >= 1e30
  float sky0, sky1, sky2;
};

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr uint32_t kSaltStep = 0x9E3779B9u;
constexpr uint32_t kDepthStep = 0x85EBCA6Bu;
constexpr int kLambertian = 0;
constexpr int kMetal = 1;
constexpr int kDielectric = 2;
constexpr int kEmissive = 3;
constexpr int kSphere = 0;
constexpr int kQuad = 1;
constexpr int kTriangle = 2;

// A path's state between bounces: origin, direction, throughput, radiance.
struct PathState {
  float ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb;
};

// One bounce's ray: direction reciprocals for the slab tests and
// w = o x d for the triangle body's triple products.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, wx, wy, wz;
};

// Closest-hit carry: the raw winner geometry (sphere center, quad normal,
// or the triangle's unnormalised interpolated normal) and the winner's
// compressed material record.
struct Hit {
  float t, gx, gy, gz, c0, c1, c2, extra, ord;
  int front, is_sph, mtype;
};

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ float uniform01(uint32_t counter, uint32_t salt) {
  uint32_t bits = pcg_hash(counter ^ (salt * kSaltStep));
  return (float)(int)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float safe_inv(float v) {
  const float eps = 1e-20f;
  return 1.0f / (fabsf(v) < eps ? (v < 0.0f ? -eps : eps) : v);
}

__device__ __forceinline__ float ld(const float* __restrict__ p, int i) {
  return __ldg(p + i);
}

// Does the ray hit column `col` of a (rows, cols) box table at a t in
// [t_min, best_t]?  The exact (b - o) * inv form: the hoisted b*inv - o*inv
// form cancels catastrophically for near-axis-parallel rays whose origin
// lies on a box plane (pallas_trace.py make_slab).
__device__ __forceinline__ bool slab_hit(const float* __restrict__ tab,
                                         int cols, int col, const Ray& r,
                                         float t_min, float best_t) {
  float tx0 = (ld(tab, col) - r.ox) * r.ix;
  float ty0 = (ld(tab, cols + col) - r.oy) * r.iy;
  float tz0 = (ld(tab, 2 * cols + col) - r.oz) * r.iz;
  float tx1 = (ld(tab, 3 * cols + col) - r.ox) * r.ix;
  float ty1 = (ld(tab, 4 * cols + col) - r.oy) * r.iy;
  float tz1 = (ld(tab, 5 * cols + col) - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                   fmaxf(fminf(tz0, tz1), t_min));
  float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                   fminf(fmaxf(tz0, tz1), best_t));
  return tf - tn >= 0.0f;
}

// Strict < with the lowest global ordinal breaking ties: the fold's result
// is the lexicographic minimum of (t, ord), whatever the visit order.
__device__ __forceinline__ bool beats(float t, float ordv, const Hit& h) {
  return t < h.t || (t == h.t && ordv < h.ord);
}

__device__ __forceinline__ void take(const PrtScene& S, float t, float ordv,
                                     float mid, float gx, float gy, float gz,
                                     int front, int is_sph, Hit& h) {
  int mi = (int)mid;
  int n = S.n_mats;
  h.t = t;
  h.ord = ordv;
  h.gx = gx;
  h.gy = gy;
  h.gz = gz;
  h.front = front;
  h.is_sph = is_sph;
  h.mtype = (int)ld(S.mats, mi);
  h.c0 = ld(S.mats, n + mi);
  h.c1 = ld(S.mats, 2 * n + mi);
  h.c2 = ld(S.mats, 3 * n + mi);
  h.extra = ld(S.mats, 4 * n + mi);
}

__device__ __forceinline__ void sphere_test(const PrtScene& S, int j,
                                            const Ray& r, Hit& h) {
  const float* __restrict__ s = S.sph;
  const int n = S.n_sph;
  float cx = ld(s, j), cy = ld(s, n + j), cz = ld(s, 2 * n + j);
  float r2 = ld(s, 3 * n + j);
  float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  float b2 = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  float cterm = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  float disc = b2 * b2 - cterm;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t_near = -b2 - sq;
  float t_far = -b2 + sq;
  bool fr = t_near >= S.t_min;
  float t = fr ? t_near : t_far;
  bool ok = (disc >= 0.0f) && (t >= S.t_min) && (t <= S.t_cap);
  if (!ok) return;
  float ordv = ld(s, 5 * n + j);
  if (!beats(t, ordv, h)) return;
  take(S, t, ordv, ld(s, 4 * n + j), cx, cy, cz, fr, 1, h);
}

__device__ __forceinline__ void quad_test(const PrtScene& S, int j,
                                          const Ray& r, Hit& h) {
  const float* __restrict__ q = S.quad;
  const int n = S.n_quad;
  float qnx = ld(q, j), qny = ld(q, n + j), qnz = ld(q, 2 * n + j);
  float cn = ld(q, 3 * n + j);
  float usx = ld(q, 4 * n + j), usy = ld(q, 5 * n + j), usz = ld(q, 6 * n + j);
  float cu = ld(q, 7 * n + j);
  float vsx = ld(q, 8 * n + j), vsy = ld(q, 9 * n + j), vsz = ld(q, 10 * n + j);
  float cv = ld(q, 11 * n + j);
  float dn = r.dx * qnx + r.dy * qny + r.dz * qnz;
  float on = r.ox * qnx + r.oy * qny + r.oz * qnz;
  bool denom_ok = fabsf(dn) >= 1e-8f;
  float inv_dn = denom_ok ? 1.0f / dn : 0.0f;
  float t = (cn - on) * inv_dn;
  float a = (r.ox * usx + r.oy * usy + r.oz * usz)
      + t * (r.dx * usx + r.dy * usy + r.dz * usz) - cu;
  float b = (r.ox * vsx + r.oy * vsy + r.oz * vsz)
      + t * (r.dx * vsx + r.dy * vsy + r.dz * vsz) - cv;
  bool ok = denom_ok && (t > S.t_min) && (a * a < 1.0f) && (b * b < 1.0f)
      && (t <= S.t_cap);
  if (!ok) return;
  float ordv = ld(q, 13 * n + j);
  if (!beats(t, ordv, h)) return;
  take(S, t, ordv, ld(q, 12 * n + j), qnx, qny, qnz, on - cn > 0.0f, 0, h);
}

// Moller-Trumbore through triple products (pallas_trace.py make_tri_body):
// div = -d.ng, t = (o.ng - p0.ng) / div, b1 = (w.e2 - d.(e2 x p0)) / div,
// b2 = (-w.e1 - d.(p0 x e1)) / div with w = o x d.  The winner carries the
// raw barycentric blend of the vertex normals and the front flag
// !(d.n_interp > 0); the normal is normalised once, after the fold.
__device__ __forceinline__ void tri_test(const PrtScene& S, int j,
                                         const Ray& r, Hit& h) {
  const float* __restrict__ q = S.tri;
  const int n = S.n_tri;
  float ngx = ld(q, j), ngy = ld(q, n + j), ngz = ld(q, 2 * n + j);
  float p0ng = ld(q, 3 * n + j);
  float e1x = ld(q, 4 * n + j), e1y = ld(q, 5 * n + j), e1z = ld(q, 6 * n + j);
  float e2x = ld(q, 7 * n + j), e2y = ld(q, 8 * n + j), e2z = ld(q, 9 * n + j);
  float xpx = ld(q, 10 * n + j), xpy = ld(q, 11 * n + j),
        xpz = ld(q, 12 * n + j);
  float pex = ld(q, 13 * n + j), pey = ld(q, 14 * n + j),
        pez = ld(q, 15 * n + j);
  float div = -(r.dx * ngx + r.dy * ngy + r.dz * ngz);
  bool div_ok = div != 0.0f;
  float inv = div_ok ? 1.0f / div : 0.0f;
  float t = (r.ox * ngx + r.oy * ngy + r.oz * ngz - p0ng) * inv;
  float b1 = ((r.wx * e2x + r.wy * e2y + r.wz * e2z)
              - (r.dx * xpx + r.dy * xpy + r.dz * xpz)) * inv;
  float b2 = (-(r.wx * e1x + r.wy * e1y + r.wz * e1z)
              - (r.dx * pex + r.dy * pey + r.dz * pez)) * inv;
  bool ok = div_ok && (t >= S.t_min) && (b1 >= 0.0f) && (b2 >= 0.0f)
      && (b1 + b2 <= 1.0f) && (t <= S.t_cap);
  if (!ok) return;
  float ordv = ld(q, 17 * n + j);
  if (!beats(t, ordv, h)) return;
  float b0 = 1.0f - b1 - b2;
  float inx = b0 * ld(q, 18 * n + j) + b1 * ld(q, 21 * n + j)
      + b2 * ld(q, 24 * n + j);
  float iny = b0 * ld(q, 19 * n + j) + b1 * ld(q, 22 * n + j)
      + b2 * ld(q, 25 * n + j);
  float inz = b0 * ld(q, 20 * n + j) + b1 * ld(q, 23 * n + j)
      + b2 * ld(q, 26 * n + j);
  bool back = (r.dx * inx + r.dy * iny + r.dz * inz) > 0.0f;
  take(S, t, ordv, ld(q, 16 * n + j), inx, iny, inz, !back, 0, h);
}

template <int kKind>
__device__ __forceinline__ void test_range(const PrtScene& S, int lo, int hi,
                                           const Ray& r, Hit& h) {
  for (int j = lo; j < hi; ++j) {
    if (kKind == kSphere) {
      sphere_test(S, j, r, h);
    } else if (kKind == kQuad) {
      quad_test(S, j, r, h);
    } else {
      tri_test(S, j, r, h);
    }
  }
}

// One kind's closest-hit fold, dispatched like `clustered`: a tiny kind
// (n <= csize) is a plain loop; an (8, M) table is the threaded tree
// (hit -> node + 1, miss -> escape link in row 6, row 7 packs a leaf as
// lo*64 + span); a (6, n_cl + 1) table is the linear cluster scan behind
// the root pretest in its last column.  `csize` is the kind's own cluster
// size (TRI_CLUSTER for triangles): it sets both the tiny-kind test and
// the linear runs.
template <int kKind>
__device__ void fold_kind(const PrtScene& S, int n, const float* __restrict__ cl,
                          int rows, int cols, int csize, const Ray& r,
                          Hit& h) {
  if (n <= csize) {
    test_range<kKind>(S, 0, n, r, h);
    return;
  }
  if (rows == 8) {
    int node = 0;
    while (node >= 0) {
      bool enter = slab_hit(cl, cols, node, r, S.t_min, h.t);
      int miss = (int)ld(cl, 6 * cols + node);
      float lo_f = ld(cl, 7 * cols + node);
      bool leaf = lo_f >= 0.0f;
      if (enter && leaf) {
        int enc = (int)lo_f;
        int lo = enc >> 6;
        test_range<kKind>(S, lo, lo + (enc & 63), r, h);
      }
      node = (enter && !leaf) ? node + 1 : miss;
    }
    return;
  }
  int n_cl = (n + csize - 1) / csize;
  if (!slab_hit(cl, cols, n_cl, r, S.t_min, h.t)) return;
  for (int ci = 0; ci < n_cl; ++ci) {
    if (slab_hit(cl, cols, ci, r, S.t_min, h.t)) {
      int lo = ci * csize;
      test_range<kKind>(S, lo, min(lo + csize, n), r, h);
    }
  }
}

// One bounce of path `s` with the bounce's stream word rng_d.  Returns
// true when the path continues; a path that ends (sky, emitter, metal ray
// scattered under the surface) keeps its origin, direction and
// throughput, and only its radiance changes.  kTri is whether the scene
// has live triangles (S.n_tri > 0): the kernels are instantiated both
// ways, so a sphere/quad scene runs code without the triangle fold, which
// would otherwise cost every ray registers and spills.  Forced inline, so
// each kernel's bounce loop compiles as one body.
template <bool kTri>
__device__ __forceinline__ bool bounce(const PrtScene& S, uint32_t rng_d,
                                       PathState& s) {
  const float ox = s.ox, oy = s.oy, oz = s.oz;
  const float dx = s.dx, dy = s.dy, dz = s.dz;
  Ray r{ox, oy, oz, dx, dy, dz, safe_inv(dx), safe_inv(dy), safe_inv(dz),
        oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx};
  Hit h{kBig, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, (float)(1 << 24),
        0, 0, 0};
  fold_kind<kSphere>(S, S.n_sph, S.sph_cl, S.sph_cl_rows, S.sph_cl_cols,
                     S.csize, r, h);
  fold_kind<kQuad>(S, S.n_quad, S.quad_cl, S.quad_cl_rows, S.quad_cl_cols,
                   S.csize, r, h);
  if (kTri) {
    fold_kind<kTriangle>(S, S.n_tri, S.tri_cl, S.tri_cl_rows, S.tri_cl_cols,
                         S.tri_csize, r, h);
  }

  if (!(h.t < kBig)) {  // miss: sky * throughput, the path ends
    s.rr = s.rr + s.tr * S.sky0;
    s.rg = s.rg + s.tg * S.sky1;
    s.rb = s.rb + s.tb * S.sky2;
    return false;
  }
  if (h.mtype == kEmissive) {  // emission; an emitter does not scatter
    s.rr = s.rr + s.tr * h.c0;
    s.rg = s.rg + s.tg * h.c1;
    s.rb = s.rb + s.tb * h.c2;
    return false;
  }

  // Deferred shading normal: spheres carried their center, quads the unit
  // plane normal, triangles the raw interpolated normal; all flip by the
  // front flag.
  float px = ox + h.t * dx;
  float py = oy + h.t * dy;
  float pz = oz + h.t * dz;
  float nrx = h.is_sph ? px - h.gx : h.gx;
  float nry = h.is_sph ? py - h.gy : h.gy;
  float nrz = h.is_sph ? pz - h.gz : h.gz;
  float n_ilen = 1.0f / sqrtf(fmaxf(nrx * nrx + nry * nry + nrz * nrz,
                                    1e-30f));
  float sgn_n = ((float)h.front * 2.0f - 1.0f) * n_ilen;
  float nx = nrx * sgn_n;
  float ny = nry * sgn_n;
  float nz = nrz * sgn_n;

  float u1 = uniform01(rng_d, 1u);
  float u2 = uniform01(rng_d, 2u);
  float u3 = uniform01(rng_d, 3u);
  float z = 1.0f - 2.0f * u1;
  float rxy = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  float phi = kTwoPi * u2;
  float ux = rxy * (float)cos((double)phi);
  float uy = rxy * (float)sin((double)phi);
  float uz = z;

  float sx, sy, sz;
  if (h.mtype == kLambertian) {
    float lx = nx + ux, ly = ny + uy, lz = nz + uz;
    bool degen = fabsf(lx) < 1e-8f && fabsf(ly) < 1e-8f && fabsf(lz) < 1e-8f;
    sx = degen ? nx : lx;
    sy = degen ? ny : ly;
    sz = degen ? nz : lz;
  } else if (h.mtype == kMetal) {
    float dn_ = dx * nx + dy * ny + dz * nz;
    sx = dx - 2.0f * dn_ * nx + h.extra * ux;
    sy = dy - 2.0f * dn_ * ny + h.extra * uy;
    sz = dz - 2.0f * dn_ * nz + h.extra * uz;
  } else {  // dielectric
    float dn_ = dx * nx + dy * ny + dz * nz;
    float ri = h.front ? 1.0f / h.extra : h.extra;
    float cos_t = fminf(-(dx * nx + dy * ny + dz * nz), 1.0f);
    float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
    bool cannot = ri * sin_t > 1.0f;
    float r0 = (1.0f - ri) / (1.0f + ri);
    r0 = r0 * r0;
    float one_mc = 1.0f - cos_t;
    float schl = r0 + (1.0f - r0) * one_mc * one_mc * one_mc * one_mc
        * one_mc;
    if (cannot || schl > u3) {
      sx = dx - 2.0f * dn_ * nx;
      sy = dy - 2.0f * dn_ * ny;
      sz = dz - 2.0f * dn_ * nz;
    } else {
      float qx = ri * (dx + cos_t * nx);
      float qy = ri * (dy + cos_t * ny);
      float qz = ri * (dz + cos_t * nz);
      float qpar = -sqrtf(fabsf(1.0f - (qx * qx + qy * qy + qz * qz)));
      sx = qx + qpar * nx;
      sy = qy + qpar * ny;
      sz = qz + qpar * nz;
    }
  }
  float ilen = 1.0f / sqrtf(fmaxf(sx * sx + sy * sy + sz * sz, 1e-30f));
  sx = sx * ilen;
  sy = sy * ilen;
  sz = sz * ilen;
  // A metal ray scattered below the surface is absorbed.
  if (h.mtype == kMetal && !((sx * nx + sy * ny + sz * nz) > 0.0f)) {
    return false;
  }
  if (h.mtype != kDielectric) {
    s.tr = s.tr * h.c0;
    s.tg = s.tg * h.c1;
    s.tb = s.tb * h.c2;
  }
  s.ox = px;
  s.oy = py;
  s.oz = pz;
  s.dx = sx;
  s.dy = sy;
  s.dz = sz;
  return true;
}

}  // namespace
