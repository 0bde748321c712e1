// One bounce of one path on Hopper (sm_90a): the closest-hit fold over the
// sphere, quad and triangle kinds and the instanced meshes, and the
// shading step after it.  Shared
// by the fused trace kernel (trace.cu: every bounce of a ray in one
// launch), the segment kernel (segment.cu: n bounces over a compacted
// queue) and the probe kernel (probe.cu: the trace kernel's loop with each
// ray's depth and walk counters), so they run the same arithmetic and
// render the same bits.
//
// The counterpart of parallelraytracing_tpu/ops/pallas_trace.py
// _make_bounce_step: the sphere, quad and triangle closest-hit bodies
// (sph_body, quad_body, make_tri_body), the three per-kind walks of
// `clustered` (threaded SAH tree, linear cluster scan behind a root
// pretest, plain loop for tiny kinds), the stream route's two-level walk
// of a big mesh (the `if tri_stream:` branch, K7), the instance block
// (inst_body: a linear scan of the instances' world boxes, each entered
// instance's tree walked by its mesh-local ray), the deferred shading
// normal, the scene
// extensions (image textures with the sphere's equirectangular map, the
// checker, the gradient and sun sky), emission, next-event estimation
// with its any-hit shadow walk, the branchless Lambertian / metal /
// dielectric block, Russian roulette and the PCG streams.
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
// is written 1.0f / sqrtf(x), and sin, cos, atan2 and asin are taken in
// float64 and rounded to float: the plain versions compute the same
// (ops/ieee.py).  (The TPU kernel takes atan2 and asin from polynomials,
// vpu_atan2 / vpu_asin, a workaround for Mosaic, within ~1e-7 rad.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The scene as both kernels read it; ops/_build.py mirrors this layout in
// ctypes and checks it against prt_scene_size() at load.  n_tri is 0 when
// the triangle kind holds only never-hit pads, n_inst 0 without instances.
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
  // The sky spec (engines/tables.sky_spec): bottom(3) top(3) sun
  // direction(3) sun color(3) power; sky_mode 0 the constant sky[0..2],
  // 1 the gradient, 2 the gradient and the sun.
  float sky[13];
  int sky_mode;
  const float* lights;  // (28, n_lights): ops/pack.pack_lights_table
  int n_lights;         // 0: NEE off
  int rr_depth;         // Russian roulette from this absolute depth; 0: off
  // Instances (ops/pack.pack_instance_tables): the unique meshes' local
  // triangles, their concatenated threaded trees, the instances' world
  // boxes and records [root, world->local 3x4, normal 3x3, mid, ord base].
  const float* itri;  // (25, n_itri): ng(3) p0ng e1(3) e2(3) e2xp0(3)
                      // p0xe1(3) n0(3) n1(3) n2(3)
  const float* iacc;  // (8, n_iacc)
  const float* ibox;  // (6, n_inst)
  const float* inst;  // (24, n_inst)
  int n_itri, n_iacc, n_inst;
  // Textures (ops/trace.texture_table, ops/pack.pack_kernel_textures):
  // per material [kind (0 none, 1 checker, 2 image), then a checker's
  // scale and odd rgb, or an image's first texel row, height, width,
  // 1/height, 1/width], null without textures; the packed u24 texel rows,
  // null without images, whose presence also says the triangle tables
  // carry texture coordinates (tri rows 27-32, itri rows 25-30).  The
  // wrapper checks every image's rows against the table's height.
  const float* mtex;  // (6, n_mats)
  const float* itex;  // (Rt, 128)
  // The stream route of a big mesh (ops/pack.py): tri then holds n_tri =
  // n_chunks * chunk slot columns and tri_cl the top tree, whose leaf word
  // is chunk index << stream_shift | span; mini the chunks' threaded
  // mini-trees, chunk c's in columns c * node_rows + k.  Null on the dense
  // route.
  const float* mini;  // (8, n_mini)
  int n_mini, chunk, node_rows, stream_shift;
};

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kPi = (float)3.14159265358979323846;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
// The float32 roundings of the float64 constants the TPU kernel uses.
constexpr float kInvTwoPi = (float)(1.0 / (2.0 * 3.14159265358979323846));
constexpr float kInvPi = (float)(1.0 / 3.14159265358979323846);
constexpr float kCheckerOff = (float)0.3183098861;  // ops/textures.py
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr int kTexLanes = 128;
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
// compressed material record; with kExt (textured or directional-sky
// scenes) also its material id and texture coordinates (a sphere's are
// computed after the fold).  The carry lives in memory across the
// non-inlined walks, so the instantiations without kExt get a carry
// without those fields.
struct HitBase {
  static constexpr bool kAnyHit = false;
  static constexpr bool kCount = false;
  float t, gx, gy, gz, c0, c1, c2, extra, ord;
  int front, is_sph, mtype;
};
template <bool kExt>
struct Hit : HitBase {
  static constexpr bool kUV = false;
};
template <>
struct Hit<true> : HitBase {
  static constexpr bool kUV = true;
  int mid;
  float u, v;
};

// Any-hit carry of a shadow ray, seeded with its light's own (t, ord): a
// primitive that beats the seed occludes the light and sets t to -kBig,
// which no slab or primitive test passes, and the walks return at once
// (the per-ray form of the TPU's "best_t -> -BIG").
struct Occluder {
  static constexpr bool kAnyHit = true;
  static constexpr bool kUV = false;
  static constexpr bool kCount = false;
  float t, ord;
};

// The traversal counters of one ray (the probe kernel, csrc/probe.cu),
// with the JAX package's rules (pallas_trace.py collect_stats): every
// column a threaded walk visits is a node (a kind's tree, the stream
// route's top tree and each mini-tree, an instance's mesh tree), and so
// are a linear scan's root pretest box and each of its cluster boxes; an
// entered leaf or linear cluster is a leaf and adds its span (a linear
// cluster its full cluster size; a top-tree leaf of the stream route adds
// nothing, its mini-walk counts the slots).  A tiny kind's plain loop and
// the instances' world-box scan count nothing.
struct WalkCount {
  int nodes, leaves, prims;
  __device__ __forceinline__ void visit(bool entered, int span) {
    nodes += 1;
    if (entered) {
      leaves += 1;
      prims += span;
    }
  }
  __device__ __forceinline__ void add(const WalkCount& o) {
    nodes += o.nodes;
    leaves += o.leaves;
    prims += o.prims;
  }
};

// A carry that also counts its walk (the probe kernel's instantiations):
// the walks test Carry::kCount at compile time, so the trace and segment
// kernels' carries compile to the walks they compile to without it.
template <class Carry>
struct Counted : Carry {
  static constexpr bool kCount = true;
  WalkCount n;
  __device__ __forceinline__ explicit Counted(const Carry& c)
      : Carry(c), n{0, 0, 0} {}
};

template <class Carry>
__device__ __forceinline__ bool occluded(const Carry& h) {
  return Carry::kAnyHit && h.t == -kBig;
}

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
template <class Carry>
__device__ __forceinline__ bool beats(float t, float ordv, const Carry& h) {
  return t < h.t || (t == h.t && ordv < h.ord);
}

// Record a winner: the closest-hit carry takes its geometry and material
// (and with kUV its material id and texture coordinates u, v); an any-hit
// carry is occluded.
template <class Carry>
__device__ __forceinline__ void take(const PrtScene& S, float t, float ordv,
                                     float mid, float gx, float gy, float gz,
                                     int front, int is_sph, float u, float v,
                                     Carry& h) {
  if constexpr (Carry::kAnyHit) {
    h.t = -kBig;
  } else {
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
    if constexpr (Carry::kUV) {
      h.mid = mi;
      h.u = u;
      h.v = v;
    }
  }
}

// The sphere test's hit distance: the nearer root when it is >= t_min,
// else the farther one; `front` says which.  The NEE block computes its
// sphere light's analytic t with this same function.
__device__ __forceinline__ bool sphere_t(float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float cx, float cy, float cz, float r2,
                                         float t_min, float t_cap, float& t,
                                         bool& front) {
  float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  float b2 = dx * ocx + dy * ocy + dz * ocz;
  float cterm = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  float disc = b2 * b2 - cterm;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t_near = -b2 - sq;
  float t_far = -b2 + sq;
  front = t_near >= t_min;
  t = front ? t_near : t_far;
  return (disc >= 0.0f) && (t >= t_min) && (t <= t_cap);
}

// A quad hit's half-extent coordinate along the scaled edge s (us or vs)
// with offset c (cu or cv): (o.s) + t (d.s) - c.
__device__ __forceinline__ float quad_coord(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float sx, float sy, float sz,
                                            float c, float t) {
  return (ox * sx + oy * sy + oz * sz) + t * (dx * sx + dy * sy + dz * sz)
      - c;
}

// The quad test's hit distance and in-extent test from the plane
// constants n, cn and the scaled edges us, cu, vs, cv; `on` is o.n (its
// sign gives the front flag).  Shared with the NEE block's quad light.
__device__ __forceinline__ bool quad_t(float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       float qnx, float qny, float qnz,
                                       float cn, float usx, float usy,
                                       float usz, float cu, float vsx,
                                       float vsy, float vsz, float cv,
                                       float t_min, float t_cap, float& t,
                                       float& on) {
  float dn = dx * qnx + dy * qny + dz * qnz;
  on = ox * qnx + oy * qny + oz * qnz;
  bool denom_ok = fabsf(dn) >= 1e-8f;
  float inv_dn = denom_ok ? 1.0f / dn : 0.0f;
  t = (cn - on) * inv_dn;
  float a = quad_coord(ox, oy, oz, dx, dy, dz, usx, usy, usz, cu, t);
  float b = quad_coord(ox, oy, oz, dx, dy, dz, vsx, vsy, vsz, cv, t);
  return denom_ok && (t > t_min) && (a * a < 1.0f) && (b * b < 1.0f)
      && (t <= t_cap);
}

template <class Carry>
__device__ __forceinline__ void sphere_test(const PrtScene& S, int j,
                                            const Ray& r, Carry& h) {
  const float* __restrict__ s = S.sph;
  const int n = S.n_sph;
  float cx = ld(s, j), cy = ld(s, n + j), cz = ld(s, 2 * n + j);
  float t;
  bool fr;
  if (!sphere_t(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, cx, cy, cz,
                ld(s, 3 * n + j), S.t_min, S.t_cap, t, fr)) {
    return;
  }
  float ordv = ld(s, 5 * n + j);
  if (!beats(t, ordv, h)) return;
  take(S, t, ordv, ld(s, 4 * n + j), cx, cy, cz, fr, 1, 0.0f, 0.0f, h);
}

template <class Carry>
__device__ __forceinline__ void quad_test(const PrtScene& S, int j,
                                          const Ray& r, Carry& h) {
  const float* __restrict__ q = S.quad;
  const int n = S.n_quad;
  float qnx = ld(q, j), qny = ld(q, n + j), qnz = ld(q, 2 * n + j);
  float cn = ld(q, 3 * n + j);
  float t, on;
  if (!quad_t(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, qnx, qny, qnz, cn,
              ld(q, 4 * n + j), ld(q, 5 * n + j), ld(q, 6 * n + j),
              ld(q, 7 * n + j), ld(q, 8 * n + j), ld(q, 9 * n + j),
              ld(q, 10 * n + j), ld(q, 11 * n + j), S.t_min, S.t_cap, t,
              on)) {
    return;
  }
  float ordv = ld(q, 13 * n + j);
  if (!beats(t, ordv, h)) return;
  float u = 0.0f, v = 0.0f;
  if constexpr (Carry::kUV) {
    // the winner's half-extent coordinates (as quad_t computed them) to
    // texture coordinates: u = (a + 1) / 2
    u = 0.5f + 0.5f * quad_coord(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                                 ld(q, 4 * n + j), ld(q, 5 * n + j),
                                 ld(q, 6 * n + j), ld(q, 7 * n + j), t);
    v = 0.5f + 0.5f * quad_coord(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                                 ld(q, 8 * n + j), ld(q, 9 * n + j),
                                 ld(q, 10 * n + j), ld(q, 11 * n + j), t);
  }
  take(S, t, ordv, ld(q, 12 * n + j), qnx, qny, qnz, on - cn > 0.0f, 0, u, v,
       h);
}

// Moller-Trumbore through triple products (pallas_trace.py make_tri_body):
// div = -d.ng, t = (o.ng - p0.ng) / div, b1 = (w.e2 - d.(e2 x p0)) / div,
// b2 = (-w.e1 - d.(p0 x e1)) / div with w = o x d, over rows 0-15 of
// column j of an (rows, n) table: the flat `tri` table and the instanced
// `itri` table share that layout.
__device__ __forceinline__ bool tri_hit(const float* __restrict__ q, int n,
                                        int j, const Ray& r, float t_min,
                                        float t_cap, float& t, float& b1,
                                        float& b2) {
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
  t = (r.ox * ngx + r.oy * ngy + r.oz * ngz - p0ng) * inv;
  b1 = ((r.wx * e2x + r.wy * e2y + r.wz * e2z)
        - (r.dx * xpx + r.dy * xpy + r.dz * xpz)) * inv;
  b2 = (-(r.wx * e1x + r.wy * e1y + r.wz * e1z)
        - (r.dx * pex + r.dy * pey + r.dz * pez)) * inv;
  return div_ok && (t >= t_min) && (b1 >= 0.0f) && (b2 >= 0.0f)
      && (b1 + b2 <= 1.0f) && (t <= t_cap);
}

// A flat triangle: the winner carries the raw barycentric blend of the
// vertex normals and the front flag !(d.n_interp > 0); the normal is
// normalised once, after the fold.  With texture coordinates (rows 27-32,
// image scenes) the kUV carry takes their barycentric blend.
template <class Carry>
__device__ __forceinline__ void tri_test(const PrtScene& S, int j,
                                         const Ray& r, Carry& h) {
  const float* __restrict__ q = S.tri;
  const int n = S.n_tri;
  float t, b1, b2;
  if (!tri_hit(q, n, j, r, S.t_min, S.t_cap, t, b1, b2)) return;
  float ordv = ld(q, 17 * n + j);
  if (!beats(t, ordv, h)) return;
  if constexpr (Carry::kAnyHit) {
    h.t = -kBig;
  } else {
    float b0 = 1.0f - b1 - b2;
    float inx = b0 * ld(q, 18 * n + j) + b1 * ld(q, 21 * n + j)
        + b2 * ld(q, 24 * n + j);
    float iny = b0 * ld(q, 19 * n + j) + b1 * ld(q, 22 * n + j)
        + b2 * ld(q, 25 * n + j);
    float inz = b0 * ld(q, 20 * n + j) + b1 * ld(q, 23 * n + j)
        + b2 * ld(q, 26 * n + j);
    bool back = (r.dx * inx + r.dy * iny + r.dz * inz) > 0.0f;
    float u = 0.0f, v = 0.0f;
    if (Carry::kUV && S.itex) {
      u = b0 * ld(q, 27 * n + j) + b1 * ld(q, 29 * n + j)
          + b2 * ld(q, 31 * n + j);
      v = b0 * ld(q, 28 * n + j) + b1 * ld(q, 30 * n + j)
          + b2 * ld(q, 32 * n + j);
    }
    take(S, t, ordv, ld(q, 16 * n + j), inx, iny, inz, !back, 0, u, v, h);
  }
}

// An instanced triangle, itri column j of instance k (pallas_trace.py
// inst_body's itri_body): the hit test in mesh-local space with the
// instance's local ray `lr`, whose t is world t.  The winner carries the
// world normal (rows 13-21 of the instance record, the inverse transpose,
// applied to the interpolated local normal), the front flag
// !(world d . that normal > 0), the instance's material (row 22), the
// ordinal row 23 + j and, with texture coordinates (itri rows 25-30), their
// barycentric blend; the shadow ray's any-hit carry reads only t and the
// ordinal.
template <class Carry>
__device__ __forceinline__ void itri_test(const PrtScene& S, int k, int j,
                                          const Ray& lr, const Ray& r,
                                          Carry& h) {
  const float* __restrict__ q = S.itri;
  const int n = S.n_itri;
  float t, b1, b2;
  if (!tri_hit(q, n, j, lr, S.t_min, S.t_cap, t, b1, b2)) return;
  const float* __restrict__ I = S.inst + k;
  const int ni = S.n_inst;
  float ordv = ld(I, 23 * ni) + (float)j;
  if (!beats(t, ordv, h)) return;
  if constexpr (Carry::kAnyHit) {
    h.t = -kBig;
  } else {
    float b0 = 1.0f - b1 - b2;
    float inx = b0 * ld(q, 16 * n + j) + b1 * ld(q, 19 * n + j)
        + b2 * ld(q, 22 * n + j);
    float iny = b0 * ld(q, 17 * n + j) + b1 * ld(q, 20 * n + j)
        + b2 * ld(q, 23 * n + j);
    float inz = b0 * ld(q, 18 * n + j) + b1 * ld(q, 21 * n + j)
        + b2 * ld(q, 24 * n + j);
    float wnx = ld(I, 13 * ni) * inx + ld(I, 14 * ni) * iny
        + ld(I, 15 * ni) * inz;
    float wny = ld(I, 16 * ni) * inx + ld(I, 17 * ni) * iny
        + ld(I, 18 * ni) * inz;
    float wnz = ld(I, 19 * ni) * inx + ld(I, 20 * ni) * iny
        + ld(I, 21 * ni) * inz;
    bool back = (r.dx * wnx + r.dy * wny + r.dz * wnz) > 0.0f;
    float u = 0.0f, v = 0.0f;
    if (Carry::kUV && S.itex) {
      u = b0 * ld(q, 25 * n + j) + b1 * ld(q, 27 * n + j)
          + b2 * ld(q, 29 * n + j);
      v = b0 * ld(q, 26 * n + j) + b1 * ld(q, 28 * n + j)
          + b2 * ld(q, 30 * n + j);
    }
    take(S, t, ordv, ld(I, 22 * ni), wnx, wny, wnz, !back, 0, u, v, h);
  }
}

// A linear cluster's box test `entered`, counted with the cluster's full
// size as its span when the carry counts.
template <class Carry>
__device__ __forceinline__ bool counted_entry(Carry& h, bool entered,
                                              int csize) {
  if constexpr (Carry::kCount) h.n.visit(entered, csize);
  return entered;
}

template <int kKind, class Carry>
__device__ __forceinline__ void test_range(const PrtScene& S, int lo, int hi,
                                           const Ray& r, Carry& h) {
  for (int j = lo; j < hi && !occluded(h); ++j) {
    if (kKind == kSphere) {
      sphere_test(S, j, r, h);
    } else if (kKind == kQuad) {
      quad_test(S, j, r, h);
    } else {
      tri_test(S, j, r, h);
    }
  }
}

// One kind's fold, dispatched like `clustered`: a tiny kind (n <= csize)
// is a plain loop; an (8, M) table is the threaded tree (hit -> node + 1,
// miss -> escape link in row 6, row 7 packs a leaf as lo*64 + span); a
// (6, n_cl + 1) table is the linear cluster scan behind the root pretest
// in its last column.  `csize` is the kind's own cluster size
// (TRI_CLUSTER for triangles): it sets both the tiny-kind test and the
// linear runs.  The carry is the closest hit (Hit) or a shadow ray's
// any-hit (Occluder), which returns as soon as the light is occluded.
template <int kKind, class Carry>
__device__ void fold_kind(const PrtScene& S, int n, const float* __restrict__ cl,
                          int rows, int cols, int csize, const Ray& r,
                          Carry& h) {
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
      if constexpr (Carry::kCount) {
        h.n.visit(enter && leaf, leaf ? (int)lo_f & 63 : 0);
      }
      if (enter && leaf) {
        int enc = (int)lo_f;
        int lo = enc >> 6;
        test_range<kKind>(S, lo, lo + (enc & 63), r, h);
        if (occluded(h)) return;
      }
      node = (enter && !leaf) ? node + 1 : miss;
    }
    return;
  }
  int n_cl = (n + csize - 1) / csize;
  if constexpr (Carry::kCount) h.n.visit(false, 0);  // the root pretest
  if (!slab_hit(cl, cols, n_cl, r, S.t_min, h.t)) return;
  for (int ci = 0; ci < n_cl && !occluded(h); ++ci) {
    if (counted_entry(h, slab_hit(cl, cols, ci, r, S.t_min, h.t), csize)) {
      int lo = ci * csize;
      test_range<kKind>(S, lo, min(lo + csize, n), r, h);
    }
  }
}

// The stream route's fold over a big mesh (pallas_trace.py's `if
// tri_stream:` branch of bounce_step, K7): the threaded walk of the top
// tree (as fold_kind's); an entered leaf names a chunk, whose threaded
// mini-tree is walked from its first column until an escape link of -1,
// and an entered mini-leaf tests its slots chunk * chunk + lo .. + span
// with tri_test.  The TPU's DMA of a chunk into scratch, its two-slot
// residency cache and its deferred fold of the pending chunk are ways to
// reach the same winner there; here the tables are read in place, and
// the fold's (t, ordinal) minimum does not depend on the visit order.
// One thread walks one ray; a shadow ray's any-hit carry returns as soon
// as it is occluded.
template <class Carry>
__device__ void fold_stream(const PrtScene& S, const Ray& r, Carry& h) {
  const float* __restrict__ top = S.tri_cl;
  const float* __restrict__ mini = S.mini;
  const int cols = S.tri_cl_cols;
  const int mcols = S.n_mini;
  int node = 0;
  while (node >= 0) {
    bool enter = slab_hit(top, cols, node, r, S.t_min, h.t);
    int miss = (int)ld(top, 6 * cols + node);
    float enc_f = ld(top, 7 * cols + node);
    bool leaf = enc_f >= 0.0f;
    if constexpr (Carry::kCount) h.n.visit(enter && leaf, 0);
    if (enter && leaf) {
      const int c = (int)enc_f >> S.stream_shift;
      const int base = c * S.node_rows;
      const int slot0 = c * S.chunk;
      int m = base;
      while (m >= 0) {
        bool m_enter = slab_hit(mini, mcols, m, r, S.t_min, h.t);
        int m_miss = (int)ld(mini, 6 * mcols + m);
        float m_enc = ld(mini, 7 * mcols + m);
        bool m_leaf = m_enc >= 0.0f;
        if constexpr (Carry::kCount) {
          h.n.visit(m_enter && m_leaf, m_leaf ? (int)m_enc & 63 : 0);
        }
        if (m_enter && m_leaf) {
          int enc = (int)m_enc;
          int lo = slot0 + (enc >> 6);
          test_range<kTriangle>(S, lo, lo + (enc & 63), r, h);
          if (occluded(h)) return;
        }
        m = (m_enter && !m_leaf) ? m + 1 : (m_miss < 0 ? -1 : base + m_miss);
      }
    }
    node = (enter && !leaf) ? node + 1 : miss;
  }
}

// The instance block (pallas_trace.py inst_body): a linear scan of the
// instances' world boxes (instances are few) at the carry's t; on entry
// the world ray goes into the mesh's space through the instance's
// world->local affine (rows 1-12), its direction NOT renormalised, so
// local t is world t and the carry's t bounds the local walk unchanged;
// then the threaded walk of the mesh's tree over iacc from the
// instance's root (row 0) to a -1 escape link, leaves testing itri
// columns lo .. lo + span.  One thread walks one ray, so an instance a
// ray misses costs one box test.
template <class Carry>
__device__ void fold_instances(const PrtScene& S, const Ray& r, Carry& h) {
  const int ni = S.n_inst;
  const int na = S.n_iacc;
  const float* __restrict__ acc = S.iacc;
  for (int k = 0; k < ni; ++k) {
    if (!slab_hit(S.ibox, ni, k, r, S.t_min, h.t)) continue;
    const float* __restrict__ I = S.inst + k;
    auto g = [&](int row) { return ld(I, row * ni); };
    Ray lr;
    lr.ox = g(1) * r.ox + g(2) * r.oy + g(3) * r.oz + g(4);
    lr.oy = g(5) * r.ox + g(6) * r.oy + g(7) * r.oz + g(8);
    lr.oz = g(9) * r.ox + g(10) * r.oy + g(11) * r.oz + g(12);
    lr.dx = g(1) * r.dx + g(2) * r.dy + g(3) * r.dz;
    lr.dy = g(5) * r.dx + g(6) * r.dy + g(7) * r.dz;
    lr.dz = g(9) * r.dx + g(10) * r.dy + g(11) * r.dz;
    lr.ix = safe_inv(lr.dx);
    lr.iy = safe_inv(lr.dy);
    lr.iz = safe_inv(lr.dz);
    lr.wx = lr.oy * lr.dz - lr.oz * lr.dy;
    lr.wy = lr.oz * lr.dx - lr.ox * lr.dz;
    lr.wz = lr.ox * lr.dy - lr.oy * lr.dx;
    int node = (int)g(0);
    while (node >= 0) {
      bool enter = slab_hit(acc, na, node, lr, S.t_min, h.t);
      int miss = (int)ld(acc, 6 * na + node);
      float lo_f = ld(acc, 7 * na + node);
      bool leaf = lo_f >= 0.0f;
      if constexpr (Carry::kCount) {
        h.n.visit(enter && leaf, leaf ? (int)lo_f & 63 : 0);
      }
      if (enter && leaf) {
        int enc = (int)lo_f;
        int lo = enc >> 6;
        for (int j = lo; j < lo + (enc & 63) && !occluded(h); ++j) {
          itri_test(S, k, j, lr, r, h);
        }
        if (occluded(h)) return;
      }
      node = (enter && !leaf) ? node + 1 : miss;
    }
  }
}

// The triangle kind's three states: none, the dense tables, the stream
// route.
constexpr int kTriNone = 0;
constexpr int kTriDense = 1;
constexpr int kTriStream = 2;

// The fold of every kind; kTri adds the triangle kind (dense or the
// stream route), kInst the instance block.
template <int kTri, bool kInst, class Carry>
__device__ __forceinline__ void fold_scene(const PrtScene& S, const Ray& r,
                                           Carry& h) {
  fold_kind<kSphere>(S, S.n_sph, S.sph_cl, S.sph_cl_rows, S.sph_cl_cols,
                     S.csize, r, h);
  if (occluded(h)) return;
  fold_kind<kQuad>(S, S.n_quad, S.quad_cl, S.quad_cl_rows, S.quad_cl_cols,
                   S.csize, r, h);
  if (kTri == kTriDense && !occluded(h)) {
    fold_kind<kTriangle>(S, S.n_tri, S.tri_cl, S.tri_cl_rows, S.tri_cl_cols,
                         S.tri_csize, r, h);
  }
  if (kTri == kTriStream && !occluded(h)) {
    fold_stream(S, r, h);
  }
  if (kInst && !occluded(h)) {
    fold_instances(S, r, h);
  }
}

// Next-event estimation at a Lambertian vertex p with shading normal n
// and albedo c (pallas_trace.py l.2748-2895, its any-hit form): pick one
// light from the stream's salt 5, sample a direction toward it from salts
// 6 and 7 (a uniform cone toward a sphere light, a uniform point on a quad
// light), trace the shadow ray as an any-hit walk seeded with the light's
// own analytic hit (t, ord), and add throughput * albedo * the light's
// emission * cos / (pi * pdf) when nothing beats the seed.  The seed's t
// is computed by the light's own primitive test from the rows 18-27 of
// the light table, so it equals the t the closest-hit fold would give the
// light, and the equal-t tie rule decides coplanar geometry as the
// closest-hit formulation does.  The shadow walk runs through the
// instances too (kInst).  Reads the incoming throughput.  With kCount the
// shadow walk's counters are added to *cnt.
template <int kTri, bool kInst, bool kCount = false>
__device__ __forceinline__ void nee_direct(const PrtScene& S, uint32_t rng_d,
                                           float px, float py, float pz,
                                           float nx, float ny, float nz,
                                           float c0, float c1, float c2,
                                           PathState& s,
                                           WalkCount* cnt = nullptr) {
  const int nl = S.n_lights;
  const float u_l = uniform01(rng_d, 5u);
  const float u_a = uniform01(rng_d, 6u);
  const float u_b = uniform01(rng_d, 7u);
  const int li = min((int)(u_l * (float)nl), nl - 1);
  // The light's rows by direct index; "+ 0.0f" turns a -0.0 entry into
  // +0.0, as the TPU kernel's blend over the lights (p*(1-m) + row*m) does.
  const float* __restrict__ L = S.lights + li;
  auto row = [&](int k) { return ld(L, k * nl) + 0.0f; };
  const bool is_sphl = row(0) == 0.0f;  // kind: 0 sphere, 1 quad
  const float lcx = row(2), lcy = row(3), lcz = row(4);
  float wix, wiy, wiz, pdf, sh_t;
  bool ok, sh_hit;
  if (is_sphl) {
    const float lr = row(5);
    float tox = lcx - px, toy = lcy - py, toz = lcz - pz;
    float dc2 = tox * tox + toy * toy + toz * toz;
    float inv_dc = 1.0f / sqrtf(fmaxf(dc2, 1e-20f));
    float axx = tox * inv_dc, axy = toy * inv_dc, axz = toz * inv_dc;
    float sin2m = fminf(fmaxf(lr * lr / fmaxf(dc2, 1e-20f), 0.0f), 1.0f);
    float cosm = sqrtf(fmaxf(1.0f - sin2m, 0.0f));
    float cost = 1.0f - u_a * (1.0f - cosm);
    float sint = sqrtf(fmaxf(1.0f - cost * cost, 0.0f));
    float phi_l = kTwoPi * u_b;
    float hy = fabsf(axx) > 0.9f ? 1.0f : 0.0f;
    float hx = 1.0f - hy;
    float t1x = axy * 0.0f - axz * hy;
    float t1y = axz * hx - axx * 0.0f;
    float t1z = axx * hy - axy * hx;
    float t_il = 1.0f / sqrtf(fmaxf(t1x * t1x + t1y * t1y + t1z * t1z,
                                    1e-20f));
    t1x = t1x * t_il;
    t1y = t1y * t_il;
    t1z = t1z * t_il;
    float t2x = axy * t1z - axz * t1y;
    float t2y = axz * t1x - axx * t1z;
    float t2z = axx * t1y - axy * t1x;
    float cp = (float)cos((double)phi_l) * sint;
    float sp = (float)sin((double)phi_l) * sint;
    wix = axx * cost + t1x * cp + t2x * sp;
    wiy = axy * cost + t1y * cp + t2y * sp;
    wiz = axz * cost + t1z * cp + t2z * sp;
    pdf = 1.0f / fmaxf(kTwoPi * (1.0f - cosm), 1e-12f);
    ok = dc2 > lr * lr;
    bool front;
    sh_hit = sphere_t(px, py, pz, wix, wiy, wiz, lcx, lcy, lcz, row(27),
                      S.t_min, S.t_cap, sh_t, front);
  } else {
    const float lux = row(6), luy = row(7), luz = row(8);
    const float lvx = row(9), lvy = row(10), lvz = row(11);
    const float lqx = row(12), lqy = row(13), lqz = row(14);
    float a2 = 2.0f * u_a - 1.0f;
    float b2l = 2.0f * u_b - 1.0f;
    float qpx = lcx + a2 * lux + b2l * lvx - px;
    float qpy = lcy + a2 * luy + b2l * lvy - py;
    float qpz = lcz + a2 * luz + b2l * lvz - pz;
    float dist2 = qpx * qpx + qpy * qpy + qpz * qpz;
    float inv_dq = 1.0f / sqrtf(fmaxf(dist2, 1e-20f));
    wix = qpx * inv_dq;
    wiy = qpy * inv_dq;
    wiz = qpz * inv_dq;
    float crx = luy * lvz - luz * lvy;
    float cry = luz * lvx - lux * lvz;
    float crz = lux * lvy - luy * lvx;
    float area = 4.0f * sqrtf(fmaxf(crx * crx + cry * cry + crz * crz, 0.0f));
    float cosl = fabsf(wix * lqx + wiy * lqy + wiz * lqz);
    pdf = dist2 / fmaxf(cosl * area, 1e-12f);
    ok = cosl > 1e-6f;
    float on;
    sh_hit = quad_t(px, py, pz, wix, wiy, wiz, lqx, lqy, lqz, row(18),
                    row(19), row(20), row(21), row(22), row(23), row(24),
                    row(25), row(26), S.t_min, S.t_cap, sh_t, on);
  }
  pdf = pdf / (float)nl;
  const float cos_s = wix * nx + wiy * ny + wiz * nz;
  if (!(cos_s > 0.0f && ok && sh_hit)) return;
  Ray r{px, py, pz, wix, wiy, wiz, safe_inv(wix), safe_inv(wiy),
        safe_inv(wiz), py * wiz - pz * wiy, pz * wix - px * wiz,
        px * wiy - py * wix};
  std::conditional_t<kCount, Counted<Occluder>, Occluder> oc{
      Occluder{sh_t, row(1)}};
  fold_scene<kTri, kInst>(S, r, oc);
  if constexpr (kCount) cnt->add(oc.n);
  if (occluded(oc)) return;
  const float w_l = cos_s / (kPi * fmaxf(pdf, 1e-12f));
  s.rr = s.rr + s.tr * c0 * w_l * row(15);
  s.rg = s.rg + s.tg * c1 * w_l * row(16);
  s.rb = s.rb + s.tb * c2 * w_l * row(17);
}

// The sky along a missed ray's direction d (pallas_trace.py l.2706-2735):
// sky_mode 1 the gradient lerp(bottom, top, 0.5 * (d_hat.y + 1)), mode 2
// plus the sun color * max(d_hat . sun_dir, 0) ** power, the power taken
// by square-and-multiply over its bits (the TPU kernel's static binary
// exponentiation, the same multiplies in the same order).
__device__ __forceinline__ void sky_radiance(const PrtScene& S, float dx,
                                             float dy, float dz, float& k0,
                                             float& k1, float& k2) {
  const float inv_l = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  const float tmix = 0.5f * (dy * inv_l + 1.0f);
  k0 = S.sky[0] + tmix * (S.sky[3] - S.sky[0]);
  k1 = S.sky[1] + tmix * (S.sky[4] - S.sky[1]);
  k2 = S.sky[2] + tmix * (S.sky[5] - S.sky[2]);
  if (S.sky_mode == 2) {
    float base = fmaxf((dx * S.sky[6] + dy * S.sky[7] + dz * S.sky[8])
                       * inv_l, 0.0f);
    float w = 1.0f;
    for (int p = (int)S.sky[12]; p; p >>= 1) {
      if (p & 1) w = w * base;
      base = base * base;
    }
    k0 = k0 + w * S.sky[9];
    k1 = k1 + w * S.sky[10];
    k2 = k2 + w * S.sky[11];
  }
}

// val mod ext for the texture's repeat wrap, with inv = float32(1 / ext).
__device__ __forceinline__ float tex_wrap(float val, float ext, float inv) {
  return val - ext * floorf(val * inv);
}

// Texel (yi, xi) of an image whose rows start at `tex`, decoded from its
// packed r * 65536 + g * 256 + b to [0, 1] (pallas_trace.py l.2655-2672).
// One indexed load at row * width + column: the TPU kernel's loop over the
// texel rows with a lane gather is its way to the same word.
__device__ __forceinline__ void tex_fetch(const float* __restrict__ tex,
                                          float yi, float xi, float thf,
                                          float twf, float ith, float itw,
                                          float& r, float& g, float& b) {
  const int idx = (int)(tex_wrap(yi, thf, ith) * twf + tex_wrap(xi, twf, itw));
  const float val = ld(tex, idx);
  const float r8 = floorf(val * (1.0f / 65536.0f));
  const float rem = val - r8 * 65536.0f;
  const float g8 = floorf(rem * (1.0f / 256.0f));
  const float b8 = rem - g8 * 256.0f;
  r = r8 * kInv255;
  g = g8 * kInv255;
  b = b8 * kInv255;
}

// The albedo h.c of hit h after its material's texture (pallas_trace.py
// l.2612-2704), before emission, NEE and attenuation read it: an image
// multiplies it by its bilinear, repeat-wrapped sample at the hit's UV (a
// sphere's from the outward p - c, whatever the front flag:
// u = 0.5 + atan2(z, x) / 2pi, v = 0.5 - asin(y_hat) / pi); a checker
// replaces it by the odd color where the world cell's parity is odd.  The
// material's row of S.mtex says which (a material has at most one
// texture, so the lookup stands for the TPU kernel's unrolled loops).
__device__ __forceinline__ void texture_albedo(const PrtScene& S, float px,
                                               float py, float pz, float nrx,
                                               float nry, float nrz,
                                               float n_ilen, Hit<true>& h) {
  const int nm = S.n_mats;
  const float* __restrict__ T = S.mtex + h.mid;
  const float kind = ld(T, 0);
  if (kind == 2.0f) {
    float u = h.u, v = h.v;
    if (h.is_sph) {
      u = 0.5f + (float)atan2((double)nrz, (double)nrx) * kInvTwoPi;
      v = 0.5f - (float)asin((double)fminf(fmaxf(nry * n_ilen, -1.0f),
                                           1.0f)) * kInvPi;
    }
    const float uw = u - floorf(u);
    const float vw = v - floorf(v);
    const float thf = ld(T, 2 * nm), twf = ld(T, 3 * nm);
    const float ith = ld(T, 4 * nm), itw = ld(T, 5 * nm);
    const float* __restrict__ tex = S.itex + (int)ld(T, nm) * kTexLanes;
    const float x = uw * twf - 0.5f;
    const float y = (1.0f - vw) * thf - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    float r00, g00, b00, r01, g01, b01, r10, g10, b10, r11, g11, b11;
    tex_fetch(tex, y0, x0, thf, twf, ith, itw, r00, g00, b00);
    tex_fetch(tex, y0, x0 + 1.0f, thf, twf, ith, itw, r01, g01, b01);
    tex_fetch(tex, y0 + 1.0f, x0, thf, twf, ith, itw, r10, g10, b10);
    tex_fetch(tex, y0 + 1.0f, x0 + 1.0f, thf, twf, ith, itw, r11, g11, b11);
    const float ex = 1.0f - fx, ey = 1.0f - fy;
    h.c0 = ((r00 * ex + r01 * fx) * ey + (r10 * ex + r11 * fx) * fy) * h.c0;
    h.c1 = ((g00 * ex + g01 * fx) * ey + (g10 * ex + g11 * fx) * fy) * h.c1;
    h.c2 = ((b00 * ex + b01 * fx) * ey + (b10 * ex + b11 * fx) * fy) * h.c2;
  } else if (kind == 1.0f) {
    const float cs = ld(T, nm);
    const float cell = floorf(px * cs + kCheckerOff)
        + floorf(py * cs + kCheckerOff) + floorf(pz * cs + kCheckerOff);
    const float odd = cell - 2.0f * floorf(cell * 0.5f);
    if (odd > 0.5f) {
      h.c0 = ld(T, 2 * nm);
      h.c1 = ld(T, 3 * nm);
      h.c2 = ld(T, 4 * nm);
    }
  }
}

// One bounce of path `s` at absolute depth `depth` with the bounce's
// stream word rng_d.  `alive_in` is the path's alive value (1, or 2 when
// NEE sampled the light at the previous, diffuse vertex: its emission is
// then not added again).  Returns the alive value after the bounce: 0
// when the path ends (sky, emitter, metal ray scattered under the
// surface, Russian roulette), 2 when it goes on from a diffuse vertex
// under NEE, else 1.  A path that ends keeps its origin and direction
// (unless roulette ended it after the scatter), and only its radiance
// changes.  kTri is whether the scene has live triangles (S.n_tri > 0)
// and in which layout (kTriDense, or kTriStream with S.mini), kNee
// whether NEE is on (S.n_lights > 0), kRR whether Russian roulette
// is (S.rr_depth > 0), kInst whether the scene has instances
// (S.n_inst > 0), kExt whether it has textures or the directional sky
// (S.mtex or S.sky_mode): the kernels are instantiated each way
// (kernel_variant), so a sphere scene without NEE or roulette runs code
// without the triangle fold, the instance block, the NEE block, the
// roulette and the scene extensions, each of which costs every ray
// registers or spills.  Forced inline, so each kernel's bounce loop
// compiles as one body.  Textured materials are Lambertian (the Scene
// builds them so), so an emitter's record is read untextured.  kCount
// (the probe kernel) adds the bounce's walks, its NEE shadow walk
// included, to *cnt; without it the walks carry no counters.
template <int kTri, bool kNee, bool kRR, bool kInst, bool kExt,
          bool kCount = false>
__device__ __forceinline__ int bounce(const PrtScene& S, uint32_t rng_d,
                                      int depth, int alive_in, PathState& s,
                                      WalkCount* cnt = nullptr) {
  const float ox = s.ox, oy = s.oy, oz = s.oz;
  const float dx = s.dx, dy = s.dy, dz = s.dz;
  Ray r{ox, oy, oz, dx, dy, dz, safe_inv(dx), safe_inv(dy), safe_inv(dz),
        oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx};
  std::conditional_t<kCount, Counted<Hit<kExt>>, Hit<kExt>> h{
      Hit<kExt>{{kBig, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                 (float)(1 << 24), 0, 0, 0}}};
  fold_scene<kTri, kInst>(S, r, h);
  if constexpr (kCount) cnt->add(h.n);

  if (!(h.t < kBig)) {  // miss: sky * throughput, the path ends
    float k0 = S.sky[0], k1 = S.sky[1], k2 = S.sky[2];
    if (kExt && S.sky_mode) sky_radiance(S, dx, dy, dz, k0, k1, k2);
    s.rr = s.rr + s.tr * k0;
    s.rg = s.rg + s.tg * k1;
    s.rb = s.rb + s.tb * k2;
    return 0;
  }
  if (h.mtype == kEmissive) {  // emission; an emitter does not scatter
    if (!(kNee && alive_in == 2)) {
      s.rr = s.rr + s.tr * h.c0;
      s.rg = s.rg + s.tg * h.c1;
      s.rb = s.rb + s.tb * h.c2;
    }
    return 0;
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

  // The albedo is read where it is used: held in registers from here it
  // would cost the plain sphere instantiation spills.
  if constexpr (kExt) {
    if (S.mtex) texture_albedo(S, px, py, pz, nrx, nry, nrz, n_ilen, h);
  }

  if (kNee && h.mtype == kLambertian) {
    nee_direct<kTri, kInst, kCount>(S, rng_d, px, py, pz, nx, ny, nz, h.c0,
                                    h.c1, h.c2, s, cnt);
  }

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
    return 0;
  }
  if (h.mtype != kDielectric) {
    s.tr = s.tr * h.c0;
    s.tg = s.tg * h.c1;
    s.tb = s.tb * h.c2;
  }
  // Russian roulette on the attenuated throughput: end the path with
  // probability 1 - p, p = clip(max channel, 0.05, 1); a survivor's
  // throughput is divided by p.  The origin and direction move either way.
  int alive = 1;
  if (kRR && depth >= S.rr_depth) {
    float p = fminf(fmaxf(fmaxf(s.tr, fmaxf(s.tg, s.tb)), 0.05f), 1.0f);
    if (uniform01(rng_d, 4u) >= p) {
      alive = 0;
    } else {
      float boost = 1.0f / p;
      s.tr = s.tr * boost;
      s.tg = s.tg * boost;
      s.tb = s.tb * boost;
    }
  }
  s.ox = px;
  s.oy = py;
  s.oz = pz;
  s.dx = sx;
  s.dy = sy;
  s.dz = sz;
  // Under NEE a diffuse continuation is marked 2: the next vertex skips
  // the emission this vertex's light sample already counted.
  return (kNee && alive && h.mtype == kLambertian) ? 2 : alive;
}

// A kernel's instantiations: 32 of the triangle kind none or dense, and
// their 16 stream twins (a scene with live triangles on the stream
// route); the dense walk takes no runtime branch on the route.
constexpr int kVariants = 48;

// The instantiation <kTri, kNee, kRR, kInst, kExt> a scene needs, as an
// index into a kernel's table of kVariants: kExt * 16 + kInst * 8 +
// (kTri == kTriDense) * 4 + kNee * 2 + kRR, or on the stream route 32 +
// kExt * 8 + kInst * 4 + kNee * 2 + kRR.
inline int kernel_variant(const PrtScene& S) {
  const int ext = S.mtex != nullptr || S.sky_mode != 0;
  const int inst = S.n_inst > 0;
  const int nee_rr = (S.n_lights > 0) * 2 + (S.rr_depth > 0);
  if (S.mini != nullptr && S.n_tri > 0) {
    return 32 + ext * 8 + inst * 4 + nee_rr;
  }
  return ext * 16 + inst * 8 + (S.n_tri > 0) * 4 + nee_rr;
}

// A kernel's table of its kVariants instantiations K<kTri, kNee, kRR,
// kInst, kExt>, in kernel_variant's order.
#define PRT_VARIANTS2(K, kTri, kInst, kExt)                              \
  K<kTri, false, false, kInst, kExt>, K<kTri, false, true, kInst, kExt>, \
      K<kTri, true, false, kInst, kExt>, K<kTri, true, true, kInst, kExt>
#define PRT_VARIANTS4(K, kInst, kExt)      \
  PRT_VARIANTS2(K, kTriNone, kInst, kExt), \
      PRT_VARIANTS2(K, kTriDense, kInst, kExt)
#define PRT_VARIANTS(K)                                                 \
  {PRT_VARIANTS4(K, false, false), PRT_VARIANTS4(K, true, false),        \
   PRT_VARIANTS4(K, false, true), PRT_VARIANTS4(K, true, true),          \
   PRT_VARIANTS2(K, kTriStream, false, false),                           \
   PRT_VARIANTS2(K, kTriStream, true, false),                            \
   PRT_VARIANTS2(K, kTriStream, false, true),                            \
   PRT_VARIANTS2(K, kTriStream, true, true)}

}  // namespace
