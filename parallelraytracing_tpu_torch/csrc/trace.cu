// Fused path-trace kernel for Hopper (sm_90a): every bounce of a ray in one
// launch, one thread per ray.
//
// Replaces parallelraytracing_tpu/ops/pallas_trace.py::pallas_trace (the
// kernel body _make_trace_kernel.kernel and the bounce step
// _make_bounce_step) on its sphere/quad subset: the sphere and quad
// closest-hit bodies, the three per-kind walks of `clustered` (threaded
// SAH tree, linear cluster scan behind a root pretest, plain loop for tiny
// kinds), the constant sky, emission, the branchless Lambertian / metal /
// dielectric block and the PCG streams.  Triangles, NEE, Russian roulette,
// textures, instances, the directional sky and the straggler-tail view are
// refused by the Python wrapper (ops/trace.py) before a launch.
//
// What bounds it on the H100: not FLOPs and not HBM bandwidth.  A ray
// reads the 13 values of its state once and writes 3; everything else is
// the walk: divergent per-ray tree walks (threads of a warp sit in
// different nodes and leaves after the first bounce) and dependent loads
// of table columns (6-14 floats per primitive, 8 per node) that the
// L1/L2 caches serve, since every table fits in L2 (RANDOM_BALLS_LARGE
// packs to about 40 KB).
//
// What this first design does about it: the ray state lives in registers
// for the whole bounce loop (no memory round trip between bounces, the
// TPU kernel's key property); the tables are read-only `const
// __restrict__` global memory in the JAX package's (C, N) column layout,
// read through the read-only data cache; the walk is per ray, so a ray
// enters only the boxes it hits (the TPU walks one cursor per 3072-ray
// tile and enters a box when any lane hits it), and a thread exits as soon
// as its ray dies.  Per-ray walks give the same winner as the TPU's
// whole-tile walk: the fold keeps the lexicographic minimum of (t,
// ordinal), which does not depend on visit order, and a box a ray misses
// holds no primitive that ray hits at t <= best_t.  The TPU's bounce-0
// frustum pretest (FRUSTUM0) only gates its lockstep tile test and leaves
// results bit-identical; it has no per-ray analogue and is not ported.
// Not done yet (later work): staging tables in shared memory, an AoS or
// SoA re-layout of the tables, sorting or compacting rays between bounces
// to cut divergence.
//
// Numerics: built WITHOUT --use_fast_math and WITH -fmad=false (see
// ops/_build.py).  The kernel is held to a plain PyTorch version that
// rounds every multiply and add on its own; contracting them into FMAs
// moves last bits, and a path tracer turns a last-bit difference at a
// grazing hit into a different path.  Division and sqrtf are IEEE-rounded
// (nvcc's default -prec-div=true -prec-sqrt=true), the kernel writes the
// TPU kernel's rsqrt as 1.0f / sqrtf(x), and it takes sin and cos in
// float64 rounded to float: the plain version computes the same
// (ops/ieee.py), so the two agree bit for bit wherever they pick the same
// primitive.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr uint32_t kSaltStep = 0x9E3779B9u;
constexpr uint32_t kDepthStep = 0x85EBCA6Bu;
constexpr int kLambertian = 0;
constexpr int kMetal = 1;
constexpr int kDielectric = 2;
constexpr int kEmissive = 3;
constexpr int kThreads = 128;

struct Params {
  const float* __restrict__ o;     // (R, 3)
  const float* __restrict__ d;     // (R, 3)
  const int* __restrict__ pix;     // (R,) pixel ids keying the streams
  float* __restrict__ out;         // (R, 3) radiance
  int n_rays;
  const float* __restrict__ sph;     // (6, n_sph)
  const float* __restrict__ sph_cl;  // (8, M) tree or (6, n_cl + 1) linear
  int n_sph, sph_cl_rows, sph_cl_cols;
  const float* __restrict__ quad;     // (14, n_quad)
  const float* __restrict__ quad_cl;
  int n_quad, quad_cl_rows, quad_cl_cols;
  const float* __restrict__ mats;  // (5, n_mats)
  int n_mats;
  int csize;  // primitives per linear cluster
  uint32_t seed;
  int max_depth;
  float t_min, t_cap;  // t_cap = t_max, or +inf when t_max >= 1e30
  float sky0, sky1, sky2;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Closest-hit carry: the raw winner geometry (sphere center or quad
// normal) and the winner's compressed material record.
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

__device__ __forceinline__ void take_material(const Params& P, float mid,
                                              Hit& h) {
  int mi = (int)mid;
  int n = P.n_mats;
  h.mtype = (int)ld(P.mats, mi);
  h.c0 = ld(P.mats, n + mi);
  h.c1 = ld(P.mats, 2 * n + mi);
  h.c2 = ld(P.mats, 3 * n + mi);
  h.extra = ld(P.mats, 4 * n + mi);
}

__device__ __forceinline__ void sphere_test(const Params& P, int j,
                                            const Ray& r, Hit& h) {
  const float* __restrict__ s = P.sph;
  const int n = P.n_sph;
  float cx = ld(s, j), cy = ld(s, n + j), cz = ld(s, 2 * n + j);
  float r2 = ld(s, 3 * n + j);
  float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  float b2 = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  float cterm = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  float disc = b2 * b2 - cterm;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t_near = -b2 - sq;
  float t_far = -b2 + sq;
  bool fr = t_near >= P.t_min;
  float t = fr ? t_near : t_far;
  bool ok = (disc >= 0.0f) && (t >= P.t_min) && (t <= P.t_cap);
  if (!ok) return;
  float ordv = ld(s, 5 * n + j);
  if (!beats(t, ordv, h)) return;
  h.t = t;
  h.ord = ordv;
  h.gx = cx;
  h.gy = cy;
  h.gz = cz;
  h.front = fr;
  h.is_sph = 1;
  take_material(P, ld(s, 4 * n + j), h);
}

__device__ __forceinline__ void quad_test(const Params& P, int j,
                                          const Ray& r, Hit& h) {
  const float* __restrict__ q = P.quad;
  const int n = P.n_quad;
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
  bool ok = denom_ok && (t > P.t_min) && (a * a < 1.0f) && (b * b < 1.0f)
      && (t <= P.t_cap);
  if (!ok) return;
  float ordv = ld(q, 13 * n + j);
  if (!beats(t, ordv, h)) return;
  h.t = t;
  h.ord = ordv;
  h.gx = qnx;
  h.gy = qny;
  h.gz = qnz;
  h.front = (on - cn > 0.0f);
  h.is_sph = 0;
  take_material(P, ld(q, 12 * n + j), h);
}

template <int kKind>
__device__ __forceinline__ void test_range(const Params& P, int lo, int hi,
                                           const Ray& r, Hit& h) {
  for (int j = lo; j < hi; ++j) {
    if (kKind == 0) {
      sphere_test(P, j, r, h);
    } else {
      quad_test(P, j, r, h);
    }
  }
}

// One kind's closest-hit fold, dispatched like `clustered`: a tiny kind
// (n <= csize) is a plain loop; an (8, M) table is the threaded tree
// (hit -> node + 1, miss -> escape link in row 6, row 7 packs a leaf as
// lo*64 + span); a (6, n_cl + 1) table is the linear cluster scan behind
// the root pretest in its last column.
template <int kKind>
__device__ void fold_kind(const Params& P, int n, const float* __restrict__ cl,
                          int rows, int cols, const Ray& r, Hit& h) {
  if (n <= P.csize) {
    test_range<kKind>(P, 0, n, r, h);
    return;
  }
  if (rows == 8) {
    int node = 0;
    while (node >= 0) {
      bool enter = slab_hit(cl, cols, node, r, P.t_min, h.t);
      int miss = (int)ld(cl, 6 * cols + node);
      float lo_f = ld(cl, 7 * cols + node);
      bool leaf = lo_f >= 0.0f;
      if (enter && leaf) {
        int enc = (int)lo_f;
        int lo = enc >> 6;
        test_range<kKind>(P, lo, lo + (enc & 63), r, h);
      }
      node = (enter && !leaf) ? node + 1 : miss;
    }
    return;
  }
  int n_cl = (n + P.csize - 1) / P.csize;
  if (!slab_hit(cl, cols, n_cl, r, P.t_min, h.t)) return;
  for (int ci = 0; ci < n_cl; ++ci) {
    if (slab_hit(cl, cols, ci, r, P.t_min, h.t)) {
      int lo = ci * P.csize;
      test_range<kKind>(P, lo, min(lo + P.csize, n), r, h);
    }
  }
}

__global__ void __launch_bounds__(kThreads) trace_kernel(const Params P) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n_rays) return;
  float ox = P.o[3 * i], oy = P.o[3 * i + 1], oz = P.o[3 * i + 2];
  float dx = P.d[3 * i], dy = P.d[3 * i + 1], dz = P.d[3 * i + 2];
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;
  // Pixel-keyed streams: the image does not depend on ray order.
  const uint32_t rng_base = pcg_hash((uint32_t)P.pix[i] ^ P.seed);

  for (int depth = 0; depth < P.max_depth; ++depth) {
    const uint32_t rng_d = rng_base + (uint32_t)depth * kDepthStep;
    Ray r{ox, oy, oz, dx, dy, dz, safe_inv(dx), safe_inv(dy), safe_inv(dz)};
    Hit h{kBig, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, (float)(1 << 24),
          0, 0, 0};
    fold_kind<0>(P, P.n_sph, P.sph_cl, P.sph_cl_rows, P.sph_cl_cols, r, h);
    fold_kind<1>(P, P.n_quad, P.quad_cl, P.quad_cl_rows, P.quad_cl_cols, r,
                 h);

    if (!(h.t < kBig)) {  // miss: sky * throughput, the path ends
      rr = rr + tr * P.sky0;
      rg = rg + tg * P.sky1;
      rb = rb + tb * P.sky2;
      break;
    }
    if (h.mtype == kEmissive) {  // emission; an emitter does not scatter
      rr = rr + tr * h.c0;
      rg = rg + tg * h.c1;
      rb = rb + tb * h.c2;
      break;
    }

    // Deferred shading normal: spheres carried their center, quads the
    // unit plane normal; both flip by the front flag.
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
    if (h.mtype == kMetal && !((sx * nx + sy * ny + sz * nz) > 0.0f)) break;
    if (h.mtype != kDielectric) {
      tr = tr * h.c0;
      tg = tg * h.c1;
      tb = tb * h.c2;
    }
    ox = px;
    oy = py;
    oz = pz;
    dx = sx;
    dy = sy;
    dz = sz;
  }
  P.out[3 * i] = rr;
  P.out[3 * i + 1] = rg;
  P.out[3 * i + 2] = rb;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) without synchronising.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int prt_trace_launch(
    int device, void* stream, const float* o, const float* d, const int* pix,
    float* out, int n_rays, const float* sph, int n_sph, const float* sph_cl,
    int sph_cl_rows, int sph_cl_cols, const float* quad, int n_quad,
    const float* quad_cl, int quad_cl_rows, int quad_cl_cols,
    const float* mats, int n_mats, int csize, unsigned int seed,
    int max_depth, float t_min, float t_cap, float sky0, float sky1,
    float sky2) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rays <= 0) return 0;
  Params P{o, d, pix, out, n_rays,
           sph, sph_cl, n_sph, sph_cl_rows, sph_cl_cols,
           quad, quad_cl, n_quad, quad_cl_rows, quad_cl_cols,
           mats, n_mats, csize, seed, max_depth, t_min, t_cap,
           sky0, sky1, sky2};
  int blocks = (n_rays + kThreads - 1) / kThreads;
  trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
