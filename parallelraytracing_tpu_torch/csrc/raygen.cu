// Camera raygen for Hopper (sm_90a): every camera ray of a frame in one
// launch, one thread a ray.
//
// Replaces no TPU kernel: the JAX package generates its rays with XLA
// (parallelraytracing_tpu/ops/rays.py generate_camera_rays_ids), and the
// port did the same with a chain of about 80 small ATen kernels
// (ops/rays.generate_camera_rays_ids_reference: two PCG draws of ~17
// kernels each, then the camera math and the normalisations), each launch
// ~14 us of host time while the card waited.  This kernel computes what
// that chain computes on the card, bit for bit, for the pixel-keyed
// route: a pixel id in, o and d out.
//
// What bounds it on the H100: memory.  A ray reads its id (4 bytes) and
// writes o and d (24 bytes); the arithmetic is a few dozen float32
// operations.  At 1080p that is 58 MB, 17 us at 3.35 TB/s.  Each thread
// writes its six floats itself: staging them in shared memory to store
// whole sectors took 27.9 us a 1080p launch against 24.7 us for the
// direct stores (H100, 700 W; 3.70 against 4.86 us at 360p).
//
// Bit-equality with the ATen chain on the card: built with -fmad=false
// (ops/_build.py), so every multiply and add rounds on its own, in the
// chain's order.  The chain's fixed scalars are the float32s below; those
// that depend on the frame's size, lens or Halton point are formed on the
// host as ATen forms them and passed in (ops/rays.kernel_constants): a
// division by a Python number is ATen's multiply by the float32
// reciprocal, and `c / t` is `t.reciprocal() * c`.  1.0f / sqrtf is
// ops/ieee.rsqrt, and sin / cos are taken in float64 and rounded once, as
// ops/ieee.py does.

#include "bounce.cuh"

namespace {

constexpr int kRaygenThreads = 256;

// which draws and camera extensions a launch applies (ops/rays.py)
constexpr int kJitter = 1;     // sub-pixel jitter from salts 101/102
constexpr int kQmc = 2;        // rotate the draws by the Halton point
constexpr int kLens = 4;       // thin lens
constexpr int kLensDraw = 8;   // the aperture from salts 103/104, else its center

// ops/rays.py's fixed scalars as float32: TAN_FOVY = tan(1/2) and
// _MIN_COS, the clamp of cos(d, front) in the focal distance; its
// _TWO_PI32 is bounce.cuh's kTwoPi
constexpr float kTanFovy = 0x1.17b4f6p-1f;
constexpr float kMinCos = 0x1.0c6f7ap-20f;

struct RaygenArgs {
  const float* __restrict__ cam;  // pos, right, up, front (12 floats)
  const int* __restrict__ idx;    // (R,) flat pixel ids
  float* __restrict__ o;          // (R, 3)
  float* __restrict__ d;          // (R, 3)
  int n;
  int width;
  uint32_t seed;
  int flags;
  // ops/rays.kernel_constants, in its order
  float inv_w, inv_h, aspect_tan;
  float q[4];
  float radius, fdist;
};

// Cranley-Patterson rotation: (u + off) mod 1.
__device__ __forceinline__ float rot(float u, float off) {
  const float v = u + off;
  return v - floorf(v);
}

// v over its float32 length (ops/rays._normalize).
__device__ __forceinline__ void normalize3(float v[3]) {
  float s = v[0] * v[0];
  s = s + v[1] * v[1];
  s = s + v[2] * v[2];
  const float n = sqrtf(s);
  v[0] = v[0] / n;
  v[1] = v[1] / n;
  v[2] = v[2] / n;
}

__device__ __forceinline__ void camera_ray(const RaygenArgs& A, int id,
                                           float o[3], float d[3]) {
  float cam[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) cam[k] = __ldg(A.cam + k);
  const float* pos = cam;
  const float* right = cam + 3;
  const float* up = cam + 6;
  const float* front = cam + 9;

  // x = id mod width, y = floor(id / width), as torch's remainder and
  // floor division round
  int yi = id / A.width, xi = id % A.width;
  if (xi != 0 && ((xi < 0) != (A.width < 0))) {
    xi += A.width;
    yi -= 1;
  }
  const float x = (float)xi, y = (float)yi;
  const uint32_t counter = (uint32_t)id ^ A.seed;

  float px, py;
  if (A.flags & kJitter) {
    float jx = uniform01(counter, 101u), jy = uniform01(counter, 102u);
    if (A.flags & kQmc) {
      jx = rot(jx, A.q[0]);
      jy = rot(jy, A.q[1]);
    }
    px = x + jx;
    py = y + jy;
  } else {
    px = x + 0.5f;
    py = y + 0.5f;
  }
  float ndc_x = px * A.inv_w;
  ndc_x = ndc_x * 2.0f;
  ndc_x = ndc_x - 1.0f;
  float ndc_y = py * A.inv_h;
  ndc_y = ndc_y * 2.0f;
  ndc_y = 1.0f - ndc_y;
  float dx = ndc_x * A.aspect_tan;
  float dy = ndc_y * kTanFovy;
  float dz = -1.0f;
  float s = dx * dx;
  s = s + dy * dy;
  s = s + dz * dz;
  const float inv_len = 1.0f / sqrtf(s);
  dx = dx * inv_len;
  dy = dy * inv_len;
  dz = dz * inv_len;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = dx * right[k];
    v = v + dy * up[k];
    d[k] = v + dz * (-front[k]);
    o[k] = pos[k];
  }
  normalize3(d);
  if (!(A.flags & kLens)) return;

  // the thin lens (ops/rays.apply_thin_lens)
  float u1 = 0.0f, u2 = 0.0f;
  if (A.flags & kLensDraw) {
    u1 = uniform01(counter, 103u);
    u2 = uniform01(counter, 104u);
    if (A.flags & kQmc) {
      u1 = rot(u1, A.q[2]);
      u2 = rot(u2, A.q[3]);
    }
  }
  const float r = A.radius * sqrtf(u1);
  const float theta = kTwoPi * u2;
  const float lx = r * (float)cos((double)theta);
  const float ly = r * (float)sin((double)theta);
  float along = d[0] * front[0];
  along = along + d[1] * front[1];
  along = along + d[2] * front[2];
  // torch.clamp_min keeps a NaN
  const float c = isnan(along) ? along : fmaxf(along, kMinCos);
  const float t_f = (1.0f / c) * A.fdist;
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p = pos[k] + d[k] * t_f;
    float o2 = pos[k] + lx * right[k];
    o2 = o2 + ly * up[k];
    o[k] = o2;
    w[k] = p - o2;
  }
  normalize3(w);
  d[0] = w[0];
  d[1] = w[1];
  d[2] = w[2];
}

__global__ void __launch_bounds__(kRaygenThreads)
    raygen_kernel(const RaygenArgs A) {
  const int i = blockIdx.x * kRaygenThreads + threadIdx.x;
  if (i >= A.n) return;
  float o[3], d[3];
  camera_ray(A, __ldg(A.idx + i), o, d);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    A.o[3 * (size_t)i + k] = o[k];
    A.d[3 * (size_t)i + k] = d[k];
  }
}

}  // namespace

// Launch the raygen of n rays on `stream` without synchronising.  `consts`
// holds ops/rays.kernel_constants' 9 floats.  Returns cudaGetLastError()
// after the launch.
extern "C" int prt_raygen_launch(int device, void* stream, const float* cam,
                                 const int* idx, float* o, float* d, int n,
                                 int width, unsigned seed, int flags,
                                 const float* consts) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  RaygenArgs A;
  A.cam = cam;
  A.idx = idx;
  A.o = o;
  A.d = d;
  A.n = n;
  A.width = width;
  A.seed = seed;
  A.flags = flags;
  A.inv_w = consts[0];
  A.inv_h = consts[1];
  A.aspect_tan = consts[2];
  for (int k = 0; k < 4; ++k) A.q[k] = consts[3 + k];
  A.radius = consts[7];
  A.fdist = consts[8];
  const int blocks = (n + kRaygenThreads - 1) / kRaygenThreads;
  raygen_kernel<<<blocks, kRaygenThreads, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
