// Segment kernel for Hopper (sm_90a): n_bounces bounces over a compacted
// ray queue, one thread per queue slot.
//
// Replaces parallelraytracing_tpu/ops/pallas_trace.py::pallas_segment (the
// kernel body _make_segment_kernel.kernel) on the same subset as the trace
// kernel, instances, textures and the directional sky included: the
// bounce is bounce.cuh, shared with trace.cu, so a path traced in segments
// gets the same bits as one traced in a single launch.  A hit's material
// id and texture coordinates live inside one bounce: the state stays 13
// planes.
//
// The state is 13 planes of R floats, (13, R) row-major: origin (3),
// direction (3), throughput (3), radiance (3) and alive (0, 1, or 2 when
// NEE sampled the light at the previous, diffuse vertex, so the next
// vertex adds no emission: the mark crosses segment boundaries here).
// Radiance rides the state across segments: it is never reset here.  A
// thread keeps its slot's state in registers across the segment's bounces
// and writes it once.  The queue's live prefix length `count` is read from device
// memory (scalars = [seed, depth0, count], int32), so the engine needs no
// host sync between segments; a thread at or past `count`, or whose slot
// is not alive, runs no bounce: it copies its slot through with alive 0
// (the TPU kernel's in_q mask, pallas_trace.py:3416).  Streams are keyed
// on (pixel id, absolute depth = depth0 + i), so the queue's order cannot
// change the image.

#include "bounce.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPlanes = 13;

struct SegmentArgs {
  const int* __restrict__ pix;      // (R,) pixel ids keying the streams
  const float* __restrict__ in;     // (13, R) state
  float* __restrict__ out;          // (13, R) state after the segment
  const int* __restrict__ scalars;  // (3,) [seed, depth0, count]
  int n_rays;
  int n_bounces;
};

template <bool kTri, bool kNee, bool kRR, bool kInst, bool kExt>
__global__ void __launch_bounds__(kThreads)
    segment_kernel(const PrtScene S, const SegmentArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = A.n_rays;
  if (i >= R) return;
  const float* __restrict__ in = A.in + i;
  float* __restrict__ out = A.out + i;
  const int count = __ldg(A.scalars + 2);
  const float alive_in = in[12 * R];
  if (i >= count || !(alive_in > 0.0f)) {
    for (int k = 0; k < kPlanes - 1; ++k) out[k * R] = in[k * R];
    out[12 * R] = 0.0f;
    return;
  }
  PathState s{in[0], in[R], in[2 * R], in[3 * R], in[4 * R], in[5 * R],
              in[6 * R], in[7 * R], in[8 * R], in[9 * R], in[10 * R],
              in[11 * R]};
  const uint32_t seed = (uint32_t)__ldg(A.scalars);
  const int depth0 = __ldg(A.scalars + 1);
  const uint32_t rng_base = pcg_hash((uint32_t)A.pix[i] ^ seed);
  int alive = alive_in > 1.5f ? 2 : 1;
  for (int b = 0; b < A.n_bounces && alive; ++b) {
    const int depth = depth0 + b;
    alive = bounce<kTri, kNee, kRR, kInst, kExt>(
        S, rng_base + (uint32_t)depth * kDepthStep, depth, alive, s);
  }
  out[0] = s.ox;
  out[R] = s.oy;
  out[2 * R] = s.oz;
  out[3 * R] = s.dx;
  out[4 * R] = s.dy;
  out[5 * R] = s.dz;
  out[6 * R] = s.tr;
  out[7 * R] = s.tg;
  out[8 * R] = s.tb;
  out[9 * R] = s.rr;
  out[10 * R] = s.rg;
  out[11 * R] = s.rb;
  out[12 * R] = (float)alive;
}

using SegmentKernel = void (*)(const PrtScene, const SegmentArgs);
// Indexed by kernel_variant().
const SegmentKernel kSegmentKernels[32] = PRT_VARIANTS(segment_kernel);

}  // namespace

// sizeof(PrtScene) as this library was built; ops/_build.py compares it
// with its ctypes mirror at load.
extern "C" int prt_scene_size() { return (int)sizeof(PrtScene); }

// Launch on `stream` (PyTorch's current stream) without synchronising.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int prt_segment_launch(int device, void* stream,
                                  const PrtScene* scene, const int* pix,
                                  const float* in, float* out,
                                  const int* scalars, int n_rays,
                                  int n_bounces) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rays <= 0) return 0;
  SegmentArgs A{pix, in, out, scalars, n_rays, n_bounces};
  int blocks = (n_rays + kThreads - 1) / kThreads;
  kSegmentKernels[kernel_variant(*scene)]<<<blocks, kThreads, 0,
                                              (cudaStream_t)stream>>>(*scene,
                                                                      A);
  return (int)cudaGetLastError();
}
