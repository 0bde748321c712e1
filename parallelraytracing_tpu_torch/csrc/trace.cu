// Fused path-trace kernel for Hopper (sm_90a): every bounce of a ray in one
// launch, one thread per ray.
//
// Replaces parallelraytracing_tpu/ops/pallas_trace.py::pallas_trace (the
// kernel body _make_trace_kernel.kernel driving _make_bounce_step) on its
// constant-sky, NEE-off, untextured subset; the bounce itself (closest-hit
// fold over spheres, quads and triangles, then shading) is bounce.cuh,
// shared with the segment kernel.  NEE, Russian roulette, textures,
// instances, the directional sky, the stream path and the straggler-tail
// view are refused by the Python wrapper (ops/trace.py) before a launch.
//
// What bounds it on the H100: not FLOPs and not HBM bandwidth.  A ray
// reads the 7 values of its input once and writes 3; everything else is
// the walk: divergent per-ray tree walks (threads of a warp sit in
// different nodes and leaves after the first bounce) and dependent loads
// of table columns (6-27 floats per primitive, 8 per node) that the
// L1/L2 caches serve.  The ray state lives in registers for the whole
// bounce loop (no memory round trip between bounces, the TPU kernel's key
// property), and a thread exits as soon as its ray dies.  The TPU's
// bounce-0 frustum pretest (FRUSTUM0) only gates its lockstep tile test
// and leaves results bit-identical; it has no per-ray analogue and is not
// ported.  Not done yet (later work): staging tables in shared memory, an
// AoS re-layout of the tables, sorting rays to cut divergence.

#include "bounce.cuh"

namespace {

constexpr int kThreads = 128;

struct TraceArgs {
  const float* __restrict__ o;  // (R, 3)
  const float* __restrict__ d;  // (R, 3)
  const int* __restrict__ pix;  // (R,) pixel ids keying the streams
  float* __restrict__ out;      // (R, 3) radiance
  int n_rays;
  uint32_t seed;
  int max_depth;
};

template <bool kTri>
__global__ void __launch_bounds__(kThreads)
    trace_kernel(const PrtScene S, const TraceArgs A) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.n_rays) return;
  PathState s{A.o[3 * i], A.o[3 * i + 1], A.o[3 * i + 2],
              A.d[3 * i], A.d[3 * i + 1], A.d[3 * i + 2],
              1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
  // Pixel-keyed streams: the image does not depend on ray order.
  const uint32_t rng_base = pcg_hash((uint32_t)A.pix[i] ^ A.seed);
  for (int depth = 0; depth < A.max_depth; ++depth) {
    if (!bounce<kTri>(S, rng_base + (uint32_t)depth * kDepthStep, s)) break;
  }
  A.out[3 * i] = s.rr;
  A.out[3 * i + 1] = s.rg;
  A.out[3 * i + 2] = s.rb;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) without synchronising.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int prt_trace_launch(int device, void* stream,
                                const PrtScene* scene, const float* o,
                                const float* d, const int* pix, float* out,
                                int n_rays, unsigned int seed, int max_depth) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rays <= 0) return 0;
  TraceArgs A{o, d, pix, out, n_rays, seed, max_depth};
  int blocks = (n_rays + kThreads - 1) / kThreads;
  if (scene->n_tri > 0) {
    trace_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*scene,
                                                                      A);
  } else {
    trace_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*scene,
                                                                       A);
  }
  return (int)cudaGetLastError();
}
