// The trace kernel's two probes for Hopper (sm_90a): every bounce of a ray
// in one launch, as trace.cu runs it, and beside the radiance each ray's
// depth (the bounces it entered alive, as float32) and its walk counters
// [nodes, leaves, primitives, alive bounces] as an int32 row.
//
// Replaces the depth_out and collect_stats outputs of
// parallelraytracing_tpu/ops/pallas_trace.py::pallas_trace (the dd plane,
// l.3146-3171, and the stats_ref increments of every walk, l.2006-2141 and
// l.2351-2355, written out at l.3191-3202).  The TPU counts one lockstep
// walk per (rows, 128) tile; one thread walks one ray here, so the
// counters are per ray (csrc/bounce.cuh WalkCount has the rules).  The
// bounce is bounce.cuh's with the counting carry (Counted), so the
// radiance is the trace kernel's bit for bit.
//
// A library of its own: the probes run once per camera move (the fused
// engine's depth_sort) or in the diagnostics (benchmarks/trace_stats.py,
// benchmarks/roofline.py), and a probe pointer or branch inside trace.cu
// would put the headline instantiations' register caps at risk.  What
// bounds it on the H100 is what bounds trace.cu (divergent per-ray walks
// and dependent table loads); the counters add three integer adds per
// visited node and 20 bytes of output per ray.

#include "bounce.cuh"

namespace {

constexpr int kThreads = 128;

struct ProbeArgs {
  const float* __restrict__ o;  // (R, 3)
  const float* __restrict__ d;  // (R, 3)
  const int* __restrict__ pix;  // (R,) pixel ids keying the streams
  float* __restrict__ out;      // (R, 3) radiance
  float* __restrict__ depth;    // (R,) bounces entered alive
  int* __restrict__ stats;      // (R, 4) nodes, leaves, primitives, bounces
  int n_rays;
  uint32_t seed;
  int max_depth;
};

template <int kTri, bool kNee, bool kRR, bool kInst, bool kExt>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const PrtScene S, const ProbeArgs A) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.n_rays) return;
  PathState s{A.o[3 * i], A.o[3 * i + 1], A.o[3 * i + 2],
              A.d[3 * i], A.d[3 * i + 1], A.d[3 * i + 2],
              1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
  const uint32_t rng_base = pcg_hash((uint32_t)A.pix[i] ^ A.seed);
  WalkCount cnt{0, 0, 0};
  int alive = 1;
  int depth = 0;
  for (; depth < A.max_depth && alive; ++depth) {
    alive = bounce<kTri, kNee, kRR, kInst, kExt, true>(
        S, rng_base + (uint32_t)depth * kDepthStep, depth, alive, s, &cnt);
  }
  A.out[3 * i] = s.rr;
  A.out[3 * i + 1] = s.rg;
  A.out[3 * i + 2] = s.rb;
  A.depth[i] = (float)depth;
  A.stats[4 * i] = cnt.nodes;
  A.stats[4 * i + 1] = cnt.leaves;
  A.stats[4 * i + 2] = cnt.prims;
  A.stats[4 * i + 3] = depth;
}

using ProbeKernel = void (*)(const PrtScene, const ProbeArgs);
// Indexed by kernel_variant().
const ProbeKernel kProbeKernels[kVariants] = PRT_VARIANTS(probe_kernel);

}  // namespace

// sizeof(PrtScene) as this library was built; ops/_build.py compares it
// with its ctypes mirror at load.
extern "C" int prt_scene_size() { return (int)sizeof(PrtScene); }

// Launch on `stream` (PyTorch's current stream) without synchronising.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int prt_probe_launch(int device, void* stream,
                                const PrtScene* scene, const float* o,
                                const float* d, const int* pix, float* out,
                                float* depth, int* stats, int n_rays,
                                unsigned int seed, int max_depth) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rays <= 0) return 0;
  ProbeArgs A{o, d, pix, out, depth, stats, n_rays, seed, max_depth};
  int blocks = (n_rays + kThreads - 1) / kThreads;
  kProbeKernels[kernel_variant(*scene)]<<<blocks, kThreads, 0,
                                          (cudaStream_t)stream>>>(*scene, A);
  return (int)cudaGetLastError();
}
