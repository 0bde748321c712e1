// Fused path-trace kernel for Hopper (sm_90a): every bounce of a ray in one
// launch, one thread per ray.
//
// Replaces parallelraytracing_tpu/ops/pallas_trace.py::pallas_trace (the
// kernel body _make_trace_kernel.kernel driving _make_bounce_step); the
// bounce itself (closest-hit fold over spheres, quads, triangles and
// instanced meshes, a big mesh's stream route, textures and the
// directional sky, shading, NEE and Russian roulette) is bounce.cuh,
// shared with the segment kernel.  depth_out and collect_stats run in the
// probe kernel of their own library (csrc/probe.cu), which leaves this
// kernel's instantiations as they are.
//
// What bounds it on the H100: not FLOPs and not HBM bandwidth.  A ray
// reads the 7 values of its input once and writes 3; everything else is
// the walk: divergent per-ray tree walks (threads of a warp sit in
// different nodes and leaves after the first bounce) and dependent loads
// of table columns (6-33 floats per primitive, 8 per node, 24 per entered
// instance, 4 texels per textured hit) that the L1/L2 caches serve; a
// big mesh's triangle slots (108 bytes each, 132 textured) outgrow the
// 50 MB L2, and its walks read device memory.  The ray state lives in
// registers for the whole bounce loop (no memory round trip between
// bounces, the TPU kernel's key property), and a thread exits as soon as
// its ray dies.  The TPU's
// bounce-0 frustum pretest (FRUSTUM0) only gates its lockstep tile test
// and leaves results bit-identical; it has no per-ray analogue and is not
// ported.  Not done yet (later work): staging tables in shared memory, an
// AoS re-layout of the tables, sorting rays to cut divergence.

#include "bounce.cuh"

namespace {

constexpr int kThreads = 128;
// Blocks per SM the plain sphere instantiation (no triangles, instances,
// NEE, roulette or scene extensions) is built for: 9 x 128 threads caps it
// at 56 registers, the count it had before NEE and roulette joined the
// bounce.
constexpr int kSphereMinBlocks = 9;

struct TraceArgs {
  const float* __restrict__ o;  // (R, 3)
  const float* __restrict__ d;  // (R, 3)
  const int* __restrict__ pix;  // (R,) pixel ids keying the streams
  float* __restrict__ out;      // (R, 3) radiance
  int n_rays;
  uint32_t seed;
  int max_depth;
};

template <int kTri, bool kNee, bool kRR, bool kInst, bool kExt>
__global__ void __launch_bounds__(kThreads,
                                  kTri || kNee || kRR || kInst || kExt
                                      ? 1 : kSphereMinBlocks)
    trace_kernel(const PrtScene S, const TraceArgs A) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.n_rays) return;
  PathState s{A.o[3 * i], A.o[3 * i + 1], A.o[3 * i + 2],
              A.d[3 * i], A.d[3 * i + 1], A.d[3 * i + 2],
              1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
  // Pixel-keyed streams: the image does not depend on ray order.
  const uint32_t rng_base = pcg_hash((uint32_t)A.pix[i] ^ A.seed);
  // The alive value carries NEE's no-emit mark (2) from bounce to bounce.
  int alive = 1;
  for (int depth = 0; depth < A.max_depth && alive; ++depth) {
    alive = bounce<kTri, kNee, kRR, kInst, kExt>(
        S, rng_base + (uint32_t)depth * kDepthStep, depth, alive, s);
  }
  A.out[3 * i] = s.rr;
  A.out[3 * i + 1] = s.rg;
  A.out[3 * i + 2] = s.rb;
}

using TraceKernel = void (*)(const PrtScene, const TraceArgs);
// Indexed by kernel_variant().
const TraceKernel kTraceKernels[kVariants] = PRT_VARIANTS(trace_kernel);

}  // namespace

// sizeof(PrtScene) as this library was built; ops/_build.py compares it
// with its ctypes mirror at load.
extern "C" int prt_scene_size() { return (int)sizeof(PrtScene); }

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
  kTraceKernels[kernel_variant(*scene)]<<<blocks, kThreads, 0,
                                          (cudaStream_t)stream>>>(*scene, A);
  return (int)cudaGetLastError();
}
