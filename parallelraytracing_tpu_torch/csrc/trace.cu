// Fused path-trace kernel for Hopper (sm_90a): every bounce of every ray
// in one launch, a persistent grid that regenerates paths.
//
// Replaces parallelraytracing_tpu/ops/pallas_trace.py::pallas_trace (the
// kernel body _make_trace_kernel.kernel driving _make_bounce_step); the
// bounce itself (closest-hit fold over spheres, quads, triangles and
// instanced meshes, a big mesh's stream route, textures and the
// directional sky, shading, NEE and Russian roulette) is bounce.cuh,
// shared with the segment kernel.  depth_out and collect_stats run in the
// probe kernel of their own library (csrc/probe.cu), which keeps one
// thread per ray and this kernel's old loop, so its radiance witnesses
// this kernel's bit for bit.
//
// What bounds it on the H100: not FLOPs and not HBM bandwidth.  A ray
// reads the 7 values of its input once and writes 3; everything else is
// the walk: divergent per-ray tree walks and dependent table loads that
// the L1/L2 caches serve (a big mesh's triangle records outgrow the 50 MB
// L2, and its walks read device memory).  What the design does about it:
//
// - Lanes idle on dead paths.  With one thread per ray a warp runs until
//   its longest path ends (a headline ray makes 2.69 bounces on average,
//   up to 20: 62% of the lane slots of the bounces idle).  Here the grid
//   is persistent (just enough blocks to fill the card, from the
//   occupancy of the instantiation) and each lane holds one path: one
//   iteration of the loop runs one bounce; a lane whose path ends writes
//   its radiance and takes the next ray index from a device counter
//   (path regeneration, Novak, Havran & Dachsbacher 2010; persistent
//   threads, Aila & Laine 2009).  The refill is warp-aggregated: one
//   atomicAdd a warp for all its idle lanes.  A path's arithmetic and
//   streams depend only on its ray index (pixel-keyed streams, depth =
//   the path's own bounce count), so the radiance of every ray is the
//   same bits whichever lane and iteration run it.
// - One 4-byte load per table value.  The tables are read as 16-byte
//   records (bounce.cuh; ops/pack.pack_records), built once per scene.
// - The ray state lives in registers for the whole path (no memory round
//   trip between bounces, the TPU kernel's key property).
//
// The TPU's bounce-0 frustum pretest (FRUSTUM0) only gates its lockstep
// tile test and leaves results bit-identical; it has no per-ray analogue
// and is not ported.  Staging the small scenes' records in shared memory
// was measured and not kept (PERF.md).

#include "bounce.cuh"
#include "persistent.cuh"

namespace {

struct TraceArgs {
  const float* __restrict__ o;  // (R, 3)
  const float* __restrict__ d;  // (R, 3)
  const int* __restrict__ pix;  // (R,) pixel ids keying the streams
  float* __restrict__ out;      // (R, 3) radiance
  int* __restrict__ next;       // the next ray index to hand out; 0 at launch
  int n_rays;
  uint32_t seed;
  int max_depth;
};

template <int kTri, bool kNee, bool kRR, bool kInst, bool kExt>
__global__ void __launch_bounds__(kThreads)
    trace_kernel(const PrtScene S, const TraceArgs A) {
  int i = -1;  // this lane's ray, -1 while it holds no path
  PathState s;
  uint32_t rng_base = 0;
  int depth = 0;
  int alive = 0;
  bool left = true;  // the counter may still hold rays (uniform in a warp)
  // Every lane stays in the loop until its warp holds no path and no ray
  // is left, so each _sync below runs with the whole warp.
  for (;;) {
    refill(A.next, A.n_rays, i < 0, left, [&](int k) {
      if (A.max_depth > 0) {
        i = k;
        s = PathState{A.o[3 * k], A.o[3 * k + 1], A.o[3 * k + 2],
                      A.d[3 * k], A.d[3 * k + 1], A.d[3 * k + 2],
                      1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
        // Pixel-keyed streams: the image does not depend on ray order.
        rng_base = pcg_hash((uint32_t)A.pix[k] ^ A.seed);
        depth = 0;
        // The alive value carries NEE's no-emit mark (2) from bounce to
        // bounce.
        alive = 1;
      } else {  // no bounce: the radiance is 0
        A.out[3 * k] = 0.0f;
        A.out[3 * k + 1] = 0.0f;
        A.out[3 * k + 2] = 0.0f;
      }
    });
    if (__all_sync(kFullMask, i < 0)) break;
    if (i >= 0) {
      alive = bounce<kTri, kNee, kRR, kInst, kExt>(
          S, rng_base + (uint32_t)depth * kDepthStep, depth, alive, s);
      ++depth;
      if (!alive || depth >= A.max_depth) {
        A.out[3 * i] = s.rr;
        A.out[3 * i + 1] = s.rg;
        A.out[3 * i + 2] = s.rb;
        i = -1;
      }
    }
  }
}

using TraceKernel = void (*)(const PrtScene, const TraceArgs);
// Indexed by kernel_variant().
const TraceKernel kTraceKernels[kVariants] = PRT_VARIANTS(trace_kernel);

// The persistent grid of each instantiation on each device: its resident
// blocks per SM times the SMs (0: not asked yet).
int g_grid[kMaxDevices][kVariants];

}  // namespace

// sizeof(PrtScene) as this library was built; ops/_build.py compares it
// with its ctypes mirror at load.
extern "C" int prt_scene_size() { return (int)sizeof(PrtScene); }

// What a launch of instantiation `variant` on `device` runs with, into
// info[0..7] (persistent.cuh launch_info): the persistent grid (blocks),
// threads a block, resident blocks per SM, registers a thread, local
// memory a thread, static and dynamic shared memory a block, the SMs.
// Returns the cudaError_t of the queries.
extern "C" int prt_trace_info(int device, int variant, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (variant < 0 || variant >= kVariants) return (int)cudaErrorInvalidValue;
  return (int)launch_info(kTraceKernels[variant], device,
                          g_grid[device % kMaxDevices][variant], info);
}

// The kernel_variant() index of a scene, as a launch picks it.
extern "C" int prt_trace_variant(const PrtScene* scene) {
  return kernel_variant(*scene);
}

// Launch on `stream` (PyTorch's current stream) without synchronising.
// `next` is one int32 on the device, 0 at the launch (the wrapper's
// torch.zeros).  The grid is the instantiation's persistent grid, or one
// block per kThreads rays when that is fewer.  Returns cudaGetLastError()
// after the launch: 0 when it was accepted.
extern "C" int prt_trace_launch(int device, void* stream,
                                const PrtScene* scene, const float* o,
                                const float* d, const int* pix, float* out,
                                int* next, int n_rays, unsigned int seed,
                                int max_depth) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rays <= 0) return 0;
  const int v = kernel_variant(*scene);
  int blocks = persistent_grid(kTraceKernels[v], device,
                               g_grid[device % kMaxDevices][v], &err);
  if (err != cudaSuccess) return (int)err;
  const int needed = (n_rays + kThreads - 1) / kThreads;
  if (needed < blocks) blocks = needed;
  TraceArgs A{o, d, pix, out, next, n_rays, seed, max_depth};
  kTraceKernels[v]<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*scene, A);
  return (int)cudaGetLastError();
}
