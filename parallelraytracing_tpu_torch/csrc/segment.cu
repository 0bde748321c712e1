// Segment kernel for Hopper (sm_90a): up to n_bounces bounces of every
// path of a ray queue, a persistent grid that regenerates paths and
// pushes its survivors to the next queue.
//
// Replaces parallelraytracing_tpu/ops/pallas_trace.py::pallas_segment (the
// kernel body _make_segment_kernel.kernel) on the same subset as the trace
// kernel, instances, a big mesh's stream route, textures and the
// directional sky included: the bounce is bounce.cuh, shared with
// trace.cu, so a path traced in segments gets the same bits as one traced
// in a single launch.  The TPU kernel runs every slot of the queue in
// lockstep tiles and leaves compaction to a jnp.argsort between segments
// (a TPU has no global atomics); this kernel compacts the queue itself,
// as a CUDA wavefront path tracer's ray queue does.
//
// The state is 13 planes of R floats, (13, R) row-major: origin (3),
// direction (3), throughput (3), radiance (3) and alive (1, or 2 when NEE
// sampled the light at the previous, diffuse vertex, so the next vertex
// adds no emission: the mark crosses segment boundaries).  The input
// queue's live prefix [0, count) is read; `count` is a device int32 (the
// previous segment's survivor count), so a frame needs no host sync.  A
// lane takes the next input slot from a device counter, keeps its path's
// state in registers (PathState, the pixel-keyed rng_base, its own depth
// and alive value) and runs one bounce per loop iteration, at absolute
// depth depth0 + i, so the queue's order cannot change the image.  (A
// lane's first slot is its thread index; the counter hands out the rest.)  A path
// that ends (alive 0, or its depth reaches max_depth) writes its radiance
// to rad[pix], in pixel order, and is gone; a path alive after n_bounces
// is pushed to the output queue with its 13 planes, its pixel id and its
// coherence sort key (the origin's 30-bit Morton code in the scene box,
// under the direction octant for "octant").  Either way the lane takes
// the next input slot.
//
// What bounds it on the H100: as for trace.cu, the walks' divergent,
// dependent table loads, not FLOPs or bytes: a live slot reads 56 bytes
// and writes 60 (a survivor) or 12 (an ended path).  Around the kernel,
// the earlier one-thread-per-slot form moved every slot of the queue
// (dead ones copied through, 224 MB a 1080p segment), idled the lanes of
// paths that had ended inside the segment, and left ~85 small torch
// launches a segment boundary (the sort key's arithmetic, the
// compaction).  What the design does about it:
//
// - In-kernel compaction: survivors are pushed with one atomicAdd a warp
//   (persistent.cuh push_slot: ballot, the leader's atomicAdd of the
//   popcount, a shuffle of the base), so a warp's survivors land on
//   consecutive slots and each plane's stores coalesce; dead slots are
//   never copied, nothing past `count` is read.
// - The sort key in the kernel: the boundary is one torch.argsort of the
//   keys (the launch function fills the key buffer with 0x7f bytes first,
//   so the slots past the survivors sort last) and two gathers; with no
//   sort, nothing.
// - Radiance at the path's end: it no longer rides the queue to the end
//   of the frame, and the frame's scatter goes.
// - A persistent grid with path regeneration (persistent.cuh, as
//   trace.cu): a lane whose path ends or completes its bounces takes the
//   next slot, so no lane idles on a dead path while slots are left.  A
//   queue shorter than the grid (every later segment of a 1080p frame)
//   is one slot a lane with no atomic; there the segment is bound by its
//   longest paths' chains of dependent walks (PERF.md).

#include "bounce.cuh"
#include "persistent.cuh"

namespace {


struct SegmentArgs {
  const int* __restrict__ pix;    // (R,) input queue: pixel ids
  const float* __restrict__ in;   // (13, R) input queue: state
  const int* __restrict__ count;  // (1,) live input slots [0, count)
  int* __restrict__ pix_out;      // (R,) output queue: pixel ids
  float* __restrict__ out;        // (13, R) output queue: state
  int* __restrict__ key_out;      // (R,) survivors' sort keys, or null
  float* __restrict__ rad;        // (P, 3) radiance, in pixel order
  int* __restrict__ next;         // the next input slot; 0 at launch
  int* __restrict__ count_out;    // survivors pushed; 0 at launch
  int n_rays;                     // R: the planes' stride
  uint32_t seed;
  int depth0;
  int n_bounces;
  int max_depth;
  int key_mode;  // 0: no key, 1: "origin", 2: "octant"
  float lo_x, lo_y, lo_z;  // the scene box's low corner
  float ie_x, ie_y, ie_z;  // 1 / the scene box's extent
};

// Spread the low 10 bits of v over 30 (x -> x00 interleave).
__device__ __forceinline__ int part1by2(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// An origin coordinate quantised to 10 bits in the scene box: the plain
// version's torch.clamp((o - lo) * ie * 1024, 0, 1023).to(int32), each
// step rounded on its own (-fmad=false).
__device__ __forceinline__ int quantise(float o, float lo, float ie) {
  return (int)fminf(fmaxf((o - lo) * ie * 1024.0f, 0.0f), 1023.0f);
}

// The coherence sort key of a survivor (ops/segment.sort_key): the
// origin's 30-bit Morton code, or the direction octant over its top 27
// bits.  Every key is below 2^30.
__device__ __forceinline__ int sort_key(const SegmentArgs& A,
                                        const PathState& s) {
  const int m = (part1by2(quantise(s.ox, A.lo_x, A.ie_x)) << 2) |
                (part1by2(quantise(s.oy, A.lo_y, A.ie_y)) << 1) |
                part1by2(quantise(s.oz, A.lo_z, A.ie_z));
  if (A.key_mode == 1) return m;
  const int oct = ((s.dx < 0.0f) << 2) | ((s.dy < 0.0f) << 1) | (s.dz < 0.0f);
  return (oct << 27) | (m >> 3);
}

template <int kTri, bool kNee, bool kRR, bool kInst, bool kExt>
__global__ void __launch_bounds__(kThreads)
    segment_kernel(const PrtScene S, const SegmentArgs A) {
  const int R = A.n_rays;
  const int count = min(__ldg(A.count), R);
  int i = -1;  // this lane's input slot, -1 while it holds no path
  PathState s;
  uint32_t rng_base = 0;
  int pix = 0;
  int depth = 0;
  int end = 0;  // the depth at which this segment stops the path
  int alive = 0;
  const auto load = [&](int k) {
    i = k;
    const float* __restrict__ in = A.in + k;
    s = PathState{in[0],      in[R],      in[2 * R],  in[3 * R],
                  in[4 * R],  in[5 * R],  in[6 * R],  in[7 * R],
                  in[8 * R],  in[9 * R],  in[10 * R], in[11 * R]};
    const float a = in[12 * R];
    // The alive value carries NEE's no-emit mark (2) from bounce to bounce
    // and across segments; a slot not alive ends at once.
    alive = a > 1.5f ? 2 : a > 0.0f ? 1 : 0;
    pix = A.pix[k];
    // Pixel-keyed streams: the image does not depend on queue order.
    rng_base = pcg_hash((uint32_t)pix ^ A.seed);
    depth = A.depth0;
    end = min(A.depth0 + A.n_bounces, A.max_depth);
  };
  // Each lane's first slot is its thread index, so a queue no longer than
  // the grid (the later segments of a frame) takes no atomic at all; the
  // counter hands out the slots past the grid's threads.
  const int threads = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (first < count) load(first);
  bool left = threads < count;  // the counter may still hold slots
  // Every lane stays in the loop until its warp holds no path and no slot
  // is left, so each _sync below runs with the whole warp.
  for (;;) {
    refill(A.next, count - threads, i < 0, left,
           [&](int k) { load(threads + k); });
    if (__all_sync(kFullMask, i < 0)) break;
    bool push = false;
    if (i >= 0) {
      if (alive && depth < end) {
        alive = bounce<kTri, kNee, kRR, kInst, kExt>(
            S, rng_base + (uint32_t)depth * kDepthStep, depth, alive, s);
        ++depth;
      }
      if (!alive || depth >= A.max_depth) {  // the path ends here
        A.rad[3 * pix] = s.rr;
        A.rad[3 * pix + 1] = s.rg;
        A.rad[3 * pix + 2] = s.rb;
        i = -1;
      } else if (depth >= end) {  // it goes on in the next segment
        push = true;
      }
    }
    const int slot = push_slot(A.count_out, push);
    if (push) {
      float* __restrict__ out = A.out + slot;
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
      A.pix_out[slot] = pix;
      if (A.key_mode != 0) A.key_out[slot] = sort_key(A, s);
      i = -1;
    }
  }
}

using SegmentKernel = void (*)(const PrtScene, const SegmentArgs);
// Indexed by kernel_variant().
const SegmentKernel kSegmentKernels[kVariants] =
    PRT_VARIANTS(segment_kernel);

// The persistent grid of each instantiation on each device (0: not asked
// yet).
int g_grid[kMaxDevices][kVariants];

}  // namespace

// sizeof(PrtScene) as this library was built; ops/_build.py compares it
// with its ctypes mirror at load.
extern "C" int prt_scene_size() { return (int)sizeof(PrtScene); }

// What a launch of instantiation `variant` on `device` runs with, into
// info[0..7] (persistent.cuh launch_info, the fields of prt_trace_info).
// Returns the cudaError_t of the queries.
extern "C" int prt_segment_info(int device, int variant, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (variant < 0 || variant >= kVariants) return (int)cudaErrorInvalidValue;
  return (int)launch_info(kSegmentKernels[variant], device,
                          g_grid[device % kMaxDevices][variant], info);
}

// Launch on `stream` (PyTorch's current stream) without synchronising:
// first the two counters (counters[0] the next input slot, counters[1]
// the survivor count, which the next segment reads as its `count`) are
// set to 0 and, when a key is written, every key to 0x7f7f7f7f (past any
// live key, so the slots past the survivors sort last), both by
// cudaMemsetAsync on the stream; then the kernel, on the instantiation's
// persistent grid or one block per kThreads slots when that is fewer.
// `bb` is the scene box's low corner and inverse extent (6 floats).
// Returns the first error: 0 when everything was accepted.
extern "C" int prt_segment_launch(int device, void* stream,
                                  const PrtScene* scene, const int* pix,
                                  const float* in, const int* count,
                                  int* pix_out, float* out, int* key_out,
                                  float* rad, int* counters, int n_rays,
                                  unsigned int seed, int depth0,
                                  int n_bounces, int max_depth, int key_mode,
                                  const float* bb) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_rays <= 0) return 0;
  if (key_mode != 0) {
    err = cudaMemsetAsync(key_out, 0x7f, (size_t)n_rays * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  const int v = kernel_variant(*scene);
  int blocks = persistent_grid(kSegmentKernels[v], device,
                               g_grid[device % kMaxDevices][v], &err);
  if (err != cudaSuccess) return (int)err;
  const int needed = (n_rays + kThreads - 1) / kThreads;
  if (needed < blocks) blocks = needed;
  SegmentArgs A{pix,       in,       count,      pix_out, out,
                key_out,   rad,      counters,   counters + 1,
                n_rays,    seed,     depth0,     n_bounces,
                max_depth, key_mode, bb[0],      bb[1],   bb[2],
                bb[3],     bb[4],    bb[5]};
  kSegmentKernels[v]<<<blocks, kThreads, 0, st>>>(*scene, A);
  return (int)cudaGetLastError();
}
