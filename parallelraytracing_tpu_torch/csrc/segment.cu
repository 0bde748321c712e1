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
// - The sort key in the kernel: the boundary moves only the survivors,
//   by a bucket of their keys (resort_count_kernel and
//   resort_scatter_kernel below); with no sort, nothing.  The launch
//   function still fills the key buffer with 0x7f bytes first, so the
//   slots past the survivors key last under any sort.
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

// ---------------------------------------------------------------------------
// The queue re-sort between segments (engines/wavefront_fused.py,
// ops/segment.resort): the survivors a segment pushed, slots [0, count) of
// its output queue, are moved to the other queue in ascending order of
// their key's bucket, `key >> shift` (the wrapper's shift: the top 12
// bits of the 30-bit sort key, the direction octant and 3 Morton bits an
// axis under "octant", 4 bits an axis under "origin"), each bucket's
// slots contiguous.  Order inside a
// bucket is the atomics' (the segment kernel's push order is already
// unspecified); no permutation of the queue changes the image.
//
// The JAX engine sorts the whole queue (a TPU has no global atomics), as
// this port did with one torch.argsort of every slot's key and two
// gathers of every slot: a radix sort of R keys and R x 14 words moved
// to place the survivors, 8% and 0.5% of R at a 1080p mesh frame's two
// boundaries.  Two launches here read only [0, count), with `count` read
// on the device (no host sync):
//
// - resort_count_kernel: a shared-memory histogram a block over its
//   survivors (one atomicAdd a group of lanes of one bucket,
//   __match_any_sync), each nonzero bucket flushed to a global histogram
//   that the launch function zeroes;
// - resort_scatter_kernel: each block scans the histogram into bucket
//   bases in shared memory, then takes tiles of kResortThreads survivors:
//   it sorts a tile by bucket in shared memory (the tile's histogram, its
//   scan, each lane's rank in its bucket), claims each bucket's run of
//   slots with one atomicAdd a tile, and copies the tile in sorted order,
//   so consecutive lanes write consecutive slots of a run.  Block 0 adds
//   `count` to a device tally of slots moved, when one is given.
//
// What bounds it: the survivors' bytes, 56 read and 56 written each
// (~20 MB a 1080p mesh frame), written in short runs.  Measured on the
// H100 at a 1080p mesh frame's first boundary (164,299 survivors, one
// call, memset included): each survivor's 13 planes stored straight to
// its slot (a warp's lanes fall in ~17 buckets, so nearly every store is
// a sector of its own) 46 us, the same stores at the survivor's own slot
// 13.5 us; sorted tiles 28.5 us; the histogram alone 6.6 us.

namespace {

// The buckets: a key's bucket is key >> shift, the shift the wrapper's
// (ops/segment.BUCKET_SHIFT), so 2^(kKeyBits - shift) buckets, at most
// kBuckets.  Wider buckets sort finer at the cost of larger histograms
// (4 bytes a bucket of shared memory, twice in the scatter, each
// scanned by every block).
constexpr int kKeyBits = 30;
constexpr int kMaxBucketBits = 12;
constexpr int kBuckets = 1 << kMaxBucketBits;
// Threads a block, and survivors a tile of the scatter.
constexpr int kResortThreads = 512;
constexpr int kResortWarps = kResortThreads / 32;
constexpr int kPerThread = kBuckets / kResortThreads;
// Blocks a launch: one a SM, at most one a kResortThreads slots of the
// queue; the blocks stride over the survivors (more a SM measured slower).
constexpr int kResortBlocksPerSm = 1;
static_assert(kBuckets % kResortThreads == 0, "whole buckets a thread");
static_assert(kBuckets <= 65536, "a bucket fits 16 bits");

struct ResortArgs {
  const float* __restrict__ in;   // (13, R) pushed queue: state
  const int* __restrict__ pix;    // (R,) pushed queue: pixel ids
  const int* __restrict__ key;    // (R,) pushed queue: sort keys
  const int* __restrict__ count;  // (1,) survivors [0, count)
  float* __restrict__ out;        // (13, R) re-sorted queue: state
  int* __restrict__ pix_out;      // (R,) re-sorted queue: pixel ids
  int* hist;  // (buckets,) survivors a bucket; 0 at launch
  int* fill;  // (buckets,) slots claimed in each bucket; 0 at launch
  unsigned long long* tally;      // (1,) slots moved, summed; or null
  int n_rays;                     // R: the planes' stride
  int shift;                      // a key's bucket: key >> shift
  int buckets;                    // 2^(kKeyBits - shift)
};

__device__ __forceinline__ int bucket_of(const ResortArgs& A, int i) {
  return (int)((unsigned)__ldg(A.key + i) >> A.shift);
}

// The lanes of the warp that hold bucket b (-1: no survivor), their
// leader and this lane's rank among them.
struct Peers {
  unsigned lanes;
  int leader;
  int rank;
};

__device__ __forceinline__ Peers peers_of(int b) {
  const unsigned lanes = __match_any_sync(kFullMask, b);
  const int lane = threadIdx.x & 31;
  return Peers{lanes, __ffs(lanes) - 1,
               __popc(lanes & ((1u << lane) - 1u))};
}

// The block's exclusive prefix sum of each thread's `sum`, in thread
// order (a shuffle scan in each warp, then one over the warps' sums).
// Every thread of the block calls it; `warp_sum` is kResortWarps ints of
// shared memory.
__device__ __forceinline__ int block_exclusive(int sum, int* warp_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kResortWarps ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kResortWarps) warp_sum[lane] = w;
  }
  __syncthreads();
  return incl - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
}

__global__ void __launch_bounds__(kResortThreads)
    resort_count_kernel(const ResortArgs A) {
  __shared__ int h[kBuckets];
  for (int b = threadIdx.x; b < kBuckets; b += kResortThreads) h[b] = 0;
  __syncthreads();
  const int count = min(__ldg(A.count), A.n_rays);
  const int stride = gridDim.x * kResortThreads;
  // The loop's bound is uniform in the block, so every lane of a warp
  // runs each _sync together.
  for (int i0 = blockIdx.x * kResortThreads; i0 < count; i0 += stride) {
    const int i = i0 + threadIdx.x;
    const int b = i < count ? bucket_of(A, i) : -1;
    const Peers p = peers_of(b);
    if (b >= 0 && p.rank == 0) atomicAdd(&h[b], __popc(p.lanes));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < A.buckets; b += kResortThreads) {
    if (h[b] != 0) atomicAdd(&A.hist[b], h[b]);
  }
}

__global__ void __launch_bounds__(kResortThreads)
    resort_scatter_kernel(const ResortArgs A) {
  // Each bucket's first slot in the queue.
  __shared__ int base[kBuckets];
  // The tile's survivors a bucket, then the bucket's first position in
  // the sorted tile, then its slots less that position.
  __shared__ int run[kBuckets];
  // The input slot and the bucket at each position of the sorted tile.
  __shared__ int src[kResortThreads];
  __shared__ unsigned short bkt[kResortThreads];
  __shared__ int warp_sum[kResortWarps];
  const int t = threadIdx.x;
  int v[kPerThread];  // this thread's kPerThread consecutive buckets
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = t * kPerThread + j;
    v[j] = c < A.buckets ? A.hist[c] : 0;
    sum += v[j];
  }
  int at = block_exclusive(sum, warp_sum);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    base[t * kPerThread + j] = at;
    at += v[j];
  }

  const int R = A.n_rays;
  const int count = min(__ldg(A.count), R);
  if (A.tally != nullptr && blockIdx.x == 0 && t == 0) {
    atomicAdd(A.tally, (unsigned long long)count);
  }
  // Tiles are uniform in the block, so every lane of a warp runs each
  // _sync together.
  const int stride = gridDim.x * kResortThreads;
  for (int i0 = blockIdx.x * kResortThreads; i0 < count; i0 += stride) {
    for (int b = t; b < kBuckets; b += kResortThreads) run[b] = 0;
    __syncthreads();
    const int i = i0 + t;
    const int b = i < count ? bucket_of(A, i) : -1;
    const Peers p = peers_of(b);
    int r0 = 0;
    if (b >= 0 && p.rank == 0) r0 = atomicAdd(&run[b], __popc(p.lanes));
    const int rank = __shfl_sync(kFullMask, r0, p.leader) + p.rank;
    __syncthreads();
    int first[kPerThread];
    int claim[kPerThread];
    sum = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      v[j] = run[t * kPerThread + j];
      sum += v[j];
    }
    at = block_exclusive(sum, warp_sum);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int c = t * kPerThread + j;
      first[j] = at;
      run[c] = at;
      claim[j] = v[j] != 0 ? atomicAdd(&A.fill[c], v[j]) : 0;
      at += v[j];
    }
    __syncthreads();
    if (b >= 0) {
      const int pos = run[b] + rank;
      src[pos] = i;
      bkt[pos] = (unsigned short)b;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int c = t * kPerThread + j;
      if (v[j] != 0) run[c] = base[c] + claim[j] - first[j];
    }
    __syncthreads();
    if (t < min(kResortThreads, count - i0)) {
      const int k = src[t];
      const int slot = t + run[bkt[t]];
      float s[13];  // every load before any store
#pragma unroll
      for (int q = 0; q < 13; ++q) s[q] = __ldg(A.in + q * R + k);
      const int px = __ldg(A.pix + k);
#pragma unroll
      for (int q = 0; q < 13; ++q) A.out[q * R + slot] = s[q];
      A.pix_out[slot] = px;
    }
    __syncthreads();  // the next tile reuses the shared arrays
  }
}

int g_sms[kMaxDevices];

}  // namespace

// Launch the re-sort on `stream` without synchronising: the workspace
// `work` (2 * 2^(kKeyBits - shift) ints: the histogram, then the slots
// claimed in each bucket) zeroed by cudaMemsetAsync, then
// resort_count_kernel and resort_scatter_kernel on the same grid.  `in`,
// `pix`, `key` are the pushed queue, `out`, `pix_out` the queue the next
// segment reads; slots past `count` of either are neither read nor
// written.  `tally` (one 64-bit int) gets `count` added, or is null.  A
// key's bucket is key >> shift.  Returns the first error: 0 when
// everything was accepted.
extern "C" int prt_resort_launch(int device, void* stream, const float* in,
                                 const int* pix, const int* key,
                                 const int* count, float* out, int* pix_out,
                                 int* work, unsigned long long* tally,
                                 int n_rays, int shift) {
  if (shift < kKeyBits - kMaxBucketBits || shift > kKeyBits) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int buckets = 1 << (kKeyBits - shift);
  err = cudaMemsetAsync(work, 0, 2 * buckets * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_rays <= 0) return 0;
  int& sms = g_sms[device % kMaxDevices];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const int needed = (n_rays + kResortThreads - 1) / kResortThreads;
  const int blocks =
      needed < kResortBlocksPerSm * sms ? needed : kResortBlocksPerSm * sms;
  const ResortArgs A{in,   pix,  key,              count, out,   pix_out,
                     work, work + buckets, tally, n_rays, shift, buckets};
  resort_count_kernel<<<blocks, kResortThreads, 0, st>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resort_scatter_kernel<<<blocks, kResortThreads, 0, st>>>(A);
  return (int)cudaGetLastError();
}
