// The persistent launch shared by the trace kernel (trace.cu) and the
// segment kernel (segment.cu): just enough blocks to fill the card (each
// instantiation's occupancy times the SMs), whose lanes take work items
// from a device counter one warp-aggregated atomicAdd at a time (refill),
// and the same pattern for a queue that lanes push to (push_slot).
//
// Every lane of a warp calls these helpers together, with the whole warp
// converged: each starts with a __ballot_sync of the full mask.  A kernel
// keeps every lane in its loop until __all_sync finds the warp with no
// work left; nothing returns before a _sync intrinsic.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 16;

// Path regeneration's refill: the lanes that `want` a work item take the
// next indices in [0, n) from *next, one atomicAdd a warp (the leader
// adds the popcount, a shuffle hands out the base), and `load(k)` runs
// on each lane that got index k.  Clears `left` (uniform in the warp)
// once the counter has passed n, after which the warp asks no more.
template <class Load>
__device__ __forceinline__ void refill(int* next, int n, bool want,
                                       bool& left, Load&& load) {
  const unsigned idle = __ballot_sync(kFullMask, want);
  if (idle != 0u && left) {
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(idle) - 1;
    const int n_idle = __popc(idle);
    int base = 0;
    if (lane == leader) base = atomicAdd(next, n_idle);
    base = __shfl_sync(kFullMask, base, leader);
    left = base + n_idle < n;
    const int k = base + __popc(idle & ((1u << lane) - 1u));
    if (want && k < n) load(k);
  }
}

// A queue push: the lanes that `push` take consecutive slots of the
// queue whose length is *count, one atomicAdd a warp, so a warp's items
// land side by side and each plane's stores stay coalesced.  Returns the
// lane's slot, or -1 when it does not push.
__device__ __forceinline__ int push_slot(int* count, bool push) {
  const unsigned lanes = __ballot_sync(kFullMask, push);
  if (lanes == 0u) return -1;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(lanes) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(lanes));
  base = __shfl_sync(kFullMask, base, leader);
  return push ? base + __popc(lanes & ((1u << lane) - 1u)) : -1;
}

// The persistent grid of `kernel` on `device`: its resident blocks of
// kThreads per SM times the SMs, cached in `grid` (0: not asked yet); 0
// with the error in *err when the runtime refuses the query.
template <class Kernel>
int persistent_grid(Kernel kernel, int device, int& grid, cudaError_t* err) {
  if (grid == 0) {
    int per_sm = 0, sms = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, 0);
    if (*err == cudaSuccess) {
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
    }
    if (*err != cudaSuccess) return 0;
    grid = per_sm * sms;
  }
  return grid;
}

// What a launch of `kernel` on `device` runs with, into info[0..7]: its
// persistent grid (blocks, cached in `grid`), threads a block, resident
// blocks per SM, registers a thread, local memory a thread (bytes: the
// stack frame and spills), static and dynamic shared memory a block
// (bytes), and the SM count.  Returns the cudaError_t of the queries.
template <class Kernel>
cudaError_t launch_info(Kernel kernel, int device, int& grid, int* info) {
  cudaError_t err = cudaSuccess;
  const int blocks = persistent_grid(kernel, device, grid, &err);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  info[0] = blocks;
  info[1] = kThreads;
  info[2] = sms > 0 ? blocks / sms : 0;
  info[3] = fa.numRegs;
  info[4] = (int)fa.localSizeBytes;
  info[5] = (int)fa.sharedSizeBytes;
  info[6] = 0;
  info[7] = sms;
  return cudaSuccess;
}

}  // namespace
