// The float32 peak micro for Hopper (sm_90a): the roofline's ceiling for
// the trace kernels, measured on the card instead of read off a data
// sheet.
//
// Replaces benchmarks/micro.py::vpu_peak_vmem (its pallas_call at l.92):
// 8 independent chains per element for `loops` iterations, seeded from x,
// the chains' sum written out so the work cannot be dropped.  mix 0
// ("fma"): two multiply-adds per chain per iteration, written as fmaf (the
// kernels build with -fmad=false, so nvcc forms no other FMA); mix 1
// ("slab"): one multiply-add per chain, then the min / max / select round
// of the slab test.  The constants are the JAX kernel's (micro.py
// l.49-84), rounded to float32 as JAX rounds them.  One thread holds an
// element's 8 chains in registers; the launch fills every SM several
// times over, so the issue rate of the SMs' float32 pipes bounds it and
// memory does not (8 bytes a thread).  The TPU's (8, 128) VMEM tiles fall
// away: registers are where the chains live on Hopper.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int k>
__device__ __forceinline__ float init_scale() {
  return (float)(0.5 + 0.05 * k);
}

// One "fma" round of chain k: a * (1 + (k + 1)e-7) + (k + 1)e-7, then
// a * (1 - (k + 1)e-7) - (k + 1)e-7.
template <int k>
__device__ __forceinline__ float fma_round(float a) {
  a = fmaf(a, (float)(1.0 + (k + 1) * 1e-7), (float)((k + 1) * 1e-7));
  return fmaf(a, (float)(1.0 - (k + 1) * 1e-7), -(float)((k + 1) * 1e-7));
}

template <int kMix>
__global__ void __launch_bounds__(kThreads)
    fp32_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int n, int loops) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float a = xi * init_scale<0>(), b = xi * init_scale<1>();
  float c = xi * init_scale<2>(), d = xi * init_scale<3>();
  float e = xi * init_scale<4>(), f = xi * init_scale<5>();
  float g = xi * init_scale<6>(), h = xi * init_scale<7>();
#pragma unroll 8
  for (int it = 0; it < loops; ++it) {
    if (kMix == 0) {
      a = fma_round<0>(a);
      b = fma_round<1>(b);
      c = fma_round<2>(c);
      d = fma_round<3>(d);
      e = fma_round<4>(e);
      f = fma_round<5>(f);
      g = fma_round<6>(g);
      h = fma_round<7>(h);
    } else {
      a = fmaf(a, (float)1.0000001, -(float)1e-7);
      b = fmaf(b, (float)0.9999999, (float)1e-7);
      c = fmaf(c, (float)1.0000002, -(float)2e-7);
      d = fmaf(d, (float)0.9999998, (float)2e-7);
      e = fmaf(e, (float)1.0000003, -(float)3e-7);
      f = fmaf(f, (float)0.9999997, (float)3e-7);
      g = fmaf(g, (float)1.0000004, -(float)4e-7);
      h = fmaf(h, (float)0.9999996, (float)4e-7);
      a = fminf(a, e);
      b = fmaxf(b, f);
      c = fminf(c, g);
      d = fmaxf(d, h);
      e = fmaxf(e, (float)0.1);
      f = fminf(f, 10.0f);
      g = g > c ? g : c;
      h = h < d ? h : d;
    }
  }
  out[i] = ((((((a + b) + c) + d) + e) + f) + g) + h;
}

}  // namespace

// Launch mix 0 (fma) or 1 (slab) over n elements on `stream` without
// synchronising.  Returns cudaGetLastError() after the launch.
extern "C" int prt_fp32_peak_launch(int device, void* stream, const float* x,
                                    float* out, int n, int loops, int mix) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  if (mix == 0) {
    fp32_peak_kernel<0><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, out, n, loops);
  } else {
    fp32_peak_kernel<1><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, out, n, loops);
  }
  return (int)cudaGetLastError();
}
