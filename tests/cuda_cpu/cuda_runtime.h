// A stand-in for the CUDA runtime header that runs a kernel's own source on
// the CPU: one std::thread per CUDA thread, a std::barrier for
// __syncthreads, the blocks one after another, __shared__ a static.  A test
// rewrites each launch `k<<<blocks, threads, ...>>>(args)` as
// `shim_launch(k, blocks, threads, args)` and builds the source with
// `g++ -std=c++20 -pthread -I tests/cuda_cpu`.  It checks a kernel's
// arithmetic and indexing, not what nvcc makes of it.
#pragma once
#include <algorithm>
#include <barrier>
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict

struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<> *shim_barrier = nullptr;
inline void __syncthreads() { shim_barrier->arrive_and_wait(); }
template <class T> T __shfl_down_sync(unsigned, T v, int) { return v; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int r) {
  r &= 31;
  return r ? (hi << r) | (lo >> (32 - r)) : hi;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline double __hiloint2double(int hi, int lo) {
  const uint64_t u = ((uint64_t)(uint32_t)hi << 32) | (uint32_t)lo;
  double d;
  std::memcpy(&d, &u, sizeof d);
  return d;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
using std::max;
using std::min;
typedef int cudaError_t;
typedef void *cudaStream_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
// atomics on the host's memory; the card's occupancy as 4 SMs of 2 blocks,
// so that a persistent grid walks its work in several strides
template <class T> T atomicAdd(T *p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int *d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int *v, cudaDeviceAttr, int) {
  *v = 4;
  return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int *n, F, int,
                                                          size_t) {
  *n = 2;
  return 0;
}
inline const char *cudaGetErrorString(cudaError_t) { return "no error"; }

template <class K, class... A>
void shim_launch(K k, int blocks, int threads, A... args) {
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(threads);
    shim_barrier = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        k(args...);
        bar.arrive_and_drop();
      });
    for (auto &th : ts) th.join();
  }
}
