// Host emulation of the CUDA primitives that the port's lane kernels use, for
// tests/test_torch_lane_emulation.py: a kernel source of
// eeyore_tpu_torch/ops/csrc compiles for the host with g++ against this header
// (its shared memory taken from emu::block_smem and emu::shared_array by the
// test), every thread of a thread-block cluster runs as a ucontext coroutine
// on one host thread, and warp shuffles, ballots, __syncwarp, __syncthreads
// and the cluster barrier are barriers over the lanes of their mask, over the
// block or over the cluster, at which a thread yields until every member has
// arrived. Each block of a cluster has its own shared memory, which
// map_shared_rank reaches; clusters (a block without one is a cluster of one)
// run one after another. Only the primitives the kernels call are here.
#pragma once
#include <ucontext.h>
#include <math.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <utility>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __constant__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }

inline dim3 threadIdx, blockIdx, blockDim, gridDim;

inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

namespace emu {
struct Bar { int arrived = 0; long gen = 0; };
inline std::map<std::pair<long, unsigned>, Bar> bars;
inline std::vector<ucontext_t> ctx;
inline std::vector<char> done;
inline ucontext_t main_ctx;
inline int cur = 0;
constexpr int kMaxCluster = 16;
inline int rank = 0;  // the current thread's block in its cluster
inline int cluster_size = 1;
inline float vals[kMaxCluster * 1024];
inline unsigned bits[kMaxCluster * 1024];
// Each block's shared memory: static arrays (shared_array), then the dynamic
// shared memory (block_smem).
constexpr size_t kStaticFloats = 4096;
constexpr size_t kArenaFloats = kStaticFloats + (size_t{1} << 20);
inline float arena[kMaxCluster][kArenaFloats];
inline float* block_smem() { return arena[rank] + kStaticFloats; }
inline float* shared_array(int id, size_t n) {
  static std::map<int, size_t> offsets;
  static size_t used = 0;
  auto it = offsets.find(id);
  if (it == offsets.end()) {
    if (used + n > kStaticFloats) {
      std::fprintf(stderr, "emulation: static shared memory exhausted\n");
      std::abort();
    }
    it = offsets.emplace(id, used).first;
    used += n;
  }
  return arena[rank] + it->second;
}
inline void yield() { swapcontext(&ctx[cur], &main_ctx); }
inline void barrier(long key, unsigned mask, int count) {
  Bar& b = bars[{key, mask}];
  const long g = b.gen;
  if (++b.arrived == count) {
    b.arrived = 0;
    b.gen++;
  } else {
    while (b.gen == g) yield();
  }
}
// the warp's slot among the cluster's (barrier keys and the exchange arrays)
inline int warp() { return rank * 32 + static_cast<int>(threadIdx.x) / 32; }
inline int lane() { return static_cast<int>(threadIdx.x) % 32; }
inline int me() { return rank * 1024 + static_cast<int>(threadIdx.x); }
inline void warp_barrier(unsigned mask) { barrier(warp(), mask, __builtin_popcount(mask)); }
inline std::function<void()> body;
inline void entry() {
  body();
  done[cur] = 1;
  swapcontext(&ctx[cur], &main_ctx);
}
// Runs the blocks [first, first + blocks) of a launch as one cluster.
inline void run_cluster(int first, int blocks, int threads_per_block, std::function<void()> fn) {
  // each thread's stack, left uninitialised so that only the pages a thread
  // uses are ever touched (a cluster may hold thousands of threads)
  constexpr size_t kStack = size_t{1} << 20;
  static std::vector<std::unique_ptr<char[]>> stacks;
  const int threads = blocks * threads_per_block;
  body = fn;
  cluster_size = blocks;
  ctx.assign(threads, ucontext_t{});
  done.assign(threads, 0);
  if (stacks.size() < static_cast<size_t>(threads)) stacks.resize(threads);
  for (int t = 0; t < threads; ++t) {
    if (!stacks[t]) stacks[t].reset(new char[kStack]);
    getcontext(&ctx[t]);
    ctx[t].uc_stack.ss_sp = stacks[t].get();
    ctx[t].uc_stack.ss_size = kStack;
    ctx[t].uc_link = nullptr;
    makecontext(&ctx[t], entry, 0);
  }
  int left = threads;
  long passes = 0;
  while (left > 0) {
    for (int t = 0; t < threads; ++t) {
      if (done[t]) continue;
      cur = t;
      rank = t / threads_per_block;
      threadIdx = dim3(t % threads_per_block);
      blockIdx = dim3(first + rank);
      swapcontext(&main_ctx, &ctx[t]);
      if (done[t]) --left;
    }
    if (++passes > 2000000000L) {
      std::fprintf(stderr, "emulation: the block's threads wait on each other\n");
      std::abort();
    }
  }
  bars.clear();
}
}  // namespace emu

inline float __shfl_sync(unsigned mask, float v, int src, int width = 32) {
  const int l = emu::lane();
  emu::vals[emu::me()] = v;
  emu::warp_barrier(mask);
  const int s = (l & ~(width - 1)) + (src & (width - 1));
  const float r = emu::vals[emu::warp() * 32 + s];
  emu::warp_barrier(mask);
  return r;
}
inline float __shfl_xor_sync(unsigned mask, float v, int o, int width = 32) {
  const int l = emu::lane();
  return __shfl_sync(mask, v, (l ^ o) & (width - 1), width);
}
inline unsigned __ballot_sync(unsigned mask, bool p) {
  emu::bits[emu::me()] = p ? 1u : 0u;
  emu::warp_barrier(mask);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) {
    if ((mask >> i) & 1u) r |= emu::bits[emu::warp() * 32 + i] << i;
  }
  emu::warp_barrier(mask);
  return r;
}
inline void __syncwarp(unsigned mask = 0xffffffffu) { emu::warp_barrier(mask); }
inline void __syncthreads() { emu::barrier(-1 - emu::rank, 0, static_cast<int>(blockDim.x)); }
inline unsigned __activemask() { return 0xffffffffu; }
inline bool __all_sync(unsigned mask, bool p) { return __ballot_sync(mask, !p) == 0u; }
inline bool __any_sync(unsigned mask, bool p) { return __ballot_sync(mask, p) != 0u; }
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  unsigned s = 0;
  emu::bits[emu::me()] = v;
  emu::warp_barrier(mask);
  for (int i = 0; i < 32; ++i) if ((mask >> i) & 1u) s += emu::bits[emu::warp() * 32 + i];
  emu::warp_barrier(mask);
  return s;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const auto o = *p; *p += v; return o;
}

// runtime API, enough for the launch code
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidConfiguration = 9;
constexpr cudaError_t cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream;
  cudaLaunchAttribute* attrs; unsigned numAttrs;
};
struct cudaFuncAttributes {
  int numRegs; size_t localSizeBytes; int maxThreadsPerBlock; int maxDynamicSharedSizeBytes;
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0; a->localSizeBytes = 0; a->maxThreadsPerBlock = 1024;
  a->maxDynamicSharedSizeBytes = 48 * 1024;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* o, F, const cudaLaunchConfig_t*) {
  *o = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* o, F, int, size_t) {
  *o = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated error"; }
template <typename... Params, typename... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Params...),
                               Args... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i) cluster = cfg->attrs[i].val.clusterDim.x;
  if (cluster < 1 || cluster > emu::kMaxCluster || cfg->gridDim.x % cluster != 0 ||
      cfg->blockDim.x > 1024) {
    return cudaErrorInvalidConfiguration;
  }
  gridDim = cfg->gridDim;
  blockDim = cfg->blockDim;
  for (unsigned b = 0; b < cfg->gridDim.x; b += cluster) {
    emu::run_cluster(static_cast<int>(b), static_cast<int>(cluster),
                     static_cast<int>(cfg->blockDim.x), [&]() { kernel(args...); });
  }
  return cudaSuccess;
}

namespace cooperative_groups {
struct cluster_group {
  void sync() { emu::barrier(-100000, 0, emu::cluster_size * static_cast<int>(blockDim.x)); }
  // the same shared-memory address in block r of the cluster
  template <class T> T* map_shared_rank(T* p, unsigned r) {
    const char* here = reinterpret_cast<const char*>(emu::arena[emu::rank]);
    char* there = reinterpret_cast<char*>(emu::arena[r]);
    return reinterpret_cast<T*>(there + (reinterpret_cast<const char*>(p) - here));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
