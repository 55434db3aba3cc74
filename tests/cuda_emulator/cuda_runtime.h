// A CPU stand-in for the CUDA runtime, enough to compile and run a kernel
// source of xfmamba_tpu_torch/csrc with g++ (tests/test_torch_n1_emulated.py):
// one std::thread per CUDA thread, the blocks of a launch one after
// another (the blocks of a thread-block cluster together, cudaLaunchKernelEx
// with a cluster dimension), __syncthreads a barrier of the block, a
// shuffle or an mma.sync a barrier-fenced exchange within the warp.  The
// launch syntax and the inline PTX are rewritten by the test before
// compiling.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)

struct uint3 {
  unsigned x, y, z;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}

struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
using std::max;
using std::min;

inline float __uint_as_float(uint32_t v) {
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}
inline uint32_t emu_bits(float f) {
  uint32_t v;
  std::memcpy(&v, &f, 4);
  return v;
}
inline size_t __cvta_generic_to_shared(const void* p) { return reinterpret_cast<size_t>(p); }

// the state of the block a thread belongs to
struct EmuBlock {
  uint3 idx;
  std::vector<float> smem;
  std::unique_ptr<std::barrier<>> barrier;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  float exchange[32][32][8];  // [warp][lane][value]
};
inline thread_local EmuBlock* emu_block;
inline thread_local float* emu_smem;  // the block's dynamic shared memory
inline thread_local float (*emu_exchange)[32][8];
// the blocks of the thread's cluster, by rank, and the cluster's barrier
inline thread_local std::vector<EmuBlock*>* emu_cluster_blocks;
inline thread_local std::barrier<>* emu_cluster_barrier;
inline thread_local unsigned emu_cluster_rank;

inline void __syncthreads() { emu_block->barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->warps[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_exchange[w][l][0] = v;
  __syncwarp();
  const float r = emu_exchange[w][l ^ mask][0];
  __syncwarp();
  return r;
}

// The blocks of one cluster (cluster dims cx, cy, 1 from block (x0, y0)),
// run together; shared memory starts as NaN, so that a read before a write
// shows in the results.
template <class K, class... A>
void emu_run_cluster(K kernel, unsigned x0, unsigned y0, unsigned cx, unsigned cy, size_t smem,
                     A... args) {
  const int n = blockDim.x * blockDim.y * blockDim.z;
  std::vector<std::unique_ptr<EmuBlock>> blocks;
  std::vector<EmuBlock*> by_rank;
  for (unsigned ry = 0; ry < cy; ++ry)
    for (unsigned rx = 0; rx < cx; ++rx) {
      auto b = std::make_unique<EmuBlock>();
      b->idx = {x0 + rx, y0 + ry, 0};
      b->smem.assign(smem / 4 + 1, std::nanf(""));
      b->barrier = std::make_unique<std::barrier<>>(n);
      for (int w = 0; w < (n + 31) / 32; ++w)
        b->warps.emplace_back(new std::barrier<>(std::min(32, n - 32 * w)));
      by_rank.push_back(b.get());
      blocks.push_back(std::move(b));
    }
  std::barrier<> cluster_barrier(n * static_cast<int>(by_rank.size()));
  std::vector<std::thread> threads;
  for (unsigned r = 0; r < by_rank.size(); ++r)
    for (int t = 0; t < n; ++t)
      threads.emplace_back([&, r, t] {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        emu_block = by_rank[r];
        blockIdx = emu_block->idx;
        emu_smem = emu_block->smem.data();
        emu_exchange = emu_block->exchange;
        emu_cluster_blocks = &by_rank;
        emu_cluster_barrier = &cluster_barrier;
        emu_cluster_rank = r;
        kernel(args...);
      });
  for (auto& t : threads) t.join();
}

// kernel<<<grid, block, smem, stream>>>(args...), 1-D blocks
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  gridDim = grid;
  blockDim = block;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) emu_run_cluster(kernel, bx, by, 1, 1, smem, args...);
}

template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A... args) {
  unsigned cx = 1, cy = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      if (cfg->attrs[i].val.clusterDim.z != 1) return cudaErrorInvalidValue;
      cx = cfg->attrs[i].val.clusterDim.x;
      cy = cfg->attrs[i].val.clusterDim.y;
    }
  const dim3 grid = cfg->gridDim;
  if (grid.x % cx || grid.y % cy || grid.z != 1) return cudaErrorInvalidValue;
  gridDim = grid;
  blockDim = cfg->blockDim;
  for (unsigned by = 0; by < grid.y; by += cy)
    for (unsigned bx = 0; bx < grid.x; bx += cx)
      emu_run_cluster(kernel, bx, by, cx, cy, cfg->dynamicSmemBytes, P(args)...);
  return cudaSuccess;
}

inline float __expf(float x) { return std::exp(x); }
inline float __fdividef(float a, float b) { return a / b; }
