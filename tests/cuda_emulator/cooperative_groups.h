// The thread-block cluster of cooperative_groups for tests/cuda_emulator
// (see cuda_runtime.h): the blocks of a cluster run together, sync() is a
// barrier of all their threads, map_shared_rank() points into another
// block's shared memory.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const { emu_cluster_barrier->arrive_and_wait(); }
  unsigned block_rank() const { return emu_cluster_rank; }
  unsigned num_blocks() const { return static_cast<unsigned>(emu_cluster_blocks->size()); }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const size_t off = reinterpret_cast<const char*>(p) - reinterpret_cast<const char*>(emu_smem);
    return reinterpret_cast<T*>(
        reinterpret_cast<char*>((*emu_cluster_blocks)[rank]->smem.data()) + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
