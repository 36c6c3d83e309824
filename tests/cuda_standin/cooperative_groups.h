// The stand-in's thread-block clusters (cuda_runtime.h beside this file):
// the cluster's barrier, its ranks, and another rank's shared memory at the
// same offset as this block's.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return cusim::ctx.rank; }
  unsigned num_blocks() const { return cusim::ctx.cluster->blocks.size(); }
  void sync() const { cusim::ctx.cluster->bar->arrive_and_wait(); }
  template <class T>
  T* map_shared_rank(T* p, unsigned r) const {
    auto& own = cusim::ctx.block->smem;
    const ptrdiff_t off = (char*)p - own.data();
    if (off < 0 || off >= (ptrdiff_t)own.size()) abort();
    return (T*)(cusim::ctx.cluster->blocks.at(r).smem.data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
