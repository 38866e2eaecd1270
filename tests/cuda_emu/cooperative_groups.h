// The thread-block cluster of cooperative_groups, on the stand-in runtime of
// cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct cluster_group {
  unsigned num_blocks() const { return emu::cluster_size(); }
  unsigned block_rank() const { return emu::cluster_rank(); }
  void sync() const { emu::cluster_sync(); }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    return (T*)emu::cluster_map((void*)p, rank);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
