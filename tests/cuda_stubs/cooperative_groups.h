// Thread-block cluster declarations for the syntax check (see
// cuda_runtime.h).
#pragma once

namespace cooperative_groups {
struct cluster_group {
  unsigned num_blocks() const;
  unsigned block_rank() const;
  void sync() const;
  template <typename T>
  T* map_shared_rank(T* p, unsigned rank) const;
};
cluster_group this_cluster();
}  // namespace cooperative_groups
