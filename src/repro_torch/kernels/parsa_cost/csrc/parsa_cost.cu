// parsa_cost: the (U, K) cost tile cost[u, i] = |N(u) \ S_i| over packed
// int32 bitmasks, written row-major.
//
// Replaces the TPU kernel kernels/parsa_cost/parsa_cost.py:parsa_cost_kernel
// (a (U/bu, W/bw) Pallas grid accumulating into a VMEM output tile).
//
// Bound on this card: bytes.  Each output costs one AND-NOT, one popcount
// and one add per word pair, far below the integer rate, while the (U, W)
// and (K, W) words must come from device memory.  The design (see
// cost_tile.cuh) reads each N(u) word once, with every load of a row issued
// before any is used, compacts the row's nonzero words by ballots and
// gathers the partition words under them for all K partitions in one pass,
// so a sparse row moves little more than its own words in two dependent
// trips; no (8, 128) padding of U or W is needed.  It drives the
// host_blocked_oracle backend (repro_torch.core.partition._assign_block):
// one K = k tile a block, and one K = 1 down-date a vertex against an
// almost all-ones complement mask.
#include "cost_tile.cuh"

extern "C" int parsa_cost(const void* nbr, const void* s, int U, int K,
                          int W, void* out, void* stream) {
  return parsa::launch_cost_tile(nbr, s, U, K, W, out, 0, stream);
}
