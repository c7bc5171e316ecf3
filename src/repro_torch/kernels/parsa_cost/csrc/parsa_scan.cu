// parsa_scan: the blocked greedy scan of the partitioner, every block and
// every round in ONE launch, each round's picks committed on the card.
//
// Replaces the TPU kernel kernels/parsa_cost/select.py:parsa_select_kernel
// as the JAX scan drives it: one fused cost + select launch a round inside
// lax.scan (core/jax_partition.py:_partition_scan, _assign_block_rounds),
// with the round's commit (S_i |= N(u), sizes, parts, retirement) left to
// XLA.  On this card a round costs a few microseconds of work, so a launch
// and a dozen tensor ops a round would leave the device idle; the scan is
// one serial chain of rounds carried on (S, sizes), and a persistent
// cluster walks all of it.
//
// Layout: one thread-block cluster of kCluster = 8 CTAs a worker (grid =
// workers clusters; device_scan has one worker).  Cluster w scans blocks
// [b0, b0 + nblk) of worker w, in order, against its own S[w] (K, W) and
// sizes[w] (K,).  Per block:
//   * every CTA builds, in its shared memory, the map from a row to its
//     slot in the block's truncated-row side channel (tr_ids);
//   * rank 0 keeps the block's retired flags (from ~valid), the count of
//     unretired rows and the worker's sizes in its shared memory;
//   * 1 + ceil((B - 1) / K) rounds (JAX _assign_block_rounds): the
//     catch-up round visits the partitions in the stable argsort of the
//     entering sizes (ranks counted by K threads), only the partitions at
//     the minimum size enabled, slot j committing to partition order[j];
//     then full rounds in index order;
//   * a round: the round body of select_round.cuh (the cost pass over the
//     compact lists into rank 0's shared tile, retired rows BIG; the same
//     code as sketch_select.cu; a truncated row is walked as the full list
//     of its nonzero words, which the wrapper builds once a launch),
//     cluster barrier, then rank 0 runs the exact epilogue
//     select_epilogue_cand (every warp ranks a slot's column into its 8
//     smallest keys, one warp resolves the slots over them) and commits
//     every active slot: S[order[j]] |= N(u_j) from u_j's list with
//     atomicOr, sizes[order[j]] += 1, parts[u_j] = order[j], u_j retired.
//     A full cluster barrier (release / acquire) then makes S, the flags
//     and the count visible to every CTA before the next round's cost
//     pass, which reads S by strong loads (select_round.cuh set_word),
//     never through the non-coherent cache;
//   * once no unretired row is left the block's remaining rounds would
//     pick nothing, and the cluster moves to the next block (a block of
//     padding rows is skipped whole).
// Ties go to the lowest row, BIG = 2^30, inactive slots commit nothing: the
// bits of the JAX scan.
//
// Shared memory, each CTA (ops.scan_smem_bytes): the (K, B) int32 tile
// (rank 0's is used), the row -> truncated-slot map (B int32), sizes,
// order, picks and costs (4 K int32), the slots' candidates (K min(K, 8)
// keys), the live count, the retired and taken flags (2 B bytes) and the
// catch-up gates (K bytes).  The wrapper keeps it within the opt-in limit
// of 232,448 bytes and B <= 32 * 1024, K <= 1024, and routes larger tiles
// to the per-round path before any launch.
//
// Bound on this card: neither bytes nor operations but the chain of
// rounds.  A round's work is small (B rows of ~20 listed words against K
// partitions) and each round waits for the last one's commit; the cluster
// uses 8 of 132 SMs, and a round's time is its chains of dependent loads,
// cluster barriers and warp collectives.
#include <cooperative_groups.h>

#include "select_round.cuh"

namespace cg = cooperative_groups;

namespace {

using parsa::kCluster;

// threads a CTA: 16 warps, so the round body has 128 registers a thread
// (at 1,024 threads a CTA it would have 64)
constexpr int kScanThreads = 512;

// kLanes lanes a listed row in the cost pass: 16 where a CTA's rows fit one
// pass at 2 rows a warp (B <= 256: fewer dependent gathers a lane), else 8
// (4 rows a warp, 6 pairs a lane in flight).  One instantiation each, so
// each gets its own registers: the 16-lane one fits in 128, the 8-lane one
// spills (chip_smoke.py prints ptxas's count for both).
template <int kLanes>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kScanThreads)
parsa_scan_kernel(const int32_t* __restrict__ widx,      // (nw, nb, B, cap)
                  const uint32_t* __restrict__ vals,     // (nw, nb, B, cap)
                  const int32_t* __restrict__ tr_ids,    // (nw, nb, TB)
                  const int32_t* __restrict__ tr_lw,     // (nw, nb, TB, W)
                  const uint32_t* __restrict__ tr_lv,    // (nw, nb, TB, W)
                  const int32_t* __restrict__ tr_len,    // (nw, nb, TB)
                  const uint8_t* __restrict__ valid,     // (nw, nb, B)
                  int cap, int TB,
                  uint32_t* s,                           // (nw, K, W)
                  int32_t* sizes,                        // (nw, K)
                  int32_t* parts,                        // (nw, nb, B)
                  int B, int K, int W, int nb, int b0, int nblk) {
  extern __shared__ __align__(16) int32_t smem[];
  const int T = min(K, parsa::kCand);
  int32_t* tile = smem;                  // (K, B) cost tile, rank 0
  int32_t* trslot = tile + K * B;        // (B,) row -> slot of tr_ids, or -1
  int32_t* sz = trslot + B;              // (K,) the worker's sizes, rank 0
  int32_t* ord = sz + K;                 // (K,) catch-up slot -> partition
  int32_t* pick = ord + K;               // (K,) the round's u_sel
  int32_t* pcost = pick + K;             // (K,) the round's c_sel
  unsigned* cand = reinterpret_cast<unsigned*>(pcost + K);  // (K, T)
  int32_t* live = pcost + K + K * T;     // [0]: unretired rows, rank 0
  uint8_t* retired = reinterpret_cast<uint8_t*>(live + 4);  // (B,) rank 0
  uint8_t* taken = retired + B;          // (B,) the epilogue's scratch
  uint8_t* en = taken + B;               // (K,) catch-up gates

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t wk = blockIdx.x / kCluster;  // this cluster's worker
  int32_t* tile0 = cluster.map_shared_rank(tile, 0);
  const uint8_t* retired0 = cluster.map_shared_rank(retired, 0);
  const int32_t* live0 = cluster.map_shared_rank(live, 0);
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = nt >> 5;
  s += wk * K * W;
  sizes += wk * K;
  const int rpc = (B + kCluster - 1) / kCluster;
  const int r_begin = rank * rpc;
  const int r_end = min(B, r_begin + rpc);
  const int n_rounds = 1 + (B - 1 + K - 1) / K;
  if (rank == 0) {
    for (int i = t; i < K; i += nt) sz[i] = sizes[i];
    for (int i = t; i < B; i += nt) taken[i] = 0;
  }

  for (int b = b0; b < b0 + nblk; ++b) {
    const int64_t blk = wk * nb + b;
    const int32_t* bw = widx + blk * B * cap;
    const uint32_t* bv = vals + blk * B * cap;
    const int32_t* bt = tr_ids + blk * TB;
    const int32_t* blw = tr_lw + blk * TB * W;
    const uint32_t* blv = tr_lv + blk * TB * W;
    const int32_t* blen = tr_len + blk * TB;
    const uint8_t* bvalid = valid + blk * B;
    int32_t* bparts = parts + blk * B;
    // every CTA has left the last block (and read rank 0's count for the
    // last time) before the block's flags, count and map are rewritten
    cluster.sync();
    for (int i = t; i < B; i += nt) trslot[i] = -1;
    __syncthreads();
    for (int i = t; i < TB; i += nt) {
      const int id = bt[i];
      if (id >= 0 && id < B) trslot[id] = i;   // B: a padding entry
    }
    if (rank == 0) {
      int n = 0;
      for (int i0 = 0; i0 < B; i0 += nt) {
        const int i = i0 + t;
        const bool v = i < B && bvalid[i] != 0;
        if (i < B) retired[i] = !v;
        n += __syncthreads_count(v);
      }
      if (t == 0) live[0] = n;
    }
    cluster.sync();
    if (*live0 == 0) continue;   // padding rows only: nothing to pick

    for (int r = 0; r < n_rounds; ++r) {
      const bool catchup = r == 0;
      const auto row_src = [&](int u) {
        const int sl = trslot[u];
        parsa::RowSrc src{retired0[u] != 0, nullptr};
        if (sl >= 0) {   // truncated: its full list
          src.lw = blw + static_cast<int64_t>(sl) * W;
          src.lv = blv + static_cast<int64_t>(sl) * W;
          src.len = blen[sl];
        }
        return src;
      };
      parsa::round_cost_pass<kLanes>(tile0, bw, bv, cap, s, B, K, W, r_begin,
                                     r_end, row_src);
      cluster.sync();   // the tile is complete in rank 0
      if (rank == 0) {
        if (catchup) {
          // the stable argsort of the sizes by counted ranks; a partition
          // is enabled iff none is smaller
          for (int i = t; i < K; i += nt) {
            const int mine = sz[i];
            int pos = 0;
            bool smaller = false;
            for (int q = 0; q < K; ++q) {
              const int v = sz[q];
              pos += v < mine || (v == mine && q < i);
              smaller |= v < mine;
            }
            ord[pos] = i;
            en[pos] = !smaller;
          }
          __syncthreads();
        }
        parsa::select_epilogue_cand(tile, catchup ? ord : nullptr,
                                    catchup ? en : nullptr, B, K, live[0],
                                    cand, taken, pick, pcost);
        __syncthreads();
        // commit: a warp a slot; slots name distinct partitions and rows
        for (int j = warp; j < K; j += nwarps) {
          const int u = pick[j];
          if (u < 0) continue;   // an inactive slot commits nothing
          const int p = catchup ? ord[j] : j;
          uint32_t* srow = s + static_cast<int64_t>(p) * W;
          const int sl = trslot[u];
          const int32_t* lw = bw + static_cast<int64_t>(u) * cap;
          const uint32_t* lv = bv + static_cast<int64_t>(u) * cap;
          int len = cap;
          if (sl >= 0) {   // truncated: its full list
            lw = blw + static_cast<int64_t>(sl) * W;
            lv = blv + static_cast<int64_t>(sl) * W;
            len = blen[sl];
          }
          for (int e = lane; e < len; e += 32) {
            const uint32_t x = lv[e];
            if (x != 0u) atomicOr(srow + lw[e], x);
          }
          if (lane == 0) {
            sz[p] += 1;
            bparts[u] = p;
            retired[u] = 1;
            atomicSub(live, 1);
          }
        }
        __threadfence();
      }
      // S, the flags and the count are visible to every CTA
      cluster.sync();
      if (*live0 == 0) break;   // the remaining rounds pick nothing
    }
  }
  // no CTA leaves while another may still read rank 0's shared memory
  cluster.sync();
  if (rank == 0)
    for (int i = t; i < K; i += nt) sizes[i] = sz[i];
}

template <int kLanes>
cudaError_t launch(const void* widx, const void* vals, const void* tr_ids,
                   const void* tr_lw, const void* tr_lv, const void* tr_len,
                   const void* valid, int cap, int TB, void* s, void* sizes,
                   void* parts, int B, int K, int W, int nb, int b0, int nblk,
                   int workers, int smem, cudaStream_t stream) {
  static int opted_in = 48 * 1024;  // the default limit needs no opt-in
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        parsa_scan_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  parsa_scan_kernel<kLanes><<<workers * kCluster, kScanThreads, smem, stream>>>(
      static_cast<const int32_t*>(widx), static_cast<const uint32_t*>(vals),
      static_cast<const int32_t*>(tr_ids), static_cast<const int32_t*>(tr_lw),
      static_cast<const uint32_t*>(tr_lv),
      static_cast<const int32_t*>(tr_len),
      static_cast<const uint8_t*>(valid), cap, TB,
      static_cast<uint32_t*>(s), static_cast<int32_t*>(sizes),
      static_cast<int32_t*>(parts), B, K, W, nb, b0, nblk);
  return cudaGetLastError();
}

}  // namespace

// The caller guarantees 1 <= B <= 32 * 1024, 1 <= K <= 1024, W >= 1,
// cap >= 1, TB >= 1, 0 <= widx < W, each truncated slot's list holding its
// row's nonzero words first (tr_len of them), 0 <= b0, b0 + nblk <= nb, and
// that the shared memory (ops.scan_smem_bytes) fits a CTA's opt-in limit.
extern "C" int parsa_scan(const void* widx, const void* vals,
                          const void* tr_ids, const void* tr_lw,
                          const void* tr_lv, const void* tr_len,
                          const void* valid, int cap, int TB, void* s,
                          void* sizes, void* parts, int B, int K, int W,
                          int nb, int b0, int nblk, int workers,
                          void* stream) {
  const int T = K < parsa::kCand ? K : parsa::kCand;
  const int bytes = 4 * (K * B + B + 4 * K + K * T + 4) + 2 * B + K;
  const int smem = (bytes + 15) / 16 * 16;
  const int rpc = (B + kCluster - 1) / kCluster;
  const auto st = static_cast<cudaStream_t>(stream);
  // 16 lanes a row while a CTA's rows fit one pass at 2 rows a warp
  const cudaError_t e =
      rpc <= 2 * (kScanThreads / 32)
          ? launch<16>(widx, vals, tr_ids, tr_lw, tr_lv, tr_len, valid, cap,
                       TB, s, sizes, parts, B, K, W, nb, b0, nblk, workers,
                       smem, st)
          : launch<8>(widx, vals, tr_ids, tr_lw, tr_lv, tr_len, valid, cap,
                      TB, s, sizes, parts, B, K, W, nb, b0, nblk, workers,
                      smem, st);
  return static_cast<int>(e);
}
