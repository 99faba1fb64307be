// Split-K over keys, merged inside the launch: the helpers that the split-KV
// decode (decode_splitkv.cuh) and the wgmma prefill (prefill_wgmma.cuh)
// share. A block that owns a run of an output's keys writes its partial
// flash state (unnormalised O, running max m in the log2 domain, row sum
// l) in fp32 to a workspace, then takes a ticket from the output's
// counter; the block that takes the last ticket merges every split's
// partial in split order (so two launches give the same bits), writes the
// output and resets the counter to 0 for the next launch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace pst_splits {

using pst_sm90::fast_exp2;

// Run `split` of `splits` over the keys [lo, hi) in tiles of `tile` keys,
// aligned to multiples of `tile`: the tiles [lo / tile, ceil(hi / tile))
// cut at n * s / splits. Sets `first` to the run's first tile and returns
// its tile count (0: an empty run). ops/paged_attention_cuda.py's
// _split_keys is the same formula, for the CPU tests. In 32 bits (n * S
// stays below 2^32 for any sequence under 2^26 keys): a 64-bit division
// is a called subroutine, and one in the prefill's merge loop took the
// whole kernel off the uniform datapath (ptxas then formed the tile loop's
// wgmma descriptors and barrier addresses per thread), a slower loop.
__device__ __forceinline__ int split_run(int lo, int hi, int tile, int split,
                                         int splits, int& first) {
  const int ta = lo / tile;
  const unsigned n = hi > lo ? (hi + tile - 1) / tile - ta : 0;
  first = ta + (int)(n * split / splits);
  return ta + (int)(n * (split + 1) / splits) - first;
}

// Called by every thread once the block's partial is in global memory:
// takes the block's ticket from `counter` and returns true in the block
// that took the last of `splits`, which must then read the other blocks'
// partials past L1 (__ldcg).
__device__ __forceinline__ bool last_split(int* counter, int splits) {
  __shared__ int last;
  __threadfence();  // this block's partial, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// The merge weights of one output row: m[s * stride] holds split s's
// running max (log2 domain) and l[s * stride] its row sum. Replaces each m
// by c_s = 2^(m_s - M) (0 where M is -inf: no split saw a live key) and
// returns L = sum of l_s c_s, in split order.
__device__ __forceinline__ float merge_weights(float* m, const float* l,
                                               int stride, int splits) {
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, m[s * stride]);
  float L = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float c = M == -INFINITY ? 0.f : fast_exp2(m[s * stride] - M);
    m[s * stride] = c;
    L += l[s * stride] * c;
  }
  return L;
}

}  // namespace pst_splits
