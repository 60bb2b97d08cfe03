// K2 write_advance: the Tardis writer jump-ahead (paper Table I store rule)
// over the blocks selected by a mask, fused into two back-to-back launches
// that never round-trip through the host.
//
// Replaces src/repro/kernels/tardis_lease/kernel.py: rowmax_table
// (_rowmax_kernel) and advance_table (_advance_kernel), as composed by
// ops.write_advance.  The TPU version reduced row maxima in one kernel,
// finished the max and built ts in XLA, then ran the advance kernel with ts
// as a scalar prefetch.  Here:
//   1. write_ts_kernel (one block): ts = max(pts, max(masked rts, -1) + 1)
//      -> a device int32;
//   2. advance_kernel (one thread per entry): wts = rts = ts where masked,
//      reading ts from device memory.
// The wrapper returns (new_wts, new_rts, ts) like ops.write_advance.
//
// Bound on the H100: bytes (three int32 reads and two int32 writes per
// entry; ~90 KB at the serving table size), so in practice launch latency.
// One block suffices for the reduction at table sizes up to ~10^5 entries
// and spares a second reduction pass or atomics.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void write_ts_kernel(const int* __restrict__ rts,
                                const int* __restrict__ mask, int n, int pts,
                                int* __restrict__ ts) {
  __shared__ int warp_top[32];
  int top = -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (mask[i] != 0) top = max(top, rts[i]);
  top = __reduce_max_sync(kFull, top);
  if ((threadIdx.x & 31) == 0) warp_top[threadIdx.x >> 5] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = -1;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t = max(t, warp_top[w]);
    *ts = max(pts, t + 1);
  }
}

__global__ void advance_kernel(const int* __restrict__ wts,
                               const int* __restrict__ rts,
                               const int* __restrict__ mask,
                               const int* __restrict__ ts, int n,
                               int* __restrict__ new_wts,
                               int* __restrict__ new_rts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool m = mask[i] != 0;
  const int t = *ts;
  new_wts[i] = m ? t : wts[i];
  new_rts[i] = m ? t : rts[i];
}

}  // namespace

extern "C" int tardis_write_advance(const void* wts, const void* rts,
                                    const void* mask, int pts, int n,
                                    void* new_wts, void* new_rts, void* ts,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  write_ts_kernel<<<1, 1024, 0, s>>>((const int*)rts, (const int*)mask, n,
                                     pts, (int*)ts);
  if (n > 0) {
    const int threads = 256;
    advance_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
        (const int*)wts, (const int*)rts, (const int*)mask, (const int*)ts, n,
        (int*)new_wts, (int*)new_rts);
  }
  return (int)cudaGetLastError();
}
