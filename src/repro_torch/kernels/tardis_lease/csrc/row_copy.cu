// K3 row_copy: indexed row copies between a paged KV pool (N, W) and a dense
// (n, w) buffer, restricted to a LANES-aligned column window.
//
// Replaces src/repro/kernels/tardis_lease/kernel.py: gather_rows
// (_gather_kernel) -- out[i] = pool[idx[i], col_lo:col_lo+w] -- and
// scatter_rows (_scatter_kernel) -- pool[idx[i], col_lo:col_lo+w] = rows[i]
// in place, every other row and every column outside the window keeping its
// bits.  On the TPU the scalar-prefetched ids drove the DMA index maps and
// the sequential grid made a duplicate id keep the LAST listed row
// (kernel.py:326).  Blocks here run in no order, so the scatter keeps that
// rule explicitly: block i checks (all threads together) whether a later
// entry names the same id, and stores nothing if one does.
//
// Bound on the H100: bytes -- it is a pure copy, 2 * n * w * sizeof(elem)
// bytes moved -- but at the serving shapes (a few rows of 22.5 KB) a call
// is a handful of dependent DRAM round trips long, not a bandwidth
// figure.  So every thread first issues ALL of its loads (kPer 16-byte
// vectors into registers), and only then stores: a thread waits on one
// round trip for its data, not one per vector (a load -> store loop
// waits on up to four in sequence).  The scatter issues its row's
// loads before the duplicate scan, so the scan's reads of idx overlap
// them.  The grid is (row, slice of kSlice = kPer * kThreads vectors):
// one decode step's scatter of 8 token rows (1408 vectors each) runs on
// 48 CTAs, a gather of 4 whole pool blocks (22528 vectors each) on 352.
// The wrapper checks that the pool row, the window offset and the window
// width are multiples of 16 bytes.
//
// tardis_empty launches an empty kernel: the floor that any one-launch
// kernel pays on this card, timed beside K3's rows by chip_smoke.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 2;                        // vectors a thread holds
constexpr long long kSlice = kPer * kThreads;  // vectors per block and row

// this thread's vectors [0, kPer) of the block's slice: src[c] into v
// (c = slice base + u * kThreads + threadIdx.x, coalesced for each u)
__device__ __forceinline__ void load_slice(const uint4* __restrict__ src,
                                           long long width_vecs,
                                           uint4 (&v)[kPer]) {
  const long long c0 = blockIdx.y * kSlice + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const long long c = c0 + u * kThreads;
    if (c < width_vecs) v[u] = src[c];
  }
}

__device__ __forceinline__ void store_slice(uint4* __restrict__ dst,
                                            long long width_vecs,
                                            const uint4 (&v)[kPer]) {
  const long long c0 = blockIdx.y * kSlice + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const long long c = c0 + u * kThreads;
    if (c < width_vecs) dst[c] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const uint4* __restrict__ pool, const int* __restrict__ idx,
    long long row_vecs, long long col_vec, long long width_vecs,
    uint4* __restrict__ out) {
  const long long i = blockIdx.x;
  uint4 v[kPer];
  load_slice(pool + static_cast<long long>(idx[i]) * row_vecs + col_vec,
             width_vecs, v);
  store_slice(out + i * width_vecs, width_vecs, v);
}

__global__ void __launch_bounds__(kThreads) scatter_kernel(
    uint4* __restrict__ pool, const int* __restrict__ idx, int n,
    long long row_vecs, long long col_vec, long long width_vecs,
    const uint4* __restrict__ rows) {
  const int i = blockIdx.x;
  uint4 v[kPer];
  load_slice(rows + static_cast<long long>(i) * width_vecs, width_vecs, v);
  const int id = idx[i];
  int later = 0;                       // last listed write wins
  for (int j = i + 1 + threadIdx.x; j < n; j += kThreads)
    later |= (idx[j] == id);
  if (__syncthreads_or(later)) return;
  store_slice(pool + static_cast<long long>(id) * row_vecs + col_vec,
              width_vecs, v);
}

__global__ void empty_kernel() {}

dim3 grid(int n, long long width_vecs) {
  return dim3(n, static_cast<unsigned>((width_vecs + kSlice - 1) / kSlice));
}

}  // namespace

extern "C" int tardis_gather_rows(const void* pool, const void* idx, int n,
                                  long long row_vecs, long long col_vec,
                                  long long width_vecs, void* out,
                                  void* stream) {
  if (n > 0 && width_vecs > 0)
    gather_kernel<<<grid(n, width_vecs), kThreads, 0,
                    (cudaStream_t)stream>>>(
        (const uint4*)pool, (const int*)idx, row_vecs, col_vec, width_vecs,
        (uint4*)out);
  return (int)cudaGetLastError();
}

extern "C" int tardis_scatter_rows(void* pool, const void* idx, int n,
                                   long long row_vecs, long long col_vec,
                                   long long width_vecs, const void* rows,
                                   void* stream) {
  if (n > 0 && width_vecs > 0)
    scatter_kernel<<<grid(n, width_vecs), kThreads, 0,
                     (cudaStream_t)stream>>>(
        (uint4*)pool, (const int*)idx, n, row_vecs, col_vec, width_vecs,
        (const uint4*)rows);
  return (int)cudaGetLastError();
}

extern "C" int tardis_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
