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
// rule explicitly: block i first checks (all threads together) whether a
// later entry names the same id, and skips its copy if one does.
//
// Bound on the H100: bytes -- it is a pure copy, 2 * n * w * sizeof(elem)
// bytes moved.  The grid is (row, slice of kSlice vectors): a gather of a
// few whole pool blocks (4 rows of 180224 bf16 = 22528 vectors each) still
// spreads over ~90 SMs instead of 4, and every thread moves 16-byte vectors
// (uint4), read and written fully coalesced.  The wrapper checks that the
// pool row, the window offset and the window width are multiples of 16
// bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSlice = 4 * kThreads;   // vectors per block and row

__global__ void gather_kernel(const uint4* __restrict__ pool,
                              const int* __restrict__ idx,
                              long long row_vecs, long long col_vec,
                              long long width_vecs, uint4* __restrict__ out) {
  const long long i = blockIdx.x;
  const uint4* src = pool + static_cast<long long>(idx[i]) * row_vecs + col_vec;
  uint4* dst = out + i * width_vecs;
  const long long end = min(width_vecs, (blockIdx.y + 1) * kSlice);
  for (long long c = blockIdx.y * kSlice + threadIdx.x; c < end; c += kThreads)
    dst[c] = src[c];
}

__global__ void scatter_kernel(uint4* __restrict__ pool,
                               const int* __restrict__ idx, int n,
                               long long row_vecs, long long col_vec,
                               long long width_vecs,
                               const uint4* __restrict__ rows) {
  const int i = blockIdx.x;
  const int id = idx[i];
  int later = 0;                       // last listed write wins
  for (int j = i + 1 + threadIdx.x; j < n; j += kThreads)
    later |= (idx[j] == id);
  if (__syncthreads_or(later)) return;
  uint4* dst = pool + static_cast<long long>(id) * row_vecs + col_vec;
  const uint4* src = rows + static_cast<long long>(i) * width_vecs;
  const long long end = min(width_vecs, (blockIdx.y + 1) * kSlice);
  for (long long c = blockIdx.y * kSlice + threadIdx.x; c < end; c += kThreads)
    dst[c] = src[c];
}

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
