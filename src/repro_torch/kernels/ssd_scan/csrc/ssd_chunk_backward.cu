// K12 ssd_chunk_backward: the gradient of K7 (the SSD intra-chunk term and
// chunk states).
//
// There is no TPU backward to replace: the JAX package differentiates
// src/repro/kernels/ssd_scan/ops.py's jnp path with autodiff.  This is the
// closed form of ssd_chunk_backward_ref (ref.py).  Per (batch b, chunk c,
// head h), positions i, j of the chunk, with xdt_j = x_j dt_j, cb = C B^T,
// L_ij = exp(cum_i - cum_j) for i >= j (else 0), M = cb o L and
// e_j = exp(cum_last - cum_j), given dy (the gradient of y_intra) and dS
// (that of the chunk states):
//   dxdt = M^T dy + e o (B dS^T)            -> dx = dxdt dt, ddt = dxdt . x
//   dM   = dy xdt^T for i >= j;  dcb = dM o L
//   dC   = dcb B;  dB = dcb^T C + e o (xdt dS)
//   dcum_i += sum_j (dM o M)_ij;  dcum_j -= sum_i (dM o M)_ij
//   de_j = xdt_j . (B dS^T)_j:  dcum_last += sum_j de_j e_j, dcum_j -= de_j e_j
// Positions t >= s (the chunk padding) read as 0 and get no dx, ddt, dB or
// dC; dcum is written at every position (the last one takes the e terms).
//
// Layout: K7's inputs where K7 reads them (x (b, s, h, p), B and C (b, s,
// [h,] n) at any strides with the last dim contiguous -- head stride 0
// where one group serves every head -- dt (b, s, h) and cum (b, nc, q, h)
// fp32); dy (b, nc, q, h, p) and dS (b, nc, h, p, n) fp32 contiguous.
//
// Design (fp32 SIMT: the fp32 tolerance is 2e-4).  At zamba2's width
// q = 256: one (chunk, head)'s decay matrix alone is 256 KB in fp32, more
// than an SM's shared memory, so nothing q x q is kept: the work is tiled
// in 64 x 64 (i-block, j-block) pairs and each tile rebuilds cb, dM and L
// from C, B, dy, xdt and cum in registers, as a flash-attention backward
// rebuilds P.  256 threads a CTA, 4 x 4 outputs each, operands staged in
// shared memory.
//  * Kernel 1 (rows): a CTA per (b * chunk, i-block, head) walks the
//    j-blocks <= its own and accumulates dC_i in registers and the row
//    sums of dM o M.
//  * Kernel 2 (columns): a CTA per (b * chunk, j-block, head) walks the
//    i-blocks >= its own and accumulates dxdt_j and dB_j in registers and
//    the column sums; then the e terms from dS (staged once), and writes
//    dx, ddt, its block's share of dcum_last.
//  * Kernel 3 (finish): dcum = row part + column part (+ the j-blocks'
//    dcum_last shares in block order at the last position); dB and dC
//    from per-head fp32 partials, summed over the heads in head order
//    where one group serves them all (else cast).
// No float atomics: every sum runs in an order the shapes fix, so two
// calls are bit identical.
// Bound on the H100: fp32 operations.  Per (chunk, head) the lower
// triangle of q^2 / 2 (i, j) pairs costs cb and dM twice (once a kernel,
// (n + p) multiply-adds each), and dC, dxdt, dB (n + p + n) once, plus
// the e terms' q p n twice.
//
// The kernels live in include/ssd_chunk_backward.cuh; this source
// instantiates them for an fp32 x and holds the C entry point.  They are
// K12's "simt" variant: the chunk sizes and widths that the tensor-core
// "tf32x3" variant (ssd_chunk_backward_tf32.cu) does not take
// (kernel.ssd_backward_variant: it takes the chunk a multiple of 64, p <=
// 64 and n <= 128 in multiples of 16).
#include "ssd_chunk_backward.cuh"

// K12 for a bf16 x (ssd_chunk_backward_bf16.cu)
int k12_bf16_x(K12_PARAMS);

// x (b, s, h, p) at strides (xsb, xst, xsh); dt (b, s, h) at (dsb, dst);
// cum (b, nc, q, h) fp32 contiguous; B and C (b, s, [h,] n) at (bsb, bst,
// bsh), bsh = 0 and shared = 1 where one group serves every head; dy
// (b, nc, q, h, p) and dS (b, nc, h, p, n) fp32 contiguous.  Scratch:
// dcum_row and dcum_col (b, nc, q, h), elast (b, nc, h, ceil(q / 64)),
// dc_head and db_head (b, s, h, n), fp32.  Outputs, contiguous: dx
// (b, s, h, p) in x's dtype, ddt (b, s, h) and dcum (b, nc, q, h) fp32, dB
// and dC (b, s, [h,] n) in B's dtype.  dtype codes: 0 float32, 1 bfloat16.
extern "C" int tardis_ssd_chunk_backward(
    const void* x, long long xsb, long long xst, long long xsh,
    const void* dt, long long dsb, long long dst, const void* cum,
    const void* B, const void* C, long long bsb, long long bst,
    long long bsh, const void* dy, const void* dS, int b, int s, int nc,
    int q, int h, int p, int n, int shared, int x_dtype, int bc_dtype,
    void* dcum_row, void* dcum_col, void* elast, void* dc_head,
    void* db_head, void* dx, void* ddt, void* dcum, void* dB, void* dC,
    void* stream) {
  if (b == 0 || nc == 0 || h == 0) return (int)cudaGetLastError();
  if (q <= 0 || q > k12::kMaxQ || p <= 0 || p > k12::kMaxPN || n <= 0 ||
      n > k12::kMaxPN || nc * q < s)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0) return k12_for_x<float>(K12_ARGS);
  if (x_dtype == 1) return k12_bf16_x(K12_ARGS);
  return (int)cudaErrorInvalidValue;
}
