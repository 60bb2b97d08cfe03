// K12 ssd_chunk_backward, variant "tf32x3" (the design is described in
// include/ssd_chunk_backward_tf32.cuh): the fp32-x instances of its main
// kernel, the finishing kernel and the C entry point.  The bf16-x
// instances build in their own nvcc process
// (ssd_chunk_backward_tf32_bf16.cu).
//
// There is no TPU backward to replace: the JAX package differentiates
// src/repro/kernels/ssd_scan/ops.py's jnp path with autodiff; the closed
// form is ssd_chunk_backward.cu's (its SIMT kernels stay for the shapes
// this variant does not take).
#include "ssd_chunk_backward_tf32.cuh"

// the main kernel for a bf16 x (ssd_chunk_backward_tf32_bf16.cu)
int k12t_bf16_x(const k12t::Args& a, int bc_dtype, cudaStream_t st);

namespace {

// dcum = its row parts from the j-blocks at or before the row's block (in
// block order) + its column part (+ the blocks' dcum_last shares, in block
// order, at the last position); dB and dC = the groups' partials in group
// order (dC's from the j-blocks at or before the row's, in block order),
// cast to B's dtype -- over the groups where one group of B / C serves
// every head, else the head's own
template <typename TBC>
__global__ void ssd_bwd_tf32_finish(const k12t::Args a, int shared,
                                    float* __restrict__ dcum, TBC* __restrict__ dB,
                                    TBC* __restrict__ dC) {
  const int q = a.q, h = a.h, n = a.n, nblk = q / k12t::kT;
  const long long n_cum = static_cast<long long>(a.b) * a.nc * q * h;
  const long long heads = shared ? 1 : h;
  const long long n_bc = static_cast<long long>(a.b) * a.s * heads * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  for (long long o = first; o < n_cum; o += stride) {
    const long long bc = o / (static_cast<long long>(q) * h);
    const int rem = static_cast<int>(o - bc * q * h);
    const int i = rem / h, hh = rem - i * h;
    float v = 0.f;
    for (int J = 0; J <= i / k12t::kT; ++J)
      v += a.rowp[((bc * nblk + J) * q + i) * h + hh];
    v += a.colp[o];
    if (i == q - 1)
      for (int J = 0; J < nblk; ++J) v += a.elast[(bc * h + hh) * nblk + J];
    dcum[o] = v;
  }
  for (long long o = first; o < n_bc; o += stride) {
    const int nn = static_cast<int>(o % n);
    const long long row = o / n;           // (bi, t[, head])
    const int hg = static_cast<int>(row % heads);
    const long long bt = row / heads;
    const int t = static_cast<int>(bt % a.s), bi = static_cast<int>(bt / a.s);
    const int c = t / q, i = t - c * q;
    const long long bc = static_cast<long long>(bi) * a.nc + c;
    const int g0 = shared ? 0 : hg, g1 = shared ? a.groups : hg + 1;
    float sb = 0.f, sc = 0.f;
    for (int g = g0; g < g1; ++g) {
      const long long bg = bc * a.groups + g;
      sb += a.dbp[(bg * q + i) * n + nn];
      for (int J = 0; J <= i / k12t::kT; ++J)
        sc += a.dcp[((bg * nblk + J) * q + i) * n + nn];
    }
    dB[o] = from_f32<TBC>(sb);
    dC[o] = from_f32<TBC>(sc);
  }
}

}  // namespace

// x (b, s, h, p) at strides (xsb, xst, xsh); dt (b, s, h) at (dsb, dst);
// cum (b, nc, q, h) fp32 contiguous; B and C (b, s, [h,] n) at (bsb, bst,
// bsh), shared = 1 (and bsh = 0) where one group serves every head; dy
// (b, nc, q, h, p) and dS (b, nc, h, p, n) fp32 contiguous.  q a multiple
// of 64 up to 256, p <= 64 and n <= 128 multiples of 16; heads_per_cta
// heads a CTA (1 unless shared).  Scratch (fp32): rowp (b, nc, q / 64, q,
// h), colp (b, nc, q, h), elast (b, nc, h, q / 64), dcp (b, nc, groups,
// q / 64, q, n), dbp (b, nc, groups, q, n) with groups = ceil(h /
// heads_per_cta).  Outputs, contiguous: dx (b, s, h, p) in x's dtype, ddt
// (b, s, h) and dcum (b, nc, q, h) fp32, dB and dC (b, s, [h,] n) in B's
// dtype.  dtype codes: 0 float32, 1 bfloat16.
extern "C" int tardis_ssd_chunk_backward_tf32(
    const void* x, long long xsb, long long xst, long long xsh,
    const void* dt, long long dsb, long long dst, const void* cum,
    const void* B, const void* C, long long bsb, long long bst,
    long long bsh, const void* dy, const void* dS, int b, int s, int nc,
    int q, int h, int p, int n, int shared, int x_dtype, int bc_dtype,
    int heads_per_cta, void* rowp, void* colp, void* elast, void* dcp,
    void* dbp, void* dx, void* ddt, void* dcum, void* dB, void* dC,
    void* stream) {
  if (b == 0 || nc == 0 || h == 0) return (int)cudaGetLastError();
  if (q % k12t::kT || q > 256 || p <= 0 || p % 16 || p > k12t::kP ||
      n <= 0 || n % 16 || n > 128 || nc * q < s || heads_per_cta <= 0 ||
      (!shared && heads_per_cta != 1) || (shared && bsh != 0) ||
      x_dtype < 0 || x_dtype > 1 || bc_dtype < 0 || bc_dtype > 1)
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  k12t::Args a{};
  a.x = x;
  a.xsb = xsb;
  a.xst = xst;
  a.xsh = xsh;
  a.dt = static_cast<const float*>(dt);
  a.dsb = dsb;
  a.dst = dst;
  a.cum = static_cast<const float*>(cum);
  a.B = B;
  a.C = C;
  a.bsb = bsb;
  a.bst = bst;
  a.bsh = bsh;
  a.dy = static_cast<const float*>(dy);
  a.dS = static_cast<const float*>(dS);
  a.b = b;
  a.s = s;
  a.nc = nc;
  a.q = q;
  a.h = h;
  a.p = p;
  a.n = n;
  a.hpc = heads_per_cta;
  a.groups = (h + heads_per_cta - 1) / heads_per_cta;
  a.x_vec = x_dtype == 0 && (xsb | xst | xsh) % 4 == 0 && aligned(x);
  a.bc_vec = bc_dtype == 0 && (bsb | bst | bsh) % 4 == 0 && aligned(B) &&
             aligned(C);
  a.dy_vec = aligned(dy) && aligned(dS);
  a.rowp = static_cast<float*>(rowp);
  a.colp = static_cast<float*>(colp);
  a.elast = static_cast<float*>(elast);
  a.dcp = static_cast<float*>(dcp);
  a.dbp = static_cast<float*>(dbp);
  a.dx = dx;
  a.ddt = static_cast<float*>(ddt);
  cudaStream_t st = (cudaStream_t)stream;
  int e = x_dtype == 0 ? k12t_for_x<float>(a, bc_dtype, st)
                       : k12t_bf16_x(a, bc_dtype, st);
  if (e) return e;
  const long long n_cum = static_cast<long long>(b) * nc * q * h;
  const long long n_bc = static_cast<long long>(b) * s * (shared ? 1 : h) * n;
  const long long most = n_cum > n_bc ? n_cum : n_bc;
  const int blocks = static_cast<int>(
      (most + 255) / 256 < 4096 ? (most + 255) / 256 : 4096);
  if (bc_dtype == 0)
    ssd_bwd_tf32_finish<float><<<blocks, 256, 0, st>>>(
        a, shared, static_cast<float*>(dcum), static_cast<float*>(dB),
        static_cast<float*>(dC));
  else
    ssd_bwd_tf32_finish<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        a, shared, static_cast<float*>(dcum),
        static_cast<__nv_bfloat16*>(dB), static_cast<__nv_bfloat16*>(dC));
  return (int)cudaGetLastError();
}
