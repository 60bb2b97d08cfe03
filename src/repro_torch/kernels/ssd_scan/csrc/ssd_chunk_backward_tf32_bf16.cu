// K12 ssd_chunk_backward, variant "tf32x3", for a bf16 x: the main kernel
// of include/ssd_chunk_backward_tf32.cuh instantiated in its own nvcc
// process, beside ssd_chunk_backward_tf32.cu's fp32-x instances.
#include "ssd_chunk_backward_tf32.cuh"

int k12t_bf16_x(const k12t::Args& a, int bc_dtype, cudaStream_t st) {
  return k12t_for_x<__nv_bfloat16>(a, bc_dtype, st);
}
