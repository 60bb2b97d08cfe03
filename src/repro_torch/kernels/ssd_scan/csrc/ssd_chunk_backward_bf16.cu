// K12 ssd_chunk_backward for a bf16 x: the kernels of
// include/ssd_chunk_backward.cuh instantiated in their own nvcc
// process, beside ssd_chunk_backward.cu's fp32-x instances.
#include "ssd_chunk_backward.cuh"

int k12_bf16_x(K12_PARAMS) { return k12_for_x<__nv_bfloat16>(K12_ARGS); }
