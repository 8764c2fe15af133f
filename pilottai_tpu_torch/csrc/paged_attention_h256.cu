// Kernel K3 at head_dim 256 (the Gemma family): paged_attention.cu's
// kernels instantiated at 256 only, built as a library of its own so that
// nvcc compiles it beside the other head dims, in parallel, rather than
// after them in one translation unit. ops/kernels/paged_attention.py loads
// it for head_dim 256. Everything else is paged_attention.cu's.
#define PT_PAGED_HEAD_DIM_256
#include "paged_attention.cu"
