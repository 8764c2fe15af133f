// Kernel K5 at head_dim 256 (the Gemma family): flash_bwd_dkv.cu's bodies
// instantiated at 256 only, built as a library of its own so that nvcc
// compiles it beside the other head dims, in parallel, rather than after
// them in one translation unit. ops/kernels/flash_attention.py loads it for
// head_dim 256. Everything else is flash_bwd_dkv.cu's.
#define PT_BWD_HEAD_DIM_256
#include "flash_bwd_dkv.cu"
