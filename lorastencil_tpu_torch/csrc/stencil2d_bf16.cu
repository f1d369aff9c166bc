// The bfloat16 instances of csrc/stencil2d.cu's kernels (the *_bf16 entries:
// the bf16 state tier of TPU kernels #1-#3), compiled as a library of their
// own so that its build runs beside the float32 / float64 one: the same
// source with LS_STENCIL2D_BF16 defined, which keeps only the bf16 entries
// (and so instantiates only the bf16 templates).
#define LS_STENCIL2D_BF16
#include "stencil2d.cu"
