// The bfloat16 instances of csrc/plan2d.cu's plan strip kernel (the
// ls_stencil2d_plan_strip_bf16 entry: the bf16 state tier of TPU kernel #1),
// compiled as a library of their own so that its build runs beside the
// float32 / float64 one: the same source with LS_PLAN2D_BF16 defined, which
// keeps only the bf16 entry (and so instantiates only the bf16 templates).
#define LS_PLAN2D_BF16
#include "plan2d.cu"
