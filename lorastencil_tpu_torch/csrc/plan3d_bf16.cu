// The bfloat16 instances of csrc/plan3d.cu's plan march kernel (the
// ls_stencil3d_plan_march_bf16 entry: the bf16 state tier of TPU kernel #8),
// compiled as a library of their own so that its build runs beside the
// float32 / float64 one: the same source with LS_PLAN3D_BF16 defined, which
// keeps only the bf16 entry (and so instantiates only the bf16 templates).
#define LS_PLAN3D_BF16
#include "plan3d.cu"
