// K1's output-stationary kernel (head_step.cuh, head_step_os_kernel), bf16 at 8 and 16
// channels a CTA (B's columns),
// compiled beside head_step.cu, whose C entries launch it at several output
// channels.

#include "head_step.cuh"

template struct HeadStepOs<bf16, 8>;
template struct HeadStepOs<bf16, 16>;
