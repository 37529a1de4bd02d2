// K1's output-stationary kernel (head_step.cuh, head_step_os_kernel), fp32 at 13-16
// channels a CTA,
// compiled beside head_step.cu, whose C entries launch it at several output
// channels.

#include "head_step.cuh"

template struct HeadStepOs<float, 13>;
template struct HeadStepOs<float, 14>;
template struct HeadStepOs<float, 15>;
template struct HeadStepOs<float, 16>;
