// K1's output-stationary kernel (head_step.cuh, head_step_os_kernel), fp32 at 8-12
// channels a CTA,
// compiled beside head_step.cu, whose C entries launch it at several output
// channels.

#include "head_step.cuh"

template struct HeadStepOs<float, 8>;
template struct HeadStepOs<float, 9>;
template struct HeadStepOs<float, 10>;
template struct HeadStepOs<float, 11>;
template struct HeadStepOs<float, 12>;
