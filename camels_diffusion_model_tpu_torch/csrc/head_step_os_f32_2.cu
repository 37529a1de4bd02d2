// K1's output-stationary kernel (head_step.cuh, head_step_os_kernel), fp32 at 2-7
// channels a CTA,
// compiled beside head_step.cu, whose C entries launch it at several output
// channels.

#include "head_step.cuh"

template struct HeadStepOs<float, 2>;
template struct HeadStepOs<float, 3>;
template struct HeadStepOs<float, 4>;
template struct HeadStepOs<float, 5>;
template struct HeadStepOs<float, 6>;
template struct HeadStepOs<float, 7>;
