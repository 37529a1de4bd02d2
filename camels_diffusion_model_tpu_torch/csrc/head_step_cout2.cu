// K1's kernels at 2 output channels a CTA (head_step.cuh), compiled beside
// head_step.cu; its C entries launch them where cout takes groups of 2.

#include "head_step.cuh"

template struct HeadStep<2>;
