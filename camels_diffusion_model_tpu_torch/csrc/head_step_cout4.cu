// K1's kernels at 4 output channels a CTA (head_step.cuh), compiled beside
// head_step.cu; its C entries launch them where cout takes groups of 4.

#include "head_step.cuh"

template struct HeadStep<4>;
