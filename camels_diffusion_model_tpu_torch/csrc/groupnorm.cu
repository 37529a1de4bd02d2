// GroupNorm + affine + activation over NHWC (K2).
//
// Replaces camels_diffusion_model_tpu/ops/pallas/groupnorm.py ::
// fused_groupnorm_act (Pallas TPU kernel, body _make_kernel :33-59,
// pallas_call :89), which GroupNormAct uses at up0_norm and out_norm
// (models/blocks.py:315-321).  It is held against the two-pass XLA path
// (blocks.py:322-330): fp32 statistics, mean first and then the centred
// variance, not the Pallas kernel's E[x^2] - E[x]^2 (a Mosaic workaround).
//
//   y = (x - mean_g) * rsqrt(var_g + eps) * gamma_c + beta_c;  out = act(y)
//   act: 0 none, 1 relu, 2 erf-gelu, 3 leaky_relu(0.2)
//
// Bound on the H100: bytes at 3.35 TB/s (about ten flops per element).
// Design: one block per (sample, group), so the statistics need no second
// launch and no atomics.  The block walks its group three times (sum, centred
// sum of squares, normalise-and-write); a group is 32 KB (up0_norm) to 256 KB
// (out_norm), so the second and third reads come mostly from L2, and device
// memory sees about one read and one write.  Neighbouring threads take
// neighbouring channels of one pixel, then the next pixel: the cg channels of
// a group are contiguous in NHWC.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ float block_sum(float v, float* shared) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // shared may still be read from a previous call
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? shared[threadIdx.x] : 0.0f;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) shared[0] = v;
  }
  __syncthreads();
  return shared[0];
}

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case 1: return fmaxf(y, 0.0f);
    case 2: return 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
    case 3: return y > 0.0f ? y : 0.2f * y;
    default: return y;
  }
}

__global__ void groupnorm_act_kernel(const float* __restrict__ x,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     float* __restrict__ out, int hw, int c,
                                     int groups, float eps, int act) {
  __shared__ float shared[32];
  const int cg = c / groups;
  const int n = blockIdx.x / groups, g = blockIdx.x % groups;
  const long long base = (long long)n * hw * c + (long long)g * cg;
  const int count = hw * cg;

  float s = 0.0f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    int p = i / cg, j = i - p * cg;
    s += x[base + (long long)p * c + j];
  }
  const float mean = block_sum(s, shared) / (float)count;

  float q = 0.0f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    int p = i / cg, j = i - p * cg;
    float d = x[base + (long long)p * c + j] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, shared) / (float)count + eps);

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    int p = i / cg, j = i - p * cg;
    long long k = base + (long long)p * c + j;
    int ch = g * cg + j;
    float y = (x[k] - mean) * rstd * gamma[ch] + beta[ch];
    out[k] = activate(y, act);
  }
}

}  // namespace

// x/out: (n, hw, c) contiguous NHWC; gamma/beta: (c,).  c % groups == 0.
// Returns the cudaError_t of the launch.
extern "C" int camels_groupnorm_act(const float* x, const float* gamma,
                                    const float* beta, float* out, int n,
                                    int hw, int c, int groups, float eps,
                                    int act, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  groupnorm_act_kernel<<<n * groups, kThreads, 0, (cudaStream_t)stream>>>(
      x, gamma, beta, out, hw, c, groups, eps, act);
  return (int)cudaGetLastError();
}
