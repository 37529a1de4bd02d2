// Output conv + classifier-free-guidance combine + reverse-diffusion step
// (K1).
//
// Replaces camels_diffusion_model_tpu/ops/pallas/sampler_step.py ::
// fused_p_sample_step (Pallas TPU kernel, body :25-30, pallas_call :60), and
// takes over the decoder's last layer (out_conv2, a 3x3 conv from C channels
// to 1: context_unet.py:314), the CFG combine of diffusion/sampler.py:137-141
// and the strided "beta" update of diffusion/ddim.py:100-106:
//
//   eps[s](y, x) = bias + sum_{ky, kx, c} W[c, ky, kx] * h[s, y+ky-1, x+kx-1, c]
//                  (zero padding)
//   eps  = tanh_out ? tanhf(eps) : eps                 (deep/big variants,
//                                                      context_unet.py:315-316)
//   e    = cfg ? eps_u + w * (eps_c - eps_u) : eps    (w scalar or per sample)
//   out  = (x - c_eps * e) * inv_sqrt_a + sigma * z    (z skipped when null)
//
// h is out_norm's NHWC output, (2B, H, W, C) stacked [cond; uncond] under
// CFG or (B, H, W, C); eps never goes to device memory.
//
// Bound on the H100: bytes at 3.35 TB/s.  h is 99% of them (67 MB at the
// w=2 serving batch) and takes 2 flops a float, far below the ridge point.
// Design:
//  - A CTA owns a band of `rows` output rows of one unit: the sample pair
//    (b, b+B) under CFG, so the combine and the step happen in its
//    epilogue, or one sample.  ops/sampler_step.py::launch_plan picks the
//    band height per batch (the tallest, least halo, that still gives a
//    CTA to each of the 132 SMs) and the chunk width (the one that keeps
//    the most CTAs resident).
//  - The band's rows + 2 halo rows of h are staged through a ring of
//    shared-memory stages, one chunk of CK channels at a time, with 16-byte
//    cp.async copies (8 threads cover one pixel's 128 contiguous bytes at
//    CK = 32).  Halo rows outside the map are zero-filled by the copy
//    itself (source size 0), which gives the conv's padding rows.  The next
//    chunk's copies are in flight while the current one is reduced.
//  - Each thread holds two tile rows (the cond and uncond pixel under CFG,
//    two pixels of the sample otherwise) and reduces their CK channels
//    into the 9 per-tap partial sums P[tap] = sum_c W[c, tap] * h[c] in
//    registers.  A staged pixel is CK + 4 or CK + 8 floats apart (an odd
//    number of 16-byte slots), so the 8 threads of a 16-byte shared-memory
//    phase, each on its own pixel, hit 8 different bank groups.  The
//    weights sit in shared memory tap-major, read as broadcast float4.
//  - After the last chunk the partials go to shared memory and each output
//    pixel gathers its 3x3 neighbourhood from them: h is read once per CTA
//    and reduced once per pixel, with no shuffles.  x and z are requested
//    before the first chunk, so their latency passes under the reduction.
//  - The halo rows (2 of every rows + 2: a third of what a CTA reads at
//    the w=2 band of 4 rows) are read again by the neighbouring band's CTA,
//    which the grid order starts at about the same time, so they should
//    come from L2; the hit rate is not measured.
//  - The per-sample w is read once per CTA (no division per element).
//
// Halo rows (a height shard of a spatial mesh, where out_conv2's window
// reads one row beyond the shard on each side; XLA's SPMD partitioner
// exchanges them in JAX): the HALO template argument.  halo is (2, units'
// samples, width, c) of h's type: [0] the row above this shard's first,
// [1] the row below its last, for every sample h holds.  A band's halo row
// -1 or `height` is then copied from it instead of zero-filled; a copy's
// offset into it is encoded as -2 - offset, so the copies keep one int
// each.  HALO false is the unsharded kernel as it was.
//
// The feature type T is float or bf16 (h, the (9, c) weights and the bias;
// the bf16 model's out_conv2, context_unet.py:314, casts its fp32 kernel
// and bias to bf16 as blocks.py:122 does).  Products of bf16 values are
// exact in fp32 and sum in fp32; eps is the conv plus bias rounded to T per
// branch, its tanh rounded to T, and the guidance combine rounds each of its
// three operations to T with w rounded to T (sampler.py:137-141).  The step
// is fp32: x, z and out are float whatever T (sampler.py:264-276 casts eps
// to x's type).  A 16-byte copy stages 4 float or 8 bf16 channels; the
// chunk's bytes, and so the plan, are the same at twice the channels.

#include <cuda_runtime.h>

#include "pack.cuh"

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  int bytes = valid ? 16 : 0;  // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Grid: unit major, band minor.  Block: T threads; tile row k < 2T holds,
// under CFG, pixel k % T (T = (rows+2)*width) of sample unit + (k/T)*batch,
// otherwise pixel k (T = (rows+2)*width/2) of sample unit; a pixel p of the
// band is at global row y0 - 1 + p / width.  Dynamic shared memory: the
// weights [9][c] as floats, then STAGES stages of [2T][STRIDE] elements of
// E; the partials [9][2T] (floats) reuse the ring at the end.
template <typename E, int CK, int STAGES, bool HALO>
__global__ void head_step_kernel(
    const E* __restrict__ h, const E* __restrict__ halo, const E* __restrict__ wt,
    const E* __restrict__ bias, const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ w_per_sample,
    float w, float* __restrict__ out, int batch, int height, int width, int c,
    int rows, int cfg, float c_eps, float inv_sqrt_a, float sigma, int tanh_out) {
  constexpr int L = kVec<E>;  // elements per 16-byte copy
  constexpr int V = CK / L;   // 16-byte copies per pixel and chunk
  constexpr int STRIDE = L * (V + (V % 2 == 0 ? 1 : 2));  // elements per staged pixel
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  E* ring = reinterpret_cast<E*>(ws + 9 * c);
  const int T = blockDim.x, tid = threadIdx.x;
  const int bands = (height + rows - 1) / rows;
  const int unit = blockIdx.x / bands;
  const int y0 = (blockIdx.x - unit * bands) * rows;
  const int stage_elems = 2 * T * STRIDE;
  const int chunks = c / CK;

  for (int i = tid; i < 9 * c; i += T) ws[i] = to_float(wt[i]);

  // This thread's copies: the offset (in elements from h) of each one's
  // 16 bytes in chunk 0, -1 for a halo row outside the map.  Only the chunk
  // offset changes from chunk to chunk, so no copy divides again.
  int src[2 * V];
#pragma unroll
  for (int m = 0; m < 2 * V; ++m) {
    const int k = (tid + m * T) / V, j = (tid + m * T) % V;
    const int half = k >= T;
    const int sample = cfg ? unit + half * batch : unit;
    const int pix = cfg ? k - half * T : k;
    const int lr = pix / width;
    const int gy = y0 - 1 + lr;
    src[m] = gy >= 0 && gy < height
                 ? ((sample * height + gy) * width + (pix - lr * width)) * c + j * L
                 : -1;
    if constexpr (HALO) {
      const int nd = cfg ? 2 * batch : batch;  // samples of h (and of halo)
      if (gy == -1 || gy == height)
        src[m] = -2 - (((gy == height) * nd + sample) * width + (pix - lr * width)) * c -
                 j * L;
    }
  }
  auto issue = [&](int chunk) {
    E* st = ring + (chunk % STAGES) * stage_elems;
#pragma unroll
    for (int m = 0; m < 2 * V; ++m) {
      const int i = tid + m * T;
      if constexpr (HALO) {
        const E* from = src[m] >= 0    ? h + src[m] + chunk * CK
                        : src[m] < -1 ? halo + (-2 - src[m]) + chunk * CK
                                      : h;
        cp_async16(st + (i / V) * STRIDE + (i % V) * L, from, src[m] != -1);
      } else {
        cp_async16(st + (i / V) * STRIDE + (i % V) * L,
                   src[m] >= 0 ? h + src[m] + chunk * CK : h, src[m] >= 0);
      }
    }
  };

  // The step's inputs of this thread's first output pixel, requested now
  // so that their latency passes under the reduction.
  const float b0 = to_float(*bias);
  const float wu = round_to<E>(cfg ? (w_per_sample ? w_per_sample[unit] : w) : 0.0f);
  const int outs = min(rows, height - y0) * width;
  const long long first = (long long)unit * height * width + (long long)y0 * width + tid;
  float x_first = 0.0f, z_first = 0.0f;
  if (tid < outs) {
    x_first = x[first];
    if (z) z_first = z[first];
  }

  float acc0[9], acc1[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc0[t] = acc1[t] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) issue(s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait<STAGES - 2>();  // this chunk's copies have landed
    __syncthreads();              // ... for every thread; the stage refilled
                                  // next was reduced by all in the last pass
    if (chunk + STAGES - 1 < chunks) issue(chunk + STAGES - 1);
    cp_async_commit();
    const E* st = ring + (chunk % STAGES) * stage_elems;
    const E* a = st + tid * STRIDE;
    const E* b = st + (tid + T) * STRIDE;
    const float* wc = ws + chunk * CK;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const Pack<L> d0 = load<L>(a + L * j);
      const Pack<L> d1 = load<L>(b + L * j);
#pragma unroll
      for (int q = 0; q < L / 4; ++q) {
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float4 wv = *reinterpret_cast<const float4*>(wc + t * c + L * j + 4 * q);
          acc0[t] = fmaf(d0.v[4 * q], wv.x, acc0[t]);
          acc0[t] = fmaf(d0.v[4 * q + 1], wv.y, acc0[t]);
          acc0[t] = fmaf(d0.v[4 * q + 2], wv.z, acc0[t]);
          acc0[t] = fmaf(d0.v[4 * q + 3], wv.w, acc0[t]);
          acc1[t] = fmaf(d1.v[4 * q], wv.x, acc1[t]);
          acc1[t] = fmaf(d1.v[4 * q + 1], wv.y, acc1[t]);
          acc1[t] = fmaf(d1.v[4 * q + 2], wv.z, acc1[t]);
          acc1[t] = fmaf(d1.v[4 * q + 3], wv.w, acc1[t]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring

  float* part = reinterpret_cast<float*>(ring);  // [9][2T]
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    part[t * 2 * T + tid] = acc0[t];
    part[t * 2 * T + tid + T] = acc1[t];
  }
  __syncthreads();

  for (int o = tid; o < outs; o += T) {
    const int r = o / width, xx = o - r * width;
    float e[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* ps = part + s * T;  // under CFG the uncond pixels start at T
      float sum = b0;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* prow = ps + (r + ky) * width;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int gx = xx + kx - 1;
          if (gx >= 0 && gx < width) sum += prow[(ky * 3 + kx) * 2 * T + gx];
        }
      }
      // Full-precision tanhf (not tanh.approx.f32): the step scales eps by
      // c_eps, and the variants' eps is the model's output.
      sum = round_to<E>(sum);
      e[s] = tanh_out ? round_to<E>(tanhf(sum)) : sum;
      if (!cfg) break;
    }
    const float ee =
        cfg ? round_to<E>(e[1] + round_to<E>(wu * round_to<E>(e[0] - e[1]))) : e[0];
    const long long idx = first + (o - tid);
    float v = ((o == tid ? x_first : x[idx]) - ee * c_eps) * inv_sqrt_a;
    if (z) v += sigma * (o == tid ? z_first : z[idx]);
    out[idx] = v;
  }
}

template <typename E, int CK, int STAGES, bool HALO>
cudaError_t launch(dim3 grid, int threads, int smem_bytes, cudaStream_t stream,
                   const E* h, const E* halo, const E* wt, const E* bias,
                   const float* x, const float* z, const float* w_per_sample,
                   float w, float* out, int batch, int height, int width, int c,
                   int rows, int cfg, float c_eps, float inv_sqrt_a, float sigma,
                   int tanh_out) {
  cudaError_t err = cudaSuccess;
  if (smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(head_step_kernel<E, CK, STAGES, HALO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    head_step_kernel<E, CK, STAGES, HALO><<<grid, threads, smem_bytes, stream>>>(
        h, halo, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, rows,
        cfg, c_eps, inv_sqrt_a, sigma, tanh_out);
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ck: channels per staged chunk, 128, 64, 32 or 16 bytes of them.
template <typename E, bool HALO>
int entry(const E* h, const E* halo, const E* wt, const E* bias, const float* x,
          const float* z,
          const float* w_per_sample, float w, float* out, int batch, int height,
          int width, int c, int rows, int cfg, int ck, int stages, int threads,
          int smem_bytes, float c_eps, float inv_sqrt_a, float sigma, int tanh_out,
          void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  dim3 grid((unsigned)(batch * ((height + rows - 1) / rows)));
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int K = 32 / (int)sizeof(E);  // channels of 32 bytes
#define CAMELS_HEAD_STEP(CK, STAGES)                                                 \
  if (ck == CK && stages == STAGES)                                                  \
    return (int)launch<E, CK, STAGES, HALO>(grid, threads, smem_bytes, st, h, halo,  \
                                            wt, bias, x, z, w_per_sample, w, out,    \
                                            batch, height, width, c, rows, cfg,      \
                                            c_eps, inv_sqrt_a, sigma, tanh_out);
  CAMELS_HEAD_STEP(4 * K, 2)
  CAMELS_HEAD_STEP(4 * K, 3)
  CAMELS_HEAD_STEP(2 * K, 2)
  CAMELS_HEAD_STEP(2 * K, 3)
  CAMELS_HEAD_STEP(K, 2)
  CAMELS_HEAD_STEP(K, 3)
  CAMELS_HEAD_STEP(K / 2, 2)
  CAMELS_HEAD_STEP(K / 2, 3)
#undef CAMELS_HEAD_STEP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// h: (cfg ? 2 * batch : batch, height, width, c) NHWC of float
// (camels_head_step) or bf16 (camels_head_step_bf16), 16-byte aligned;
// wt: (9, c) tap-major weights (tap = ky * 3 + kx) and bias: one element,
// both of h's type; x, z, out: (batch, height, width) float; z null to skip
// the noise term; w_per_sample: null for the scalar w (floats); tanh_out: 1
// to take eps = tanh(conv).  rows, ck, stages, threads and smem_bytes come
// from ops/sampler_step.py::launch_plan.  Returns the cudaError_t of the
// launch.
#define CAMELS_HEAD_STEP_ENTRY(NAME, E)                                              \
  extern "C" int NAME(const E* h, const E* wt, const E* bias, const float* x,       \
                      const float* z, const float* w_per_sample, float w,           \
                      float* out, int batch, int height, int width, int c,          \
                      int rows, int cfg, int ck, int stages, int threads,           \
                      int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,   \
                      int tanh_out, void* stream) {                                 \
    return entry<E, false>(h, nullptr, wt, bias, x, z, w_per_sample, w, out, batch, \
                           height, width, c, rows, cfg, ck, stages, threads,        \
                           smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream); \
  }
CAMELS_HEAD_STEP_ENTRY(camels_head_step, float)
CAMELS_HEAD_STEP_ENTRY(camels_head_step_bf16, bf16)
#undef CAMELS_HEAD_STEP_ENTRY

// The halo mode: the arguments above with halo, (2, cfg ? 2 * batch :
// batch, width, c) of h's type, after h.
#define CAMELS_HEAD_STEP_HALO_ENTRY(NAME, E)                                         \
  extern "C" int NAME(const E* h, const E* halo, const E* wt, const E* bias,        \
                      const float* x, const float* z, const float* w_per_sample,    \
                      float w, float* out, int batch, int height, int width, int c, \
                      int rows, int cfg, int ck, int stages, int threads,           \
                      int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,   \
                      int tanh_out, void* stream) {                                 \
    return entry<E, true>(h, halo, wt, bias, x, z, w_per_sample, w, out, batch,     \
                          height, width, c, rows, cfg, ck, stages, threads,         \
                          smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream);  \
  }
CAMELS_HEAD_STEP_HALO_ENTRY(camels_head_step_halo, float)
CAMELS_HEAD_STEP_HALO_ENTRY(camels_head_step_halo_bf16, bf16)
#undef CAMELS_HEAD_STEP_HALO_ENTRY
