// Output conv + classifier-free-guidance combine + reverse-diffusion step
// (K1).
//
// Replaces camels_diffusion_model_tpu/ops/pallas/sampler_step.py ::
// fused_p_sample_step (Pallas TPU kernel, body :25-30, pallas_call :60), and
// takes over the decoder's last layer (out_conv2, a 3x3 conv from C channels
// to the cout image channels: context_unet.py:314), the CFG combine of
// diffusion/sampler.py:137-141 and the strided "beta" update of
// diffusion/ddim.py:100-106, for each output channel o < cout:
//
//   eps[s](y, x, o) = bias[o] + sum_{ky, kx, c} W[o, c, ky, kx] * h[s, y+ky-1, x+kx-1, c]
//                     (zero padding)
//   eps  = tanh_out ? tanhf(eps) : eps                 (deep/big variants,
//                                                      context_unet.py:315-316)
//   e    = cfg ? eps_u + w * (eps_c - eps_u) : eps    (w scalar or per sample)
//   out  = (x - c_eps * e) * inv_sqrt_a + sigma * z    (z skipped when null)
//
// h is out_norm's NHWC output, (2B, H, W, C) stacked [cond; uncond] under
// CFG or (B, H, W, C); x, z and out are (B, H, W, cout); eps never goes to
// device memory.
//
// Output channels (cout = the model's in_channels: one for every committed
// model, several for a model of several CMD fields).  Every kernel below
// takes a template parameter COUT, the output channels one CTA computes
// (1-4), and reduces each staged value of h into all COUT channels' 9 taps,
// so h is read once for all of them (h is 99% of the bytes).  Where cout is
// over 4 the channels go in equal groups of COUT over the grid (group_size:
// ceil(cout / ceil(cout / 4))), the CTAs of one band's groups next to each
// other in the grid so that their reads of h meet in L2, and a last group's
// channels past cout are masked (zero weights, no store).  The weights are
// staged tap-major per channel, row o * 9 + tap of (cout * 9, c), so the
// taps of channel 0 are the rows a one-channel kernel stages.  At COUT = 1
// every kernel is the one-channel kernel it was: the same products, sums,
// roundings and launch bounds.  The instances of COUT = 1 are built in
// head_step.cu, those of 2, 3 and 4 each in a file of its own
// (head_step_cout<N>.cu), so that the build compiles them in parallel.
//
// Bound on the H100: bytes at 3.35 TB/s.  h is 99% of them (67 MB at the
// w=2 serving batch) and takes 2 * cout flops a float, far below the ridge
// point.
//
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
// exchanges them in JAX): the kernels of their own below take top and
// bottom, (units' samples, width, c) of h's type: the row above this
// shard's first and the row below its last, for every sample h holds, or
// null at the image's edge.  A band's halo row -1 or `height` is then
// copied from them instead of zero-filled (a null row stays zero-filled).
//
// The template (head_step_kernel) serves the float unsharded launch.  The bf16
// launches are head_step_bf16_kernel and head_step_bf16_halo_kernel below,
// at items of 64 channels or, where c is any other multiple of 8 (n_feat
// 8-56, 72, 96, 160, 264, ...), of 32, the last block masked past c (in
// bf16 the template's taps on CUDA cores did twice the arithmetic per
// staged byte, one CTA fit an SM, and the first chunk's copy was exposed),
// the float halo mode head_step_halo_f32_kernel (the template's halo mode
// ran one CTA an SM with a 2-stage ring and a block barrier per chunk),
// each with the same arithmetic and roundings.  Where their weights
// outgrow shared memory (c in the thousands) or h has 2^31 elements or
// more, the split launch below (head_step_*_split_kernel, then
// head_step_combine_kernel) takes the shape in either type and mode
// (ops/sampler_step.py::route).

// The feature type T is float or bf16 (h, the (9, c) weights and the bias;
// the bf16 model's out_conv2, context_unet.py:314, casts its fp32 kernel
// and bias to bf16 as blocks.py:122 does).  Products of bf16 values are
// exact in fp32 and sum in fp32; eps is the conv plus bias rounded to T per
// branch, its tanh rounded to T, and the guidance combine rounds each of its
// three operations to T with w rounded to T (sampler.py:137-141).  The step
// is fp32: x, z and out are float whatever T (sampler.py:264-276 casts eps
// to x's type).  A 16-byte copy stages 4 float or 8 bf16 channels; the
// chunk's bytes, and so the plan, are the same at twice the channels.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

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

// Where the staged pixels of a CTA's band come from, for the halo kernels
// that stage a band as a list of pixels (head_step_bf16_halo_kernel,
// head_step_halo_f32_kernel).  Band pixel p < m (m = branches * pb, pb =
// (rows + 2) * width) is pixel q = p % pb of branch s = p / pb (under CFG
// sample unit + s * batch, else sample unit); a branch's pixel q sits at
// global row y0 - 1 + q / width.  A branch's rows y0 - 1 .. y0 + rows are
// contiguous in h, and its rows -1 and `height` in the halo rows, so each
// source is a base plus q * c: no division per copy.  Rows inside the map
// (q_lo <= q < q_hi) read h; row -1 (q < q_lo, only in the first band)
// reads top and row `height` (q_hi <= q < qb_hi) bottom, each (cfg ? 2 *
// batch : batch, width, c) or null (zero) at the image's edge; every other
// pixel (beyond the band) is zero.
struct Band {
  int pb, m, q_lo, q_hi, qb_hi;
  int base0, base1, top0, top1, bottom0, bottom1;  // element offsets of a branch's pixel 0
};

__device__ __forceinline__ Band band_of(int unit, int batch, int height, int width, int c,
                                        int rows, int cfg, int y0) {
  Band b;
  b.pb = (rows + 2) * width;
  b.m = (cfg ? 2 : 1) * b.pb;
  b.q_lo = y0 == 0 ? width : 0;
  const int q_bottom = (height - y0 + 1) * width;  // row `height`'s first pixel
  b.q_hi = min(b.pb, q_bottom);
  b.qb_hi = min(b.pb, q_bottom + width);
  const int s1 = cfg ? unit + batch : unit;  // branch 1's sample (unused without CFG)
  b.base0 = ((unit * height + y0 - 1) * width) * c;
  b.base1 = cfg ? ((s1 * height + y0 - 1) * width) * c : 0;
  b.top0 = unit * width * c;
  b.top1 = s1 * width * c;
  b.bottom0 = (unit * width - q_bottom) * c;
  b.bottom1 = (s1 * width - q_bottom) * c;
  return b;
}

// Band pixel p's channel 0: element off of array where reads (else a zero
// pixel).
template <typename E>
struct Source {
  const E* array;
  int off;
  bool reads;
};

template <typename E>
__device__ __forceinline__ Source<E> band_source(const Band& b, const E* h, const E* top,
                                                 const E* bottom, int p, int c) {
  const int s = p >= b.pb, q = p - s * b.pb;
  if (p < b.m && q < b.q_lo) return Source<E>{top, (s ? b.top1 : b.top0) + q * c, top != nullptr};
  if (p < b.m && q >= b.q_hi && q < b.qb_hi)
    return Source<E>{bottom, (s ? b.bottom1 : b.bottom0) + q * c, bottom != nullptr};
  return Source<E>{h, (s ? b.base1 : b.base0) + q * c, p < b.m && q >= b.q_lo && q < b.q_hi};
}

// The output channels of a CTA: group grp of COUT channels, o0 = grp * COUT
// (the last group masked past cout), and its block index without the group.
// The groups of one band are neighbours in the grid (group minor).
struct OutGroup {
  int blk, o0;
};

template <int COUT>
__device__ __forceinline__ OutGroup out_group(int cout) {
  if constexpr (COUT == 1) {
    return OutGroup{(int)blockIdx.x, 0};
  } else {
    const int groups = (cout + COUT - 1) / COUT;
    const int blk = blockIdx.x / groups;
    return OutGroup{blk, ((int)blockIdx.x - blk * groups) * COUT};
  }
}

// Grid: (unit major, band minor) x output-channel group.  Block: T threads;
// tile row k < 2T holds, under CFG, pixel k % T (T = (rows+2)*width) of
// sample unit + (k/T)*batch, otherwise pixel k (T = (rows+2)*width/2) of
// sample unit; a pixel p of the band is at global row y0 - 1 + p / width.
// Dynamic shared memory: the weights [9 * COUT][c] as floats (row oc * 9 +
// tap), then STAGES stages of [2T][STRIDE] elements of E; the partials [9 *
// COUT][2T] (floats) reuse the ring at the end (ops/sampler_step.py::
// launch_plan sizes the ring to hold them).
template <typename E, int CK, int STAGES, int COUT>
__device__ __forceinline__ void head_step_body(
    const E* __restrict__ h, const E* __restrict__ wt, const E* __restrict__ bias,
    const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ w_per_sample,
    float w, float* __restrict__ out, int batch, int height, int width, int c, int cout,
    int rows, int cfg, float c_eps, float inv_sqrt_a, float sigma, int tanh_out) {
  constexpr int L = kVec<E>;  // elements per 16-byte copy
  constexpr int V = CK / L;   // 16-byte copies per pixel and chunk
  constexpr int STRIDE = L * (V + (V % 2 == 0 ? 1 : 2));  // elements per staged pixel
  constexpr int TAPS = 9 * COUT;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  E* ring = reinterpret_cast<E*>(ws + TAPS * c);
  const int T = blockDim.x, tid = threadIdx.x;
  const int bands = (height + rows - 1) / rows;
  const OutGroup og = out_group<COUT>(cout);
  const int co = COUT == 1 ? 1 : cout;  // x, z and out: channels a pixel
  const int unit = og.blk / bands;
  const int y0 = (og.blk - unit * bands) * rows;
  const int stage_elems = 2 * T * STRIDE;
  const int chunks = c / CK;

  if constexpr (COUT == 1) {
    for (int i = tid; i < 9 * c; i += T) ws[i] = to_float(wt[i]);
  } else {  // this group's rows, zero past cout
    const int live = min(TAPS, 9 * (cout - og.o0)) * c;
    for (int i = tid; i < TAPS * c; i += T)
      ws[i] = i < live ? to_float(wt[og.o0 * 9 * c + i]) : 0.0f;
  }

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
  }
  auto issue = [&](int chunk) {
    E* st = ring + (chunk % STAGES) * stage_elems;
#pragma unroll
    for (int m = 0; m < 2 * V; ++m) {
      const int i = tid + m * T;
      cp_async16(st + (i / V) * STRIDE + (i % V) * L,
                 src[m] >= 0 ? h + src[m] + chunk * CK : h, src[m] >= 0);
    }
  };

  // The step's inputs of this thread's first output pixel, requested now
  // so that their latency passes under the reduction.
  float b0[COUT];
#pragma unroll
  for (int oc = 0; oc < COUT; ++oc)
    b0[oc] = COUT == 1 || og.o0 + oc < cout ? to_float(bias[og.o0 + oc]) : 0.0f;
  const float wu = round_to<E>(cfg ? (w_per_sample ? w_per_sample[unit] : w) : 0.0f);
  const int outs = min(rows, height - y0) * width;
  const long long first = (long long)unit * height * width + (long long)y0 * width + tid;
  float x_first[COUT], z_first[COUT];
#pragma unroll
  for (int oc = 0; oc < COUT; ++oc) {
    x_first[oc] = z_first[oc] = 0.0f;
    if (tid < outs && (COUT == 1 || og.o0 + oc < cout)) {
      x_first[oc] = x[first * co + og.o0 + oc];
      if (z) z_first[oc] = z[first * co + og.o0 + oc];
    }
  }

  float acc0[TAPS], acc1[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) acc0[t] = acc1[t] = 0.0f;

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
        for (int t = 0; t < TAPS; ++t) {
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

  float* part = reinterpret_cast<float*>(ring);  // [TAPS][2T]
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    part[t * 2 * T + tid] = acc0[t];
    part[t * 2 * T + tid + T] = acc1[t];
  }
  __syncthreads();

  for (int o = tid; o < outs; o += T) {
    const int r = o / width, xx = o - r * width;
#pragma unroll
    for (int oc = 0; oc < COUT; ++oc) {
      if (COUT > 1 && og.o0 + oc >= cout) break;
      float e[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float* ps = part + oc * 9 * 2 * T + s * T;  // under CFG the uncond pixels start at T
        float sum = b0[oc];
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
      const long long idx = (first + (o - tid)) * co + og.o0 + oc;
      float v = ((o == tid ? x_first[oc] : x[idx]) - ee * c_eps) * inv_sqrt_a;
      if (z) v += sigma * (o == tid ? z_first[oc] : z[idx]);
      out[idx] = v;
    }
  }
}

// The one-channel kernel (no launch bound: at 32-channel chunks it holds up
// to 154 registers, and 384 threads still fit an SM's 64K).
template <typename E, int CK, int STAGES>
__global__ void head_step_kernel(
    const E* __restrict__ h, const E* __restrict__ wt, const E* __restrict__ bias,
    const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ w_per_sample,
    float w, float* __restrict__ out, int batch, int height, int width, int c, int cout,
    int rows, int cfg, float c_eps, float inv_sqrt_a, float sigma, int tanh_out) {
  head_step_body<E, CK, STAGES, 1>(h, wt, bias, x, z, w_per_sample, w, out, batch, height,
                                   width, c, cout, rows, cfg, c_eps, inv_sqrt_a, sigma,
                                   tanh_out);
}

// COUT > 1: 18 * COUT accumulators a thread, so a CTA is at most
// MULTI_THREADS (ops/sampler_step.py::MULTI_THREADS), at most 255 registers.
constexpr int MULTI_THREADS = 256;
template <typename E, int CK, int STAGES, int COUT>
__global__ void __launch_bounds__(MULTI_THREADS) head_step_cout_kernel(
    const E* __restrict__ h, const E* __restrict__ wt, const E* __restrict__ bias,
    const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ w_per_sample,
    float w, float* __restrict__ out, int batch, int height, int width, int c, int cout,
    int rows, int cfg, float c_eps, float inv_sqrt_a, float sigma, int tanh_out) {
  head_step_body<E, CK, STAGES, COUT>(h, wt, bias, x, z, w_per_sample, w, out, batch, height,
                                      width, c, cout, rows, cfg, c_eps, inv_sqrt_a, sigma,
                                      tanh_out);
}

// The kernel of COUT channels: head_step_kernel at one, else
// head_step_cout_kernel (each instantiated only where it runs).
template <typename E, int CK, int STAGES, int COUT>
auto template_kernel() {
  if constexpr (COUT == 1)
    return head_step_kernel<E, CK, STAGES>;
  else
    return head_step_cout_kernel<E, CK, STAGES, COUT>;
}

template <typename E, int CK, int STAGES, int COUT>
cudaError_t launch(dim3 grid, int threads, int smem_bytes, cudaStream_t stream,
                   const E* h, const E* wt, const E* bias,
                   const float* x, const float* z, const float* w_per_sample,
                   float w, float* out, int batch, int height, int width, int c, int cout,
                   int rows, int cfg, float c_eps, float inv_sqrt_a, float sigma,
                   int tanh_out) {
  const auto kernel = template_kernel<E, CK, STAGES, COUT>();
  cudaError_t err = cudaSuccess;
  if (COUT > 1 && threads > MULTI_THREADS) return cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
  if (err == cudaSuccess)
    kernel<<<grid, threads, smem_bytes, stream>>>(
        h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, cout,
        rows, cfg, c_eps, inv_sqrt_a, sigma, tanh_out);
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ck: channels per staged chunk, 128, 64, 32 or 16 bytes of them; stages 2
// or 3 (COUT > 1: 64 bytes at most and 2 stages, ops/sampler_step.py::
// launch_plan: their accumulators leave no registers for 128-byte chunks).
template <typename E, int COUT>
int entry(const E* h, const E* wt, const E* bias,
          const float* x,
          const float* z,
          const float* w_per_sample, float w, float* out, int batch, int height,
          int width, int c, int cout, int rows, int cfg, int ck, int stages, int threads,
          int smem_bytes, float c_eps, float inv_sqrt_a, float sigma, int tanh_out,
          void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  const int groups = (cout + COUT - 1) / COUT;
  dim3 grid((unsigned)(batch * ((height + rows - 1) / rows) * groups));
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int K = 32 / (int)sizeof(E);  // channels of 32 bytes
#define CAMELS_HEAD_STEP(CK, STAGES)                                                 \
  if (ck == CK && stages == STAGES)                                                  \
    return (int)launch<E, CK, STAGES, COUT>(grid, threads, smem_bytes, st, h, wt, bias, x, \
                                            z, w_per_sample, w, out, batch, height, width,  \
                                            c, cout, rows, cfg, c_eps, inv_sqrt_a, sigma,   \
                                            tanh_out);
  CAMELS_HEAD_STEP(2 * K, 2)
  CAMELS_HEAD_STEP(K, 2)
  CAMELS_HEAD_STEP(K / 2, 2)
  if constexpr (COUT == 1) {
    CAMELS_HEAD_STEP(4 * K, 2)
    CAMELS_HEAD_STEP(4 * K, 3)
    CAMELS_HEAD_STEP(2 * K, 3)
    CAMELS_HEAD_STEP(K, 3)
    CAMELS_HEAD_STEP(K / 2, 3)
  }
#undef CAMELS_HEAD_STEP
  return (int)cudaErrorInvalidValue;
}


// ---- The bf16 instance of the unsharded launch: the taps on tensor cores. ----
//
// The nine per-tap partials of a band are one product, P[pixel, tap] =
// sum_c h[pixel, c] * W[c, tap]: pixels by C, times C by 9 (padded to 16
// with zero taps), run with mma.sync m16n8k16 (bf16 in, fp32 sums).  Each
// warp streams its own 16-pixel tiles of the band (tiles w, w + 8, ... of
// each branch's rows + 2 halo rows), 64 channels an item, through a
// private ring of RING shared-memory slots (2 KiB each) filled by 16-byte
// cp.async copies (8 lanes a pixel's 128 bytes; rows outside the map and
// pixels past the band are zero-filled by the copy itself).  A warp
// waits only for its own copies (cp.async.wait_group, __syncwarp): no
// block barrier runs until the partials are done, and RING - 1 items a
// warp are in flight, the first issued before the weights are staged and the
// step's x and z are requested.  Lane (g, t) reads 16 bytes (channels
// 8t..8t+7 of a 32-channel half) of tile rows g and g + 8, and those 8
// channels fill its A fragment's four columns of two k-steps (the half's
// channels permuted; the weights' B fragments, read by the same 16-byte
// pattern from shared memory, are permuted alike, so the product is the
// same sum).  A pixel's 16-byte chunk q sits at slot q ^ 4 (p & 1), so a
// quarter warp's reads (2 pixels x 4 chunks) and writes (one pixel's 8
// chunks) hit 8 bank groups.  The warp keeps its tile's accumulators over
// the channel blocks and stores the partials after the last; then the 3x3
// gather epilogue runs as in the float kernel, with x and z of a thread's
// first OUTS output pixels requested in the prologue.  A band pixel's
// source offset is its run's base plus q * c (a branch's rows y0 - 1 ..
// y0 + rows are contiguous), so issuing a copy costs no division.
// ops/sampler_step.py::bf16_plan takes the shortest band whose grid is one
// wave of two CTAs an SM (4 rows at the w=2 serving shape, 256 CTAs), so
// one CTA's gather runs beside the other's copies.
//
// The halo mode (head_step_bf16_halo_kernel, a height shard's launch)
// copies a band's row -1 or `height` from the halo rows (band_source); the
// two launches share one body (bf16_step_body) and differ only in that copy
// map and their launch bounds: the same items, products, sums and
// roundings, so two shards' steps equal the unsharded launch's step on the
// whole map bit for bit (each pixel's partials are the same products
// summed in the same order, whichever band or tile holds it).
//
// The narrow item (c a multiple of 8 that no 64-channel item divides:
// n_feat 32, 96 and 160, and where c is not a multiple of 32, as 40 or
// 264, with a last channel block masked past c): both launches
// instantiate the same body at items of 32 pixels x 32 channels
// (bf16_step_body<NARROW_BLOCK>), two tiles of the wide item's fragments
// and sums, so the narrow halo mode too equals its unsharded launch bit
// for bit.  At c = 32 the fixed costs of
// a band (the weights' staging, the x and z prefetch, the 18-partial
// gather) weigh four times as much per byte of h as at c = 128: with no
// read of h at all the launch kept 69% of its time at n_feat 32, 16 maps,
// and without the halo rows' reads all of it (scripts/
// compare_torch_kernels.py --narrow on diagnostic copies), so the item
// spends its fixed instructions on 2 KiB, and the narrow path counts its
// items' tiles and channel blocks instead of dividing (the wide path's
// text is as it was).  Its ring is RING slots too: with items of 2 KiB 3
// slots ran faster than 4 and 6 at n_feat 32, 96 and 160.  The 64-channel
// instance's text is kept as it was (if constexpr), so its SASS does not
// change (68 registers, 2424 instructions; the halo mode 86, 2744).

// The split launch's epilogue (SPLIT in bf16_step_body and f32_step_body):
// each of the band's outs output pixels (o = tid, tid + threads, ...; the
// first at element `first` of the map's pixels) gets, per branch and output
// channel o0 + oc of the CTA's group, the sum of its 3x3 neighbourhood's
// per-tap partials (part: [9 * COUT][pstride], a branch's staged pixels pb
// apart) in the band kernels' gather order, no bias, stored to
// part_out[(s * cout + o0 + oc) * npix + pixel].
template <int COUT>
__device__ __forceinline__ void store_range_sums(const float* part, int pb, int pstride,
                                                 int width, int outs, int cfg, long long first,
                                                 int tid, int threads, float* part_out,
                                                 long long npix, int cout, int o0) {
  const int co = COUT == 1 ? 1 : cout;
  for (int o = tid; o < outs; o += threads) {
    const int r = o / width, xx = o - r * width;
#pragma unroll
    for (int oc = 0; oc < COUT; ++oc) {
      if (COUT > 1 && o0 + oc >= cout) break;
      for (int s = 0; s < (cfg ? 2 : 1); ++s) {
        const float* ps = part + oc * 9 * pstride + s * pb;
        float sum = 0.0f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float* prow = ps + (r + ky) * width;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int gx = xx + kx - 1;
            if (gx >= 0 && gx < width) sum += prow[(ky * 3 + kx) * pstride + gx];
          }
        }
        part_out[(s * co + o0 + oc) * npix + first + (o - tid)] = sum;
      }
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

constexpr int BF16_THREADS = 256;  // 8 warps
constexpr int TILE = 16, BLOCK = 64;  // an item: 16 pixels x 64 channels (2 KiB)
constexpr int NARROW_BLOCK = 32;  // the narrow item: 32 pixels x 32 channels (2 KiB)
constexpr int OUTS = 4;  // output pixels a thread's x and z are prefetched for
// Slots of a warp's ring: 3 let two CTAs share an SM, which ran faster at
// every path shape than one CTA with 4, 6 or 8 (scripts/
// compare_torch_kernels.py --dtype bfloat16).
constexpr int RING = 3;

// The body of both bf16 kernels, at items of IB channels (BLOCK, or
// NARROW_BLOCK where c is a multiple of 8 but not of 64).
// Grid: unit major, band minor (this
// CTA: unit, band rows y0 ..).  Block: BF16_THREADS.  Band pixel p < m (m =
// branches * pb, pb = (rows + 2) * width) is, under CFG, pixel p % pb of
// sample unit + (p / pb) * batch, else pixel p of sample unit; a branch's
// pixel q is at global row y0 - 1 + q / width.  source_of(p) is band pixel
// p's channel 0 (a Source<bf16>): the launch's own copy map.  Dynamic
// shared memory: the weights [16][wstride] bf16 (taps 9-15 zero; a row is
// 4 mod 8 16-byte slots, so a quarter warp's 2 taps x 4 chunks hit 8 bank
// groups), the warps' rings (8 x RING slots), then the partials
// [9][pstride] floats.
//
// The narrow item (IB = NARROW_BLOCK, c a multiple of 8 but not of 64:
// n_feat 32, 96 and 160, and 40, 264, ...): 32 pixels x 32 channels, the
// same 2 KiB as the wide item, two 16-pixel tiles of one 32-channel
// block: the same fragments, 8 MMAs
// an item, each tile's products summed as in the wide item, the weights'
// fragments read once for both tiles (items of one tile, half the bytes,
// paid the item's fixed instructions twice a byte).  Lane l copies chunk l
// & 3 of pixels l / 4 + 8i (a quarter warp's writes: two pixels' 64
// contiguous bytes) and lane (g, t) reads chunk t of rows g, g + 8, g + 16
// and g + 24 (a quarter warp: rows of one parity pair, 128 contiguous
// bytes), so no swizzle is needed; the weights' rows are
// weight_stride(cpad) apart, 4 mod 8 slots.  Where c is not a multiple of
// 32 (cpad = c rounded up to 32), the last block is masked: a 16-byte
// chunk (8 channels) lies wholly inside c or wholly past it, and a chunk
// past c is zero-filled by its copy (never read: it would be the next
// pixel's channels), as are the weights' rows past c, so the block's
// extra products are zeros and each pixel's fp32 partials are the sums of
// its c channels alone; the halo mode masks alike, and two shards still
// equal the unsharded launch bit for bit.
//
// SPLIT (head_step_bf16_split_kernel): c is the CTA's channel range, wt its
// first weight column and wrow the weights' row stride (the whole c); no
// step: each output pixel's per-branch sum of the 3x3 gather (no bias) goes
// to part_out (store_range_sums; head_step_combine_kernel sums the ranges).
//
// COUT output channels (o0 .. o0 + COUT - 1 of cout, masked past cout):
// the B operand is C x 9 * COUT, its columns oc * 9 + tap padded with zero
// columns to NT tiles of 8 (16 columns at one channel, as the one-channel
// kernel's taps 9-15; 24 at two, 32 at three, 40 at four), NT
// accumulators a tile of pixels: more MMAs and registers, no more bytes.
template <int IB, bool SPLIT, int COUT, typename SourceOf>
__device__ __forceinline__ void bf16_step_body(
    SourceOf source_of, int unit, int y0, int pb, int m, int cout, int o0,
    const bf16* __restrict__ h,
    const bf16* __restrict__ wt, const bf16* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out,
    int height, int width, int c, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out, int wrow = 0, float* __restrict__ part_out = nullptr,
    long long npix = 0) {
  constexpr int BLOCK = IB;  // the item's channels
  constexpr int IPX = TILE * 64 / BLOCK;  // an item's pixels: one tile, or the narrow item's two
  constexpr int SLOT = IPX * BLOCK;  // elements (2 KiB)
  constexpr int WARPS = BF16_THREADS / 32;
  constexpr int TAPS = 9 * COUT, NT = (TAPS + 7) / 8;  // B's columns and n8 tiles
  constexpr int PRE = COUT == 1 ? OUTS : 1;  // output pixels x and z are prefetched for
  extern __shared__ float4 smem4[];
  // The narrow item's channel blocks: the last one masked past c where c
  // is not a multiple of 32 (cpad channels in all).
  const int cpad = BLOCK == 64 ? c : (c + BLOCK - 1) / BLOCK * BLOCK;
  // ops/sampler_step.py::weight_stride(cpad): cpad + 32 at cpad % 64 == 0,
  // else cpad.
  const int wstride = BLOCK == 64 ? c + 32 : cpad % 64 == 0 ? cpad + 32 : cpad;
  bf16* ws = reinterpret_cast<bf16*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* ring = ws + 8 * NT * wstride + warp * RING * SLOT;  // this warp's
  const int tiles = (m + IPX - 1) / IPX;  // of an item's pixels
  const int pstride = (m + 31) / 32 * 32 + 4;  // 4 mod 32: a store's 4 taps, 4 banks apart
  float* part = reinterpret_cast<float*>(ws + 8 * NT * wstride + WARPS * RING * SLOT);
  const int cblocks = cpad / BLOCK;
  const int items = tiles > warp ? ((tiles - 1 - warp) / WARPS + 1) * cblocks : 0;

  // Item it of this warp: tile warp + (it / cblocks) * WARPS, channel block
  // it % cblocks; lane l copies chunk l & 7 of tile pixels l / 8 + 4i (the
  // narrow item: chunk l & 3 of its 32 pixels l / 4 + 8i).
  int ik = 0, icb = 0;  // the narrow item issued next: its tile and channel block
  auto issue = [&](int it) {
    bf16* dst = ring + (it % RING) * SLOT;
    if constexpr (BLOCK == 64) {
      const int k = it / cblocks, cb = it - k * cblocks;
      const int p0 = (warp + k * WARPS) * TILE, q = lane & 7;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pp = (lane >> 3) + 4 * i;
        const Source<bf16> src = source_of(p0 + pp);
        // One int offset, then the pointer: src.off + (cb * BLOCK + 8 * q)
        // cost the unsharded launch 32 SASS instructions and 4% at w=2.
        const int off = src.off + cb * BLOCK + 8 * q;
        cp_async16(dst + pp * BLOCK + 8 * (q ^ ((pp & 1) << 2)),
                   src.reads ? src.array + off : h, src.reads);
      }
    } else {  // items are issued in order
      const int p0 = (warp + ik * WARPS) * IPX, q = lane & 3;
      // A chunk past c (the last block's tail) is zero-filled: never the
      // next pixel's channels.
      const bool inside = icb * BLOCK + 8 * q < c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pp = (lane >> 2) + 8 * i;
        const Source<bf16> src = source_of(p0 + pp);
        const int off = src.off + icb * BLOCK + 8 * q;
        const bool reads = src.reads && inside;
        cp_async16(dst + pp * BLOCK + 8 * q, reads ? src.array + off : h, reads);
      }
      if (++icb == cblocks) icb = 0, ++ik;
    }
  };
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < items) issue(s);
    cp_async_commit();
  }

  const int wr = SPLIT ? wrow : c;  // the weights' row stride
  // B's live columns (this group's channels' taps) and their first row of wt.
  const int live = COUT == 1 ? 9 : min(TAPS, 9 * (cout - o0));
  const bf16* wg = wt + (COUT == 1 ? 0 : o0 * 9 * wr);
  if constexpr (BLOCK == 64) {
    for (int i = tid; i < 8 * NT * (c / 8); i += BF16_THREADS) {
      const int tap = i / (c / 8), q = i - tap * (c / 8);
      *reinterpret_cast<uint4*>(ws + tap * wstride + 8 * q) =
          tap < live ? *reinterpret_cast<const uint4*>(wg + tap * wr + 8 * q)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {  // rows of cpad channels, zero past c
    for (int i = tid; i < 8 * NT * (cpad / 8); i += BF16_THREADS) {
      const int tap = i / (cpad / 8), q = i - tap * (cpad / 8);
      *reinterpret_cast<uint4*>(ws + tap * wstride + 8 * q) =
          tap < live && 8 * q < c ? *reinterpret_cast<const uint4*>(wg + tap * wr + 8 * q)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // The step's inputs of this thread's first PRE output pixels.
  const int co = COUT == 1 ? 1 : cout;  // x, z and out: channels a pixel
  float b0[COUT];
#pragma unroll
  for (int oc = 0; oc < COUT; ++oc)
    b0[oc] = SPLIT || !(COUT == 1 || o0 + oc < cout) ? 0.0f : to_float(bias[o0 + oc]);
  const float wu =
      round_to<bf16>(cfg && !SPLIT ? (w_per_sample ? w_per_sample[unit] : w) : 0.0f);
  const int outs = min(rows, height - y0) * width;
  const long long first = (long long)unit * height * width + (long long)y0 * width + tid;
  float xs[PRE][COUT], zs[PRE][COUT];
#pragma unroll
  for (int k = 0; k < PRE; ++k) {
    const int o = tid + k * BF16_THREADS;
#pragma unroll
    for (int oc = 0; oc < COUT; ++oc) {
      const bool live_o = o < outs && !SPLIT && (COUT == 1 || o0 + oc < cout);
      const long long idx = (first + k * BF16_THREADS) * co + o0 + oc;
      xs[k][oc] = live_o ? x[idx] : 0.0f;
      zs[k][oc] = live_o && z ? z[idx] : 0.0f;
    }
  }
  __syncthreads();  // the weights are staged

  float acc[NT][4], accb[NT][4];  // a tile's B tiles (accb: the narrow item's tile 1)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = accb[j][q] = 0.0f;
  int nk = 0, ncb = 0;  // the narrow item reduced next: its tile and channel block
  const int swz = (g & 1) << 2;  // rows g and g + 8 share a parity
  // A tile's partials: columns 8j + 2t, 8j + 2t + 1 of its rows g, g + 8
  // (tile pixel p) from its accumulators a (B tile j), the columns past
  // TAPS dropped (at one channel: taps 2t, 2t+1 and, at t = 0, 8), zeroed.
  auto store_tile = [&](float (&a)[NT][4], int p) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t;
      if (col + 1 < TAPS) {
        part[col * pstride + p] = a[j][0];
        part[(col + 1) * pstride + p] = a[j][1];
        part[col * pstride + p + 8] = a[j][2];
        part[(col + 1) * pstride + p + 8] = a[j][3];
      } else if (col < TAPS) {
        part[col * pstride + p] = a[j][0];
        part[col * pstride + p + 8] = a[j][2];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[j][q] = 0.0f;
  };
  for (int it = 0; it < items; ++it) {
    cp_async_wait<RING - 2>();  // this item's copies (this lane's) have landed
    __syncwarp();            // ... every lane's; the slot refilled next was
                             // read by all in the last pass
    if (it + RING - 1 < items) issue(it + RING - 1);
    cp_async_commit();
    const bf16* slot = ring + (it % RING) * SLOT;
    if constexpr (BLOCK == 64) {
      const int k = it / cblocks, cb = it - k * cblocks;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int chunk = (4 * half + t) ^ swz;
        const uint4 a = *reinterpret_cast<const uint4*>(slot + g * BLOCK + 8 * chunk);
        const uint4 b = *reinterpret_cast<const uint4*>(slot + (g + 8) * BLOCK + 8 * chunk);
        const int col = cb * BLOCK + 32 * half + 8 * t;
        uint4 wf[NT];  // B tile j's fragments: column 8j + g's row
#pragma unroll
        for (int j = 0; j < NT; ++j)
          wf[j] = *reinterpret_cast<const uint4*>(ws + (8 * j + g) * wstride + col);
        // k-step 0: channels 8t, 8t+1 (columns 2t, 2t+1) and 8t+2, 8t+3
        // (columns 2t+8, 2t+9); k-step 1: 8t+4..8t+7 likewise.
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a.x, b.x, a.y, b.y, wf[j].x, wf[j].y);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a.z, b.z, a.w, b.w, wf[j].z, wf[j].w);
      }
      if (cb == cblocks - 1)  // the tile's partials of rows g, g + 8
        store_tile(acc, (warp + k * WARPS) * TILE + g);
    } else {  // the narrow item: its two tiles, the same weight fragments
      const int col = ncb * BLOCK + 8 * t;
      uint4 wf[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        wf[j] = *reinterpret_cast<const uint4*>(ws + (8 * j + g) * wstride + col);
      const uint4 a0 = *reinterpret_cast<const uint4*>(slot + g * BLOCK + 8 * t);
      const uint4 b0 = *reinterpret_cast<const uint4*>(slot + (g + 8) * BLOCK + 8 * t);
      const uint4 a1 = *reinterpret_cast<const uint4*>(slot + (g + 16) * BLOCK + 8 * t);
      const uint4 b1 = *reinterpret_cast<const uint4*>(slot + (g + 24) * BLOCK + 8 * t);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a0.x, b0.x, a0.y, b0.y, wf[j].x, wf[j].y);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a0.z, b0.z, a0.w, b0.w, wf[j].z, wf[j].w);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(accb[j], a1.x, b1.x, a1.y, b1.y, wf[j].x, wf[j].y);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(accb[j], a1.z, b1.z, a1.w, b1.w, wf[j].z, wf[j].w);
      if (ncb == cblocks - 1) {
        const int p = (warp + nk * WARPS) * IPX + g;
        store_tile(acc, p);
        store_tile(accb, p + TILE);
      }
      if (++ncb == cblocks) ncb = 0, ++nk;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every partial is in shared memory

  if constexpr (SPLIT) {
    store_range_sums<COUT>(part, pb, pstride, width, outs, cfg, first, tid, BF16_THREADS,
                           part_out, npix, cout, o0);
    return;
  }
  // Output pixel o = tid + k * BF16_THREADS, its x and z prefetched for k < PRE.
  auto step = [&](int k, const float (&xo)[COUT], const float (&zo)[COUT]) {
    const int o = tid + k * BF16_THREADS;
    const int r = o / width, xx = o - r * width;
#pragma unroll
    for (int oc = 0; oc < COUT; ++oc) {
      if (COUT > 1 && o0 + oc >= cout) break;
      float e[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // Under CFG the uncond pixels start at pb; channel oc's taps at row oc * 9.
        const float* ps = part + oc * 9 * pstride + s * pb;
        float sum = b0[oc];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float* prow = ps + (r + ky) * width;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int gx = xx + kx - 1;
            if (gx >= 0 && gx < width) sum += prow[(ky * 3 + kx) * pstride + gx];
          }
        }
        sum = round_to<bf16>(sum);
        e[s] = tanh_out ? round_to<bf16>(tanhf(sum)) : sum;
        if (!cfg) break;
      }
      const float ee =
          cfg ? round_to<bf16>(e[1] + round_to<bf16>(wu * round_to<bf16>(e[0] - e[1]))) : e[0];
      float v = (xo[oc] - ee * c_eps) * inv_sqrt_a;
      if (z) v += sigma * zo[oc];
      out[(first + k * BF16_THREADS) * co + o0 + oc] = v;
    }
  };
#pragma unroll
  for (int k = 0; k < PRE; ++k)
    if (tid + k * BF16_THREADS < outs) step(k, xs[k], zs[k]);
  for (int k = PRE; tid + k * BF16_THREADS < outs; ++k) {
    float xo[COUT], zo[COUT];
#pragma unroll
    for (int oc = 0; oc < COUT; ++oc) {
      const long long idx = (first + k * BF16_THREADS) * co + o0 + oc;
      const bool live_o = COUT == 1 || o0 + oc < cout;
      xo[oc] = live_o ? x[idx] : 0.0f;
      zo[oc] = live_o && z ? z[idx] : 0.0f;
    }
    step(k, xo, zo);
  }
}

// The unsharded launch: rows outside the map are zero.
template <int IB, int COUT>
__global__ void __launch_bounds__(BF16_THREADS) head_step_bf16_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wt, const bf16* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int cout, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const OutGroup og = out_group<COUT>(cout);
  const int unit = og.blk / bands;
  const int y0 = (og.blk - unit * bands) * rows;
  const int pb = (rows + 2) * width, m = (cfg ? 2 : 1) * pb;
  // A branch's band pixel q is pixel q of the contiguous run of pixels
  // that starts at its sample's row y0 - 1 (offset base[s] in elements,
  // negative for the row above the map); it reads if inside the map's
  // rows, q_lo <= q < q_hi.
  const int base0 = ((unit * height + y0 - 1) * width) * c;
  const int base1 = cfg ? (((unit + batch) * height + y0 - 1) * width) * c : 0;
  const int q_lo = y0 == 0 ? width : 0, q_hi = min(pb, (height - y0 + 1) * width);
  auto source_of = [&](int p) {
    const int s = p >= pb, qq = p - s * pb;
    return Source<bf16>{h, (s ? base1 : base0) + qq * c, p < m && qq >= q_lo && qq < q_hi};
  };
  bf16_step_body<IB, false, COUT>(source_of, unit, y0, pb, m, cout, og.o0, h, wt, bias, x, z,
                                  w_per_sample, w, out, height, width, c, rows, cfg, c_eps,
                                  inv_sqrt_a, sigma, tanh_out);
}

// The halo mode: a band's row -1 or `height` copied from the halo rows
// (band_source).  Its launch bound asks for two CTAs an SM at one output
// channel, as bf16_plan places them; at more, one (their accumulators).
template <int IB, int COUT>
__global__ void __launch_bounds__(BF16_THREADS, COUT == 1 ? 2 : 1) head_step_bf16_halo_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ top, const bf16* __restrict__ bottom,
    const bf16* __restrict__ wt, const bf16* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int cout, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const OutGroup og = out_group<COUT>(cout);
  const int unit = og.blk / bands;
  const int y0 = (og.blk - unit * bands) * rows;
  const Band band = band_of(unit, batch, height, width, c, rows, cfg, y0);
  auto source_of = [&](int p) { return band_source<bf16>(band, h, top, bottom, p, c); };
  bf16_step_body<IB, false, COUT>(source_of, unit, y0, band.pb, band.m, cout, og.o0, h, wt,
                                  bias, x, z, w_per_sample, w, out, height, width, c, rows,
                                  cfg, c_eps, inv_sqrt_a, sigma, tanh_out);
}

// ---- The float halo mode: warp-private rings, the taps on CUDA cores. ----
//
// A height shard's launch (ops/sampler_step.py::fused_head_step with halo)
// in fp32.  Bound: bytes, as the template's (h is 99% of them); the 9 fp32
// FMAs per staged float, about a fifth of the byte time at 67 TFLOP/s,
// stay on the CUDA cores with fmaf: no TF32, as the fp32 path serves with
// TF32 off and holds the JAX golden to 1e-4.  The layout is
// head_step_bf16_kernel's with the tensor-core product replaced:
//  - A CTA (8 warps) takes a band of `rows` rows of a unit, staged as the
//    list of band pixels of band_source (h, a halo row or zero).  Each
//    warp owns tiles w, w + 8, ... of F32_TILE band pixels and streams
//    each tile's channels F32_CK at a time (an item: the tile's pixels'
//    whole 128-byte lines) through a private ring of F32_RING slots with
//    16-byte cp.async copies (8 lanes a pixel), the sources of a tile
//    computed once when its first item is issued.  Items of whole lines
//    matter: with 32-byte items each pixel's lines stayed open over 16
//    items and the kernel ran slower than the template
//    (scripts/compare_torch_kernels.py --halo).  A warp waits only for its
//    own copies (cp.async.wait_group, __syncwarp): no block barrier runs
//    until the partials are done; F32_RING - 1 items a warp are in flight,
//    the first issued before the weights are staged.  c need only be a
//    multiple of 4: the last item's channels past c are zero-filled, as
//    are the weights' (rows of c32 floats).
//  - Lane (quarter, l) reduces channels 8 quarter .. 8 quarter + 7 of each
//    item for tile pixels l, l + 8, ... (PX of them) into the 9 per-tap
//    partials with fmaf, in channel order; the weights ([9][c32] floats in
//    shared memory) are read as float4, one address a quarter.  A tile
//    skips the taps no output reads from its rows (a staged row r feeds
//    output row r - ky through tap row ky only where that row is in the
//    band: the band's first and last staged rows one tap row of three, at
//    bands of 2 rows half the taps in all).  After a
//    tile's last item the quarters' sums meet in a butterfly (shuffles
//    over lanes 8 and 16 apart) and lane t < F32_TILE stores pixel t's
//    partials.  A pixel's 16-byte chunk q sits at slot q ^ (pp & 7), so a
//    quarter warp's reads (8 pixels, one chunk each) and writes (one
//    pixel's 8 chunks) hit 8 bank groups.
//  - After a block barrier the 3x3 gather epilogue runs as in
//    head_step_bf16_kernel, x and z of a thread's first output requested
//    in the prologue.
//  - The shared memory of a CTA (weights, 64 KiB of rings, partials) lets
//    two CTAs share an SM, so one CTA's gather runs beside another's
//    copies; ops/sampler_step.py::halo_plan takes the shortest band whose
//    grid is one wave of two CTAs an SM (2 rows at half the w=2 serving
//    features, 256 CTAs).
//  - Against the template's halo mode (the halo rows passed the same way)
//    at that shape it ties cold, runs 1.10x faster right after a cuDNN
//    conv (as the spatial chain launches it, after out_conv1) and 3%
//    slower alone (scripts/compare_torch_kernels.py --halo).
constexpr int F32_THREADS = 256;  // 8 warps
constexpr int F32_TILE = 32;      // pixels of a warp's tile (a multiple of 8)
constexpr int F32_CK = 32;        // channels of an item: 128 bytes a pixel, 8 copies of 16
constexpr int F32_RING = 2;       // slots of a warp's ring
constexpr int F32_OUTS = 1;       // output pixels a thread's x and z are prefetched for

// Grid: unit major, band minor.  Block: F32_THREADS.  Band pixels as
// band_source's.  Dynamic shared memory: the weights [9][c32] (c32: c
// rounded up to F32_CK), the warps' rings (8 x F32_RING slots of F32_TILE
// x F32_CK floats), then the partials [9][pstride] (pstride: the tiles'
// pixels).
// source_of(p) is band pixel p's channel 0 (a Source<float>), pb and m as
// bf16_step_body's.  SPLIT (head_step_f32_split_kernel): c, wt, wrow,
// part_out and npix as bf16_step_body's.  COUT output channels (o0 ..,
// masked past cout): the weights [9 * COUT][c32] (row oc * 9 + tap), a
// lane's 9 * COUT partials of each of its PX pixels, the partials [9 *
// COUT][pstride].
template <bool SPLIT, int COUT, typename SourceOf>
__device__ __forceinline__ void f32_step_body(
    SourceOf source_of, int unit, int y0, int pb, int m, int cout, int o0,
    const float* __restrict__ h,
    const float* __restrict__ wt, const float* __restrict__ bias, const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ w_per_sample, float w,
    float* __restrict__ out, int height, int width, int c, int rows, int cfg, float c_eps,
    float inv_sqrt_a, float sigma, int tanh_out, int wrow = 0,
    float* __restrict__ part_out = nullptr, long long npix = 0) {
  constexpr int SLOT = F32_TILE * F32_CK;  // floats
  constexpr int WARPS = F32_THREADS / 32;
  constexpr int PX = F32_TILE / 8;      // tile pixels a lane reduces
  constexpr int COPIES = F32_TILE / 4;  // 16-byte copies a lane issues an item
  constexpr int TAPS = 9 * COUT;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cblocks = (c + F32_CK - 1) / F32_CK, c32 = cblocks * F32_CK;
  float* ring = ws + TAPS * c32 + warp * F32_RING * SLOT;  // this warp's
  const int tiles = (m + F32_TILE - 1) / F32_TILE;
  const int pstride = tiles * F32_TILE;
  float* part = ws + TAPS * c32 + WARPS * F32_RING * SLOT;
  const int items = tiles > warp ? ((tiles - 1 - warp) / WARPS + 1) * cblocks : 0;

  // Item it of this warp: tile warp + (it / cblocks) * WARPS, channel block
  // it % cblocks; lane l copies chunk l & 7 of tile pixels l / 8 + 4 i,
  // from[i] (null: zero-filled), set when the tile's first item is issued.
  const float* from[COPIES];
  auto issue = [&](int it) {
    float* dst = ring + (it % F32_RING) * SLOT;
    const int k = it / cblocks, cb = it - k * cblocks;
    const int q = lane & 7;
    const bool inside = cb * F32_CK + 4 * q < c;  // the last item's tail is zero
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const int pp = (lane >> 3) + 4 * i;
      if (cb == 0) {
        const Source<float> src = source_of((warp + k * WARPS) * F32_TILE + pp);
        from[i] = src.reads ? src.array + src.off : nullptr;
      }
      const bool reads = from[i] != nullptr && inside;
      cp_async16(dst + pp * F32_CK + 4 * (q ^ (pp & 7)),
                 reads ? from[i] + cb * F32_CK + 4 * q : h, reads);
    }
  };
#pragma unroll
  for (int s = 0; s < F32_RING - 1; ++s) {
    if (s < items) issue(s);
    cp_async_commit();
  }

  const int wr = SPLIT ? wrow : c;  // the weights' row stride
  // This group's live rows of weights and their first row of wt.
  const int live = COUT == 1 ? 9 : min(TAPS, 9 * (cout - o0));
  const float* wg = wt + (COUT == 1 ? 0 : o0 * 9 * wr);
  for (int i = tid; i < TAPS * c32 / 4; i += F32_THREADS) {
    const int tap = i / (c32 / 4), q = i - tap * (c32 / 4);
    reinterpret_cast<float4*>(ws)[i] = 4 * q < c && (COUT == 1 || tap < live)
        ? *reinterpret_cast<const float4*>(wg + tap * wr + 4 * q)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // The step's inputs of this thread's first F32_OUTS output pixels.
  const int co = COUT == 1 ? 1 : cout;  // x, z and out: channels a pixel
  float b0[COUT];
#pragma unroll
  for (int oc = 0; oc < COUT; ++oc)
    b0[oc] = SPLIT || !(COUT == 1 || o0 + oc < cout) ? 0.0f : bias[o0 + oc];
  const float wu = cfg && !SPLIT ? (w_per_sample ? w_per_sample[unit] : w) : 0.0f;
  const int out_rows = min(rows, height - y0), outs = out_rows * width;
  const long long first = (long long)unit * height * width + (long long)y0 * width + tid;
  float xs[F32_OUTS][COUT], zs[F32_OUTS][COUT];
#pragma unroll
  for (int k = 0; k < F32_OUTS; ++k) {
    const int o = tid + k * F32_THREADS;
#pragma unroll
    for (int oc = 0; oc < COUT; ++oc) {
      const bool live_o = o < outs && !SPLIT && (COUT == 1 || o0 + oc < cout);
      const long long idx = (first + k * F32_THREADS) * co + o0 + oc;
      xs[k][oc] = live_o ? x[idx] : 0.0f;
      zs[k][oc] = live_o && z ? z[idx] : 0.0f;
    }
  }
  __syncthreads();  // the weights are staged

  const int quarter = lane >> 3, pl = lane & 7;
  int ky_lo = 0, ky_hi = 2;  // the tap rows the current tile's staged rows feed
  float acc[PX][TAPS];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int t = 0; t < TAPS; ++t) acc[i][t] = 0.0f;
  for (int it = 0; it < items; ++it) {
    cp_async_wait<F32_RING - 2>();  // this item's copies (this lane's) have landed
    __syncwarp();                   // ... every lane's; the slot refilled next was
                                    // read by all in the last pass
    if (it + F32_RING - 1 < items) issue(it + F32_RING - 1);
    cp_async_commit();
    const float* slot = ring + (it % F32_RING) * SLOT;
    const int k = it / cblocks, cb = it - k * cblocks;
    if (cb == 0) {  // a new tile: the staged rows r_lo .. r_hi it holds
      const int p_first = (warp + k * WARPS) * F32_TILE;
      const int p_last = min(p_first + F32_TILE, m) - 1;
      const int s_first = p_first >= pb, s_last = p_last >= pb;
      int r_lo = 0, r_hi = rows + 1;  // a tile across both branches: every row
      if (s_first == s_last) {
        r_lo = (p_first - s_first * pb) / width;
        r_hi = (p_last - s_last * pb) / width;
      }
      ky_lo = max(0, r_lo - out_rows + 1);  // output row r - ky within the band
      ky_hi = min(2, r_hi);
    }
    const float* wc = ws + cb * F32_CK + 8 * quarter;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float4 d[PX];
#pragma unroll
      for (int i = 0; i < PX; ++i)  // tile pixel pl + 8 i: its chunk 2 quarter + j
        d[i] = *reinterpret_cast<const float4*>(slot + (pl + 8 * i) * F32_CK +
                                                4 * ((2 * quarter + j) ^ pl));
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        if (t % 9 / 3 < ky_lo || t % 9 / 3 > ky_hi) continue;  // warp-uniform
        const float4 wv = *reinterpret_cast<const float4*>(wc + t * c32 + 4 * j);
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          acc[i][t] = fmaf(d[i].x, wv.x, acc[i][t]);
          acc[i][t] = fmaf(d[i].y, wv.y, acc[i][t]);
          acc[i][t] = fmaf(d[i].z, wv.z, acc[i][t]);
          acc[i][t] = fmaf(d[i].w, wv.w, acc[i][t]);
        }
      }
    }
    if (cb == cblocks - 1) {  // the tile's partials: the quarters' sums, pixel lane
      const int p = (warp + k * WARPS) * F32_TILE + lane;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          float v = acc[i][t];
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (i == quarter) part[t * pstride + p] = v;  // lane = pl + 8 quarter
          acc[i][t] = 0.0f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every partial is in shared memory

  if constexpr (SPLIT) {
    store_range_sums<COUT>(part, pb, pstride, width, outs, cfg, first, tid, F32_THREADS,
                           part_out, npix, cout, o0);
    return;
  }
  // Output pixel o = tid + k * F32_THREADS, its x and z prefetched for k < F32_OUTS.
  auto step = [&](int k, const float (&xo)[COUT], const float (&zo)[COUT]) {
    const int o = tid + k * F32_THREADS;
    const int r = o / width, xx = o - r * width;
#pragma unroll
    for (int oc = 0; oc < COUT; ++oc) {
      if (COUT > 1 && o0 + oc >= cout) break;
      float e[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // Under CFG the uncond pixels start at pb; channel oc's taps at row oc * 9.
        const float* ps = part + oc * 9 * pstride + s * pb;
        float sum = b0[oc];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float* prow = ps + (r + ky) * width;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int gx = xx + kx - 1;
            if (gx >= 0 && gx < width) sum += prow[(ky * 3 + kx) * pstride + gx];
          }
        }
        e[s] = tanh_out ? tanhf(sum) : sum;
        if (!cfg) break;
      }
      const float ee = cfg ? e[1] + wu * (e[0] - e[1]) : e[0];
      float v = (xo[oc] - ee * c_eps) * inv_sqrt_a;
      if (z) v += sigma * zo[oc];
      out[(first + k * F32_THREADS) * co + o0 + oc] = v;
    }
  };
#pragma unroll
  for (int k = 0; k < F32_OUTS; ++k)
    if (tid + k * F32_THREADS < outs) step(k, xs[k], zs[k]);
  for (int k = F32_OUTS; tid + k * F32_THREADS < outs; ++k) {
    float xo[COUT], zo[COUT];
#pragma unroll
    for (int oc = 0; oc < COUT; ++oc) {
      const long long idx = (first + k * F32_THREADS) * co + o0 + oc;
      const bool live_o = COUT == 1 || o0 + oc < cout;
      xo[oc] = live_o ? x[idx] : 0.0f;
      zo[oc] = live_o && z ? z[idx] : 0.0f;
    }
    step(k, xo, zo);
  }
}

// The fp32 halo mode: a band's row -1 or `height` copied from the halo rows
// (band_source).
// Two CTAs an SM at one output channel; at more, one (their 36 * COUT
// accumulators a lane).
template <int COUT>
__global__ void __launch_bounds__(F32_THREADS, COUT == 1 ? 2 : 1) head_step_halo_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ top,
    const float* __restrict__ bottom, const float* __restrict__ wt,
    const float* __restrict__ bias, const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int cout, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const OutGroup og = out_group<COUT>(cout);
  const int unit = og.blk / bands;
  const int y0 = (og.blk - unit * bands) * rows;
  const Band band = band_of(unit, batch, height, width, c, rows, cfg, y0);
  auto source_of = [&](int p) { return band_source<float>(band, h, top, bottom, p, c); };
  f32_step_body<false, COUT>(source_of, unit, y0, band.pb, band.m, cout, og.o0, h, wt, bias,
                             x, z, w_per_sample, w, out, height, width, c, rows, cfg, c_eps,
                             inv_sqrt_a, sigma, tanh_out);
}

// The fp32 unsharded launch at widths from 128 (ops/sampler_step.py::route):
// the same body with the unsharded copy map of head_step_bf16_kernel, rows
// outside the map zero, in a kernel of its own so that the halo kernel keeps
// its text.  Against the template (head_step_kernel) at 128-wide maps, whose
// band of (rows + 2) x 128 pixel pairs under CFG fits MAX_THREADS only at one
// row (three rows staged for each row computed) and whose ring held one CTA
// an SM: bands of any height whatever the width (2 rows at up to 128
// channels, two CTAs an SM; 4 over them, where rows staged again from L2 cost
// more: ops/sampler_step.py::BAND_ROWS), warp-private rings.  Without CFG
// the template's band of 4 rows fits, and at 256 channels it stays faster
// (ops/sampler_step.py::route keeps it there).
template <int COUT>
__global__ void __launch_bounds__(F32_THREADS, COUT == 1 ? 2 : 1) head_step_f32_band_kernel(
    const float* __restrict__ h, const float* __restrict__ wt, const float* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int cout, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const OutGroup og = out_group<COUT>(cout);
  const int unit = og.blk / bands;
  const int y0 = (og.blk - unit * bands) * rows;
  const int pb = (rows + 2) * width, m = (cfg ? 2 : 1) * pb;
  // As head_step_bf16_kernel's: a branch's band pixel q is pixel q of the
  // run that starts at its sample's row y0 - 1, read where inside the map.
  const int base0 = ((unit * height + y0 - 1) * width) * c;
  const int base1 = cfg ? (((unit + batch) * height + y0 - 1) * width) * c : 0;
  const int q_lo = y0 == 0 ? width : 0, q_hi = min(pb, (height - y0 + 1) * width);
  auto source_of = [&](int p) {
    const int s = p >= pb, qq = p - s * pb;
    return Source<float>{h, (s ? base1 : base0) + qq * c, p < m && qq >= q_lo && qq < q_hi};
  };
  f32_step_body<false, COUT>(source_of, unit, y0, pb, m, cout, og.o0, h, wt, bias, x, z,
                             w_per_sample, w, out, height, width, c, rows, cfg, c_eps,
                             inv_sqrt_a, sigma, tanh_out);
}

// ---- The split launch: the channel sum over CTAs, then combine and step. ----
//
// Where a band kernel's weights outgrow shared memory (c in the thousands:
// bf16_plan, halo_plan and, for the float unsharded launch, launch_plan
// refuse it), or h has 2^31 elements or more (the band kernels' offsets
// are 32-bit), ops/sampler_step.py::route takes this pair of launches.  It
// replaces the float template's instances there (one CTA an SM staging
// all 9 * c weights as floats and walking every channel of a band in
// series: 8 CTAs on 132 SMs at (2,8,8,6000), 17.8x slower than F.conv2d).
//  - Launch 1 (head_step_bf16_split_kernel, head_step_f32_split_kernel):
//    the grid is (unit x band, split).  A CTA runs the band kernels' body
//    (bf16_step_body, f32_step_body with SPLIT) on channels [c0, c0 + cs)
//    of its band: it stages only that range's weights, reduces the range
//    into the per-tap partials and gathers each output pixel's 3x3
//    neighbourhood, then writes one fp32 sum per (branch, output pixel)
//    to partials[split][branch][pixel] (the wrapper's workspace).  A
//    range is span channels (the last one shorter), span fixed
//    (ops/sampler_step.py::split_plan), so the boundaries depend on c
//    alone.  The copies take the whole map's rows or the halo rows (null:
//    zero), so the unsharded and the halo launch are one kernel, and two
//    shards' steps equal the unsharded launch's bit for bit in both types
//    (each pixel's range sums are the same products in the same order).
//    Pixel offsets are 64-bit: a branch's band base is a pointer.
//  - Launch 2 (head_step_combine_kernel): a thread a pixel sums its
//    ranges' partials in split order, adds the bias, and applies the band
//    kernels' epilogue (eps rounded to E, tanh, the guidance combine, the
//    step).  No float atomics: the result is the same run to run.
// Bound: bytes, h read once; the partials add 8 bytes a pixel and branch a
// range (written and read: 1/64 of h's bytes at span 128 in bf16).

// A split CTA's band pixel p < m (as band_of's) from the whole map's rows
// (64-bit bases, a branch's row y0 - 1 on), the halo rows or zero.
template <typename E>
struct SplitBand {
  int pb, m, q_lo, q_hi, qb_hi, c;
  const E *h0, *h1, *top0, *top1, *bottom0, *bottom1;  // a branch's pixel 0, channel c0
  bool has_top, has_bottom;

  __device__ __forceinline__ Source<E> operator()(int p) const {
    const int s = p >= pb, q = p - s * pb, off = q * c;
    if (p < m && q < q_lo) return Source<E>{s ? top1 : top0, off, has_top};
    if (p < m && q >= q_hi && q < qb_hi) return Source<E>{s ? bottom1 : bottom0, off, has_bottom};
    return Source<E>{s ? h1 : h0, off, p < m && q >= q_lo && q < q_hi};
  }
};

template <typename E>
__device__ __forceinline__ SplitBand<E> split_band(const E* h, const E* top, const E* bottom,
                                                   int unit, int batch, int height, int width,
                                                   int c, int rows, int cfg, int y0, int c0) {
  SplitBand<E> b;
  b.pb = (rows + 2) * width;
  b.m = (cfg ? 2 : 1) * b.pb;
  b.q_lo = y0 == 0 ? width : 0;
  const int q_bottom = (height - y0 + 1) * width;  // row `height`'s first pixel
  b.q_hi = min(b.pb, q_bottom);
  b.qb_hi = min(b.pb, q_bottom + width);
  b.c = c;
  const long long s0 = unit, s1 = cfg ? unit + batch : unit, row = (long long)width * c;
  b.h0 = h + (s0 * height + y0 - 1) * row + c0;
  b.h1 = h + (s1 * height + y0 - 1) * row + c0;
  b.has_top = top != nullptr;
  b.has_bottom = bottom != nullptr;
  b.top0 = b.has_top ? top + s0 * row + c0 : h;
  b.top1 = b.has_top ? top + s1 * row + c0 : h;
  b.bottom0 = b.has_bottom ? bottom + s0 * row - (long long)q_bottom * c + c0 : h;
  b.bottom1 = b.has_bottom ? bottom + s1 * row - (long long)q_bottom * c + c0 : h;
  return b;
}

// Grid: ((unit major, band minor) x output-channel group; split).  Block:
// BF16_THREADS.  Dynamic shared memory as head_step_bf16_kernel's for a
// range of span channels.  partials: (splits, branches, cout, batch *
// height * width) floats.
template <int IB, int COUT>
__global__ void __launch_bounds__(BF16_THREADS, COUT == 1 ? 2 : 1) head_step_bf16_split_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ top, const bf16* __restrict__ bottom,
    const bf16* __restrict__ wt, float* __restrict__ partials, int batch, int height,
    int width, int c, int cout, int rows, int cfg, int span) {
  const int bands = (height + rows - 1) / rows;
  const OutGroup og = out_group<COUT>(cout);
  const int unit = og.blk / bands;
  const int y0 = (og.blk - unit * bands) * rows;
  const int c0 = blockIdx.y * span, cs = min(span, c - c0);
  const long long npix = (long long)batch * height * width;
  const SplitBand<bf16> band =
      split_band<bf16>(h, top, bottom, unit, batch, height, width, c, rows, cfg, y0, c0);
  bf16_step_body<IB, true, COUT>(
      band, unit, y0, band.pb, band.m, cout, og.o0, h, wt + c0, nullptr, nullptr, nullptr,
      nullptr, 0.0f, nullptr, height, width, cs, rows, cfg, 0.0f, 0.0f, 0.0f, 0, c,
      partials + (long long)blockIdx.y * (cfg ? 2 : 1) * (COUT == 1 ? 1 : cout) * npix, npix);
}

// The same in fp32 (f32_step_body; dynamic shared memory as
// head_step_halo_f32_kernel's for a range of span channels).
template <int COUT>
__global__ void __launch_bounds__(F32_THREADS, COUT == 1 ? 2 : 1) head_step_f32_split_kernel(
    const float* __restrict__ h, const float* __restrict__ top,
    const float* __restrict__ bottom, const float* __restrict__ wt,
    float* __restrict__ partials, int batch, int height, int width, int c, int cout, int rows,
    int cfg, int span) {
  const int bands = (height + rows - 1) / rows;
  const OutGroup og = out_group<COUT>(cout);
  const int unit = og.blk / bands;
  const int y0 = (og.blk - unit * bands) * rows;
  const int c0 = blockIdx.y * span, cs = min(span, c - c0);
  const long long npix = (long long)batch * height * width;
  const SplitBand<float> band =
      split_band<float>(h, top, bottom, unit, batch, height, width, c, rows, cfg, y0, c0);
  f32_step_body<true, COUT>(
      band, unit, y0, band.pb, band.m, cout, og.o0, h, wt + c0, nullptr, nullptr, nullptr,
      nullptr, 0.0f, nullptr, height, width, cs, rows, cfg, 0.0f, 0.0f, 0.0f, 0, c,
      partials + (long long)blockIdx.y * (cfg ? 2 : 1) * (COUT == 1 ? 1 : cout) * npix, npix);
}

// Launch 2: element i of (batch, height, width, cout) (pixel i / cout,
// output channel i % cout) sums its ranges' partials in split order, adds
// the bias, and steps with the band kernels' arithmetic for E (eps rounded
// to E per branch, its tanh rounded, the combine's three operations
// rounded, w rounded; the identity for float).
template <typename E>
__global__ void head_step_combine_kernel(
    const float* __restrict__ partials, int splits, long long npix, int hw, int cout,
    const E* __restrict__ bias, const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int cfg,
    float c_eps, float inv_sqrt_a, float sigma, int tanh_out) {
  const int branches = cfg ? 2 : 1;
  const long long n = npix * cout;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long px = i / cout;
    const int oc = (int)(i - px * cout);
    const float b0 = to_float(bias[oc]);
    float e[2];
    for (int s = 0; s < branches; ++s) {
      const float* ps = partials + (s * cout + oc) * npix + px;
      float sum = ps[0];
#pragma unroll 8  // the loads in flight together, the sum in split order
      for (int k = 1; k < splits; ++k) sum += ps[k * branches * cout * npix];
      sum = round_to<E>(sum + b0);
      e[s] = tanh_out ? round_to<E>(tanhf(sum)) : sum;
    }
    float ee = e[0];
    if (cfg) {
      const float wu = round_to<E>(w_per_sample ? w_per_sample[px / hw] : w);
      ee = round_to<E>(e[1] + round_to<E>(wu * round_to<E>(e[0] - e[1])));
    }
    float v = (x[i] - ee * c_eps) * inv_sqrt_a;
    if (z) v += sigma * z[i];
    out[i] = v;
  }
}

constexpr int COMBINE_THREADS = 256;

template <typename E>
int split_entry(void (*kernel)(const E*, const E*, const E*, const E*, float*, int, int, int,
                               int, int, int, int, int),
                const E* h, const E* top, const E* bottom, const E* wt, const E* bias,
                const float* x, const float* z, const float* w_per_sample, float w,
                float* out, float* partials, int batch, int height, int width, int c, int cout,
                int groups, int rows, int cfg, int span, int splits, int threads,
                int smem_bytes, float c_eps, float inv_sqrt_a, float sigma, int tanh_out,
                void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (span <= 0 || splits != (c + span - 1) / span || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    kernel<<<dim3((unsigned)(batch * ((height + rows - 1) / rows) * groups), (unsigned)splits),
             threads, smem_bytes, st>>>(h, top, bottom, wt, partials, batch, height, width, c,
                                        cout, rows, cfg, span);
  cudaError_t last = cudaGetLastError();
  if (err != cudaSuccess || last != cudaSuccess) return (int)(err != cudaSuccess ? err : last);
  const long long npix = (long long)batch * height * width;
  const long long blocks = std::min<long long>(
      (npix * cout + COMBINE_THREADS - 1) / COMBINE_THREADS, 1 << 16);
  head_step_combine_kernel<E><<<(unsigned)blocks, COMBINE_THREADS, 0, st>>>(
      partials, splits, npix, height * width, cout, bias, x, z, w_per_sample, w, out, cfg,
      c_eps, inv_sqrt_a, sigma, tanh_out);
  return (int)cudaGetLastError();
}

// One launch of a halo kernel of its own (head_step_bf16_halo_kernel,
// head_step_halo_f32_kernel): a CTA a band of `rows` rows of a unit and a
// group of output channels.
template <typename E>
int band_launch(void (*kernel)(const E*, const E*, const E*, const E*, const E*,
                               const float*, const float*, const float*, float, float*, int,
                               int, int, int, int, int, int, float, float, float, int),
                const E* h, const E* top, const E* bottom, const E* wt, const E* bias,
                const float* x,
                const float* z, const float* w_per_sample, float w, float* out, int batch,
                int height, int width, int c, int cout, int groups, int rows, int cfg,
                int threads, int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,
                int tanh_out, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    kernel<<<dim3((unsigned)(batch * ((height + rows - 1) / rows) * groups)), threads,
             smem_bytes, (cudaStream_t)stream>>>(h, top, bottom, wt, bias, x, z, w_per_sample,
                                                 w, out, batch, height, width, c, cout, rows,
                                                 cfg, c_eps, inv_sqrt_a, sigma, tanh_out);
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// One launch of an unsharded band kernel (head_step_bf16_kernel,
// head_step_f32_band_kernel).
template <typename E>
int unsharded_launch(void (*kernel)(const E*, const E*, const E*, const float*, const float*,
                                    const float*, float, float*, int, int, int, int, int, int,
                                    int, float, float, float, int),
                     const E* h, const E* wt, const E* bias, const float* x, const float* z,
                     const float* w_per_sample, float w, float* out, int batch, int height,
                     int width, int c, int cout, int groups, int rows, int cfg, int threads,
                     int smem_bytes, float c_eps, float inv_sqrt_a, float sigma, int tanh_out,
                     void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    kernel<<<dim3((unsigned)(batch * ((height + rows - 1) / rows) * groups)), threads,
             smem_bytes, (cudaStream_t)stream>>>(h, wt, bias, x, z, w_per_sample, w, out,
                                                 batch, height, width, c, cout, rows, cfg,
                                                 c_eps, inv_sqrt_a, sigma, tanh_out);
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// The output channels a CTA computes for cout of them: equal groups of at
// most COUT_MAX (ops/sampler_step.py::out_groups).
constexpr int COUT_MAX = 4;

inline int group_size(int cout) {
  const int groups = (cout + COUT_MAX - 1) / COUT_MAX;
  return (cout + groups - 1) / groups;
}

// Every launch of K1 at COUT output channels a CTA, for the C entries of
// head_step.cu (their arguments, with ib the bf16 item's channels, 64 or
// 32).  Defined below and instantiated explicitly: COUT = 1 in
// head_step.cu, COUT = N in head_step_cout<N>.cu.
template <int COUT>
struct HeadStep {
  static int step(const float* h, const float* wt, const float* bias, const float* x,
                  const float* z, const float* w_per_sample, float w, float* out, int batch,
                  int height, int width, int c, int cout, int rows, int cfg, int ck,
                  int stages, int threads, int smem_bytes, float c_eps, float inv_sqrt_a,
                  float sigma, int tanh_out, void* stream);
  static int bf16_step(int ib, const bf16* h, const bf16* wt, const bf16* bias,
                       const float* x, const float* z, const float* w_per_sample, float w,
                       float* out, int batch, int height, int width, int c, int cout,
                       int rows, int cfg, int threads, int smem_bytes, float c_eps,
                       float inv_sqrt_a, float sigma, int tanh_out, void* stream);
  static int f32_band(const float* h, const float* wt, const float* bias, const float* x,
                      const float* z, const float* w_per_sample, float w, float* out,
                      int batch, int height, int width, int c, int cout, int rows, int cfg,
                      int threads, int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,
                      int tanh_out, void* stream);
  static int bf16_halo(int ib, const bf16* h, const bf16* top, const bf16* bottom,
                       const bf16* wt, const bf16* bias, const float* x, const float* z,
                       const float* w_per_sample, float w, float* out, int batch, int height,
                       int width, int c, int cout, int rows, int cfg, int threads,
                       int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,
                       int tanh_out, void* stream);
  static int f32_halo(const float* h, const float* top, const float* bottom, const float* wt,
                      const float* bias, const float* x, const float* z,
                      const float* w_per_sample, float w, float* out, int batch, int height,
                      int width, int c, int cout, int rows, int cfg, int threads,
                      int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,
                      int tanh_out, void* stream);
  static int f32_split(const float* h, const float* top, const float* bottom, const float* wt,
                       const float* bias, const float* x, const float* z,
                       const float* w_per_sample, float w, float* out, float* partials,
                       int batch, int height, int width, int c, int cout, int rows, int cfg,
                       int span, int splits, int threads, int smem_bytes, float c_eps,
                       float inv_sqrt_a, float sigma, int tanh_out, void* stream);
  static int bf16_split(int ib, const bf16* h, const bf16* top, const bf16* bottom,
                        const bf16* wt, const bf16* bias, const float* x, const float* z,
                        const float* w_per_sample, float w, float* out, float* partials,
                        int batch, int height, int width, int c, int cout, int rows, int cfg,
                        int span, int splits, int threads, int smem_bytes, float c_eps,
                        float inv_sqrt_a, float sigma, int tanh_out, void* stream);
};

template <int COUT>
int HeadStep<COUT>::step(const float* h, const float* wt, const float* bias, const float* x,
                         const float* z, const float* w_per_sample, float w, float* out,
                         int batch, int height, int width, int c, int cout, int rows, int cfg,
                         int ck, int stages, int threads, int smem_bytes, float c_eps,
                         float inv_sqrt_a, float sigma, int tanh_out, void* stream) {
  return entry<float, COUT>(h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c,
                            cout, rows, cfg, ck, stages, threads, smem_bytes, c_eps,
                            inv_sqrt_a, sigma, tanh_out, stream);
}

template <int COUT>
int HeadStep<COUT>::bf16_step(int ib, const bf16* h, const bf16* wt, const bf16* bias,
                              const float* x, const float* z, const float* w_per_sample,
                              float w, float* out, int batch, int height, int width, int c,
                              int cout, int rows, int cfg, int threads, int smem_bytes,
                              float c_eps, float inv_sqrt_a, float sigma, int tanh_out,
                              void* stream) {
  return unsharded_launch<bf16>(
      ib == BLOCK ? head_step_bf16_kernel<BLOCK, COUT> : head_step_bf16_kernel<NARROW_BLOCK, COUT>,
      h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, cout,
      (cout + COUT - 1) / COUT, rows, cfg, threads, smem_bytes, c_eps, inv_sqrt_a, sigma,
      tanh_out, stream);
}

template <int COUT>
int HeadStep<COUT>::f32_band(const float* h, const float* wt, const float* bias,
                             const float* x, const float* z, const float* w_per_sample,
                             float w, float* out, int batch, int height, int width, int c,
                             int cout, int rows, int cfg, int threads, int smem_bytes,
                             float c_eps, float inv_sqrt_a, float sigma, int tanh_out,
                             void* stream) {
  return unsharded_launch<float>(head_step_f32_band_kernel<COUT>, h, wt, bias, x, z,
                                 w_per_sample, w, out, batch, height, width, c, cout,
                                 (cout + COUT - 1) / COUT, rows, cfg, threads, smem_bytes,
                                 c_eps, inv_sqrt_a, sigma, tanh_out, stream);
}

template <int COUT>
int HeadStep<COUT>::bf16_halo(int ib, const bf16* h, const bf16* top, const bf16* bottom,
                              const bf16* wt, const bf16* bias, const float* x,
                              const float* z, const float* w_per_sample, float w, float* out,
                              int batch, int height, int width, int c, int cout, int rows,
                              int cfg, int threads, int smem_bytes, float c_eps,
                              float inv_sqrt_a, float sigma, int tanh_out, void* stream) {
  return band_launch<bf16>(
      ib == BLOCK ? head_step_bf16_halo_kernel<BLOCK, COUT>
                  : head_step_bf16_halo_kernel<NARROW_BLOCK, COUT>,
      h, top, bottom, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, cout,
      (cout + COUT - 1) / COUT, rows, cfg, threads, smem_bytes, c_eps, inv_sqrt_a, sigma,
      tanh_out, stream);
}

template <int COUT>
int HeadStep<COUT>::f32_halo(const float* h, const float* top, const float* bottom,
                             const float* wt, const float* bias, const float* x,
                             const float* z, const float* w_per_sample, float w, float* out,
                             int batch, int height, int width, int c, int cout, int rows,
                             int cfg, int threads, int smem_bytes, float c_eps,
                             float inv_sqrt_a, float sigma, int tanh_out, void* stream) {
  return band_launch<float>(head_step_halo_f32_kernel<COUT>, h, top, bottom, wt, bias, x, z,
                            w_per_sample, w, out, batch, height, width, c, cout,
                            (cout + COUT - 1) / COUT, rows, cfg, threads, smem_bytes, c_eps,
                            inv_sqrt_a, sigma, tanh_out, stream);
}

template <int COUT>
int HeadStep<COUT>::f32_split(const float* h, const float* top, const float* bottom,
                              const float* wt, const float* bias, const float* x,
                              const float* z, const float* w_per_sample, float w, float* out,
                              float* partials, int batch, int height, int width, int c,
                              int cout, int rows, int cfg, int span, int splits, int threads,
                              int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,
                              int tanh_out, void* stream) {
  return split_entry<float>(head_step_f32_split_kernel<COUT>, h, top, bottom, wt, bias, x, z,
                            w_per_sample, w, out, partials, batch, height, width, c, cout,
                            (cout + COUT - 1) / COUT, rows, cfg, span, splits, threads,
                            smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream);
}

template <int COUT>
int HeadStep<COUT>::bf16_split(int ib, const bf16* h, const bf16* top, const bf16* bottom,
                               const bf16* wt, const bf16* bias, const float* x,
                               const float* z, const float* w_per_sample, float w, float* out,
                               float* partials, int batch, int height, int width, int c,
                               int cout, int rows, int cfg, int span, int splits, int threads,
                               int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,
                               int tanh_out, void* stream) {
  return split_entry<bf16>(
      ib == BLOCK ? head_step_bf16_split_kernel<BLOCK, COUT>
                  : head_step_bf16_split_kernel<NARROW_BLOCK, COUT>,
      h, top, bottom, wt, bias, x, z, w_per_sample, w, out, partials, batch, height, width, c,
      cout, (cout + COUT - 1) / COUT, rows, cfg, span, splits, threads, smem_bytes, c_eps,
      inv_sqrt_a, sigma, tanh_out, stream);
}

extern template struct HeadStep<1>;
extern template struct HeadStep<2>;
extern template struct HeadStep<3>;
extern template struct HeadStep<4>;
