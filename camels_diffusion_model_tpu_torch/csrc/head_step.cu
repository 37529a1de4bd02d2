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

// Grid: unit major, band minor.  Block: T threads; tile row k < 2T holds,
// under CFG, pixel k % T (T = (rows+2)*width) of sample unit + (k/T)*batch,
// otherwise pixel k (T = (rows+2)*width/2) of sample unit; a pixel p of the
// band is at global row y0 - 1 + p / width.  Dynamic shared memory: the
// weights [9][c] as floats, then STAGES stages of [2T][STRIDE] elements of
// E; the partials [9][2T] (floats) reuse the ring at the end.
template <typename E, int CK, int STAGES>
__global__ void head_step_kernel(
    const E* __restrict__ h, const E* __restrict__ wt, const E* __restrict__ bias,
    const float* __restrict__ x,
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

template <typename E, int CK, int STAGES>
cudaError_t launch(dim3 grid, int threads, int smem_bytes, cudaStream_t stream,
                   const E* h, const E* wt, const E* bias,
                   const float* x, const float* z, const float* w_per_sample,
                   float w, float* out, int batch, int height, int width, int c,
                   int rows, int cfg, float c_eps, float inv_sqrt_a, float sigma,
                   int tanh_out) {
  cudaError_t err = cudaSuccess;
  if (smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(head_step_kernel<E, CK, STAGES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    head_step_kernel<E, CK, STAGES><<<grid, threads, smem_bytes, stream>>>(
        h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c,
        rows, cfg, c_eps, inv_sqrt_a, sigma, tanh_out);
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ck: channels per staged chunk, 128, 64, 32 or 16 bytes of them.
template <typename E>
int entry(const E* h, const E* wt, const E* bias,
          const float* x,
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
    return (int)launch<E, CK, STAGES>(grid, threads, smem_bytes, st, h, wt, bias, x, z, \
                                      w_per_sample, w, out, batch, height, width, c,     \
                                      rows, cfg, c_eps, inv_sqrt_a, sigma, tanh_out);
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
// first at element `first` of the map's pixels) gets, per branch, the sum
// of its 3x3 neighbourhood's per-tap partials (part: [9][pstride], a
// branch's staged pixels pb apart) in the band kernels' gather order, no
// bias, stored to part_out[s * npix + pixel].
__device__ __forceinline__ void store_range_sums(const float* part, int pb, int pstride,
                                                 int width, int outs, int cfg, long long first,
                                                 int tid, int threads, float* part_out,
                                                 long long npix) {
  for (int o = tid; o < outs; o += threads) {
    const int r = o / width, xx = o - r * width;
    for (int s = 0; s < (cfg ? 2 : 1); ++s) {
      const float* ps = part + s * pb;
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
      part_out[s * npix + first + (o - tid)] = sum;
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
// to part_out[s * npix + pixel] (head_step_combine_kernel sums the ranges).
template <int IB, bool SPLIT, typename SourceOf>
__device__ __forceinline__ void bf16_step_body(
    SourceOf source_of, int unit, int y0, int pb, int m, const bf16* __restrict__ h,
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
  bf16* ring = ws + 16 * wstride + warp * RING * SLOT;  // this warp's
  const int tiles = (m + IPX - 1) / IPX;  // of an item's pixels
  const int pstride = (m + 31) / 32 * 32 + 4;  // 4 mod 32: a store's 4 taps, 4 banks apart
  float* part = reinterpret_cast<float*>(ws + 16 * wstride + WARPS * RING * SLOT);
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
  if constexpr (BLOCK == 64) {
    for (int i = tid; i < 16 * (c / 8); i += BF16_THREADS) {
      const int tap = i / (c / 8), q = i - tap * (c / 8);
      *reinterpret_cast<uint4*>(ws + tap * wstride + 8 * q) =
          tap < 9 ? *reinterpret_cast<const uint4*>(wt + tap * wr + 8 * q)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {  // rows of cpad channels, zero past c
    for (int i = tid; i < 16 * (cpad / 8); i += BF16_THREADS) {
      const int tap = i / (cpad / 8), q = i - tap * (cpad / 8);
      *reinterpret_cast<uint4*>(ws + tap * wstride + 8 * q) =
          tap < 9 && 8 * q < c ? *reinterpret_cast<const uint4*>(wt + tap * wr + 8 * q)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // The step's inputs of this thread's first OUTS output pixels.
  const float b0 = SPLIT ? 0.0f : to_float(*bias);
  const float wu =
      round_to<bf16>(cfg && !SPLIT ? (w_per_sample ? w_per_sample[unit] : w) : 0.0f);
  const int outs = min(rows, height - y0) * width;
  const long long first = (long long)unit * height * width + (long long)y0 * width + tid;
  float xs[OUTS], zs[OUTS];
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int o = tid + k * BF16_THREADS;
    xs[k] = o < outs && !SPLIT ? x[first + k * BF16_THREADS] : 0.0f;
    zs[k] = o < outs && !SPLIT && z ? z[first + k * BF16_THREADS] : 0.0f;
  }
  __syncthreads();  // the weights are staged

  float acc0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc2[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc3[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // narrow tile 1
  int nk = 0, ncb = 0;  // the narrow item reduced next: its tile and channel block
  const int swz = (g & 1) << 2;  // rows g and g + 8 share a parity
  // A tile's partials: taps 2t, 2t+1 (and 8) of its rows g, g + 8 (tile
  // pixel p), from its accumulators c0 (taps 0-7) and c1 (8-15), zeroed.
  auto store_tile = [&](float (&c0)[4], float (&c1)[4], int p) {
    part[2 * t * pstride + p] = c0[0];
    part[(2 * t + 1) * pstride + p] = c0[1];
    part[2 * t * pstride + p + 8] = c0[2];
    part[(2 * t + 1) * pstride + p + 8] = c0[3];
    if (t == 0) {
      part[8 * pstride + p] = c1[0];
      part[8 * pstride + p + 8] = c1[2];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) c0[q] = c1[q] = 0.0f;
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
        const uint4 w0 = *reinterpret_cast<const uint4*>(ws + g * wstride + col);
        const uint4 w1 = *reinterpret_cast<const uint4*>(ws + (8 + g) * wstride + col);
        // k-step 0: channels 8t, 8t+1 (columns 2t, 2t+1) and 8t+2, 8t+3
        // (columns 2t+8, 2t+9); k-step 1: 8t+4..8t+7 likewise.
        mma_bf16(acc0, a.x, b.x, a.y, b.y, w0.x, w0.y);
        mma_bf16(acc1, a.x, b.x, a.y, b.y, w1.x, w1.y);
        mma_bf16(acc0, a.z, b.z, a.w, b.w, w0.z, w0.w);
        mma_bf16(acc1, a.z, b.z, a.w, b.w, w1.z, w1.w);
      }
      if (cb == cblocks - 1) {  // the tile's partials: taps 2t, 2t+1 (and 8) of rows g, g+8
        const int p = (warp + k * WARPS) * TILE + g;
        part[2 * t * pstride + p] = acc0[0];
        part[(2 * t + 1) * pstride + p] = acc0[1];
        part[2 * t * pstride + p + 8] = acc0[2];
        part[(2 * t + 1) * pstride + p + 8] = acc0[3];
        if (t == 0) {
          part[8 * pstride + p] = acc1[0];
          part[8 * pstride + p + 8] = acc1[2];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc0[q] = acc1[q] = 0.0f;
      }
    } else {  // the narrow item: its two tiles, the same weight fragments
      const int col = ncb * BLOCK + 8 * t;
      const uint4 w0 = *reinterpret_cast<const uint4*>(ws + g * wstride + col);
      const uint4 w1 = *reinterpret_cast<const uint4*>(ws + (8 + g) * wstride + col);
      const uint4 a0 = *reinterpret_cast<const uint4*>(slot + g * BLOCK + 8 * t);
      const uint4 b0 = *reinterpret_cast<const uint4*>(slot + (g + 8) * BLOCK + 8 * t);
      const uint4 a1 = *reinterpret_cast<const uint4*>(slot + (g + 16) * BLOCK + 8 * t);
      const uint4 b1 = *reinterpret_cast<const uint4*>(slot + (g + 24) * BLOCK + 8 * t);
      mma_bf16(acc0, a0.x, b0.x, a0.y, b0.y, w0.x, w0.y);
      mma_bf16(acc1, a0.x, b0.x, a0.y, b0.y, w1.x, w1.y);
      mma_bf16(acc0, a0.z, b0.z, a0.w, b0.w, w0.z, w0.w);
      mma_bf16(acc1, a0.z, b0.z, a0.w, b0.w, w1.z, w1.w);
      mma_bf16(acc2, a1.x, b1.x, a1.y, b1.y, w0.x, w0.y);
      mma_bf16(acc3, a1.x, b1.x, a1.y, b1.y, w1.x, w1.y);
      mma_bf16(acc2, a1.z, b1.z, a1.w, b1.w, w0.z, w0.w);
      mma_bf16(acc3, a1.z, b1.z, a1.w, b1.w, w1.z, w1.w);
      if (ncb == cblocks - 1) {
        const int p = (warp + nk * WARPS) * IPX + g;
        store_tile(acc0, acc1, p);
        store_tile(acc2, acc3, p + TILE);
      }
      if (++ncb == cblocks) ncb = 0, ++nk;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every partial is in shared memory

  if constexpr (SPLIT) {
    store_range_sums(part, pb, pstride, width, outs, cfg, first, tid, BF16_THREADS, part_out,
                     npix);
    return;
  }
  // Output pixel o = tid + k * BF16_THREADS, its x and z prefetched for k < OUTS.
  auto step = [&](int k, float xo, float zo) {
    const int o = tid + k * BF16_THREADS;
    const int r = o / width, xx = o - r * width;
    float e[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* ps = part + s * pb;  // under CFG the uncond pixels start at pb
      float sum = b0;
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
    float v = (xo - ee * c_eps) * inv_sqrt_a;
    if (z) v += sigma * zo;
    out[first + k * BF16_THREADS] = v;
  };
#pragma unroll
  for (int k = 0; k < OUTS; ++k)
    if (tid + k * BF16_THREADS < outs) step(k, xs[k], zs[k]);
  for (int k = OUTS; tid + k * BF16_THREADS < outs; ++k) {
    const long long idx = first + k * BF16_THREADS;
    step(k, x[idx], z ? z[idx] : 0.0f);
  }
}

// The unsharded launch: rows outside the map are zero.
template <int IB>
__global__ void __launch_bounds__(BF16_THREADS) head_step_bf16_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wt, const bf16* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const int unit = blockIdx.x / bands;
  const int y0 = (blockIdx.x - unit * bands) * rows;
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
  bf16_step_body<IB, false>(source_of, unit, y0, pb, m, h, wt, bias, x, z, w_per_sample, w,
                            out, height, width, c, rows, cfg, c_eps, inv_sqrt_a, sigma,
                            tanh_out);
}

// The halo mode: a band's row -1 or `height` copied from the halo rows
// (band_source).  Its launch bound asks for two CTAs an SM, as bf16_plan
// places them.
template <int IB>
__global__ void __launch_bounds__(BF16_THREADS, 2) head_step_bf16_halo_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ top, const bf16* __restrict__ bottom,
    const bf16* __restrict__ wt, const bf16* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const int unit = blockIdx.x / bands;
  const int y0 = (blockIdx.x - unit * bands) * rows;
  const Band band = band_of(unit, batch, height, width, c, rows, cfg, y0);
  auto source_of = [&](int p) { return band_source<bf16>(band, h, top, bottom, p, c); };
  bf16_step_body<IB, false>(source_of, unit, y0, band.pb, band.m, h, wt, bias, x, z,
                            w_per_sample, w, out, height, width, c, rows, cfg, c_eps,
                            inv_sqrt_a, sigma, tanh_out);
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
// part_out and npix as bf16_step_body's.
template <bool SPLIT, typename SourceOf>
__device__ __forceinline__ void f32_step_body(
    SourceOf source_of, int unit, int y0, int pb, int m, const float* __restrict__ h,
    const float* __restrict__ wt, const float* __restrict__ bias, const float* __restrict__ x,
    const float* __restrict__ z, const float* __restrict__ w_per_sample, float w,
    float* __restrict__ out, int height, int width, int c, int rows, int cfg, float c_eps,
    float inv_sqrt_a, float sigma, int tanh_out, int wrow = 0,
    float* __restrict__ part_out = nullptr, long long npix = 0) {
  constexpr int SLOT = F32_TILE * F32_CK;  // floats
  constexpr int WARPS = F32_THREADS / 32;
  constexpr int PX = F32_TILE / 8;      // tile pixels a lane reduces
  constexpr int COPIES = F32_TILE / 4;  // 16-byte copies a lane issues an item
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cblocks = (c + F32_CK - 1) / F32_CK, c32 = cblocks * F32_CK;
  float* ring = ws + 9 * c32 + warp * F32_RING * SLOT;  // this warp's
  const int tiles = (m + F32_TILE - 1) / F32_TILE;
  const int pstride = tiles * F32_TILE;
  float* part = ws + 9 * c32 + WARPS * F32_RING * SLOT;
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
  for (int i = tid; i < 9 * c32 / 4; i += F32_THREADS) {
    const int tap = i / (c32 / 4), q = i - tap * (c32 / 4);
    reinterpret_cast<float4*>(ws)[i] = 4 * q < c
        ? *reinterpret_cast<const float4*>(wt + tap * wr + 4 * q)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // The step's inputs of this thread's first F32_OUTS output pixels.
  const float b0 = SPLIT ? 0.0f : *bias;
  const float wu = cfg && !SPLIT ? (w_per_sample ? w_per_sample[unit] : w) : 0.0f;
  const int out_rows = min(rows, height - y0), outs = out_rows * width;
  const long long first = (long long)unit * height * width + (long long)y0 * width + tid;
  float xs[F32_OUTS], zs[F32_OUTS];
#pragma unroll
  for (int k = 0; k < F32_OUTS; ++k) {
    const int o = tid + k * F32_THREADS;
    xs[k] = o < outs && !SPLIT ? x[first + k * F32_THREADS] : 0.0f;
    zs[k] = o < outs && !SPLIT && z ? z[first + k * F32_THREADS] : 0.0f;
  }
  __syncthreads();  // the weights are staged

  const int quarter = lane >> 3, pl = lane & 7;
  int ky_lo = 0, ky_hi = 2;  // the tap rows the current tile's staged rows feed
  float acc[PX][9];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[i][t] = 0.0f;
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
      for (int t = 0; t < 9; ++t) {
        if (t / 3 < ky_lo || t / 3 > ky_hi) continue;  // warp-uniform
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
        for (int t = 0; t < 9; ++t) {
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
    store_range_sums(part, pb, pstride, width, outs, cfg, first, tid, F32_THREADS, part_out,
                     npix);
    return;
  }
  // Output pixel o = tid + k * F32_THREADS, its x and z prefetched for k < F32_OUTS.
  auto step = [&](int k, float xo, float zo) {
    const int o = tid + k * F32_THREADS;
    const int r = o / width, xx = o - r * width;
    float e[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* ps = part + s * pb;  // under CFG the uncond pixels start at pb
      float sum = b0;
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
    float v = (xo - ee * c_eps) * inv_sqrt_a;
    if (z) v += sigma * zo;
    out[first + k * F32_THREADS] = v;
  };
#pragma unroll
  for (int k = 0; k < F32_OUTS; ++k)
    if (tid + k * F32_THREADS < outs) step(k, xs[k], zs[k]);
  for (int k = F32_OUTS; tid + k * F32_THREADS < outs; ++k) {
    const long long idx = first + k * F32_THREADS;
    step(k, x[idx], z ? z[idx] : 0.0f);
  }
}

// The fp32 halo mode: a band's row -1 or `height` copied from the halo rows
// (band_source).
__global__ void __launch_bounds__(F32_THREADS, 2) head_step_halo_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ top,
    const float* __restrict__ bottom, const float* __restrict__ wt,
    const float* __restrict__ bias, const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const int unit = blockIdx.x / bands;
  const int y0 = (blockIdx.x - unit * bands) * rows;
  const Band band = band_of(unit, batch, height, width, c, rows, cfg, y0);
  auto source_of = [&](int p) { return band_source<float>(band, h, top, bottom, p, c); };
  f32_step_body<false>(source_of, unit, y0, band.pb, band.m, h, wt, bias, x, z, w_per_sample,
                       w, out, height, width, c, rows, cfg, c_eps, inv_sqrt_a, sigma,
                       tanh_out);
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
__global__ void __launch_bounds__(F32_THREADS, 2) head_step_f32_band_kernel(
    const float* __restrict__ h, const float* __restrict__ wt, const float* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int batch,
    int height, int width, int c, int rows, int cfg, float c_eps, float inv_sqrt_a,
    float sigma, int tanh_out) {
  const int bands = (height + rows - 1) / rows;
  const int unit = blockIdx.x / bands;
  const int y0 = (blockIdx.x - unit * bands) * rows;
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
  f32_step_body<false>(source_of, unit, y0, pb, m, h, wt, bias, x, z, w_per_sample, w, out,
                       height, width, c, rows, cfg, c_eps, inv_sqrt_a, sigma, tanh_out);
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

// Grid: (unit major, band minor; split).  Block: BF16_THREADS.  Dynamic
// shared memory as head_step_bf16_kernel's for a range of span channels.
// partials: (splits, branches, batch * height * width) floats.
template <int IB>
__global__ void __launch_bounds__(BF16_THREADS, 2) head_step_bf16_split_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ top, const bf16* __restrict__ bottom,
    const bf16* __restrict__ wt, float* __restrict__ partials, int batch, int height,
    int width, int c, int rows, int cfg, int span) {
  const int bands = (height + rows - 1) / rows;
  const int unit = blockIdx.x / bands;
  const int y0 = (blockIdx.x - unit * bands) * rows;
  const int c0 = blockIdx.y * span, cs = min(span, c - c0);
  const long long npix = (long long)batch * height * width;
  const SplitBand<bf16> band =
      split_band<bf16>(h, top, bottom, unit, batch, height, width, c, rows, cfg, y0, c0);
  bf16_step_body<IB, true>(band, unit, y0, band.pb, band.m, h, wt + c0, nullptr, nullptr,
                           nullptr, nullptr, 0.0f, nullptr, height, width, cs, rows, cfg,
                           0.0f, 0.0f, 0.0f, 0, c,
                           partials + (long long)blockIdx.y * (cfg ? 2 : 1) * npix, npix);
}

// The same in fp32 (f32_step_body; dynamic shared memory as
// head_step_halo_f32_kernel's for a range of span channels).
__global__ void __launch_bounds__(F32_THREADS, 2) head_step_f32_split_kernel(
    const float* __restrict__ h, const float* __restrict__ top,
    const float* __restrict__ bottom, const float* __restrict__ wt,
    float* __restrict__ partials, int batch, int height, int width, int c, int rows, int cfg,
    int span) {
  const int bands = (height + rows - 1) / rows;
  const int unit = blockIdx.x / bands;
  const int y0 = (blockIdx.x - unit * bands) * rows;
  const int c0 = blockIdx.y * span, cs = min(span, c - c0);
  const long long npix = (long long)batch * height * width;
  const SplitBand<float> band =
      split_band<float>(h, top, bottom, unit, batch, height, width, c, rows, cfg, y0, c0);
  f32_step_body<true>(band, unit, y0, band.pb, band.m, h, wt + c0, nullptr, nullptr, nullptr,
                      nullptr, 0.0f, nullptr, height, width, cs, rows, cfg, 0.0f, 0.0f, 0.0f,
                      0, c, partials + (long long)blockIdx.y * (cfg ? 2 : 1) * npix, npix);
}

// Launch 2: pixel i of (batch, height, width) sums its ranges' partials
// in split order, adds the bias, and steps with the band kernels'
// arithmetic for E (eps rounded to E per branch, its tanh rounded, the
// combine's three operations rounded, w rounded; the identity for float).
template <typename E>
__global__ void head_step_combine_kernel(
    const float* __restrict__ partials, int splits, long long npix, int hw,
    const E* __restrict__ bias, const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ w_per_sample, float w, float* __restrict__ out, int cfg,
    float c_eps, float inv_sqrt_a, float sigma, int tanh_out) {
  const int branches = cfg ? 2 : 1;
  const float b0 = to_float(*bias);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < npix;
       i += (long long)gridDim.x * blockDim.x) {
    float e[2];
    for (int s = 0; s < branches; ++s) {
      const float* ps = partials + s * npix + i;
      float sum = ps[0];
#pragma unroll 8  // the loads in flight together, the sum in split order
      for (int k = 1; k < splits; ++k) sum += ps[k * branches * npix];
      sum = round_to<E>(sum + b0);
      e[s] = tanh_out ? round_to<E>(tanhf(sum)) : sum;
    }
    float ee = e[0];
    if (cfg) {
      const float wu = round_to<E>(w_per_sample ? w_per_sample[i / hw] : w);
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
                               int, int, int, int),
                const E* h, const E* top, const E* bottom, const E* wt, const E* bias,
                const float* x, const float* z, const float* w_per_sample, float w,
                float* out, float* partials, int batch, int height, int width, int c,
                int rows, int cfg, int span, int splits, int threads, int smem_bytes,
                float c_eps, float inv_sqrt_a, float sigma, int tanh_out, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (span <= 0 || splits != (c + span - 1) / span || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    kernel<<<dim3((unsigned)(batch * ((height + rows - 1) / rows)), (unsigned)splits), threads,
             smem_bytes, st>>>(h, top, bottom, wt, partials, batch, height, width, c, rows,
                               cfg, span);
  cudaError_t last = cudaGetLastError();
  if (err != cudaSuccess || last != cudaSuccess) return (int)(err != cudaSuccess ? err : last);
  const long long npix = (long long)batch * height * width;
  const long long blocks = std::min<long long>((npix + COMBINE_THREADS - 1) / COMBINE_THREADS,
                                               1 << 16);
  head_step_combine_kernel<E><<<(unsigned)blocks, COMBINE_THREADS, 0, st>>>(
      partials, splits, npix, height * width, bias, x, z, w_per_sample, w, out, cfg, c_eps,
      inv_sqrt_a, sigma, tanh_out);
  return (int)cudaGetLastError();
}

}  // namespace

// h: (cfg ? 2 * batch : batch, height, width, c) NHWC float, 16-byte
// aligned; wt: (9, c) tap-major weights (tap = ky * 3 + kx) and bias: one
// element; x, z, out: (batch, height, width) float; z null to skip the
// noise term; w_per_sample: null for the scalar w (floats); tanh_out: 1 to
// take eps = tanh(conv).  rows, ck, stages, threads and smem_bytes come
// from ops/sampler_step.py::launch_plan.  Returns the cudaError_t of the
// launch.  The float unsharded launch.
extern "C" int camels_head_step(const float* h, const float* wt, const float* bias,
                                const float* x, const float* z, const float* w_per_sample,
                                float w, float* out, int batch, int height, int width, int c,
                                int rows, int cfg, int ck, int stages, int threads,
                                int smem_bytes, float c_eps, float inv_sqrt_a, float sigma,
                                int tanh_out, void* stream) {
  return entry<float>(h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, rows,
                      cfg, ck, stages, threads, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out,
                      stream);
}

// The split launch (both modes): camels_head_step_halo's arguments (top and
// bottom null for the unsharded launch or at the image's edge), then
// partials, a (splits, cfg ? 2 : 1, batch * height * width) float
// workspace, and span and splits (ranges of span channels, the last
// shorter; splits = ceil(c / span)) in place of nothing; rows, threads
// (256), span and smem_bytes from ops/sampler_step.py::split_plan.  bf16:
// items of 64 channels where c and span are multiples of 64, else of 32
// (the last block of a range masked past it).  Returns the cudaError_t of
// the first failed launch.
extern "C" int camels_head_step_split(const float* h, const float* top, const float* bottom,
                                      const float* wt, const float* bias, const float* x,
                                      const float* z, const float* w_per_sample, float w,
                                      float* out, float* partials, int batch, int height,
                                      int width, int c, int rows, int cfg, int span,
                                      int splits, int threads, int smem_bytes, float c_eps,
                                      float inv_sqrt_a, float sigma, int tanh_out,
                                      void* stream) {
  if (threads != F32_THREADS || c % 4 || span % F32_CK) return (int)cudaErrorInvalidValue;
  return split_entry<float>(head_step_f32_split_kernel, h, top, bottom, wt, bias, x, z,
                            w_per_sample, w, out, partials, batch, height, width, c, rows, cfg,
                            span, splits, threads, smem_bytes, c_eps, inv_sqrt_a, sigma,
                            tanh_out, stream);
}

extern "C" int camels_head_step_split_bf16(const bf16* h, const bf16* top, const bf16* bottom,
                                           const bf16* wt, const bf16* bias, const float* x,
                                           const float* z, const float* w_per_sample, float w,
                                           float* out, float* partials, int batch, int height,
                                           int width, int c, int rows, int cfg, int span,
                                           int splits, int threads, int smem_bytes,
                                           float c_eps, float inv_sqrt_a, float sigma,
                                           int tanh_out, void* stream) {
  if (threads != BF16_THREADS || c % 8 || span % BLOCK) return (int)cudaErrorInvalidValue;
  return split_entry<bf16>(
      c % BLOCK == 0 ? head_step_bf16_split_kernel<BLOCK>
                     : head_step_bf16_split_kernel<NARROW_BLOCK>,
      h, top, bottom, wt, bias, x, z, w_per_sample, w, out, partials, batch, height, width, c,
      rows, cfg, span, splits, threads, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream);
}

namespace {

// One launch of a halo kernel of its own (head_step_bf16_halo_kernel,
// head_step_halo_f32_kernel): a CTA a band of `rows` rows of a unit.
template <typename E>
int band_launch(void (*kernel)(const E*, const E*, const E*, const E*, const E*,
                               const float*, const float*, const float*, float, float*, int,
                               int, int, int, int, int, float, float, float, int),
                const E* h, const E* top, const E* bottom, const E* wt, const E* bias,
                const float* x,
                const float* z, const float* w_per_sample, float w, float* out, int batch,
                int height, int width, int c, int rows, int cfg, int threads, int smem_bytes,
                float c_eps, float inv_sqrt_a, float sigma, int tanh_out, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    kernel<<<dim3((unsigned)(batch * ((height + rows - 1) / rows))), threads, smem_bytes,
             (cudaStream_t)stream>>>(h, top, bottom, wt, bias, x, z, w_per_sample, w, out,
                                     batch, height, width, c, rows, cfg, c_eps, inv_sqrt_a,
                                     sigma, tanh_out);
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

namespace {

// One launch of the unsharded bf16 kernel at items of IB channels.
template <int IB>
int bf16_launch(const bf16* h, const bf16* wt, const bf16* bias, const float* x,
                const float* z, const float* w_per_sample, float w, float* out, int batch,
                int height, int width, int c, int rows, int cfg, int smem_bytes, float c_eps,
                float inv_sqrt_a, float sigma, int tanh_out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(head_step_bf16_kernel<IB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err == cudaSuccess)
    head_step_bf16_kernel<IB><<<dim3((unsigned)(batch * ((height + rows - 1) / rows))),
                                BF16_THREADS, smem_bytes, (cudaStream_t)stream>>>(
        h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, rows, cfg, c_eps,
        inv_sqrt_a, sigma, tanh_out);
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// The bf16 instance (h, wt, bias bf16; c a multiple of 64): the arguments
// of camels_head_step without ck and stages; threads 256; rows and
// smem_bytes come from ops/sampler_step.py::bf16_plan.
extern "C" int camels_head_step_bf16(const bf16* h, const bf16* wt, const bf16* bias,
                                     const float* x, const float* z,
                                     const float* w_per_sample, float w, float* out,
                                     int batch, int height, int width, int c, int rows,
                                     int cfg, int threads, int smem_bytes, float c_eps,
                                     float inv_sqrt_a, float sigma, int tanh_out,
                                     void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (threads != BF16_THREADS || c % BLOCK) return (int)cudaErrorInvalidValue;
  return bf16_launch<BLOCK>(h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c,
                            rows, cfg, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream);
}

// The narrow bf16 instance (c a multiple of 8 but not of 64: items of
// NARROW_BLOCK channels, the last block masked past c):
// camels_head_step_bf16's arguments; rows and smem_bytes from
// ops/sampler_step.py::bf16_plan.
extern "C" int camels_head_step_bf16_narrow(const bf16* h, const bf16* wt, const bf16* bias,
                                            const float* x, const float* z,
                                            const float* w_per_sample, float w, float* out,
                                            int batch, int height, int width, int c, int rows,
                                            int cfg, int threads, int smem_bytes, float c_eps,
                                            float inv_sqrt_a, float sigma, int tanh_out,
                                            void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (threads != BF16_THREADS || c % 8 || c % BLOCK == 0) return (int)cudaErrorInvalidValue;
  return bf16_launch<NARROW_BLOCK>(h, wt, bias, x, z, w_per_sample, w, out, batch, height,
                                   width, c, rows, cfg, smem_bytes, c_eps, inv_sqrt_a, sigma,
                                   tanh_out, stream);
}

// The halo mode of the kernels of their own: camels_head_step_bf16's
// arguments with top and bottom after h, each (cfg ? 2 * batch : batch,
// width, c) of h's type, or null (zero rows) at the image's edge.  bf16:
// head_step_bf16_halo_kernel (c a multiple of 64 here, any other multiple
// of 8 in camels_head_step_halo_bf16_narrow below; threads 256, rows and
// smem_bytes from ops/sampler_step.py::bf16_plan); float:
// head_step_halo_f32_kernel (c a multiple of 4, threads 256, rows and
// smem_bytes from ops/sampler_step.py::halo_plan).
extern "C" int camels_head_step_halo_bf16(const bf16* h, const bf16* top, const bf16* bottom,
                                          const bf16* wt, const bf16* bias, const float* x,
                                          const float* z,
                                          const float* w_per_sample, float w, float* out,
                                          int batch, int height, int width, int c, int rows,
                                          int cfg, int threads, int smem_bytes, float c_eps,
                                          float inv_sqrt_a, float sigma, int tanh_out,
                                          void* stream) {
  if (threads != BF16_THREADS || c % BLOCK) return (int)cudaErrorInvalidValue;
  return band_launch<bf16>(head_step_bf16_halo_kernel<BLOCK>, h, top, bottom, wt, bias, x, z,
                           w_per_sample, w, out, batch, height, width, c, rows, cfg, threads,
                           smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream);
}

// The narrow bf16 halo mode (c a multiple of 8 but not of 64): the
// arguments of camels_head_step_halo_bf16.
extern "C" int camels_head_step_halo_bf16_narrow(
    const bf16* h, const bf16* top, const bf16* bottom, const bf16* wt, const bf16* bias,
    const float* x, const float* z, const float* w_per_sample, float w, float* out, int batch,
    int height, int width, int c, int rows, int cfg, int threads, int smem_bytes, float c_eps,
    float inv_sqrt_a, float sigma, int tanh_out, void* stream) {
  if (threads != BF16_THREADS || c % 8 || c % BLOCK == 0) return (int)cudaErrorInvalidValue;
  return band_launch<bf16>(head_step_bf16_halo_kernel<NARROW_BLOCK>, h, top, bottom, wt, bias,
                           x, z, w_per_sample, w, out, batch, height, width, c, rows, cfg,
                           threads, smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream);
}

extern "C" int camels_head_step_halo(const float* h, const float* top, const float* bottom,
                                     const float* wt, const float* bias, const float* x,
                                     const float* z,
                                     const float* w_per_sample, float w, float* out,
                                     int batch, int height, int width, int c, int rows,
                                     int cfg, int threads, int smem_bytes, float c_eps,
                                     float inv_sqrt_a, float sigma, int tanh_out,
                                     void* stream) {
  if (threads != F32_THREADS || c % 4) return (int)cudaErrorInvalidValue;
  return band_launch<float>(head_step_halo_f32_kernel, h, top, bottom, wt, bias, x, z,
                            w_per_sample, w, out, batch, height, width, c, rows, cfg, threads,
                            smem_bytes, c_eps, inv_sqrt_a, sigma, tanh_out, stream);
}

// The fp32 unsharded launch at widths from 128 (head_step_f32_band_kernel):
// camels_head_step_bf16's arguments on float features (c a multiple of 4,
// threads 256; rows and smem_bytes from ops/sampler_step.py::halo_plan).
extern "C" int camels_head_step_f32_band(const float* h, const float* wt, const float* bias,
                                         const float* x, const float* z,
                                         const float* w_per_sample, float w, float* out,
                                         int batch, int height, int width, int c, int rows,
                                         int cfg, int threads, int smem_bytes, float c_eps,
                                         float inv_sqrt_a, float sigma, int tanh_out,
                                         void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (threads != F32_THREADS || c % 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(head_step_f32_band_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err == cudaSuccess)
    head_step_f32_band_kernel<<<dim3((unsigned)(batch * ((height + rows - 1) / rows))),
                                F32_THREADS, smem_bytes, (cudaStream_t)stream>>>(
        h, wt, bias, x, z, w_per_sample, w, out, batch, height, width, c, rows, cfg, c_eps,
        inv_sqrt_a, sigma, tanh_out);
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
