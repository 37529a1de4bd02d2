// GroupNorm + affine + activation over NHWC, with an optional FiLM epilogue
// (K2).
//
// Replaces camels_diffusion_model_tpu/ops/pallas/groupnorm.py ::
// fused_groupnorm_act (Pallas TPU kernel, body _make_kernel :33-59,
// pallas_call :89), which GroupNormAct uses at up0_norm and out_norm
// (models/blocks.py:315-321).  It is held against the two-pass XLA path
// (blocks.py:322-330): fp32 statistics, mean first and then the centred
// variance, not the Pallas kernel's E[x^2] - E[x]^2 (a Mosaic workaround).
//
//   y = act((x - mean_g) * rsqrt(var_g + eps) * gamma_c + beta_c)
//   out = film ? y * scale[n, c] + shift[n, c] : y
//   act: 0 none, 1 relu, 2 erf-gelu, 3 leaky_relu(0.2)
//
// The FiLM epilogue is decoder stage 0 (context_unet.py:300,305: up0_norm,
// then cemb1 * u + temb1); scale/shift rows have stride C (one per sample)
// or 0 (one row for the batch).
//
// Bound on the H100: bytes at 3.35 TB/s, x read once and out written once
// (about ten flops per element).  Design:
//  - One (sample, group) is split over a thread-block cluster of 1-8 CTAs,
//    each taking a contiguous run of pixels, so that even 4 samples x 8
//    groups give 256 CTAs.  The launch plan (cluster size, pixels per CTA,
//    vector width) is chosen in ops/groupnorm.py::launch_plan.
//  - Each CTA reads its slice from device memory once, 16 bytes a thread,
//    into dynamic shared memory; the sum and then the centred sum of squares
//    come from that on-chip copy, and the CTAs of a cluster add their
//    partials through distributed shared memory in rank order, so every CTA
//    gets the same statistics.  Device memory sees one read and one write.
//  - A slice larger than a CTA's shared memory (the big model's out_norm,
//    (N, 128, 128, 256): 2 MiB a group, 256 KiB a CTA in a cluster of 8)
//    keeps its first resident_pixels in shared memory and spills the rest:
//    the variance and output passes read the spilled pixels again from
//    device memory (12% of that slice, so 1.23 reads of x in all).  The
//    alternative, a non-portable cluster of 16 at 128 KiB a CTA, needs 16
//    free SMs of one GPC for each group and was not taken: the plan could
//    not know before the launch whether the card schedules it.  The sums
//    are the same, in the same order, on both paths.
//  - A thread keeps the same channels for its whole slice (the block covers
//    whole pixels), so gamma, beta, scale and shift sit in registers and the
//    loops do no division.  Shapes whose channels per group are not a
//    multiple of one 16-byte access (4 floats, 8 bf16), or pointers not
//    16-byte aligned, take the scalar instance (V = 1) of the same kernel.
//
// The I/O type T is float or bf16 (the bf16 model, blocks.py:316-321 with
// dtype=bfloat16).  Whatever T, the statistics, gamma/beta and the
// activation are fp32 and y is rounded to T once, as the Pallas kernel
// does (ops/pallas/groupnorm.py:52-57); the FiLM epilogue then runs in T
// as context_unet.py:300-307 does: scale * y rounded, + shift rounded
// (rows of T).  Shared memory holds the slice as T, exact.  The template
// serves the float single launch, and the bf16 single launch only at the
// shapes no bf16 kernel below takes (ops/groupnorm.py::single_route: an
// unaligned pointer, a group of over 256 channels, or a group of whole
// packs whose part exceeds groupnorm_bf16_kernel's registers even in a
// cluster of 8; no model's).  groupnorm_bf16_kernel takes groups of whole
// 16-byte packs (the bf16 instance of this template took 78% of the float
// time for half the bytes, its 1024 CTAs at the w=2 out_norm 1.3 waves of
// one latency-bound chain each), groupnorm_bf16_narrow_kernel and
// groupnorm_bf16_wide_kernel the groups that are not (the out_norm of
// n_feat 32, 96 and 160; units of over 256 channels, as n_feat 264's
// heads: 33 packs a pixel), where this template's scalar instance read 2
// bytes a load, each with the same arithmetic and roundings.
//
// Sharded statistics (a height shard of a spatial mesh, whose GroupNorm
// statistics span every shard; XLA's SPMD partitioner inserts them in JAX)
// take two launches of their own, groupnorm_stats_kernel and
// groupnorm_apply_kernel at the end of this file: the first writes each
// (sample, group)'s (count, mean, centred M2) of the shard, the host
// all-reduces the shards' triples into an (n_parts, n, groups, 3) buffer,
// and the second merges them by Chan's formula and normalises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pack.cuh"

namespace cg = cooperative_groups;

namespace {

// Sum over the block (a multiple of 32 threads), returned to every thread.
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

// This CTA's partial plus every other CTA's of the cluster, in rank order.
__device__ float cluster_sum(cg::cluster_group& cluster, float* partial,
                             float block_total, int cluster_size) {
  if (threadIdx.x == 0) *partial = block_total;
  cluster.sync();
  float s = 0.0f;
  for (int r = 0; r < cluster_size; ++r) s += *cluster.map_shared_rank(partial, r);
  return s;
}

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case 1: return fmaxf(y, 0.0f);
    case 2: return 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
    case 3: return y > 0.0f ? y : 0.2f * y;
    default: return y;
  }
}

// Grid: (sample, group) major, cluster rank minor.  Dynamic shared memory:
// resident_pixels * cg elements of T, the CTA's slice as [pixel][channel of
// group].
template <typename T, int V>
__global__ void groupnorm_act_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ scale,
    const T* __restrict__ shift, T* __restrict__ out, int hw, int c,
    int groups, int cluster_size, int pixels_per_cta, int resident_pixels,
    int scale_stride, int shift_stride, float eps, int act) {
  extern __shared__ float4 slice_storage[];
  __shared__ float warp_sums[32];
  __shared__ float partials[2];
  cg::cluster_group cluster = cg::this_cluster();

  const int cgroup = c / groups, vpp = cgroup / V;  // vectors per pixel
  const int ng = blockIdx.x / cluster_size;
  const int n = ng / groups, g = ng - n * groups;
  const int rank = (int)cluster.block_rank();
  const int p0 = min(hw, rank * pixels_per_cta);
  const int np = min(hw, p0 + pixels_per_cta) - p0;
  const int pstride = blockDim.x / vpp;  // pixels the block covers per step
  const int j = (threadIdx.x % vpp) * V;  // this thread's channels in the group
  // Threads past the last whole pixel of the block only join the sums.
  const int first = threadIdx.x < pstride * vpp ? threadIdx.x / vpp : np;
  const int ch = g * cgroup + j;
  const long long base = ((long long)n * hw + p0) * c + ch;
  T* mine = reinterpret_cast<T*>(slice_storage) + j;
  const T* xs = x + base;  // this thread's channels of the slice
  // Pixels [0, res) of the slice sit in shared memory, [res, np) spill;
  // spill is this thread's first pixel at or past res.
  const int res = min(np, resident_pixels);
  const int spill =
      first >= res ? first : first + (res - first + pstride - 1) / pstride * pstride;
  // Second and third passes: this thread's pixels in order, each with its
  // values, from shared memory and then (spilled) from device memory.
  auto sweep = [&](auto&& body) {
    for (int p = first; p < res; p += pstride) body(p, load<V>(mine + p * cgroup));
    for (int p = spill; p < np; p += pstride) body(p, load<V>(xs + (long long)p * c));
  };

  float s = 0.0f;
#pragma unroll 4
  for (int p = first; p < np; p += pstride) {
    Pack<V> v = load<V>(xs + (long long)p * c);
    if (p < res) store<V>(mine + p * cgroup, v);  // only this thread reads it back
#pragma unroll
    for (int i = 0; i < V; ++i) s += v.v[i];
  }
  const float count = (float)((long long)hw * cgroup);
  const float mean =
      cluster_sum(cluster, &partials[0], block_sum(s, warp_sums), cluster_size) / count;

  float q = 0.0f;
  sweep([&](int, const Pack<V>& v) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float d = v.v[i] - mean;
      q += d * d;
    }
  });
  const float m2 = cluster_sum(cluster, &partials[1], block_sum(q, warp_sums), cluster_size);
  const float rstd = rsqrtf(m2 / count + eps);
  // Done with the other CTAs' shared memory; wait for them before exiting,
  // so no CTA's partials vanish while another still reads them.
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");

  const Pack<V> ga = load<V>(gamma + ch), be = load<V>(beta + ch);
  const bool film = scale != nullptr;
  Pack<V> sc{}, sh{};
  if (film) {
    sc = load<V>(scale + (long long)n * scale_stride + ch);
    sh = load<V>(shift + (long long)n * shift_stride + ch);
  }
  sweep([&](int p, Pack<V> v) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float y = activate((v.v[i] - mean) * rstd * ga.v[i] + be.v[i], act);
      v.v[i] = film ? round_to<T>(round_to<T>(round_to<T>(y) * sc.v[i]) + sh.v[i]) : y;
    }
    store<V>(out + base + (long long)p * c, v);
  });
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <typename T, int V>
cudaError_t launch(cudaLaunchConfig_t* cfg, const T* x, const float* gamma,
                   const float* beta, const T* scale, const T* shift,
                   T* out, int hw, int c, int groups, int cluster,
                   int pixels_per_cta, int resident_pixels, int scale_stride,
                   int shift_stride, float eps, int act) {
  cudaError_t err = cudaSuccess;
  // Past 48 KiB in all, static arrays included (warp_sums, partials), a
  // launch needs the opt-in: a 48 KiB slice (bf16 n_feat 96's unaligned
  // out_norm in a cluster of 2) was refused without it.
  if (cfg->dynamicSmemBytes + 1024 > 48 * 1024)
    err = cudaFuncSetAttribute(groupnorm_act_kernel<T, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg->dynamicSmemBytes);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(cfg, groupnorm_act_kernel<T, V>, x, gamma, beta, scale, shift,
                             out, hw, c, groups, cluster, pixels_per_cta, resident_pixels,
                             scale_stride, shift_stride, eps, act);
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
int entry(const T* x, const float* gamma, const float* beta, const T* scale,
          const T* shift, T* out, int n, int hw, int c, int groups,
          int scale_stride, int shift_stride, float eps, int act, int vec,
          int cluster, int threads, int pixels_per_cta, int resident_pixels,
          int smem_bytes, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * groups * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (vec == kVec<T>)
    return (int)launch<T, kVec<T>>(&cfg, x, gamma, beta, scale, shift, out, hw, c, groups,
                                   cluster, pixels_per_cta, resident_pixels, scale_stride,
                                   shift_stride, eps, act);
  if (vec == 1)
    return (int)launch<T, 1>(&cfg, x, gamma, beta, scale, shift, out, hw, c, groups, cluster,
                             pixels_per_cta, resident_pixels, scale_stride, shift_stride,
                             eps, act);
  return (int)cudaErrorInvalidValue;
}

// ---- The bf16 single launch: segments of groups, one merge. ----
//
// A unit is a (sample, segment): seg consecutive groups of one sample, so
// that a pixel's slice of the unit is at least 64 bytes, two sectors (2
// groups of the out_norm's 16 channels; up0_norm's groups of 32 are one
// each): the out_norm's 32-byte slices of one group read slower, and of
// segments of 1, 2, 4 and 8 groups two ran fastest
// (scripts/compare_torch_kernels.py --dtype bfloat16).  A unit's pixels
// split over a cluster of `cluster` CTAs, `part_px` each, as the
// template's (sample, group) does (ops/groupnorm.py::bf16_plan).  A
// thread issues all K of its 16-byte loads at once, before anything else,
// and keeps its packs in registers: no copy of the part goes to shared
// memory and back (the template's bf16 slices in shared memory left the
// w=2 out_norm's 1024 CTAs 1.3 waves).  Statistics in one merge: each
// thread merges the centred moments (count, mean, M2) of its packs, one
// pack as it lands, by Chan's formula (the k-th pack of V weighs 1 / k);
// the lanes of one group merge by the same formula across the warp (a
// butterfly over the lane bits that keep the group), then the block's
// warps in order and the cluster's CTAs in rank order, so every CTA gets
// the same statistics: one cluster barrier where the template takes two,
// and the variance stays centred.  The segment's gamma, beta and FiLM rows
// go to shared memory while the packs land (no registers held for them).
// The output is normalised from the registers and written once, with the
// activation and the FiLM epilogue fixed at compile time (see the kernel).

struct Moments {
  float n, mean, m2;
};

// Chan's merge of a (first) and b, in that order (the weight b.n / n by
// the fast division: 2 ulps, far inside the statistics' fp32 rounding).
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.0f) return a;
  const float n = a.n + b.n, f = __fdividef(b.n, n), d = b.mean - a.mean;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// Four bf16 (8 bytes) as floats.
__device__ __forceinline__ Pack<4> load4(const bf16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  return Pack<4>{{__uint_as_float(t.x << 16), __uint_as_float(t.x & 0xffff0000u),
                  __uint_as_float(t.y << 16), __uint_as_float(t.y & 0xffff0000u)}};
}

__device__ __forceinline__ uint4 load_stream(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

constexpr int MAX_SEG = 8;  // groups of one segment
constexpr int MAX_SEG_CH = 256;  // channels of one segment
constexpr int BF16_THREADS = 512;  // a CTA at most

// Grid: unit (sample major, segment minor) major, cluster rank minor.
// Thread t holds pack t % vs (vs = the segment's packs a pixel) of pixels
// t / vs, + pstride, ... (K of them) of its part: one group's 8 channels.
// The activation (ACT, as activate's act) and the FiLM epilogue (FILM) are
// template arguments: with K packs unrolled, a runtime choice inlines every
// activation's code (erff's among them) beside each of the K * 8 outputs,
// and the instruction fetch of that code, cold after the layers before it,
// cost a served step's out_norm more than the isolated launch takes.
template <int K, int ACT, bool FILM>
__global__ void __launch_bounds__(BF16_THREADS) groupnorm_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ scale,
    const bf16* __restrict__ shift, bf16* __restrict__ out, int hw, int c, int groups,
    int seg, int cluster_size, int part_px, int scale_stride, int shift_stride, float eps) {
  constexpr int V = 8;  // one 16-byte pack
  __shared__ Moments warp_moments[BF16_THREADS / 32][MAX_SEG];
  __shared__ Moments block_moments[MAX_SEG];
  // The segment's gamma, beta (float) and FiLM rows (bf16, as floats):
  // read in the output pass, not held in registers through the loads.
  __shared__ float4 operands[4][MAX_SEG_CH / 4];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vpg = c / groups / V, vs = vpg * seg;  // packs per group, per segment
  const int segs = groups / seg;
  const int unit = blockIdx.x / cluster_size;
  const int nn = unit / segs, sg = unit - nn * segs;
  const int rank = (int)cluster.block_rank();
  const int p0 = min(hw, rank * part_px);
  const int np = min(hw, p0 + part_px) - p0;
  const int pstride = blockDim.x / vs;  // pixels the block covers per step
  const int j = tid % vs, gl = j / vpg;  // this thread's pack and group in the segment
  // Threads past the last whole pixel of the block only join the merges.
  const int first = tid < pstride * vs ? tid / vs : np;
  const int ch = sg * vs * V + j * V;
  const long long base = ((long long)nn * hw + p0) * c + ch;

  uint4 raw[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int p = first + i * pstride;
    raw[i] = p < np ? load_stream(x + base + (long long)p * c) : make_uint4(0u, 0u, 0u, 0u);
  }
  // The per-channel operands of the segment into shared memory, 4 floats
  // a thread, their latency under the statistics and the merges.
  const int seg0 = sg * vs * V;
  for (int q = tid; q < vs * 2; q += blockDim.x) {  // 4 channels each
    const int cq = seg0 + 4 * q;
    operands[0][q] = *reinterpret_cast<const float4*>(gamma + cq);
    operands[1][q] = *reinterpret_cast<const float4*>(beta + cq);
    if constexpr (FILM) {
      const Pack<4> a = load4(scale + (long long)nn * scale_stride + cq);
      const Pack<4> b = load4(shift + (long long)nn * shift_stride + cq);
      operands[2][q] = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
      operands[3][q] = make_float4(b.v[0], b.v[1], b.v[2], b.v[3]);
    }
  }
  Moments m{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (first + i * pstride < np) {
      const Pack<V> v = load<V>(reinterpret_cast<const bf16*>(&raw[i]));
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < V; ++e) sum += v.v[e];
      const float pm = sum * (1.0f / V);
      float pq = 0.0f;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v.v[e] - pm;
        pq += d * d;
      }
      const float f = 1.0f / (float)(i + 1), d = pm - m.mean;
      m.mean += d * f;
      m.m2 += pq + d * d * (m.n * f);
      m.n += (float)V;
    }
  }
  // The lanes of one group: the butterfly skips the lane bits that change
  // the group (at and above a group's packs, below a pixel's), which needs
  // vpg and vs powers of two where seg > 1; with seg 1 every lane holds the
  // one group and no offset is skipped, whatever vpg.  Partners merge the
  // lower lane first, so every lane of the group gets the same.
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= vpg && off < vs) continue;
    const Moments o{__shfl_xor_sync(0xffffffffu, m.n, off),
                    __shfl_xor_sync(0xffffffffu, m.mean, off),
                    __shfl_xor_sync(0xffffffffu, m.m2, off)};
    m = (lane & off) ? merge(o, m) : merge(m, o);
  }
  // A warp's lanes hold packs (32 warp) % vs, ... (all of a pixel's: vs is
  // at most 32); its first lane of each group writes the group's moments.
  if (lane % vpg == 0 && lane < vs) warp_moments[warp][gl] = m;
  __syncthreads();
  if (tid < seg) {
    Moments b{0.0f, 0.0f, 0.0f};
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) b = merge(b, warp_moments[w][tid]);
    block_moments[tid] = b;
  }
  cluster.sync();  // every CTA's block_moments is written
  // The ranks' moments, all requested before the merges (in rank order).
  Moments ranks[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < cluster_size) ranks[r] = *cluster.map_shared_rank(&block_moments[gl], r);
  Moments t = ranks[0];
#pragma unroll
  for (int r = 1; r < 8; ++r)
    if (r < cluster_size) t = merge(t, ranks[r]);
  // Done with the other CTAs' shared memory; wait for them before exiting.
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  const float mean = t.mean, rstd = rsqrtf(t.m2 / t.n + eps);

  const float* ops = reinterpret_cast<const float*>(operands) + j * V;
  constexpr int ROW = MAX_SEG_CH;  // floats of one operand row
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int p = first + i * pstride;
    if (p < np) {
      Pack<V> v = load<V>(reinterpret_cast<const bf16*>(&raw[i]));
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float y = activate((v.v[e] - mean) * rstd * ops[e] + ops[ROW + e], ACT);
        if constexpr (FILM)
          v.v[e] = round_to<bf16>(round_to<bf16>(round_to<bf16>(y) * ops[2 * ROW + e]) +
                                  ops[3 * ROW + e]);
        else
          v.v[e] = y;
      }
      store<V>(out + base + (long long)p * c, v);
    }
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int K, int ACT, bool FILM>
cudaError_t launch_bf16(cudaLaunchConfig_t* cfg, const bf16* x, const float* gamma,
                        const float* beta, const bf16* scale, const bf16* shift, bf16* out,
                        int hw, int c, int groups, int seg, int cluster, int part_px,
                        int scale_stride, int shift_stride, float eps) {
  cudaError_t err = cudaLaunchKernelEx(cfg, groupnorm_bf16_kernel<K, ACT, FILM>, x, gamma,
                                       beta, scale, shift, out, hw, c, groups, seg, cluster,
                                       part_px, scale_stride, shift_stride, eps);
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// launch_bf16 with the activation and the FiLM epilogue as template
// arguments (act as activate's; FiLM where scale is given).
template <int K>
cudaError_t launch_bf16_act(cudaLaunchConfig_t* cfg, const bf16* x, const float* gamma,
                            const float* beta, const bf16* scale, const bf16* shift, bf16* out,
                            int hw, int c, int groups, int seg, int cluster, int part_px,
                            int scale_stride, int shift_stride, float eps, int act) {
#define CAMELS_BF16_ACT(A)                                                                    \
  if (act == A)                                                                               \
    return scale ? launch_bf16<K, A, true>(cfg, x, gamma, beta, scale, shift, out, hw, c,   \
                                           groups, seg, cluster, part_px, scale_stride,     \
                                           shift_stride, eps)                               \
                 : launch_bf16<K, A, false>(cfg, x, gamma, beta, scale, shift, out, hw, c,  \
                                            groups, seg, cluster, part_px, scale_stride,    \
                                            shift_stride, eps);
  CAMELS_BF16_ACT(0)
  CAMELS_BF16_ACT(1)
  CAMELS_BF16_ACT(2)
  CAMELS_BF16_ACT(3)
#undef CAMELS_BF16_ACT
  return cudaErrorInvalidValue;
}

// ---- The bf16 single launch where a group is not whole 16-byte packs. ----
//
// groupnorm_bf16_narrow_kernel: the shapes groupnorm_bf16_kernel refuses
// because a group's channels are not a multiple of 8 (the out_norm of
// n_feat 32, 96 and 160: 4, 12 and 20 channels a group), with its
// arithmetic: fp32 statistics, centred, merged by Chan's formula; fp32
// gamma/beta and activation, one rounding to bf16; the FiLM epilogue in
// bf16.  Bound: bytes, x read once and out written once.
//
// A unit is a segment of seg groups of a sample whose slice of a pixel is
// whole 16-byte packs (seg * cg a multiple of 8: seg = 8 / gcd(cg, 8)),
// widened until it is whole 32-byte sectors where the groups allow
// (ops/groupnorm.py::narrow_plan: 4 groups at n_feat 32, 96 and 160: 2, 6
// and 10 packs).  Its pixels split over a cluster (the smallest whose
// parts fit: at 16 maps clusters of 8 ran 1.35x slower than of 2), a
// part a CTA, and a thread holds pack t % vs of
// pixels t / vs, + pstride, ... (vs the unit's packs a pixel, the block a
// multiple of it), all K loads issued at once into registers, as in
// groupnorm_bf16_kernel: a warp's loads run along whole slices of pixels.
// Two things break that kernel's merge here: a pack straddles groups (at
// cg 12 pack 1 holds channels 8-11 of group 0 and 12-15 of group 1; at cg
// 3 it touches up to 4 groups), and vs is not a power of two (6 at n_feat
// 96, 10 at 160), so no butterfly over lane bits keeps a group.  So the
// statistics are merged per channel, which a thread keeps for the whole
// launch, and grouped last:
//  - a thread's 8 channels: their mean over its pixels, then the sums of
//    squares about them (both from registers; one count for all 8);
//  - the lanes of a warp that hold the same pack (lanes vs apart) merge by
//    Chan's formula in a tree of shuffles vs, 2 vs, 4 vs, ... lanes down,
//    lower lane first, into lanes 0 .. vs - 1 (one lane a pack: vs <= 32);
//  - the block's warps, in order, a thread a channel (shared memory);
//  - a group from its channels (equal counts: the mean of their means, and
//    their sums of squares plus the spread of their means);
//  - the cluster's CTAs in rank order, through distributed shared memory,
//    so every CTA gets the same statistics.
// A thread's channels map to their groups once, before the output pass:
// each channel's mean, rstd * gamma, beta and FiLM rows go from shared
// memory to registers once (a global store may alias shared memory as far
// as the compiler knows, so operands read inside the pass would be read
// again after every pack's store), and the pass writes each pack once.
//
// groupnorm_bf16_wide_kernel: the units that layout cannot hold, with the
// same arithmetic and, from the block's channels up, the same merges.  A
// unit's packs a pixel tile no whole warps of whole pixels within 512
// threads where they are over 32 (a unit of over 256 channels: n_feat
// 264's out_norm, 8 groups of 33, and up0_norm, 4 of 66: 33 packs; n_feat
// 280's out_norm, 35) or an odd number from 17 to 31 (n_feat 136-248's
// out_norm); and a part may be over 16 packs a thread even in a cluster of
// 8 (n_feat 264's 64x64 out_norm: 512 pixels of 33 packs a CTA).  So:
//  - a CTA is whole warps (ops/groupnorm.py::idle_lane_threads), thread t <
//    pstride * vs holding pack t % vs of pixels t / vs, + pstride, ...;
//    the lanes past its last whole pixel hold no pixel and only join the
//    merges and barriers (the sharded launches' layout);
//  - a thread takes its pixels in rounds of K packs, the K loads of a
//    round issued at once into registers; each round's per-channel mean
//    and centred squares merge into the thread's by Chan's formula (the
//    first round is the narrow kernel's whole computation); the output
//    pass writes the last round from the registers and reads the earlier
//    rounds again (from L2 where a wave's parts fit it);
//  - with no lane tree (a pixel's packs straddle warps), each thread
//    publishes its 8 channels' (count, mean, M2) to shared memory once,
//    and one thread a channel merges that channel's entries in the
//    threads' pixel rows' order: a fixed order whatever vs, within shared
//    memory at the widest unit the plan takes (8 groups of 255: 98 KiB).
// Its shared memory is dynamic (wide_smem_bytes): the unit's operand rows
// [6][uc], the threads' moments [pstride * vs][8] twice, the block's
// per-channel moments [uc] twice, the threads' counts [pstride * vs].

constexpr int NARROW_THREADS = 512;  // a CTA at most
constexpr int NARROW_CH = 256;  // channels of one unit at most (32 packs: a warp's lanes)
constexpr int NARROW_GROUP_CH = 256;  // channels of a group at most (a wide unit: 8 of them)

// The unit's per-channel operands into shared memory, 4 channels a thread,
// rows of `row` floats: 0 gamma, 1 beta, 2 and 3 sample nn's FiLM scale and
// shift (as floats).
template <bool FILM>
__device__ __forceinline__ void stage_operands(float* ops, int row, int seg0, int uc,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta,
                                               const bf16* __restrict__ scale,
                                               const bf16* __restrict__ shift, int nn,
                                               int scale_stride, int shift_stride) {
  float4* o = reinterpret_cast<float4*>(ops);
  const int r4 = row / 4;
  for (int q = threadIdx.x; q < uc / 4; q += blockDim.x) {  // 4 channels each
    const int cq = seg0 + 4 * q;
    o[q] = *reinterpret_cast<const float4*>(gamma + cq);
    o[r4 + q] = *reinterpret_cast<const float4*>(beta + cq);
    if constexpr (FILM) {
      const Pack<4> a = load4(scale + (long long)nn * scale_stride + cq);
      const Pack<4> b = load4(shift + (long long)nn * shift_stride + cq);
      o[2 * r4 + q] = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
      o[3 * r4 + q] = make_float4(b.v[0], b.v[1], b.v[2], b.v[3]);
    }
  }
}

// Thread g < seg: group g's moments over the part's np pixels from its
// cgroup channels' (equal counts: the mean of their means, their sums of
// squares plus the spread of their means).
__device__ __forceinline__ void group_from_channels(Moments* block_moments,
                                                    const float* chan_mean,
                                                    const float* chan_m2, int seg, int cgroup,
                                                    int np) {
  const int tid = threadIdx.x;
  if (tid < seg) {
    const float* cm = chan_mean + tid * cgroup;
    const float* cq = chan_m2 + tid * cgroup;
    float s = 0.0f;
    for (int k = 0; k < cgroup; ++k) s += cm[k];
    const float gm = s / (float)cgroup;
    float q = 0.0f, spread = 0.0f;
    for (int k = 0; k < cgroup; ++k) {
      const float d = cm[k] - gm;
      q += cq[k];
      spread += d * d;
    }
    block_moments[tid] = Moments{(float)np * cgroup, gm, q + (float)np * spread};
  }
}

// After the cluster barrier: each of the unit's uc channels' group
// statistics, the cluster's ranks merged in order, its mean into
// mean_row and its rstd into rstd_row.
__device__ __forceinline__ void channel_statistics(cg::cluster_group& cluster,
                                                   Moments* block_moments, float* mean_row,
                                                   float* rstd_row, int uc, int cgroup,
                                                   int cluster_size, float eps) {
  for (int t = threadIdx.x; t < uc; t += blockDim.x) {  // a channel's group: the ranks in order
    const int g = t / cgroup;
    Moments ranks[8];  // all requested before the merges
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < cluster_size) ranks[r] = *cluster.map_shared_rank(&block_moments[g], r);
    Moments m = ranks[0];
#pragma unroll
    for (int r = 1; r < 8; ++r)
      if (r < cluster_size) m = merge(m, ranks[r]);
    mean_row[t] = m.mean;
    rstd_row[t] = rsqrtf(m.m2 / m.n + eps);
  }
}

// A thread's 8 channels' operands, in registers for the output pass: the
// group mean, rstd * gamma, beta and the FiLM rows.
struct ChannelOps {
  float mu[8], ga[8], be[8], sc[8], sh[8];
};

// From the operand rows (stage_operands' and channel_statistics' rows 4
// and 5) at this thread's first channel, rows `row` floats apart.
template <bool FILM>
__device__ __forceinline__ ChannelOps channel_operands(const float* ops, int row) {
  ChannelOps o;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    o.mu[e] = ops[4 * row + e];
    o.ga[e] = ops[5 * row + e] * ops[e];  // rstd * gamma
    o.be[e] = ops[row + e];
    o.sc[e] = FILM ? ops[2 * row + e] : 0.0f;
    o.sh[e] = FILM ? ops[3 * row + e] : 0.0f;
  }
  return o;
}

// One pack normalised, activated, through the FiLM epilogue and stored.
template <int ACT, bool FILM>
__device__ __forceinline__ void normalise_store(const uint4& raw, const ChannelOps& o,
                                                bf16* dst) {
  Pack<8> v = load<8>(reinterpret_cast<const bf16*>(&raw));
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float y = activate((v.v[e] - o.mu[e]) * o.ga[e] + o.be[e], ACT);
    if constexpr (FILM)
      v.v[e] = round_to<bf16>(round_to<bf16>(round_to<bf16>(y) * o.sc[e]) + o.sh[e]);
    else
      v.v[e] = y;
  }
  store<8>(dst, v);
}

// Grid: unit (sample major, segment minor) major, cluster rank minor.
// ACT and FILM as in groupnorm_bf16_kernel.
template <int K, int ACT, bool FILM>
__global__ void __launch_bounds__(NARROW_THREADS) groupnorm_bf16_narrow_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ scale,
    const bf16* __restrict__ shift, bf16* __restrict__ out, int hw, int c, int groups,
    int seg, int cluster_size, int part_px, int scale_stride, int shift_stride, float eps) {
  constexpr int V = 8;  // one 16-byte pack
  constexpr int WARPS = NARROW_THREADS / 32;
  __shared__ float4 warp_mean[WARPS][NARROW_CH / 4];  // each warp's per-channel moments
  __shared__ float4 warp_m2[WARPS][NARROW_CH / 4];
  __shared__ float warp_n[WARPS][NARROW_CH / V];  // one count a (warp, pack)
  __shared__ float chan_mean[NARROW_CH], chan_m2[NARROW_CH];  // the block's, a channel
  __shared__ Moments block_moments[MAX_SEG];
  // A channel's gamma, beta, FiLM rows (as floats), its group's mean and rstd.
  __shared__ float4 operands[6][NARROW_CH / 4];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgroup = c / groups, uc = seg * cgroup;  // channels of a group, of the unit
  const int vs = uc / V;  // packs of a unit's pixel
  const int segs = groups / seg;
  const int unit = blockIdx.x / cluster_size;
  const int nn = unit / segs, sg = unit - nn * segs;
  const int rank = (int)cluster.block_rank();
  const int p0 = min(hw, rank * part_px);
  const int np = min(hw, p0 + part_px) - p0;
  const int pstride = blockDim.x / vs;  // pixels the block covers per step
  const int j = tid % vs, first = tid / vs;  // this thread's pack and first pixel
  const int seg0 = sg * uc;  // the unit's first channel
  const long long base = ((long long)nn * hw + p0) * c + seg0 + j * V;
  float* ops = reinterpret_cast<float*>(operands);
  constexpr int ROW = NARROW_CH;  // floats of one operand row

  uint4 raw[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int p = first + i * pstride;
    raw[i] = p < np ? load_stream(x + base + (long long)p * c) : make_uint4(0u, 0u, 0u, 0u);
  }
  stage_operands<FILM>(ops, ROW, seg0, uc, gamma, beta, scale, shift, nn, scale_stride,
                       shift_stride);

  // This thread's channels: the mean over its pixels, then the centred sum
  // of squares.
  const int mine = np > first ? min(K, (np - first + pstride - 1) / pstride) : 0;
  float cnt = (float)mine, mean[V], m2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) mean[e] = m2[e] = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < mine) {
      const Pack<V> v = load<V>(reinterpret_cast<const bf16*>(&raw[i]));
#pragma unroll
      for (int e = 0; e < V; ++e) mean[e] += v.v[e];
    }
  }
  const float inv = mine ? 1.0f / cnt : 0.0f;
#pragma unroll
  for (int e = 0; e < V; ++e) mean[e] *= inv;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < mine) {
      const Pack<V> v = load<V>(reinterpret_cast<const bf16*>(&raw[i]));
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v.v[e] - mean[e];
        m2[e] += d * d;
      }
    }
  }
  // The lanes that hold this pack (row lane / vs of the warp): row r takes
  // row r + s where r % 2s == 0, so lanes 0 .. vs - 1 end with the warp's.
  const int row = lane / vs;
  for (int s = 1; s * vs < 32; s <<= 1) {
    const int off = s * vs;
    const float on = __shfl_down_sync(0xffffffffu, cnt, off);
    float om[V], oq[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      om[e] = __shfl_down_sync(0xffffffffu, mean[e], off);
      oq[e] = __shfl_down_sync(0xffffffffu, m2[e], off);
    }
    if (row % (2 * s) == 0 && lane + off < 32 && on > 0.0f) {
      const float tot = cnt + on, f = __fdividef(on, tot);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = om[e] - mean[e];
        mean[e] += d * f;
        m2[e] += oq[e] + d * d * (cnt * f);
      }
      cnt = tot;
    }
  }
  if (lane < vs) {  // lanes 0 .. vs - 1 hold every pack once
    warp_n[warp][j] = cnt;
    warp_mean[warp][2 * j] = make_float4(mean[0], mean[1], mean[2], mean[3]);
    warp_mean[warp][2 * j + 1] = make_float4(mean[4], mean[5], mean[6], mean[7]);
    warp_m2[warp][2 * j] = make_float4(m2[0], m2[1], m2[2], m2[3]);
    warp_m2[warp][2 * j + 1] = make_float4(m2[4], m2[5], m2[6], m2[7]);
  }
  __syncthreads();
  const int warps = (int)(blockDim.x >> 5);
  for (int t = tid; t < uc; t += blockDim.x) {  // a channel: the warps in order
    Moments b{0.0f, 0.0f, 0.0f};
    for (int w = 0; w < warps; ++w)
      b = merge(b, Moments{warp_n[w][t / V], reinterpret_cast<const float*>(warp_mean[w])[t],
                           reinterpret_cast<const float*>(warp_m2[w])[t]});
    chan_mean[t] = b.mean;
    chan_m2[t] = b.m2;
  }
  __syncthreads();
  group_from_channels(block_moments, chan_mean, chan_m2, seg, cgroup, np);
  cluster.sync();  // every CTA's block_moments is written
  channel_statistics(cluster, block_moments, ops + 4 * ROW, ops + 5 * ROW, uc, cgroup,
                     cluster_size, eps);
  // Done with the other CTAs' shared memory; wait for them before exiting.
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  __syncthreads();  // every channel's operands are in shared memory

  const ChannelOps o = channel_operands<FILM>(ops + j * V, ROW);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < mine)
      normalise_store<ACT, FILM>(raw[i], o, out + base + (long long)(first + i * pstride) * c);
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Grid as groupnorm_bf16_narrow_kernel's.  Block: whole warps, at least a
// unit's pixel; threads past the last whole pixel idle.  K packs a round.
template <int K, int ACT, bool FILM>
__global__ void __launch_bounds__(NARROW_THREADS) groupnorm_bf16_wide_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ scale,
    const bf16* __restrict__ shift, bf16* __restrict__ out, int hw, int c, int groups,
    int seg, int cluster_size, int part_px, int scale_stride, int shift_stride, float eps) {
  constexpr int V = 8;  // one 16-byte pack
  extern __shared__ float4 wide_smem[];
  __shared__ Moments block_moments[MAX_SEG];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int cgroup = c / groups, uc = seg * cgroup;  // channels of a group, of the unit
  const int vs = uc / V;  // packs of a unit's pixel
  const int segs = groups / seg;
  const int unit = blockIdx.x / cluster_size;
  const int nn = unit / segs, sg = unit - nn * segs;
  const int rank = (int)cluster.block_rank();
  const int p0 = min(hw, rank * part_px);
  const int np = min(hw, p0 + part_px) - p0;
  const int pstride = blockDim.x / vs;  // whole pixels the block covers per step
  const int active = pstride * vs;  // the threads that hold pixels
  const int j = tid % vs;
  const int first = tid < active ? tid / vs : np;  // an idle lane: no pixel
  const int seg0 = sg * uc;  // the unit's first channel
  const long long base = ((long long)nn * hw + p0) * c + seg0 + j * V;
  float* ops = reinterpret_cast<float*>(wide_smem);  // [6][uc]
  float* tmean = ops + 6 * uc;  // [active][V]: a thread's channels' moments
  float* tm2 = tmean + pstride * uc;
  float* chan_mean = tm2 + pstride * uc;  // [uc]: the block's, a channel
  float* chan_m2 = chan_mean + uc;
  float* tcnt = chan_m2 + uc;  // [active]

  const int rows = first < np ? (np - first + pstride - 1) / pstride : 0;  // this thread's pixels
  const int rounds = (rows + K - 1) / K;
  uint4 raw[K];
  auto fetch = [&](int r) {  // round r's K packs, all requested at once
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int p = first + (r * K + i) * pstride;
      raw[i] = p < np ? load_stream(x + base + (long long)p * c) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  fetch(0);
  stage_operands<FILM>(ops, uc, seg0, uc, gamma, beta, scale, shift, nn, scale_stride,
                       shift_stride);

  // This thread's channels: each round's mean over its pixels and centred
  // sum of squares, merged into the thread's by Chan's formula.
  float cnt = 0.0f, mean[V], m2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) mean[e] = m2[e] = 0.0f;
  for (int r = 0; r < rounds; ++r) {
    if (r) fetch(r);
    const int m = min(K, rows - r * K);
    float rm[V], rq[V];
#pragma unroll
    for (int e = 0; e < V; ++e) rm[e] = rq[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i < m) {
        const Pack<V> v = load<V>(reinterpret_cast<const bf16*>(&raw[i]));
#pragma unroll
        for (int e = 0; e < V; ++e) rm[e] += v.v[e];
      }
    }
    const float inv = 1.0f / (float)m;
#pragma unroll
    for (int e = 0; e < V; ++e) rm[e] *= inv;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i < m) {
        const Pack<V> v = load<V>(reinterpret_cast<const bf16*>(&raw[i]));
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = v.v[e] - rm[e];
          rq[e] += d * d;
        }
      }
    }
    const float tot = cnt + (float)m, f = __fdividef((float)m, tot);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = rm[e] - mean[e];
      mean[e] += d * f;
      m2[e] += rq[e] + d * d * (cnt * f);
    }
    cnt = tot;
  }
  if (tid < active) {  // published once; thread t = r * vs + j holds row r's pack j
    tcnt[tid] = cnt;
    float4* tm = reinterpret_cast<float4*>(tmean) + 2 * tid;
    float4* tq = reinterpret_cast<float4*>(tm2) + 2 * tid;
    tm[0] = make_float4(mean[0], mean[1], mean[2], mean[3]);
    tm[1] = make_float4(mean[4], mean[5], mean[6], mean[7]);
    tq[0] = make_float4(m2[0], m2[1], m2[2], m2[3]);
    tq[1] = make_float4(m2[4], m2[5], m2[6], m2[7]);
  }
  __syncthreads();
  for (int t = tid; t < uc; t += blockDim.x) {  // a channel: the pixel rows in order
    Moments b{0.0f, 0.0f, 0.0f};
    for (int r = 0; r < pstride; ++r)
      b = merge(b, Moments{tcnt[r * vs + t / V], tmean[r * uc + t], tm2[r * uc + t]});
    chan_mean[t] = b.mean;
    chan_m2[t] = b.m2;
  }
  __syncthreads();
  group_from_channels(block_moments, chan_mean, chan_m2, seg, cgroup, np);
  cluster.sync();  // every CTA's block_moments is written
  channel_statistics(cluster, block_moments, ops + 4 * uc, ops + 5 * uc, uc, cgroup,
                     cluster_size, eps);
  // Done with the other CTAs' shared memory; wait for them before exiting.
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  __syncthreads();  // every channel's operands are in shared memory

  const ChannelOps o = channel_operands<FILM>(ops + j * V, uc);
  auto emit = [&](int r) {  // round r's packs, from raw
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int p = first + (r * K + i) * pstride;
      if (p < np) normalise_store<ACT, FILM>(raw[i], o, out + base + (long long)p * c);
    }
  };
  if (rounds) {
    emit(rounds - 1);  // the last round, still in registers
    for (int r = 0; r + 1 < rounds; ++r) {
      fetch(r);
      emit(r);
    }
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Dynamic shared memory of groupnorm_bf16_wide_kernel (its layout above).
__host__ __device__ constexpr int wide_smem_bytes(int uc, int threads) {
  return 4 * (8 * uc + 2 * (threads / (uc / 8)) * uc + threads / (uc / 8) * (uc / 8));
}

template <int K>
cudaError_t launch_narrow_act(cudaLaunchConfig_t* cfg, bool wide, const bf16* x,
                              const float* gamma, const float* beta, const bf16* scale,
                              const bf16* shift, bf16* out, int hw, int c, int groups, int seg,
                              int cluster, int part_px, int scale_stride, int shift_stride,
                              float eps, int act) {
  using Kernel = void (*)(const bf16*, const float*, const float*, const bf16*, const bf16*,
                          bf16*, int, int, int, int, int, int, int, int, float);
  Kernel kernel = nullptr;
#define CAMELS_NARROW_ACT(A)                                                             \
  if (act == A)                                                                          \
    kernel = wide ? (scale ? groupnorm_bf16_wide_kernel<K, A, true>                      \
                           : groupnorm_bf16_wide_kernel<K, A, false>)                    \
                  : (scale ? groupnorm_bf16_narrow_kernel<K, A, true>                    \
                           : groupnorm_bf16_narrow_kernel<K, A, false>);
  CAMELS_NARROW_ACT(0)
  CAMELS_NARROW_ACT(1)
  CAMELS_NARROW_ACT(2)
  CAMELS_NARROW_ACT(3)
#undef CAMELS_NARROW_ACT
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (cfg->dynamicSmemBytes > 0)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg->dynamicSmemBytes);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(cfg, kernel, x, gamma, beta, scale, shift, out, hw, c, groups,
                             seg, cluster, part_px, scale_stride, shift_stride, eps);
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ---- The sharded launches: statistics, then apply. ----
//
// Statistics (groupnorm_stats_kernel).  Bound: bytes, the shard read once.
// A unit is a (sample, segment): seg consecutive groups of one sample, the
// fewest whose slice of a pixel is 64 bytes where the groups allow (the
// out_norm's 16 channels a group: one group in fp32, two in bf16).  Its
// pixels split over a cluster of `cluster` CTAs, a part of part_px each,
// and the cluster is 1 (no barrier at all) wherever the units alone give
// every SM a CTA (ops/groupnorm.py::stats_plan).  A thread keeps one pack
// of the segment (one group's channels) and streams its pixels STATS_LOADS
// packs at a time, all requested before any is used, straight into
// registers: the statistics need one read, so no copy of the slice goes
// to shared memory (two rounds in flight, the next requested before this
// one merges, ran slower: 100 registers against 71, fewer CTAs an SM).
// Each pack's centred moments (count, mean, M2) merge into the thread's by
// Chan's formula as it lands; then the lanes of one group (a butterfly),
// the block's warps in order and the cluster's CTAs in rank order, as
// groupnorm_bf16_kernel does.  Rank 0 writes the unit's triples.
//
// Apply (groupnorm_apply_kernel).  Bound: bytes, the shard read once and
// its output written once.  A streaming pass: no cluster and no barrier.
// A CTA takes part_px whole pixels (all c channels) of one sample, so its
// loads and stores are 16-byte packs running contiguously along the rows;
// a thread keeps the same pack of every pixel, so its prologue merges, in
// shard order by Chan's formula, the n_parts triples of the one group its
// channels belong to (the formula and order of ops/groupnorm.py::
// merge_stats), and gamma, beta and the FiLM rows then sit in registers.
// The first APPLY_LOADS packs are requested before the prologue, so its
// reads of the partials pass under them.  The activation (ACT, as
// activate's act) and the FiLM epilogue (FILM) are template arguments, as
// in groupnorm_bf16_kernel: a runtime choice costs a launch that follows a
// conv its cold instruction fetch.  y rounds to T once, then the epilogue
// rounds scale * y and + shift in T, as the single launches do.
//
// Both take V = 1 (a thread one channel) where the channels per group are
// not a multiple of a 16-byte pack or a pointer is unaligned.  Where whole
// warps of whole pixels would exceed the launch bound (a statistics unit
// of one group of 17 or 33 elements, an apply pixel of 264), the block is
// whole warps and the lanes past its last whole pixel idle
// (ops/groupnorm.py::idle_lane_threads): in the statistics they hold
// empty moments (the unit is one group, so every lane's merge is the
// group's), in the apply they return at once.  Where one pixel's accesses
// outnumber the block (MULTI: a statistics group of over 512 of them, an
// apply pixel of over 1024 elements or 512 packs, as n_feat 1032's
// up0_norm: 2064 channels), a thread takes accesses t, t + blockDim.x, ...
// of each pixel of its part, one access at a time over the part's pixels:
// the statistics merge each into the thread's moments by Chan's formula
// before the warp and block merges (the unit is one group), the apply
// merges each access's group's triples and reads its gamma, beta and FiLM
// values anew.  The pair then takes every width on one card as well
// (ops/groupnorm.py::single_route: where the single launches refuse).

// A pack of V elements of T as loaded: 16 bytes, or one element.
template <typename T, int V>
struct Raw {
  uint4 bits;
};
template <typename T>
struct Raw<T, 1> {
  T bits;
};

// Read once: no L1 line kept for it.
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  Raw<T, V> r;
  if constexpr (V == 1) {
    r.bits = *p;
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.bits.x), "=r"(r.bits.y), "=r"(r.bits.z), "=r"(r.bits.w)
                 : "l"(p));
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ Pack<V> unpack(const Raw<T, V>& r) {
  return load<V>(reinterpret_cast<const T*>(&r.bits));
}

constexpr int STATS_LOADS = 8;  // packs a thread requests at once
constexpr int STATS_THREADS = 512;  // a CTA at most
constexpr int APPLY_LOADS = 4;

// Grid: unit (sample major, segment minor) major, cluster rank minor.
// Thread t < pstride * vs holds pack t % vs (vs = the segment's packs a
// pixel; the block a multiple of it but where IDLE, seg 1) of pixels t /
// vs, + pstride, ... of its part; with MULTI (seg 1, vs over the block)
// packs t, t + blockDim.x, ... of every pixel of its part.  IDLE is a
// template argument so that the plans of whole pixels compile as they did
// without idle lanes (their launch read 5% slower with the test,
// scripts/compare_torch_kernels.py --sharded); MULTI likewise.
template <typename T, int V, bool IDLE, bool MULTI>
__global__ void __launch_bounds__(STATS_THREADS) groupnorm_stats_kernel(
    const T* __restrict__ x, float* __restrict__ stats, int hw, int c, int groups, int seg,
    int cluster_size, int part_px) {
  __shared__ Moments warp_moments[STATS_THREADS / 32][MAX_SEG];
  __shared__ Moments block_moments[MAX_SEG];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgroup = c / groups, vpg = cgroup / V, vs = vpg * seg;
  const int segs = groups / seg;
  const int unit = blockIdx.x / cluster_size, rank = blockIdx.x - unit * cluster_size;
  const int nn = unit / segs, sg = unit - nn * segs;
  const int p0 = min(hw, rank * part_px);
  const int np = min(hw, p0 + part_px) - p0;
  const int pstride = blockDim.x / vs;  // pixels the block covers per step
  const int j = tid % vs, gl = j / vpg;  // this thread's pack and group in the segment
  const T* xs = x + ((long long)nn * hw + p0) * c + sg * seg * cgroup + j * V;

  Moments m{0.0f, 0.0f, 0.0f};
  // Pixels p, p + stride, ... (STATS_LOADS of them requested at once) of
  // the pack at src, merged into m.
  auto stream = [&](const T* src, int p, int stride) {
    for (; p < np; p += STATS_LOADS * stride) {
      Raw<T, V> raw[STATS_LOADS];
#pragma unroll
      for (int i = 0; i < STATS_LOADS; ++i)
        if (p + i * stride < np) raw[i] = load_raw<T, V>(src + (long long)(p + i * stride) * c);
#pragma unroll
      for (int i = 0; i < STATS_LOADS; ++i) {
        if (p + i * stride < np) {
          const Pack<V> v = unpack<T, V>(raw[i]);
          float sum = 0.0f;
#pragma unroll
          for (int e = 0; e < V; ++e) sum += v.v[e];
          const float pm = sum * (1.0f / V);
          float pq = 0.0f;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float d = v.v[e] - pm;
            pq += d * d;
          }
          m = merge(m, Moments{(float)V, pm, pq});
        }
      }
    }
  };
  if constexpr (MULTI) {  // seg 1: every pack is the one group's
    for (int jj = tid; jj < vs; jj += blockDim.x) stream(xs + (jj - j) * V, 0, 1);
  } else {
    stream(xs, !IDLE || tid < pstride * vs ? tid / vs : np, pstride);
  }
  // The lanes of one group, as in groupnorm_bf16_kernel: the butterfly
  // skips the lane bits that change the group (vpg and vs powers of two
  // where seg > 1; with seg 1 every lane holds the one group).
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= vpg && off < vs) continue;
    const Moments o{__shfl_xor_sync(0xffffffffu, m.n, off),
                    __shfl_xor_sync(0xffffffffu, m.mean, off),
                    __shfl_xor_sync(0xffffffffu, m.m2, off)};
    m = (lane & off) ? merge(o, m) : merge(m, o);
  }
  // A warp holds every group of the segment where vs <= 32, else 32 / vpg
  // of them; the others stay empty.
  if (lane < seg) warp_moments[warp][lane] = Moments{0.0f, 0.0f, 0.0f};
  __syncwarp();
  if (lane % vpg == 0 && lane < vs) warp_moments[warp][gl] = m;
  __syncthreads();
  const float count = (float)((long long)hw * cgroup);
  float* out = stats + ((long long)nn * groups + sg * seg) * 3;
  Moments b{0.0f, 0.0f, 0.0f};
  if (tid < seg) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) b = merge(b, warp_moments[w][tid]);
    block_moments[tid] = b;
  }
  if (cluster_size == 1) {
    if (tid < seg) {
      out[3 * tid] = count;
      out[3 * tid + 1] = b.mean;
      out[3 * tid + 2] = b.m2;
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's block_moments is written
  if (rank == 0 && tid < seg) {
    for (int r = 1; r < cluster_size; ++r)
      b = merge(b, *cluster.map_shared_rank(&block_moments[tid], r));
    out[3 * tid] = count;
    out[3 * tid + 1] = b.mean;
    out[3 * tid + 2] = b.m2;
  }
  // Rank 0 is done with the others' shared memory: no CTA leaves before.
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <typename T>
struct ApplyArgs {
  const T* x;
  const float* parts;  // (n_parts, n, groups, 3): count, mean, M2 of each shard
  const float* gamma;
  const float* beta;
  const T* scale;  // FiLM rows, strides scale_stride and shift_stride (0 or c)
  const T* shift;
  T* out;
  int n_parts, n, hw, c, groups, part_px, scale_stride, shift_stride;
  float eps;
};

// Grid: sample major, part minor.  Thread t < pstride * (c / V) holds
// pack t % (c / V) of pixels t / (c / V), + pstride, ... of its part; with
// MULTI (c / V over the block) packs t, t + blockDim.x, ... of every pixel
// of its part.
template <typename T, int V, int ACT, bool FILM, bool MULTI>
__global__ void __launch_bounds__(V == 1 ? 1024 : 512)
    groupnorm_apply_kernel(const ApplyArgs<T> a) {
  const int tid = threadIdx.x;
  const int vpp = a.c / V;  // packs a pixel
  const int ctas = (a.hw + a.part_px - 1) / a.part_px;  // a sample's
  const int nn = blockIdx.x / ctas;
  const int p0 = (blockIdx.x - nn * ctas) * a.part_px;
  const int np = min(a.hw, p0 + a.part_px) - p0;

  // Pack j of pixels first, first + pstride, ... of the part.
  auto run = [&](int j, int first, int pstride) {
    const int ch = j * V, g = ch / (a.c / a.groups);
    const T* xs = a.x + ((long long)nn * a.hw + p0) * a.c + ch;
    T* os = a.out + ((long long)nn * a.hw + p0) * a.c + ch;

    Raw<T, V> raw[APPLY_LOADS];
    auto fetch = [&](int p) {
#pragma unroll
      for (int i = 0; i < APPLY_LOADS; ++i)
        if (p + i * pstride < np)
          raw[i] = load_raw<T, V>(xs + (long long)(p + i * pstride) * a.c);
    };
    fetch(first);

    // Chan's merge of the shards' (count, mean, M2) of (sample, group), in
    // shard order.
    const long long ngs = (long long)a.n * a.groups, ng = (long long)nn * a.groups + g;
    float cnt = a.parts[ng * 3], mean = a.parts[ng * 3 + 1], m2 = a.parts[ng * 3 + 2];
    for (int k = 1; k < a.n_parts; ++k) {
      const float* q = a.parts + (k * ngs + ng) * 3;
      const float nb = q[0], nab = cnt + nb, delta = q[1] - mean;
      mean = mean + delta * (nb / nab);
      m2 = m2 + q[2] + delta * delta * (cnt * nb / nab);
      cnt = nab;
    }
    const float rstd = rsqrtf(m2 / cnt + a.eps);
    const Pack<V> ga = load<V>(a.gamma + ch), be = load<V>(a.beta + ch);
    Pack<V> sc{}, sh{};
    if constexpr (FILM) {
      sc = load<V>(a.scale + (long long)nn * a.scale_stride + ch);
      sh = load<V>(a.shift + (long long)nn * a.shift_stride + ch);
    }

    for (int p = first; p < np; p += APPLY_LOADS * pstride) {
      if (p != first) fetch(p);
#pragma unroll
      for (int i = 0; i < APPLY_LOADS; ++i) {
        const int q = p + i * pstride;
        if (q < np) {
          Pack<V> v = unpack<T, V>(raw[i]);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float y = activate((v.v[e] - mean) * rstd * ga.v[e] + be.v[e], ACT);
            if constexpr (FILM)
              v.v[e] = round_to<T>(round_to<T>(round_to<T>(y) * sc.v[e]) + sh.v[e]);
            else
              v.v[e] = y;
          }
          store<V>(os + (long long)q * a.c, v);
        }
      }
    }
  };
  if constexpr (MULTI) {
    for (int j = tid; j < vpp; j += blockDim.x) run(j, 0, 1);
  } else {
    const int pstride = blockDim.x / vpp;  // pixels the block covers per step
    if (tid >= pstride * vpp) return;  // an idle lane past the last whole pixel
    run(tid % vpp, tid / vpp, pstride);
  }
}

template <typename T, int V>
cudaError_t apply_launch(dim3 grid, int threads, cudaStream_t stream, const ApplyArgs<T>& a,
                         int act) {
  const bool multi = threads < a.c / V;  // a thread takes several packs of a pixel
#define CAMELS_GROUPNORM_APPLY(A)                                                         \
  if (act == A) {                                                                         \
    if (multi && a.scale)                                                                 \
      groupnorm_apply_kernel<T, V, A, true, true><<<grid, threads, 0, stream>>>(a);       \
    else if (multi)                                                                       \
      groupnorm_apply_kernel<T, V, A, false, true><<<grid, threads, 0, stream>>>(a);      \
    else if (a.scale)                                                                     \
      groupnorm_apply_kernel<T, V, A, true, false><<<grid, threads, 0, stream>>>(a);      \
    else                                                                                  \
      groupnorm_apply_kernel<T, V, A, false, false><<<grid, threads, 0, stream>>>(a);     \
    return cudaGetLastError();                                                            \
  }
  CAMELS_GROUPNORM_APPLY(0)
  CAMELS_GROUPNORM_APPLY(1)
  CAMELS_GROUPNORM_APPLY(2)
  CAMELS_GROUPNORM_APPLY(3)
#undef CAMELS_GROUPNORM_APPLY
  return cudaErrorInvalidValue;
}

template <typename T, int V>
cudaError_t stats_launch(const cudaLaunchConfig_t* cfg, bool idle, bool multi, const T* x,
                         float* stats, int hw, int c, int groups, int seg, int cluster,
                         int part_px) {
  return multi ? cudaLaunchKernelEx(cfg, groupnorm_stats_kernel<T, V, false, true>, x, stats,
                                    hw, c, groups, seg, cluster, part_px)
         : idle ? cudaLaunchKernelEx(cfg, groupnorm_stats_kernel<T, V, true, false>, x, stats,
                                     hw, c, groups, seg, cluster, part_px)
                : cudaLaunchKernelEx(cfg, groupnorm_stats_kernel<T, V, false, false>, x, stats,
                                     hw, c, groups, seg, cluster, part_px);
}

template <typename T>
int stats_entry(const T* x, float* stats, int n, int hw, int c, int groups, int vec, int seg,
                int cluster, int threads, int part_px, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((vec != 1 && vec != kVec<T>) || groups <= 0 || c % groups || c / groups % vec)
    return (int)cudaErrorInvalidValue;
  const int vpg = c / groups / vec, vs = vpg * seg;
  const bool multi = threads < vs;  // seg 1: a thread takes several packs of a pixel
  if (seg < 1 || seg > MAX_SEG || groups % seg || (seg > 1 && (vs & (vs - 1))) ||
      threads <= 0 || threads > STATS_THREADS || threads % 32 || (multi && seg > 1) ||
      (seg > 1 && threads % vs) || cluster < 1 || cluster > 8 || part_px < 1)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * (groups / seg) * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a cluster of 1 is launched as a plain grid
  const bool idle = !multi && threads % vs != 0;  // lanes past the last whole pixel
  cudaError_t err =
      vec == 1 ? stats_launch<T, 1>(&cfg, idle, multi, x, stats, hw, c, groups, seg, cluster,
                                    part_px)
               : stats_launch<T, kVec<T>>(&cfg, idle, multi, x, stats, hw, c, groups, seg,
                                          cluster, part_px);
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename T>
int apply_entry(const T* x, const float* parts, const float* gamma, const float* beta,
                const T* scale, const T* shift, T* out, int n_parts, int n, int hw, int c,
                int groups, int scale_stride, int shift_stride, float eps, int act, int vec,
                int threads, int part_px, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((vec != 1 && vec != kVec<T>) || groups <= 0 || c % groups || c / groups % vec ||
      n_parts < 1 || part_px < 1 || threads <= 0 || threads % 32 ||
      threads > (vec == 1 ? 1024 : 512))
    return (int)cudaErrorInvalidValue;
  const ApplyArgs<T> a{x,  parts, gamma,  beta,    scale,        shift,        out, n_parts,
                       n,  hw,    c,      groups,  part_px,      scale_stride, shift_stride,
                       eps};
  const dim3 grid((unsigned)(n * ((hw + part_px - 1) / part_px)));
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(vec == 1 ? apply_launch<T, 1>(grid, threads, st, a, act)
                        : apply_launch<T, kVec<T>>(grid, threads, st, a, act));
}

}  // namespace

// x/out: (n, hw, c) contiguous NHWC of T; gamma/beta: (c,) float;
// scale/shift: null, or rows of c elements of T with strides 0 or c.
// vec, cluster, threads, pixels_per_cta, resident_pixels and smem_bytes
// come from ops/groupnorm.py::launch_plan (vec a 16-byte pack needs
// c/groups a multiple of it and 16-byte aligned pointers).  The float
// single launch, and the bf16 one at the shapes bf16_plan and narrow_plan
// refuse (ops/groupnorm.py::single_route).  Returns the cudaError_t of the
// launch.
#define CAMELS_GROUPNORM_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* x, const float* gamma, const float* beta,            \
                      const T* scale, const T* shift, T* out, int n, int hw, int c, \
                      int groups, int scale_stride, int shift_stride, float eps,    \
                      int act, int vec, int cluster, int threads,                   \
                      int pixels_per_cta, int resident_pixels, int smem_bytes,      \
                      void* stream) {                                               \
    return entry<T>(x, gamma, beta, scale, shift, out, n, hw, c, groups,            \
                    scale_stride, shift_stride, eps, act, vec, cluster, threads,    \
                    pixels_per_cta, resident_pixels, smem_bytes, stream);           \
  }
CAMELS_GROUPNORM_ENTRY(camels_groupnorm_act, float)
CAMELS_GROUPNORM_ENTRY(camels_groupnorm_act_bf16_generic, bf16)
#undef CAMELS_GROUPNORM_ENTRY

// The bf16 instance of the single launch: x/out (n, hw, c) contiguous NHWC
// bf16, 16-byte aligned, c/groups a multiple of 8; gamma/beta (c,) float;
// scale/shift null or rows of c bf16 with strides 0 or c.  seg (groups a
// unit, dividing groups, at most 8 and 256 channels; 1 unless c/groups/8
// is a power of two), cluster, threads,
// packs (K: 1, 2, 4, 8 or 16 a thread; at most 512 threads) and
// part_px come from ops/groupnorm.py::bf16_plan.  Returns the
// cudaError_t of the launch.
extern "C" int camels_groupnorm_act_bf16(const bf16* x, const float* gamma, const float* beta,
                                         const bf16* scale, const bf16* shift, bf16* out,
                                         int n, int hw, int c, int groups, int scale_stride,
                                         int shift_stride, float eps, int act, int seg,
                                         int cluster, int threads, int packs, int part_px,
                                         void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int vpg = c / groups / 8;  // packs a group: a power of two where seg > 1
  if (seg > MAX_SEG || groups % seg || c / groups * seg > MAX_SEG_CH ||
      (seg > 1 && (vpg & (vpg - 1))))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * (groups / seg) * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (threads > BF16_THREADS) return (int)cudaErrorInvalidValue;
#define CAMELS_GROUPNORM_BF16(K)                                                               \
  if (packs == K)                                                                              \
    return (int)launch_bf16_act<K>(&cfg, x, gamma, beta, scale, shift, out, hw, c, groups, seg, \
                                   cluster, part_px, scale_stride, shift_stride, eps, act);
  CAMELS_GROUPNORM_BF16(1)
  CAMELS_GROUPNORM_BF16(2)
  CAMELS_GROUPNORM_BF16(4)
  CAMELS_GROUPNORM_BF16(8)
  CAMELS_GROUPNORM_BF16(16)
#undef CAMELS_GROUPNORM_BF16
  return (int)cudaErrorInvalidValue;
}

// The bf16 single launch where a group is not whole 16-byte packs:
// camels_groupnorm_act_bf16's arguments, then wide; x/out 16-byte aligned,
// seg groups (dividing groups, at most 8) of at most 256 channels whose
// channels are whole packs; threads a multiple of 32, at most 512; packs
// (K) 4, 8 or 16 a thread; all from ops/groupnorm.py::narrow_plan.  wide
// 0: groupnorm_bf16_narrow_kernel (a unit of at most 256 channels, threads
// a multiple of its packs a pixel, a part within packs of a thread); wide
// 1: groupnorm_bf16_wide_kernel (threads at least a unit's packs a pixel,
// parts of any size).  Returns the cudaError_t of the launch.
extern "C" int camels_groupnorm_act_bf16_narrow(
    const bf16* x, const float* gamma, const float* beta, const bf16* scale,
    const bf16* shift, bf16* out, int n, int hw, int c, int groups, int scale_stride,
    int shift_stride, float eps, int act, int seg, int cluster, int threads, int packs,
    int part_px, int wide, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (groups <= 0 || c % groups || c / groups > NARROW_GROUP_CH || seg < 1 || seg > MAX_SEG ||
      groups % seg)
    return (int)cudaErrorInvalidValue;
  const int uc = c / groups * seg, vs = uc / 8;  // channels and packs of a unit's pixel
  if (uc % 8 || threads > NARROW_THREADS || threads % 32 || threads < vs || cluster < 1 ||
      cluster > 8 || part_px < 1)
    return (int)cudaErrorInvalidValue;
  if (!wide && (uc > NARROW_CH || threads % vs || part_px > packs * (threads / vs)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * (groups / seg) * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = wide ? (size_t)wide_smem_bytes(uc, threads) : 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#define CAMELS_GROUPNORM_NARROW(K)                                                         \
  if (packs == K)                                                                          \
    return (int)launch_narrow_act<K>(&cfg, wide != 0, x, gamma, beta, scale, shift, out, hw, \
                                     c, groups, seg, cluster, part_px, scale_stride,        \
                                     shift_stride, eps, act);
  CAMELS_GROUPNORM_NARROW(4)
  CAMELS_GROUPNORM_NARROW(8)
  CAMELS_GROUPNORM_NARROW(16)
#undef CAMELS_GROUPNORM_NARROW
  return (int)cudaErrorInvalidValue;
}

// The sharded launches.  Statistics: x (n, hw, c) contiguous NHWC of T;
// stats (n, groups, 3) float: each (sample, group)'s count, mean and
// centred M2; vec, seg, cluster, threads and part_px from
// ops/groupnorm.py::stats_plan.  Apply: x and out as the single launch's,
// parts (n_parts, n, groups, 3) float in shard order, gamma/beta and the
// rows as above, act as activate's; vec, threads and part_px from
// ops/groupnorm.py::apply_plan.  Each returns the cudaError_t of its
// launch.
#define CAMELS_GROUPNORM_SHARDED_ENTRIES(STATS, APPLY, T)                                  \
  extern "C" int STATS(const T* x, float* stats, int n, int hw, int c, int groups,        \
                       int vec, int seg, int cluster, int threads, int part_px,           \
                       void* stream) {                                                    \
    return stats_entry<T>(x, stats, n, hw, c, groups, vec, seg, cluster, threads,         \
                          part_px, stream);                                               \
  }                                                                                       \
  extern "C" int APPLY(const T* x, const float* parts, const float* gamma,                \
                       const float* beta, const T* scale, const T* shift, T* out,         \
                       int n_parts, int n, int hw, int c, int groups, int scale_stride,   \
                       int shift_stride, float eps, int act, int vec, int threads,        \
                       int part_px, void* stream) {                                       \
    return apply_entry<T>(x, parts, gamma, beta, scale, shift, out, n_parts, n, hw, c,    \
                          groups, scale_stride, shift_stride, eps, act, vec, threads,     \
                          part_px, stream);                                               \
  }
CAMELS_GROUPNORM_SHARDED_ENTRIES(camels_groupnorm_stats, camels_groupnorm_apply, float)
CAMELS_GROUPNORM_SHARDED_ENTRIES(camels_groupnorm_stats_bf16, camels_groupnorm_apply_bf16,
                                 bf16)
#undef CAMELS_GROUPNORM_SHARDED_ENTRIES
