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
//  - A slice larger than a CTA's shared memory takes no launch of this
//    kernel: groupnorm_f32_large_kernel below holds such a part in shared
//    memory and registers, and past its budget the statistics and apply
//    pair streams it (ops/groupnorm.py::single_route).  A spill of the
//    slice's tail, read again from device memory by the later passes, ran
//    1.28-1.38x slower than the pair at 320-384 KiB slices
//    (scripts/compare_torch_kernels.py --template).
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
// serves the float single launch but where its slice is over 48 KiB in
// whole packs (the deep and big out_norm: groupnorm_f32_large_kernel below),
// and the bf16 single launch only at the
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
// groupnorm_apply_kernel in groupnorm_sharded.cu: the first writes each
// (sample, group)'s (count, mean, centred M2) of the shard, the host
// all-reduces the shards' triples into an (n_parts, n, groups, 3) buffer,
// and the second merges them by Chan's formula and normalises.

#include <cuda.h>
#include <dlfcn.h>

#include <algorithm>

#include "groupnorm.cuh"

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

// Grid: (sample, group) major, cluster rank minor.  Dynamic shared memory:
// pixels_per_cta * cg elements of T, the CTA's slice as [pixel][channel of
// group].
template <typename T, int V>
__global__ void groupnorm_act_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ scale,
    const T* __restrict__ shift, T* __restrict__ out, int hw, int c,
    int groups, int cluster_size, int pixels_per_cta, int scale_stride,
    int shift_stride, float eps, int act) {
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
  // Second and third passes: this thread's pixels in order, each with its
  // values, from shared memory.
  auto sweep = [&](auto&& body) {
    for (int p = first; p < np; p += pstride) body(p, load<V>(mine + p * cgroup));
  };

  float s = 0.0f;
#pragma unroll 4
  for (int p = first; p < np; p += pstride) {
    Pack<V> v = load<V>(xs + (long long)p * c);
    store<V>(mine + p * cgroup, v);  // only this thread reads it back
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
                   int pixels_per_cta, int scale_stride, int shift_stride, float eps,
                   int act) {
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
                             out, hw, c, groups, cluster, pixels_per_cta, scale_stride,
                             shift_stride, eps, act);
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
int entry(const T* x, const float* gamma, const float* beta, const T* scale,
          const T* shift, T* out, int n, int hw, int c, int groups,
          int scale_stride, int shift_stride, float eps, int act, int vec,
          int cluster, int threads, int pixels_per_cta, int smem_bytes,
          void* stream) {
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
                                   cluster, pixels_per_cta, scale_stride, shift_stride, eps,
                                   act);
  if (vec == 1)
    return (int)launch<T, 1>(&cfg, x, gamma, beta, scale, shift, out, hw, c, groups, cluster,
                             pixels_per_cta, scale_stride, shift_stride, eps, act);
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

// ---- The fp32 single launch at slices over 48 KiB: groups of 0.5-2 MiB. ----
//
// groupnorm_f32_large_kernel replaces the template above at the fp32 shapes
// whose slice (a group's pixels over a cluster of 8) is over 48 KiB and whose
// groups are whole 32-byte sectors: the deep and big models' out_norm
// ((N, 128, 128, 128): 1 MiB a group, 128 KiB a CTA; (N, 128, 128, 256): 2
// MiB, 256 KiB a CTA), the 128x128 family's out_norm at n_feat 64-256 and the
// canonical out_norm from n_feat 256 (ops/groupnorm.py::single_route).  Same
// function and arguments as the template (every activation, the FiLM
// epilogue with rows of stride c or 0), the statistics centred as the JAX
// reference's (models/blocks.py:322-330).  Bound: bytes, x read once and out
// written once.  What held the template to 44-50% of that at these shapes,
// and what this design does about it:
//  - The big slice spilled 30 of its 256 KiB (read twice more).  Here a
//    CTA's part of the group lives on chip whole: its first `boxes` TMA boxes
//    of box_px pixels in shared memory, the rest (at most LARGE_PACKS packs a
//    thread) in registers, so x is read once (ops/groupnorm.py::large_plan:
//    deep 7 boxes of 16 KiB + 2 packs a thread, two CTAs an SM; big 7 boxes
//    of 32 KiB + 4 packs, one CTA an SM; a 64x64 map's 512-pixel parts in
//    CTAs of 256 threads).
//  - Its bytes in flight were 4 loads of 16 bytes a thread.  Here one
//    thread issues every box's tensor copy (cp.async.bulk.tensor, 4-D view
//    (channel in box, box of a group, group, pixel)) at the start, each
//    completing on an mbarrier of its own, and every thread its register
//    packs: the whole part is requested at once whatever the thread count,
//    and the statistics start on the first box that lands.
//  - Two cluster barriers (the mean, then the centred M2).  Here each thread
//    merges its packs' centred moments (count, mean, M2) by Chan's formula
//    as they land, the lanes in a butterfly, the warps in order, the
//    cluster's CTAs in rank order through distributed shared memory (lane r
//    reads rank r, shuffles merge them in order): one cluster barrier, the
//    same order every run (reruns bit-identical).
//  - One CTA an SM, so nothing overlapped its barriers and its store pass.
//    Here each box is normalised in place and written back by a tensor store
//    (cp.async.bulk.tensor, shared to global) as soon as it is done, the
//    register packs by plain stores first, so the store stream starts right
//    after the barrier and the CTA's only wait is for its last box's read;
//    where the part fits in half the SM (the deep out_norm) two CTAs share
//    it, one's barrier and normalising under the other's copies (1.21x one
//    CTA an SM at 10 maps, scripts/compare_torch_kernels.py --variants).
//    The big part (256 KiB) fits one CTA an SM: halving it takes a
//    non-portable cluster of 16, of which the card held 14 at two CTAs an
//    SM, and it ran within 2% of this plan, so the plan keeps clusters of 8.
// A box that runs past the part (a map whose pixels do not split evenly)
// loads pixels it does not count and is written by the threads' own stores,
// so no store leaves the part.

constexpr int LARGE_THREADS = 512;  // a CTA at most
constexpr int LARGE_MAX_BOXES = 16;  // tensor copies of a CTA's part in shared memory
constexpr int LARGE_PACKS = 4;  // register packs a thread: 64 registers, two CTAs an SM

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (0, 0, g, row) of the 4-D view `map` into shared memory at dst,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int g, int row,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(shared_address(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(0), "r"(0), "r"(g), "r"(row),
      "r"(shared_address(bar))
      : "memory");
}

// Shared memory at src to box (0, 0, g, row) of `map`, in the bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int g, int row,
                                          const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];" ::"l"(reinterpret_cast<unsigned long long>(map)),
      "r"(0), "r"(0), "r"(g), "r"(row), "r"(shared_address(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Grid: (sample, group) major, cluster rank minor.  Thread t < pstride * vpg
// (vpg = the group's packs a pixel, pstride = blockDim.x / vpg) holds pack t %
// vpg of pixels t / vpg, + pstride, ... of its part: from shared memory below
// boxes * box_px, from its LARGE_PACKS registers past it; threads past the
// last whole pixel of the block only join the merges.  Dynamic shared memory: 128 bytes
// of alignment, then the boxes, [pixel][channel of group] floats each.  The
// activation and the FiLM epilogue are chosen at run time (act as
// activate's, FiLM where scale is given): at these launches' 0.1-0.7 ms the
// choice costs nothing measurable, and the build keeps one instance.
__global__ void __launch_bounds__(LARGE_THREADS, 2) groupnorm_f32_large_kernel(
    const __grid_constant__ CUtensorMap in_map, const __grid_constant__ CUtensorMap out_map,
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ scale,
    const float* __restrict__ shift, float* __restrict__ out, int hw, int c, int groups,
    int cluster_size, int part_px, int boxes, int box_px, int scale_stride, int shift_stride,
    float eps, int act) {
  extern __shared__ float4 large_storage[];
  __shared__ __align__(8) unsigned long long bars[LARGE_MAX_BOXES];
  __shared__ Moments warp_moments[LARGE_THREADS / 32];
  __shared__ Moments block_moments;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgroup = c / groups, vpg = cgroup / 4;  // packs a pixel of the group
  const int ng = blockIdx.x / cluster_size;
  const int nn = ng / groups, g = ng - nn * groups;
  const int rank = (int)cluster.block_rank();
  const int p0 = min(hw, rank * part_px);
  const int np = min(hw, p0 + part_px) - p0;
  const int pstride = blockDim.x / vpg;  // pixels the block covers per step
  const int first = tid < pstride * vpg ? tid / vpg : np;
  const int ch = g * cgroup + (tid % vpg) * 4;
  const int row0 = nn * hw + p0;  // the part's first pixel among the n * hw
  const int used = min(boxes, (np + box_px - 1) / box_px);  // boxes holding pixels
  const int resident = boxes * box_px;  // pixels [0, resident) in shared memory
  const unsigned pad = (128u - (shared_address(large_storage) & 127u)) & 127u;
  float* slice = reinterpret_cast<float*>(reinterpret_cast<char*>(large_storage) + pad);
  float* mine = slice + (tid % vpg) * 4;  // this thread's channels of pixel 0

  if (tid == 0) {
    for (int b = 0; b < used; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int b = 0; b < used; ++b) {
      mbar_expect_tx(&bars[b], (unsigned)(box_px * cgroup * 4));
      tma_load(slice + b * box_px * cgroup, &in_map, g, row0 + b * box_px, &bars[b]);
    }
  }
  Raw<float, 4> raw[LARGE_PACKS];
#pragma unroll
  for (int i = 0; i < LARGE_PACKS; ++i) {
    const int p = resident + first + i * pstride;
    if (p < np) raw[i] = load_raw<float, 4>(x + (long long)(row0 + p) * c + ch);
  }
  const Pack<4> ga = load<4>(gamma + ch), be = load<4>(beta + ch);
  const bool film = scale != nullptr;
  Pack<4> sc{}, sh{};
  if (film) {
    sc = load<4>(scale + (long long)nn * scale_stride + ch);
    sh = load<4>(shift + (long long)nn * shift_stride + ch);
  }

  // This thread's packs' centred moments, merged in a fixed order: the
  // boxes' pixels as each box lands, then the register packs.
  Moments m{0.0f, 0.0f, 0.0f};
  auto add = [&](const Pack<4>& v) {
    const float pm = (v.v[0] + v.v[1] + v.v[2] + v.v[3]) * 0.25f;
    float pq = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = v.v[e] - pm;
      pq += d * d;
    }
    m = merge(m, Moments{4.0f, pm, pq});
  };
  int p = first;
  for (int b = 0; b < used; ++b) {
    const int end = min((b + 1) * box_px, np);
    if (p < end) mbar_wait(&bars[b], 0);
    for (; p < end; p += pstride) add(load<4>(mine + p * cgroup));
  }
#pragma unroll
  for (int i = 0; i < LARGE_PACKS; ++i)
    if (resident + first + i * pstride < np) add(unpack<float, 4>(raw[i]));
  // The block's one group: every lane merges with its partners, lower
  // lane first, so every lane gets the same; then the warps in order.
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Moments o{__shfl_xor_sync(0xffffffffu, m.n, off),
                    __shfl_xor_sync(0xffffffffu, m.mean, off),
                    __shfl_xor_sync(0xffffffffu, m.m2, off)};
    m = (lane & off) ? merge(o, m) : merge(m, o);
  }
  if (lane == 0) warp_moments[warp] = m;
  __syncthreads();
  if (tid == 0) {
    Moments b{0.0f, 0.0f, 0.0f};
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) b = merge(b, warp_moments[w]);
    block_moments = b;
  }
  cluster.sync();  // every CTA's block_moments is written
  // Lane r of each warp reads rank r's moments (the reads in flight
  // together), then every lane merges them in rank order through shuffles.
  Moments own{0.0f, 0.0f, 0.0f};
  if (lane < cluster_size) own = *cluster.map_shared_rank(&block_moments, lane);
  auto rank_moments = [&](int r) {
    return Moments{__shfl_sync(0xffffffffu, own.n, r), __shfl_sync(0xffffffffu, own.mean, r),
                   __shfl_sync(0xffffffffu, own.m2, r)};
  };
  Moments t = rank_moments(0);
  for (int r = 1; r < cluster_size; ++r) t = merge(t, rank_moments(r));
  // Done with the other CTAs' shared memory; wait for them before exiting.
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  const float mean = t.mean, rstd = rsqrtf(t.m2 / t.n + eps);

  auto normalise = [&](Pack<4> v) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = activate((v.v[e] - mean) * rstd * ga.v[e] + be.v[e], act);
      v.v[e] = film ? y * sc.v[e] + sh.v[e] : y;
    }
    return v;
  };
  // The register packs first, so their stores pass under the boxes' work.
#pragma unroll
  for (int i = 0; i < LARGE_PACKS; ++i) {
    const int q = resident + first + i * pstride;
    if (q < np) store<4>(out + (long long)(row0 + q) * c + ch, normalise(unpack<float, 4>(raw[i])));
  }
  p = first;
  for (int b = 0; b < used; ++b) {
    const int end = min((b + 1) * box_px, np);
    const bool whole = (b + 1) * box_px <= np;  // the same for every thread
    for (; p < end; p += pstride) {
      const Pack<4> v = normalise(load<4>(mine + p * cgroup));
      if (whole)
        store<4>(mine + p * cgroup, v);
      else
        store<4>(out + (long long)(row0 + p) * c + ch, v);
    }
    if (whole) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the copy
      __syncthreads();
      if (tid == 0) tma_store(&out_map, g, row0 + b * box_px, slice + b * box_px * cgroup);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// cuTensorMapEncodeTiled from the libcuda the process has loaded (no link to
// it at build time); null if there is none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The 4-D view of NHWC fp32 `base` (rows pixels of c channels in `groups`
// groups) whose box is a group's box_px pixels: (box_ch channels, cgroup /
// box_ch of them, groups, rows), the box (box_ch, cgroup / box_ch, 1, box_px)
// laid out in shared memory as [pixel][channel of group].
bool group_map(CUtensorMap* map, const float* base, long long rows, int c, int groups,
               int box_ch, int box_px) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int cgroup = c / groups;
  const cuuint64_t dims[4] = {(cuuint64_t)box_ch, (cuuint64_t)(cgroup / box_ch),
                              (cuuint64_t)groups, (cuuint64_t)rows};
  const cuuint64_t strides[3] = {(cuuint64_t)box_ch * 4, (cuuint64_t)cgroup * 4,
                                 (cuuint64_t)c * 4};  // bytes, dimensions 1-3
  const cuuint32_t box[4] = {(cuuint32_t)box_ch, (cuuint32_t)(cgroup / box_ch), 1u,
                             (cuuint32_t)box_px};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_large(cudaLaunchConfig_t* cfg, const CUtensorMap& in_map,
                         const CUtensorMap& out_map, const float* x, const float* gamma,
                         const float* beta, const float* scale, const float* shift, float* out,
                         int hw, int c, int groups, int cluster, int part_px, int boxes,
                         int box_px, int scale_stride, int shift_stride, float eps, int act) {
  if (act < 0 || act > 3) return cudaErrorInvalidValue;
  const auto kernel = groupnorm_f32_large_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg->dynamicSmemBytes);
  if (err == cudaSuccess)  // two CTAs an SM need its shared memory carved out to the most
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(cfg, kernel, in_map, out_map, x, gamma, beta, scale, shift, out, hw,
                             c, groups, cluster, part_px, boxes, box_px, scale_stride,
                             shift_stride, eps, act);
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// x/out: (n, hw, c) contiguous NHWC of T; gamma/beta: (c,) float;
// scale/shift: null, or rows of c elements of T with strides 0 or c.
// vec, cluster, threads, pixels_per_cta and smem_bytes come from ops/groupnorm.py::launch_plan (vec a 16-byte pack needs
// c/groups a multiple of it and 16-byte aligned pointers).  The float
// single launch, and the bf16 one at the shapes bf16_plan and narrow_plan
// refuse (ops/groupnorm.py::single_route).  Returns the cudaError_t of the
// launch.
#define CAMELS_GROUPNORM_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* x, const float* gamma, const float* beta,            \
                      const T* scale, const T* shift, T* out, int n, int hw, int c, \
                      int groups, int scale_stride, int shift_stride, float eps,    \
                      int act, int vec, int cluster, int threads,                   \
                      int pixels_per_cta, int smem_bytes, void* stream) {           \
    return entry<T>(x, gamma, beta, scale, shift, out, n, hw, c, groups,            \
                    scale_stride, shift_stride, eps, act, vec, cluster, threads,    \
                    pixels_per_cta, smem_bytes, stream);                            \
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

// The fp32 single launch at slices over 48 KiB (groupnorm_f32_large_kernel):
// camels_groupnorm_act's arguments up to act, then cluster, threads,
// part_px, boxes (TMA boxes of a part in shared memory, at most 16), box_px
// (pixels a box, at most 256), box_ch (channels of a box's row: c / groups
// where that is at most 256, else a divisor of it; LARGE_PACKS register
// packs a thread cover the part past the boxes) and smem_bytes, all from
// ops/groupnorm.py::large_plan; x and out 16-byte
// aligned, c / groups a multiple of 4.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue where libcuda's tensor maps are missing
// or refuse the view).
extern "C" int camels_groupnorm_act_large(const float* x, const float* gamma, const float* beta,
                                          const float* scale, const float* shift, float* out,
                                          int n, int hw, int c, int groups, int scale_stride,
                                          int shift_stride, float eps, int act, int cluster,
                                          int threads, int part_px, int boxes, int box_px,
                                          int box_ch, int smem_bytes, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (groups <= 0 || c % groups || c / groups % 4 || box_ch <= 0 || box_ch % 4 ||
      c / groups % box_ch || c / groups / box_ch > 256 || box_ch > 256)
    return (int)cudaErrorInvalidValue;
  const int vpg = c / groups / 4;
  if (threads <= 0 || threads > LARGE_THREADS || threads % 32 || threads < vpg ||
      cluster < 1 || cluster > 8 || part_px < 1 || boxes < 1 || boxes > LARGE_MAX_BOXES ||
      box_px < 1 || box_px > 256 || part_px - boxes * box_px > LARGE_PACKS * (threads / vpg) ||
      smem_bytes < 128 + boxes * box_px * (c / groups) * 4)
    return (int)cudaErrorInvalidValue;
  CUtensorMap in_map, out_map;
  const long long rows = (long long)n * hw;
  if (!group_map(&in_map, x, rows, c, groups, box_ch, box_px) ||
      !group_map(&out_map, out, rows, c, groups, box_ch, box_px))
    return (int)cudaErrorInvalidValue;
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
  return (int)launch_large(&cfg, in_map, out_map, x, gamma, beta, scale, shift, out, hw, c,
                           groups, cluster, part_px, boxes, box_px, scale_stride, shift_stride,
                           eps, act);
}
