// K2's bf16 single launch where a group's channels are not whole 16-byte
// packs (ops/groupnorm.py::narrow_plan: groupnorm_bf16_narrow_kernel and its
// wide layout groupnorm_bf16_wide_kernel), in a source of their own so that
// the build compiles them beside groupnorm.cu.  With groupnorm.cu's
// launches they replace camels_diffusion_model_tpu/ops/pallas/groupnorm.py
// :: fused_groupnorm_act (Pallas TPU kernel, pallas_call :89).  Bound: bytes.

#include "groupnorm.cuh"

namespace {

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

}  // namespace

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
