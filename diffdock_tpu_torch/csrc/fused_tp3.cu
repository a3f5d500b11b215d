// Gen-3 fused factored tensor-product contraction on Hopper's tensor cores.
//
// Replaces diffdock_tpu/ops/pallas_tpconv3.py:_kernel (the body of
// _forward_pallas). Per receiver row r and live output class c it computes
//
//     P_c[h, u*d3+d] = sum_k h_aug[r, k, h] * coupled[r, k, f_off_c + u*d3+d]
//     out[r, o_off_c + w*d3+d] = sum_h sum_u P_c[h, u*d3+d] * W_c[h, u, w]
//
// where h runs over the H hidden channels plus the bias row (h = H, whose
// activation is mask*edge_weight), and W_c (H+1, fan_c, mul_c) carries the
// class's last-layer weights and bias with 1/sqrt(fan_c) folded in (the
// TPU kernel's block-diagonal T3, read in its compact form).
//
// What bounds it on an H100: operations. Both products are GEMM-shaped
// (P: M = hidden rows, N = class columns, depth = neighbours; the weight
// product: M = w, N = (receiver, d), depth = (u, h)) and do 30-80 FLOP per
// byte they must read. They run on the tensor cores as mma.sync m16n8k8
// TF32 products in 3xTF32: each float32 operand is split into a TF32 head
// (rounded to nearest) and a TF32 remainder, and rem*head + head*rem +
// head*head is accumulated in float32 registers, which keeps float32
// accuracy at a third of the TF32 rate (495 / 3 = 165 TFLOP/s against 67
// on the CUDA cores). The design:
//   - a block owns 16 receivers (one warp each), one slice of one class's
//     columns (at most 64: whole u groups of d3 columns, the class's slices
//     balanced) and one group of hidden rows (32, or 16 when H+1 <= 16).
//     Each warp keeps its receiver's P tile (hidden rows x slice columns)
//     in registers for the whole neighbour loop, and streams its own h_aug
//     and coupled rows through a 3-stage cp.async ring in shared memory (no
//     block barrier in the loop; coupled in 8-byte pairs where the slice
//     starts on an even column). h_aug and coupled are read once per
//     (slice, group); the blocks that share a receiver tile are launched
//     next to each other, where those repeated reads hit L2;
//   - the P tiles of the 16 receivers then go to shared memory, and the
//     block runs the weight product over them: W_c's (group, slice) block
//     is read once per 16 receivers, each W fragment feeds every
//     (receiver, d) tile, and the (u, h) depth is split across the warps;
//   - the partial sums of the depth split, and of the groups and slices,
//     are added in a fixed order (in shared memory, and in a second small
//     kernel over a scratch buffer), so the result does not depend on
//     scheduling: two launches on the same inputs give the same bits.
// One block per SM (16 warps at 128 registers); nothing is split with
// atomics.
//
// The bfloat16 operand mode is a kernel of its own, designed for Hopper's
// TMA and wgmma: fused_tp3_bf16.cu.
//
// The 3xTF32 and cp.async helpers are in tp_mma.cuh. Plain C
// interface (no PyTorch headers), built with nvcc into a shared library
// and called through ctypes; see diffdock_tpu_torch/ops/fused_tp3.py.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "tp_mma.cuh"

namespace {

using namespace tp_mma;

constexpr int kMaxClasses = 16;
constexpr int kWarps = 16;                // receivers per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kNT = 8;                    // n8 tiles of P per warp: 64 columns
constexpr int kSliceCols = kNT * 8;
constexpr int kKC = 8;                    // neighbours per pipeline stage
constexpr int kStages = 3;
constexpr int kBStride = kSliceCols + 8;  // 72: conflict-free fragment reads
constexpr int kMaxWN = 6;                 // weight-product n8 tiles per warp
constexpr int kPrefetch = 8;              // weight-product depth steps in flight
constexpr int kMaxOutputs = 256;          // mul*d3 of one class
constexpr int kMaxColumns = 4096;         // fan*d3 of one class

struct ClassTable {
  int f_off[kMaxClasses];    // column offset of the class in `coupled`
  int fan[kMaxClasses];
  int d3[kMaxClasses];
  int mul[kMaxClasses];
  int out_off[kMaxClasses];  // column offset of the class in `out`
  int us[kMaxClasses];       // u per column slice (us * d3 <= 64)
  int n_slices[kMaxClasses]; // ceil(fan / us)
  int slice_base[kMaxClasses];  // slices of the classes before this one
  int pairs[kMaxClasses];    // 1: the class's coupled slices load as 8-byte pairs
  long long w_off[kMaxClasses];  // element offset of the class's W_c
};

__device__ __forceinline__ void cp_async_wait_stages() { cp_async_wait<kStages - 2>(); }

// ---- the kernel ---------------------------------------------------------

// MT: m16 tiles of hidden rows per block (2, or 1 when H+1 <= 16)
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
fused_tp3_kernel(const float* __restrict__ h_aug,
                 const float* __restrict__ coupled,
                 const float* __restrict__ weights,
                 float* __restrict__ dst,            // out, or the scratch parts
                 ClassTable tbl, int n_classes, long long n_rows, int K, int Ha, int F,
                 int D, int n_groups, int n_sl, int s_max) {
  // h_aug (n_rows, K, Ha), coupled (n_rows, K, F), weights the packed W_c
  using In = float;
  constexpr int HR = MT * 16;          // hidden rows per block
  constexpr int AStride = HR + 8;      // 24 or 40: conflict-free fragment reads
  constexpr int StageFloats = kKC * AStride + kKC * kBStride;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  // block -> (receiver tile, slice of a class, hidden group); the groups
  // and slices of one receiver tile are neighbours in launch order
  long long bid = blockIdx.x;
  const int g = static_cast<int>(bid % n_groups);
  bid /= n_groups;
  const int sl = static_cast<int>(bid % n_sl);
  const long long tile = bid / n_sl;
  int c = 0;
  while (c + 1 < n_classes && sl >= tbl.slice_base[c + 1]) ++c;
  const int s = sl - tbl.slice_base[c];

  const int fan = tbl.fan[c], d3 = tbl.d3[c], mul = tbl.mul[c];
  const int u0 = s * tbl.us[c];
  const int nu = min(tbl.us[c], fan - u0);    // u of this slice
  const int ncols = nu * d3;                  // P columns of this slice (<= 64)
  const int nt_used = (ncols + 7) / 8;
  const int h0 = g * HR;
  const long long r0 = tile * kWarps;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;   // mma fragment coordinates
  const long long r = r0 + warp;
  const bool row_ok = r < n_rows;
  const long long rr = row_ok ? r : 0;

  // ---- P phase: this warp's receiver, every neighbour -----------------
  float acc[MT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.f;

  float* ring = smem + warp * kStages * StageFloats;
  const In* h_row = h_aug + rr * K * static_cast<long long>(Ha);
  const In* c_row = coupled + rr * K * static_cast<long long>(F) + tbl.f_off[c] + u0 * d3;
  const int n_steps = (K + kKC - 1) / kKC;

  // stage `st` of the ring <- neighbours [kc*8, kc*8+8): per lane, A takes
  // hidden row (lane % HR) of 32/HR neighbours per pass, B column lane and
  // lane+32 of one neighbour per pass
  auto load_stage = [&](int kc, int st) {
    float* as = ring + st * StageFloats;
    float* bs = as + kKC * AStride;
    const int k0 = kc * kKC;
    const int ha = lane % HR;
    const bool h_ok = row_ok && h0 + ha < Ha;
#pragma unroll
    for (int i = 0; i < kKC * HR / 32; ++i) {
      const int kk = i * (32 / HR) + lane / HR;
      const bool ok = h_ok && k0 + kk < K;
      cp_async4(as + kk * AStride + ha,
                ok ? h_row + static_cast<long long>(k0 + kk) * Ha + h0 + ha : h_aug, ok);
    }
    if (tbl.pairs[c]) {  // every slice starts on an even column of an even-width row
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        const int j = 2 * lane;
        const int n = row_ok && k0 + kk < K ? max(0, min(2, ncols - j)) : 0;
        cp_async8(bs + kk * kBStride + j,
                  n > 0 ? c_row + static_cast<long long>(k0 + kk) * F + j : coupled, n);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2 * kKC; ++i) {
        const int kk = i >> 1;
        const int j = lane + 32 * (i & 1);
        const bool ok = row_ok && k0 + kk < K && j < ncols;
        cp_async4(bs + kk * kBStride + j,
                  ok ? c_row + static_cast<long long>(k0 + kk) * F + j : coupled, ok);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load_stage(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_steps; ++kc) {
    cp_async_wait_stages();
    __syncwarp();
    // refill the stage read in the step before, so kStages - 1 stages are
    // in flight while this one is multiplied
    if (kc + kStages - 1 < n_steps) load_stage(kc + kStages - 1, (kc + kStages - 1) % kStages);
    cp_async_commit();
    const float* stage = ring + (kc % kStages) * StageFloats;
#pragma unroll
    for (int k8 = 0; k8 < kKC / 8; ++k8) {
      const float* as = stage + k8 * 8 * AStride;
      const float* bs = stage + kKC * AStride + k8 * 8 * kBStride;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        split(as[tq * AStride + mi * 16 + gq], ah[mi][0], al[mi][0]);
        split(as[tq * AStride + mi * 16 + gq + 8], ah[mi][1], al[mi][1]);
        split(as[(tq + 4) * AStride + mi * 16 + gq], ah[mi][2], al[mi][2]);
        split(as[(tq + 4) * AStride + mi * 16 + gq + 8], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        if (ni < nt_used) {
          uint32_t bh0, bl0, bh1, bl1;
          split(bs[tq * kBStride + ni * 8 + gq], bh0, bl0);
          split(bs[(tq + 4) * kBStride + ni * 8 + gq], bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            mma_3xtf32(acc[mi][ni], ah[mi], al[mi], bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncwarp();  // every lane has read this stage before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: P and the partial sums reuse it

  // ---- P tiles to shared memory: ps[(uu*HR + hh)][t*d3 + d] -------------
  // (depth rows of the weight product, kWarps*d3 receiver-and-d columns;
  // the row stride kWarps*d3 + 8 is an odd multiple of 8, so fragment reads
  // are conflict-free). j / d3 for j < 64 by a multiply: exact for d3 <= 64.
  const int nstride = kWarps * d3 + 8;
  const int inv_d3 = (65536 + d3 - 1) / d3;
  float* ps = smem;
  const int depth = HR * nu;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int hh = mi * 16 + gq + (v >> 1) * 8;
        const int j = ni * 8 + 2 * tq + (v & 1);
        if (j < ncols) {
          const int uu = (j * inv_d3) >> 16, d = j - uu * d3;
          ps[(uu * HR + hh) * nstride + warp * d3 + d] = acc[mi][ni][v];
        }
      }
  __syncthreads();

  // ---- weight product: O[w][t*d3+d] = sum_(u,h) W_c[h0+hh, u0+uu, w] * ps --
  // tiles: m16 over w (n_m of them), n8 over (receiver, d) (n_n = kWarps*d3/8).
  // Main path (n_n <= kMaxWN): a warp takes one m tile and every n tile, so
  // each W fragment feeds n_n products, and the depth is split into `parts`
  // contiguous ranges across the warps of the same m tile. Else a warp
  // takes whole tiles (w, n) in turn over the full depth.
  const int n_m = (mul + 15) / 16;
  const int n_n = kWarps * d3 / 8;
  const bool wide = n_n <= kMaxWN && n_m <= kWarps;
  const int n_tiles = n_m * n_n;
  const int parts = wide ? kWarps / n_m : 1;
  const int part = wide ? warp / n_m : 0;
  const bool w_active = wide ? part < parts : warp < n_tiles;
  // depth steps of 8 (m16n8k8 TF32)
  constexpr int kDepthStep = 8;
  const int steps = depth / kDepthStep;
  const int k_begin = part * steps / parts * kDepthStep;
  const int k_end = (part + 1) * steps / parts * kDepthStep;
  const In* wc = weights + tbl.w_off[c];
  float* red = ps + depth * nstride;  // [parts][n_m*16][nstride]

  float wacc[kMaxWN][4];
#pragma unroll
  for (int i = 0; i < kMaxWN; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) wacc[i][v] = 0.f;

  // W_c row of depth row k = uu*HR + hh, or null past the hidden rows
  auto w_row = [&](int k) -> const In* {
    const int hh = k % HR, uu = k / HR;
    return h0 + hh < Ha ? wc + ((h0 + hh) * fan + u0 + uu) * mul : nullptr;
  };

  if (w_active && wide) {
    const int mi = warp % n_m;
    const int w0 = mi * 16 + gq, w1 = w0 + 8;
    const bool w0_ok = w0 < mul, w1_ok = w1 < mul;
    for (int kb = k_begin; kb < k_end; kb += 8 * kPrefetch) {
      // the W fragments of kPrefetch depth steps are loaded together
      float raw[kPrefetch][4];
#pragma unroll
      for (int q = 0; q < kPrefetch; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = kb + 8 * q + tq + 4 * half;
          const float* wr = k < k_end ? w_row(k) : nullptr;
          raw[q][2 * half] = wr != nullptr && w0_ok ? __ldg(wr + w0) : 0.f;
          raw[q][2 * half + 1] = wr != nullptr && w1_ok ? __ldg(wr + w1) : 0.f;
        }
#pragma unroll
      for (int q = 0; q < kPrefetch; ++q) {
        const int k0 = kb + 8 * q;
        if (k0 < k_end) {
          // fragment order: (w0, k), (w1, k), (w0, k+4), (w1, k+4)
          uint32_t ah[4], al[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) split(raw[q][v], ah[v], al[v]);
#pragma unroll
          for (int ni = 0; ni < kMaxWN; ++ni) {
            if (ni < n_n) {
              uint32_t bh0, bl0, bh1, bl1;
              split(ps[(k0 + tq) * nstride + ni * 8 + gq], bh0, bl0);
              split(ps[(k0 + tq + 4) * nstride + ni * 8 + gq], bh1, bl1);
              mma_3xtf32(wacc[ni], ah, al, bh0, bh1, bl0, bl1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < kMaxWN; ++ni) {
      if (ni < n_n) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int w = mi * 16 + gq + (v >> 1) * 8;
          const int n = ni * 8 + 2 * tq + (v & 1);
          red[(part * n_m * 16 + w) * nstride + n] = wacc[ni][v];
        }
      }
    }
  } else if (w_active) {
    for (int ti = warp; ti < n_tiles; ti += kWarps) {
      const int mi = ti / n_n, ni = ti - mi * n_n;
      const int w0 = mi * 16 + gq, w1 = w0 + 8;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < depth; k0 += 8) {
        const float* wr0 = w_row(k0 + tq);
        const float* wr1 = w_row(k0 + tq + 4);
        uint32_t ah[4], al[4];
        split(wr0 != nullptr && w0 < mul ? __ldg(wr0 + w0) : 0.f, ah[0], al[0]);
        split(wr0 != nullptr && w1 < mul ? __ldg(wr0 + w1) : 0.f, ah[1], al[1]);
        split(wr1 != nullptr && w0 < mul ? __ldg(wr1 + w0) : 0.f, ah[2], al[2]);
        split(wr1 != nullptr && w1 < mul ? __ldg(wr1 + w1) : 0.f, ah[3], al[3]);
        uint32_t bh0, bl0, bh1, bl1;
        split(ps[(k0 + tq) * nstride + ni * 8 + gq], bh0, bl0);
        split(ps[(k0 + tq + 4) * nstride + ni * 8 + gq], bh1, bl1);
        mma_3xtf32(o, ah, al, bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int w = mi * 16 + gq + (v >> 1) * 8;
        const int n = ni * 8 + 2 * tq + (v & 1);
        red[w * nstride + n] = o[v];
      }
    }
  }
  __syncthreads();

  // ---- sum the depth parts in order and store ----------------------------
  // one part (one group, one slice) writes `out`; else scratch part
  // (s * n_groups + g), summed by fused_tp3_reduce
  const bool direct = n_groups * s_max == 1;
  float* base = direct ? dst : dst + (static_cast<long long>(s) * n_groups + g) * n_rows * D;
  const int wd = mul * d3;
  for (int e = threadIdx.x; e < kWarps * wd; e += kThreads) {
    // consecutive threads: consecutive outputs (w, d) of one receiver t
    const int t = e / wd, o = e - t * wd;
    const int w = o / d3, n = t * d3 + o - w * d3;
    float sum = 0.f;
    for (int p = 0; p < parts; ++p) sum += red[(p * n_m * 16 + w) * nstride + n];
    const long long ro = r0 + t;
    if (ro < n_rows) base[ro * D + tbl.out_off[c] + o] = sum;
  }
}

// out[r, col] = sum over the class's slices s and the groups g, in order
__global__ void fused_tp3_reduce(const float* __restrict__ parts, float* __restrict__ out,
                                 ClassTable tbl, int n_classes, long long n_rows, int D,
                                 int n_groups) {
  const long long total = n_rows * D;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(e % D);
    int c = 0;
    while (c + 1 < n_classes && col >= tbl.out_off[c + 1]) ++c;
    const int n_parts = tbl.n_slices[c] * n_groups;
    float sum = 0.f;
    for (int q = 0; q < n_parts; ++q) sum += parts[q * total + e];
    out[e] = sum;
  }
}

// ---- the launcher -------------------------------------------------------

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

struct Plan {
  int mt;        // m16 tiles of hidden rows per block
  int n_groups;  // hidden-row groups
  int s_max;     // most column slices of a class
  int n_sl;      // column slices of all classes
  long long smem_floats;
};

// Fills the derived columns of `tbl` and returns the launch plan, or
// mt = 0 if a class does not fit a block.
Plan make_plan(ClassTable& tbl, int n_classes, int Ha) {
  Plan p = {};
  p.mt = Ha <= 16 ? 1 : 2;
  const int hr = 16 * p.mt;
  p.n_groups = (Ha + hr - 1) / hr;
  const long long ring =
      static_cast<long long>(kWarps) * kStages * (kKC * (hr + 8) + kKC * kBStride);
  p.smem_floats = ring;
  for (int c = 0; c < n_classes; ++c) {
    const int fan = tbl.fan[c], d3 = tbl.d3[c], mul = tbl.mul[c];
    if (fan < 1 || d3 < 1 || mul < 1 || d3 > kSliceCols || mul * d3 > kMaxOutputs ||
        fan * d3 > kMaxColumns) {
      p.mt = 0;
      return p;
    }
    // the fewest slices of at most 64 columns, balanced; an even number of
    // u per slice where that fits, so every slice starts on an even column
    const int us_max = kSliceCols / d3;
    tbl.n_slices[c] = (fan + us_max - 1) / us_max;
    tbl.us[c] = (fan + tbl.n_slices[c] - 1) / tbl.n_slices[c];
    if (tbl.us[c] % 2 == 1 && tbl.us[c] < us_max) ++tbl.us[c];
    // as the kernel's weight product splits its depth
    const int n_m = (mul + 15) / 16, n_n = kWarps * d3 / 8;
    const int parts = n_n <= kMaxWN && n_m <= kWarps ? kWarps / n_m : 1;
    const long long nstride = static_cast<long long>(kWarps) * d3 + 8;
    const long long need = hr * static_cast<long long>(tbl.us[c]) * nstride +
                           static_cast<long long>(parts) * n_m * 16 * nstride;
    p.smem_floats = std::max(p.smem_floats, need);
    p.s_max = std::max(p.s_max, tbl.n_slices[c]);
    tbl.slice_base[c] = p.n_sl;
    p.n_sl += tbl.n_slices[c];
  }
  return p;
}

bool read_table(const long long* class_table, int n_classes, ClassTable& tbl) {
  if (n_classes < 1 || n_classes > kMaxClasses) return false;
  tbl = ClassTable{};
  for (int c = 0; c < n_classes; ++c) {
    const long long* row = class_table + 6 * c;
    tbl.f_off[c] = static_cast<int>(row[0]);
    tbl.fan[c] = static_cast<int>(row[1]);
    tbl.d3[c] = static_cast<int>(row[2]);
    tbl.mul[c] = static_cast<int>(row[3]);
    tbl.out_off[c] = static_cast<int>(row[4]);
    tbl.w_off[c] = row[5];
  }
  return true;
}

template <int MT>
cudaError_t launch(const float* h_aug, const float* coupled, const float* weights, float* out,
                   float* scratch, const ClassTable& tbl, const Plan& plan, int n_classes,
                   long long n_rows, int K, int Ha, int F, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(plan.smem_floats);
  cudaError_t err = cudaFuncSetAttribute(fused_tp3_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n_rows + kWarps - 1) / kWarps;
  const long long n_blocks = n_tiles * plan.n_sl * plan.n_groups;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool direct = plan.n_groups * plan.s_max == 1;
  // a class's coupled slices load in 8-byte pairs if the rows
  // have an even width and an 8-byte aligned base, and every slice starts on
  // an even column
  ClassTable t = tbl;
  const bool even_rows = F % 2 == 0 && reinterpret_cast<uintptr_t>(coupled) % 8 == 0;
  for (int c = 0; c < n_classes; ++c)
    t.pairs[c] = even_rows && t.f_off[c] % 2 == 0 && (t.us[c] * t.d3[c]) % 2 == 0;
  fused_tp3_kernel<MT><<<static_cast<unsigned>(n_blocks), kThreads, smem, stream>>>(
      h_aug, coupled, weights, direct ? out : scratch, t, n_classes, n_rows, K, Ha, F, D,
      plan.n_groups, plan.n_sl, plan.s_max);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  const long long total = n_rows * D;
  const long long blocks = std::min<long long>((total + 255) / 256, 32LL * sm_count());
  fused_tp3_reduce<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      scratch, out, tbl, n_classes, n_rows, D, plan.n_groups);
  return cudaGetLastError();
}

int forward(const float* h_aug, const float* coupled, const float* weights, float* out,
            float* scratch, const long long* class_table, int n_classes, long long n_rows, int K,
            int Ha, int F, int D, void* stream) {
  ClassTable tbl;
  if (!read_table(class_table, n_classes, tbl) || K < 1 || Ha < 1)
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(tbl, n_classes, Ha);
  if (plan.mt == 0) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (plan.mt == 1)
    return launch<1>(h_aug, coupled, weights, out, scratch, tbl, plan, n_classes, n_rows,
                           K, Ha, F, D, s);
  return launch<2>(h_aug, coupled, weights, out, scratch, tbl, plan, n_classes, n_rows, K,
                         Ha, F, D, s);
}

}  // namespace

extern "C" {

int fused_tp3_max_classes() { return kMaxClasses; }
// the widest class a block takes: mul*d3 outputs, fan*d3 coupled columns
int fused_tp3_max_outputs() { return kMaxOutputs; }
int fused_tp3_max_columns() { return kMaxColumns; }

// Floats of scratch the call needs (0 when the kernel writes `out`
// directly), or -1 if the class table is refused.
long long fused_tp3_scratch_floats(const long long* class_table, int n_classes,
                                   long long n_rows, int Ha, int D) {
  ClassTable tbl;
  if (!read_table(class_table, n_classes, tbl) || Ha < 1) return -1;
  const Plan plan = make_plan(tbl, n_classes, Ha);
  if (plan.mt == 0) return -1;
  const long long n_parts = static_cast<long long>(plan.n_groups) * plan.s_max;
  return n_parts == 1 ? 0 : n_parts * n_rows * D;
}

// class_table: host array of n_classes rows of 6 int64 values
// (f_off, fan, d3, mul, out_off, w_off); scratch: the floats that
// fused_tp3_scratch_floats asks for. Returns a cudaError_t.
int fused_tp3_forward(const float* h_aug, const float* coupled, const float* weights,
                      float* out, float* scratch, const long long* class_table,
                      int n_classes, long long n_rows, int K, int Ha, int F, int D,
                      void* stream) {
  return forward(h_aug, coupled, weights, out, scratch, class_table, n_classes, n_rows, K, Ha, F,
                 D, stream);
}

}  // extern "C"
