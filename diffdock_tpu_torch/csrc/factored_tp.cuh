// The factored tensor-product contraction with the Clebsch-Gordan coupling
// built inside the kernel, on Hopper's tensor cores: the body shared by
// factored_tp2.cu (gen 2) and factored_tp1.cu (gen 1), which differ only in
// how they read the hidden rows, the CG weights and the last-layer weights.
//
// Per receiver row r and output class c (fan, d3, mul):
//
//     W[k, col]     = sum_j sh[r, k, j] * CG[j, col]           (CG weights)
//     C[k, u*d3+d]  = sum_i xp[r, k, path(u), i, u] * W[k, col(path(u)) + i*d3 + d]
//     P[h, u*d3+d]  = sum_k A[r, h, k] * C[k, u*d3+d]
//     out[r, o_c + w*d3+d] = sum_h sum_u P[h, u*d3+d] * T_c[h, u, w] / sqrt(fan)
//
// where the hidden rows A are the edge MLP's hidden activations (already
// scaled by mask*edge_weight) with mask*edge_weight itself as row H, and
// T_c's row H is the class's bias: rows past H are not walked. xp holds the
// neighbour features packed [path][i][u]. Gen 2 takes A as h_aug (N, K,
// He), row H included, one dense (J, cols) CG matrix for every path and
// one (He, fan, mul) block per class; gen 1 takes h (N, K, H) and mw (N,
// K), per path a (d2, d1*d3) CG block read against the path's own d2
// harmonics, and T_c (H, fan, mul) and b_c (fan, mul) apart.
//
// What bounds it on an H100: operations. The two products (P: M = hidden
// rows, N = one class's columns, depth = neighbours; the weight product:
// M = w, N = (receiver, d), depth = (u, h)) run on the tensor cores as
// mma.sync m16n8k8 TF32 in 3xTF32 (tp_mma.cuh), float32 accuracy at 165
// TFLOP/s. The coupling (CG weights, then d1 FMAs per coupled column) is
// a few per cent of P's FLOPs but runs on the CUDA cores and reads shared
// memory for every FMA, and it is rebuilt for every hidden-row group. The
// design:
//   - a block owns 16 receivers (one warp each), one slice of one class's
//     columns (whole u groups, at most 24 columns, at most xp_cap packed
//     input floats and 64 CG-weight columns per neighbour) and one group
//     of hidden rows: the fewest groups of at most 80 rows (5 m16 tiles),
//     so H+1 = 145 takes 2 groups of 80 and H+1 = 73 one. Each warp keeps
//     its receiver's 80 x 24 P tile in registers (60 floats a lane, as
//     many as csrc/fused_tp3.cu's 32 x 64) over all neighbours; each W_c
//     fragment of the weight product feeds the block's 16 receivers;
//   - the coupling is built by the warp that multiplies it, per stage of 8
//     neighbours: its hidden rows, harmonics and the slice's packed input
//     floats arrive through a 2-stage cp.async ring (no block barrier in
//     the neighbour loop); the warp computes the stage's CG weights (only
//     the CG rows that are not zero for a column: the same sums as the
//     dense sh @ CG), then the coupled columns straight into its B tile,
//     in the row stride (40) the fragment reads want, 8 neighbours side
//     by side in each lane. Tall, narrow P tiles are what keeps the
//     rebuilds few: a warp of fused_tp3's shape (32 x 64) would rebuild
//     the coupling 5 times at H+1 = 145 and 3 times at 73, and took
//     1.3-2.1x as long. The alternative, warps of a block splitting one
//     receiver's hidden rows over one shared coupled tile, reads each W_c
//     block for 3 receivers instead of 16;
//   - the slice's geometry (which paths it touches, where each coupled
//     column reads its packed inputs and CG weights, which global floats
//     each stage copies) is worked out once per block into shared tables;
//   - the partial sums of the weight product's depth split, and of the
//     groups and slices, are added in a fixed order (in shared memory, and
//     in a second small kernel over a scratch buffer): two launches give
//     the same bits. Nothing is split with atomics.
//
// The bfloat16 modes of both gens are a kernel of their own,
// factored_tp_bf16.cu.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "tp_mma.cuh"

namespace {

using namespace tp_mma;

constexpr int kMaxClasses = 16;
constexpr int kMaxPaths = 64;
constexpr int kWarps = 16;                // receivers per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kNT = 3;                    // n8 tiles of P per warp: 24 columns
constexpr int kSliceCols = kNT * 8;
constexpr int kMaxMT = 5;                 // m16 tiles of P per warp: up to 80 hidden rows
constexpr int kKC = 8;                    // neighbours per pipeline stage
constexpr int kStages = 2;
constexpr int kBStride = kSliceCols + 16;  // 40: conflict-free fragment reads
constexpr int kMaxWN = 6;                 // weight-product n8 tiles per warp
constexpr int kPrefetch = 8;              // weight-product depth steps in flight
constexpr int kMaxOutputs = 256;          // mul*d3 of one class
constexpr int kMaxColumns = 4096;         // fan*d3 of one class
constexpr int kMaxXp = 96;                // packed input floats per neighbour of a slice (cap)
constexpr int kMaxW = 64;                 // CG-weight columns of a slice
constexpr int kMaxSh = 16;                // harmonics per neighbour, CG rows
constexpr int kMaxSmemBytes = 232448;
// the block's shared tables at their largest: colinfo, wcol, xmap, cg_s
constexpr int kTableFloats = 4 * kSliceCols + 4 * kMaxW + kMaxXp + kMaxSh * kMaxW;

// The most packed input floats per neighbour a slice may take with hr
// hidden rows and J harmonics: kMaxXp, or what each warp's share of shared
// memory holds beside its ring's hidden rows and harmonics, its B tile and
// kMaxW CG-weight columns.
__host__ __device__ inline int xp_cap(int hr, int J) {
  const int per_warp = (kMaxSmemBytes / 4 - kTableFloats) / kWarps;
  const int room = per_warp - kKC * kBStride - kKC * kMaxW - kStages * kKC * (hr + 8 + J);
  const int cap = room / (kStages * kKC);
  return cap < kMaxXp ? cap : kMaxXp;
}

// The class and path tables of one call. Path columns are relative to the
// class: u_off into its fan, col into its CG columns (from col0).
struct Tables {
  int n_classes, n_paths;
  int fan[kMaxClasses], d3[kMaxClasses], mul[kMaxClasses], out_off[kMaxClasses];
  int col0[kMaxClasses], path0[kMaxClasses], np[kMaxClasses];
  long long w_off[kMaxClasses];  // gen 2: the (He, fan, mul) block; gen 1: T_c (H, fan, mul)
  long long b_off[kMaxClasses];  // gen 1: b_c (fan, mul)
  int us[kMaxClasses];           // u per column slice
  int n_slices[kMaxClasses];
  int slice_base[kMaxClasses];   // slices of the classes before this one
  int u_off[kMaxPaths], pmul[kMaxPaths], d1[kMaxPaths], xp_start[kMaxPaths];
  int col[kMaxPaths], sh_start[kMaxPaths], d2[kMaxPaths];
};

// Every operand is float32.
struct Operands {
  const float* xp;      // (N, K, XP)
  const float* sh;      // (N, K, J)
  const float* hid;     // gen 2: h_aug (N, K, He); gen 1: h (N, K, H)
  const float* mw;      // gen 1: (N, K)
  const float* cg;      // (cg_rows, cg_cols)
  const float* w_main;  // gen 2: packed (He, fan, mul); gen 1: packed T_c
  const float* w_bias;  // gen 1: packed b_c
};

struct Dims {
  long long n_rows;
  int K, XP, J, H, Ha, He, cg_rows, cg_cols, D;
  int n_groups, n_sl, s_max, xs_max, nc_max;
};

// The paths pa..pb of class c that a slice [u0, u0 + nu) touches, its
// packed input floats per neighbour (xs) and its CG-weight columns (nc,
// from column cw0 of the class). Path p of the slice covers u in
// [max(u0, u_off), min(u0 + nu, u_off + mul)); its d1 runs of packed
// input follow each other, path after path.
struct Slice {
  int pa, pb, xs, cw0, nc;
};

__host__ __device__ inline Slice slice_of(const Tables& tb, int c, int u0, int nu) {
  Slice sl;
  const int pend = tb.path0[c] + tb.np[c];
  int p = tb.path0[c];
  while (tb.u_off[p] + tb.pmul[p] <= u0) ++p;
  sl.pa = p;
  sl.xs = 0;
  for (; p < pend && tb.u_off[p] < u0 + nu; ++p) {
    const int ua = u0 > tb.u_off[p] ? u0 : tb.u_off[p];
    const int ub = u0 + nu < tb.u_off[p] + tb.pmul[p] ? u0 + nu : tb.u_off[p] + tb.pmul[p];
    sl.xs += tb.d1[p] * (ub - ua);
  }
  sl.pb = p - 1;
  sl.cw0 = tb.col[sl.pa];
  sl.nc = tb.col[sl.pb] + tb.d1[sl.pb] * tb.d3[c] - sl.cw0;
  return sl;
}

// ---- the kernel ---------------------------------------------------------

// MT: m16 tiles of hidden rows per block (1-5: the hidden rows in the
// fewest groups of at most 80, balanced)
template <int MT, bool kGen1>
__global__ void __launch_bounds__(kThreads, 1)
factored_tp_kernel(Operands op, float* __restrict__ dst, Tables tb, Dims dm) {
  constexpr int HR = MT * 16;          // hidden rows per block
  constexpr int AStride = HR + 8;      // 8 or 24 mod 32: conflict-free fragment reads
  const int J = dm.J, K = dm.K, xs_s = dm.xs_max, nc_s = dm.nc_max;
  const int stage_floats = kKC * (AStride + J + xs_s);
  const int warp_floats = kStages * stage_floats + kKC * kBStride + kKC * nc_s;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  // block -> (receiver tile, slice of a class, hidden group); the groups
  // and slices of one receiver tile are neighbours in launch order
  long long bid = blockIdx.x;
  const int g = static_cast<int>(bid % dm.n_groups);
  bid /= dm.n_groups;
  const int sl_id = static_cast<int>(bid % dm.n_sl);
  const long long tile = bid / dm.n_sl;
  int c = 0;
  while (c + 1 < tb.n_classes && sl_id >= tb.slice_base[c + 1]) ++c;
  const int s = sl_id - tb.slice_base[c];

  const int fan = tb.fan[c], d3 = tb.d3[c], mul = tb.mul[c];
  const int u0 = s * tb.us[c];
  const int nu = min(tb.us[c], fan - u0);     // u of this slice
  const int ncols = nu * d3;                  // P columns of this slice (<= 24)
  const int nt_used = (ncols + 7) / 8;
  const int h0 = g * HR;
  const long long r0 = tile * kWarps;
  const Slice sl = slice_of(tb, c, u0, nu);
  const int nc = sl.nc;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;   // mma fragment coordinates
  const long long r = r0 + warp;
  const bool row_ok = r < dm.n_rows;
  const long long rr = row_ok ? r : 0;

  // ---- the slice's tables, shared by the block's warps ------------------
  // colinfo[j]: coupled column j reads its d1 packed inputs at xoff +
  //   i*xstr of a stage row, and its CG weights at woff + i*d3;
  // wcol[cc]: CG-weight column cc sums sh[so + t] * cg[ro + t] for t < n;
  // xmap[e]: the packed input float e of a stage row, as an offset into a
  //   neighbour's xp row; cg_s: the slice's CG columns
  int4* colinfo = reinterpret_cast<int4*>(smem + kWarps * warp_floats);  // [64]
  int4* wcol = colinfo + kSliceCols;                                    // [nc_s]
  int* xmap = reinterpret_cast<int*>(wcol + nc_s);                       // [kMaxXp]
  float* cg_s = reinterpret_cast<float*>(xmap + kMaxXp);                  // [cg_rows][nc_s]
  const int tid = threadIdx.x;
  const int gcol0 = tb.col0[c] + sl.cw0;  // the slice's first CG column
  if (tid < kSliceCols) {
    int4 ci = make_int4(0, 0, 0, 0);
    if (tid < ncols) {
      const int uu = tid / d3, d = tid - uu * d3, u = u0 + uu;
      int base = 0;
      for (int p = sl.pa; p <= sl.pb; ++p) {
        const int ua = max(u0, tb.u_off[p]);
        const int len = min(u0 + nu, tb.u_off[p] + tb.pmul[p]) - ua;
        if (u < ua + len) {
          ci = make_int4(base + u - ua, len, tb.col[p] - sl.cw0 + d, tb.d1[p]);
          break;
        }
        base += tb.d1[p] * len;
      }
    }
    colinfo[tid] = ci;
  } else if (tid < kSliceCols + nc) {
    const int cc = tid - kSliceCols;
    int p = sl.pa;
    while (p < sl.pb && tb.col[p + 1] <= sl.cw0 + cc) ++p;
    int4 wc;
    if constexpr (kGen1) {
      wc = make_int4(tb.sh_start[p], 0, tb.d2[p], 0);  // the path's own harmonics
    } else {
      // sh @ CG restricted to the rows where this column is not zero
      int lo = dm.cg_rows, hi = -1;
      for (int j = 0; j < dm.cg_rows; ++j) {
        if (__ldg(op.cg + static_cast<long long>(j) * dm.cg_cols + gcol0 + cc) != 0.f) {
          lo = min(lo, j);
          hi = j;
        }
      }
      wc = hi < 0 ? make_int4(0, 0, 0, 0) : make_int4(lo, lo, hi - lo + 1, 0);
    }
    wcol[cc] = wc;
  }
  for (int e = tid; e < sl.xs; e += kThreads) {
    int base = 0;
    for (int p = sl.pa; p <= sl.pb; ++p) {
      const int ua = max(u0, tb.u_off[p]);
      const int len = min(u0 + nu, tb.u_off[p] + tb.pmul[p]) - ua;
      if (e < base + tb.d1[p] * len) {
        const int i = (e - base) / len, t = e - base - i * len;
        xmap[e] = tb.xp_start[p] + i * tb.pmul[p] + ua - tb.u_off[p] + t;
        break;
      }
      base += tb.d1[p] * len;
    }
  }
  for (int q = tid; q < dm.cg_rows * nc; q += kThreads) {
    const int j = q / nc, cc = q - j * nc;
    cg_s[j * nc_s + cc] = __ldg(op.cg + static_cast<long long>(j) * dm.cg_cols + gcol0 + cc);
  }
  __syncthreads();

  // ---- P phase: this warp's receiver, every neighbour -----------------
  float acc[MT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.f;

  float* ring = smem + warp * warp_floats;
  float* bs = ring + kStages * stage_floats;  // [kKC][kBStride]: the coupled B tile
  float* ws = bs + kKC * kBStride;            // [kKC][nc_s]: the stage's CG weights
  const long long x_row = rr * K * static_cast<long long>(dm.XP);
  const int n_steps = (K + kKC - 1) / kKC;

  // stage `st` of the ring <- neighbours [kc*8, kc*8+8): the hidden rows
  // (A, k-major), the harmonics and the slice's packed input floats
  auto load_stage = [&](int kc, int st) {
    float* as = ring + st * stage_floats;
    float* shs = as + kKC * AStride;
    float* xs = shs + kKC * J;
    const int k0 = kc * kKC;
    const int n_k = row_ok ? min(kKC, K - k0) : 0;  // live neighbours of the stage
    const long long e0 = rr * K + k0;
    {
      // hidden rows, (N, K, rows): consecutive lanes read
      // consecutive hidden rows, each lane its rows for the 8 neighbours.
      // Gen 2's h_aug holds row H (mw) itself; gen 1 reads h for rows below
      // H and mw for row H. Rows past H are zero.
      const float* hid = op.hid;
#pragma unroll 1
      for (int ha = lane; ha < HR; ha += 32) {
        const int h = h0 + ha;
        bool h_ok;
        const float* src;
        int step;
        if constexpr (kGen1) {
          h_ok = h <= dm.H;
          src = h < dm.H ? hid + e0 * dm.H + h : op.mw + e0;
          step = h < dm.H ? dm.H : 1;
        } else {
          h_ok = h < dm.Ha;
          src = hid + e0 * dm.He + h;
          step = dm.He;
        }
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk, src += step) {
          const bool ok = h_ok && kk < n_k;
          cp_async4(as + kk * AStride + ha, ok ? src : hid, ok);
        }
      }
    }
    // the stage's harmonics are kKC contiguous rows of J values
    for (int e = lane; e < kKC * J; e += 32) {
      const bool ok = e < n_k * J;
      cp_async4(shs + e, op.sh + (ok ? e0 * J + e : 0), ok);
    }
    // each packed input's kKC neighbours, dm.XP floats apart
    const float* x_rowf = op.xp + x_row + static_cast<long long>(k0) * dm.XP;
    for (int e = lane; e < sl.xs; e += 32) {
      const float* src = x_rowf + xmap[e];
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk, src += dm.XP) {
        const bool ok = kk < n_k;
        cp_async4(xs + kk * xs_s + e, ok ? src : op.xp, ok);
      }
    }
  };

  load_stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_steps; ++kc) {
    // the next stage loads while this one is coupled and multiplied
    if (kc + 1 < n_steps) load_stage(kc + 1, (kc + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const float* as = ring + (kc % kStages) * stage_floats;
    const float* shs = as + kKC * AStride;
    const float* xs = shs + kKC * J;

    // CG weights: ws[kk][cc] = sum_t sh[kk][so + t] * cg[ro + t][cc]; lane
    // cc (and cc + 32) sums the 8 neighbours side by side
    for (int cc = lane; cc < nc; cc += 32) {
      const int4 wc = wcol[cc];
      float v[kKC];
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) v[kk] = 0.f;
      for (int t = 0; t < wc.z; ++t) {
        const float gv = cg_s[(wc.y + t) * nc_s + cc];
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk) v[kk] = fmaf(shs[kk * J + wc.x + t], gv, v[kk]);
      }
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) ws[kk * nc_s + cc] = v[kk];
    }
    __syncwarp();

    // coupled columns into the B tile: bs[kk][j] = sum_i x[kk][xoff + i*xstr]
    // * ws[kk][woff + i*d3]; lane j (zero past the slice), the 8 neighbours
    // side by side
    if (lane < nt_used * 8) {
      const int4 ci = colinfo[lane];
      float v[kKC];
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) v[kk] = 0.f;
      for (int i = 0; i < ci.w; ++i) {
        const int e = ci.x + i * ci.y;
        const float* xr = xs + e;
        const float* wr = ws + ci.z + i * d3;
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk) v[kk] = fmaf(xr[kk * xs_s], wr[kk * nc_s], v[kk]);
      }
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) bs[kk * kBStride + lane] = v[kk];
    }
    __syncwarp();

    // P += A^T-stage x B-stage, 3xTF32: the B fragments of the slice's
    // column tiles, then each row tile against all of them
    {
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        split(bs[tq * kBStride + ni * 8 + gq], bh[ni][0], bl[ni][0]);
        split(bs[(tq + 4) * kBStride + ni * 8 + gq], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t ah[4], al[4];
        split(as[tq * AStride + mi * 16 + gq], ah[0], al[0]);
        split(as[tq * AStride + mi * 16 + gq + 8], ah[1], al[1]);
        split(as[(tq + 4) * AStride + mi * 16 + gq], ah[2], al[2]);
        split(as[(tq + 4) * AStride + mi * 16 + gq + 8], ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
          if (ni < nt_used)
            mma_3xtf32(acc[mi][ni], ah, al, bh[ni][0], bh[ni][1], bl[ni][0], bl[ni][1]);
      }
    }
    __syncwarp();  // every lane is done with this stage, ws and bs
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: P and the partial sums reuse it

  // ---- P tiles to shared memory: ps[(uu*HR + hh)][t*d3 + d] -------------
  // (depth rows of the weight product, kWarps*d3 receiver-and-d columns;
  // the row stride kWarps*d3 + 8 is an odd multiple of 8, so fragment reads
  // are conflict-free). j / d3 for j < 24 by a multiply: exact for d3 <= 24.
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

  // ---- weight product: O[w][t*d3+d] = sum_(u,h) T_c[h0+hh, u0+uu, w] * ps --
  // tiles: m16 over w (n_m of them), n8 over (receiver, d) (n_n = kWarps*d3/8).
  // Main path (n_n <= kMaxWN): a warp takes one m tile and every n tile, so
  // each weight fragment feeds n_n products, and the depth is split into
  // `parts` contiguous ranges across the warps of the same m tile. Else a
  // warp takes whole tiles (w, n) in turn over the full depth.
  const int n_m = (mul + 15) / 16;
  const int n_n = kWarps * d3 / 8;
  const bool wide = n_n <= kMaxWN && n_m <= kWarps;
  const int n_tiles = n_m * n_n;
  const int parts = wide ? kWarps / n_m : 1;
  const int part = wide ? warp / n_m : 0;
  const bool w_active = wide ? part < parts : warp < n_tiles;
  const int steps = depth / 8;
  const int k_begin = part * steps / parts * 8, k_end = (part + 1) * steps / parts * 8;
  float* red = ps + depth * nstride;  // [parts][n_m*16][nstride]

  float wacc[kMaxWN][4];
#pragma unroll
  for (int i = 0; i < kMaxWN; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) wacc[i][v] = 0.f;

  // the weight row of depth row k = uu*HR + hh, or null past the hidden
  // rows; row H is the bias
  auto w_row = [&](int k) -> const float* {
    const int h = h0 + k % HR, u = u0 + k / HR;
    if constexpr (kGen1) {
      if (h < dm.H) return op.w_main + tb.w_off[c] + (static_cast<long long>(h) * fan + u) * mul;
      return h == dm.H ? op.w_bias + tb.b_off[c] + static_cast<long long>(u) * mul : nullptr;
    } else {
      return h < dm.Ha ? op.w_main + tb.w_off[c] + (static_cast<long long>(h) * fan + u) * mul
                       : nullptr;
    }
  };
  auto ld_w = [](const float* row, int w) { return __ldg(row + w); };

  if (w_active && wide) {
    const int mi = warp % n_m;
    const int w0 = mi * 16 + gq, w1 = w0 + 8;
    const bool w0_ok = w0 < mul, w1_ok = w1 < mul;
    for (int kb = k_begin; kb < k_end; kb += 8 * kPrefetch) {
      // the weight fragments of kPrefetch depth steps are loaded together
      float raw[kPrefetch][4];
#pragma unroll
      for (int q = 0; q < kPrefetch; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = kb + 8 * q + tq + 4 * half;
          const float* wr = k < k_end ? w_row(k) : nullptr;
          raw[q][2 * half] = wr != nullptr && w0_ok ? ld_w(wr, w0) : 0.f;
          raw[q][2 * half + 1] = wr != nullptr && w1_ok ? ld_w(wr, w1) : 0.f;
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
              const float p0 = ps[(k0 + tq) * nstride + ni * 8 + gq];
              const float p1 = ps[(k0 + tq + 4) * nstride + ni * 8 + gq];
              uint32_t bh0, bl0, bh1, bl1;
              split(p0, bh0, bl0);
              split(p1, bh1, bl1);
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
        const float a[4] = {wr0 != nullptr && w0 < mul ? ld_w(wr0, w0) : 0.f,
                            wr0 != nullptr && w1 < mul ? ld_w(wr0, w1) : 0.f,
                            wr1 != nullptr && w0 < mul ? ld_w(wr1, w0) : 0.f,
                            wr1 != nullptr && w1 < mul ? ld_w(wr1, w1) : 0.f};
        const float p0 = ps[(k0 + tq) * nstride + ni * 8 + gq];
        const float p1 = ps[(k0 + tq + 4) * nstride + ni * 8 + gq];
        uint32_t ah[4], al[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) split(a[v], ah[v], al[v]);
        uint32_t bh0, bl0, bh1, bl1;
        split(p0, bh0, bl0);
        split(p1, bh1, bl1);
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

  // ---- sum the depth parts in order, scale by 1/sqrt(fan) and store ------
  // one part (one group, one slice) writes `out`; else scratch part
  // (s * n_groups + g), summed by factored_tp_reduce
  const bool direct = dm.n_groups * dm.s_max == 1;
  float* base =
      direct ? dst : dst + (static_cast<long long>(s) * dm.n_groups + g) * dm.n_rows * dm.D;
  const float scale = 1.0f / sqrtf(static_cast<float>(fan));
  const int wd = mul * d3;
  for (int e = tid; e < kWarps * wd; e += kThreads) {
    // consecutive threads: consecutive outputs (w, d) of one receiver t
    const int t = e / wd, o = e - t * wd;
    const int w = o / d3, n = t * d3 + o - w * d3;
    float sum = 0.f;
    for (int p = 0; p < parts; ++p) sum += red[(p * n_m * 16 + w) * nstride + n];
    const long long ro = r0 + t;
    if (ro < dm.n_rows) base[ro * dm.D + tb.out_off[c] + o] = sum * scale;
  }
}

// out[r, col] = sum over the class's slices s and the groups g, in order
__global__ void factored_tp_reduce(const float* __restrict__ parts, float* __restrict__ out,
                                   Tables tb, long long n_rows, int D, int n_groups) {
  const long long total = n_rows * D;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(e % D);
    int c = 0;
    while (c + 1 < tb.n_classes && col >= tb.out_off[c + 1]) ++c;
    const int n_parts = tb.n_slices[c] * n_groups;
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

// The tables are consistent and every read they imply lies inside its
// operand: paths tile their class's u and CG columns in order, packed
// input runs lie inside XP, CG columns inside cg_cols, harmonics inside J.
bool tables_ok(const Tables& tb, int XP, int J, int cg_rows, int cg_cols, int D, bool gen1) {
  if (tb.n_classes < 1 || tb.n_classes > kMaxClasses || tb.n_paths < 1 ||
      tb.n_paths > kMaxPaths || J < 1 || J > kMaxSh || cg_rows < 1 || cg_rows > kMaxSh)
    return false;
  int out_end = 0;
  for (int c = 0; c < tb.n_classes; ++c) {
    const int fan = tb.fan[c], d3 = tb.d3[c], mul = tb.mul[c];
    if (fan < 1 || d3 < 1 || d3 > kSliceCols || mul < 1 || mul * d3 > kMaxOutputs ||
        fan * d3 > kMaxColumns || tb.np[c] < 1 || tb.path0[c] < 0 ||
        tb.path0[c] + tb.np[c] > tb.n_paths || tb.out_off[c] != out_end || tb.col0[c] < 0)
      return false;
    out_end += mul * d3;
    int u = 0, col = 0;
    for (int p = tb.path0[c]; p < tb.path0[c] + tb.np[c]; ++p) {
      const int d1 = tb.d1[p];
      if (tb.u_off[p] != u || tb.pmul[p] < 1 || tb.col[p] != col || d1 < 1 ||
          d1 > kMaxXp || d1 * d3 > kMaxW || tb.xp_start[p] < 0 ||
          tb.xp_start[p] + d1 * tb.pmul[p] > XP || tb.col0[c] + col + d1 * d3 > cg_cols)
        return false;
      if (gen1 && (tb.d2[p] < 1 || tb.d2[p] > cg_rows || tb.sh_start[p] < 0 ||
                   tb.sh_start[p] + tb.d2[p] > J))
        return false;
      u += tb.pmul[p];
      col += d1 * d3;
    }
    if (u != fan) return false;
  }
  return out_end == D;
}

struct Plan {
  int mt;        // m16 tiles of hidden rows per block (0: refused)
  int n_groups;  // hidden-row groups
  int s_max;     // most column slices of a class
  int n_sl;      // column slices of all classes
  int xs_max;    // most packed input floats per neighbour of a slice
  int nc_max;    // most CG-weight columns of a slice
  long long smem_floats;
};

// Fills the slice columns of `tb` and returns the launch plan: the hidden
// rows in the fewest groups of at most 80 (m16 tiles, balanced), per class
// the fewest slices of at most 24 columns, balanced, that keep every slice
// within xp_cap packed input floats and kMaxW CG-weight columns (which
// keeps the block's shared memory within the card's).
Plan make_plan(Tables& tb, int Ha, int J, int cg_rows) {
  Plan p = {};
  p.n_groups = (Ha + 16 * kMaxMT - 1) / (16 * kMaxMT);
  const int mt = (Ha + 16 * p.n_groups - 1) / (16 * p.n_groups);
  const int hr = 16 * mt;
  long long wp_need = 0;
  const int cap = xp_cap(hr, J);
  for (int c = 0; c < tb.n_classes; ++c) {
    const int fan = tb.fan[c], d3 = tb.d3[c], mul = tb.mul[c];
    int n = (fan + kSliceCols / d3 - 1) / (kSliceCols / d3);
    int us = 0, ns = 0;
    for (;; ++n) {
      us = (fan + n - 1) / n;
      ns = (fan + us - 1) / us;
      bool fits = true;
      for (int s = 0; s < ns && fits; ++s) {
        const Slice sl = slice_of(tb, c, s * us, std::min(us, fan - s * us));
        fits = sl.xs <= cap && sl.nc <= kMaxW;
      }
      if (fits) break;
      if (us == 1) return p;  // mt = 0: one u alone does not fit
    }
    tb.us[c] = us;
    tb.n_slices[c] = ns;
    tb.slice_base[c] = p.n_sl;
    p.n_sl += ns;
    p.s_max = std::max(p.s_max, ns);
    for (int s = 0; s < ns; ++s) {
      const Slice sl = slice_of(tb, c, s * us, std::min(us, fan - s * us));
      p.xs_max = std::max(p.xs_max, sl.xs);
      p.nc_max = std::max(p.nc_max, sl.nc);
    }
    // as the kernel's weight product splits its depth
    const int n_m = (mul + 15) / 16, n_n = kWarps * d3 / 8;
    const int parts = n_n <= kMaxWN && n_m <= kWarps ? kWarps / n_m : 1;
    const long long nstride = static_cast<long long>(kWarps) * d3 + 8;
    wp_need = std::max(wp_need, hr * static_cast<long long>(us) * nstride +
                                    static_cast<long long>(parts) * n_m * 16 * nstride);
  }
  const long long warp_floats = static_cast<long long>(kStages) * kKC * (hr + 8 + J + p.xs_max) +
                                kKC * kBStride + kKC * p.nc_max;
  const long long ring = kWarps * warp_floats + 4LL * kSliceCols + 4LL * p.nc_max + kMaxXp +
                         static_cast<long long>(cg_rows) * p.nc_max;
  p.smem_floats = std::max(ring, wp_need);
  if (p.smem_floats * 4 > kMaxSmemBytes) return p;
  p.mt = mt;
  return p;
}

// plan_out: n_groups, s_max, n_sl, xs_max, nc_max, hidden rows, then us
// and n_slices of each class (6 + 2*kMaxClasses ints)
void write_plan(const Plan& p, const Tables& tb, int* plan_out) {
  plan_out[0] = p.n_groups;
  plan_out[1] = p.s_max;
  plan_out[2] = p.n_sl;
  plan_out[3] = p.xs_max;
  plan_out[4] = p.nc_max;
  plan_out[5] = 16 * p.mt;
  for (int c = 0; c < tb.n_classes; ++c) {
    plan_out[6 + c] = tb.us[c];
    plan_out[6 + kMaxClasses + c] = tb.n_slices[c];
  }
}

long long scratch_floats(const Plan& p, long long n_rows, int D) {
  const long long n_parts = static_cast<long long>(p.n_groups) * p.s_max;
  return n_parts == 1 ? 0 : n_parts * n_rows * D;
}

template <int MT, bool kGen1>
cudaError_t launch_mt(const Operands& op, float* out, float* scratch, const Tables& tb,
                      const Dims& dm, const Plan& plan, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(plan.smem_floats);
  cudaError_t err = cudaFuncSetAttribute(factored_tp_kernel<MT, kGen1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_tiles = (dm.n_rows + kWarps - 1) / kWarps;
  const long long n_blocks = n_tiles * plan.n_sl * plan.n_groups;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool direct = plan.n_groups * plan.s_max == 1;
  factored_tp_kernel<MT, kGen1><<<static_cast<unsigned>(n_blocks), kThreads, smem, stream>>>(
      op, direct ? out : scratch, tb, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  const long long total = dm.n_rows * dm.D;
  const long long blocks = std::min<long long>((total + 255) / 256, 32LL * sm_count());
  factored_tp_reduce<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(scratch, out, tb,
                                                                        dm.n_rows, dm.D,
                                                                        plan.n_groups);
  return cudaGetLastError();
}

// Plans and launches one call; the tables must have passed tables_ok.
template <bool kGen1>
cudaError_t launch(const Operands& op, float* out, float* scratch, Tables tb, Dims dm,
                   cudaStream_t stream) {
  const Plan plan = make_plan(tb, dm.Ha, dm.J, dm.cg_rows);
  if (plan.mt == 0) return cudaErrorInvalidValue;
  if (dm.n_rows == 0) return cudaSuccess;
  dm.n_groups = plan.n_groups;
  dm.n_sl = plan.n_sl;
  dm.s_max = plan.s_max;
  dm.xs_max = plan.xs_max;
  dm.nc_max = plan.nc_max;
  switch (plan.mt) {
    case 1: return launch_mt<1, kGen1>(op, out, scratch, tb, dm, plan, stream);
    case 2: return launch_mt<2, kGen1>(op, out, scratch, tb, dm, plan, stream);
    case 3: return launch_mt<3, kGen1>(op, out, scratch, tb, dm, plan, stream);
    case 4: return launch_mt<4, kGen1>(op, out, scratch, tb, dm, plan, stream);
    default: return launch_mt<5, kGen1>(op, out, scratch, tb, dm, plan, stream);
  }
}

}  // namespace
