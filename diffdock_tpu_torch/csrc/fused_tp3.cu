// Gen-3 fused factored tensor-product contraction on Hopper's tensor cores,
// float32 operands, the Clebsch-Gordan coupling built inside the kernel.
//
// Replaces diffdock_tpu/ops/pallas_tpconv3.py:_forward_pallas: the body
// (_kernel) and the coupled tensor and weight blocks its wrapper builds.
// Per receiver row r, output class c (fan, d3, mul) and path p of c (an
// input entry of d1 components from x_p, a harmonic entry of d2 components
// from sh_p, the path's u from u_p):
//
//     W_p[k, i*d3+d] = sum_{t < d2} sh[r, k, sh_p + t] * CG_p[t, i*d3+d]
//     C[k, u*d3+d]   = sum_i x[r, k, x_p + (u - u_p)*d1 + i] * W_p[k, i*d3+d]
//     P[h, u*d3+d]   = sum_k A[r, k, h] * C[k, u*d3+d]
//     out[r, o_c + w*d3+d] = sum_h sum_u P[h, u*d3+d] * s_c*T_c[h, u, w]
//
// A is the edge MLP's hidden activations h (N, K, H), already scaled by
// mask*edge_weight, with mw (N, K) = mask*edge_weight as row H; T_c[h, u,
// w] is out_kernel[h, w_c + u*mul + w] for h < H and out_bias[w_c + u*mul +
// w] for h = H (the class's columns of the edge MLP's last layer, as the
// parameters hold them); s_c = 1/sqrt(fan) in float32, multiplied into
// each weight as it is read. Every operand is read where the caller has
// it: x_nbr (e3nn layout), edge_sh, h and mw through their row strides
// (the last axis contiguous), the CG blocks of every path from one small
// (max d2, columns) matrix uploaded once per tensor product. The output is
// the e3nn layout, with zeros in output classes that have no path.
//
// What bounds it on an H100: operations. The two products (P: M = hidden
// rows, N = one class's columns, depth = neighbours; the weight product:
// M = w, N = (receiver, d), depth = (u, h)) run on the tensor cores as
// mma.sync m16n8k8 TF32 in 3xTF32 (tp_mma.cuh): each float32 operand split
// into a TF32 head (rounded to nearest) and a TF32 remainder, rem*head +
// head*rem + head*head accumulated in float32, float32 accuracy at 165
// TFLOP/s. The coupling (CG weights, then d1 FMAs per coupled column) is a
// few per cent of P's FLOPs on the CUDA cores in float32, and it is rebuilt
// for every hidden-row group, so the design keeps the groups few:
//   - a block owns 16 receivers (one warp each), one slice of one class's
//     columns (whole u groups, at most 24 columns, at most xp_cap input
//     floats, 64 CG-weight columns and 32 harmonics per neighbour) and one
//     group of hidden rows: the fewest groups of at most 80 rows (5 m16
//     tiles), balanced, so H+1 = 145 and 97 take 2 groups and 73 one. Each
//     warp keeps its receiver's P tile (up to 80 x 24) in registers over
//     all neighbours; each T_c fragment of the weight product feeds the
//     block's 16 receivers. A warp of 32 x 64 (the shape of this kernel
//     before it built the coupling) would rebuild it 5 times at H+1 = 145,
//     and such a warp took 1.3-2.1x as long as these tall, narrow tiles
//     (measured on gen 2's kernel, factored_tp.cuh, whose design this is);
//   - the coupling is built by the warp that multiplies it, per stage of 8
//     neighbours: its hidden rows, the slice's window of harmonics and the
//     slice's input floats arrive through a 2-stage cp.async ring (no block
//     barrier in the neighbour loop); the warp computes the stage's CG
//     weights, then the coupled columns straight into its B tile, in the
//     row stride (40) the fragment reads want, 8 neighbours side by side
//     in each lane;
//   - the slice's geometry (which paths it touches, where each coupled
//     column reads its inputs and CG weights, which floats of a neighbour's
//     row each stage copies) is worked out once per block into shared
//     tables, from the class and path tables the call passes by value;
//   - the partial sums of the weight product's depth split, and of the
//     groups and slices, are added in a fixed order (in shared memory, and
//     in a second small kernel over a scratch buffer): two launches give
//     the same bits. Nothing is split with atomics.
//
// The bfloat16 operand mode is a kernel of its own, designed for Hopper's
// TMA and wgmma: fused_tp3_bf16.cu. Plain C interface (no PyTorch
// headers), built with nvcc into a shared library and called through
// ctypes; see diffdock_tpu_torch/ops/fused_tp3.py, whose tile_plan mirrors
// make_plan below.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "tp_mma.cuh"

namespace {

using namespace tp_mma;

constexpr int kMaxClasses = 16;
constexpr int kMaxPaths = 64;
constexpr int kWarps = 16;                 // receivers per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kNT = 3;                     // n8 tiles of P per warp: 24 columns
constexpr int kSliceCols = kNT * 8;
constexpr int kMaxMT = 5;                  // m16 tiles of P per warp: up to 80 hidden rows
constexpr int kKC = 8;                     // neighbours per pipeline stage
constexpr int kStages = 2;
constexpr int kBStride = kSliceCols + 16;  // 40: conflict-free fragment reads
constexpr int kMaxWN = 6;                  // weight-product n8 tiles per warp
constexpr int kPrefetch = 8;               // weight-product depth steps in flight
constexpr int kMaxOutputs = 256;           // mul*d3 of one class
constexpr int kMaxColumns = 4096;          // fan*d3 of one class
constexpr int kMaxXp = 96;                 // input floats per neighbour of a slice (cap)
constexpr int kMaxW = 64;                  // CG-weight columns of a slice
constexpr int kMaxSh = 32;                 // harmonics a slice stages per neighbour
constexpr int kMaxCgRows = 16;             // rows of the CG matrix (the largest d2)
constexpr int kMaxSmemBytes = 232448;
// the block's shared tables at their largest: colinfo, wcol, xmap, cg_s
constexpr int kTableFloats = 4 * kSliceCols + 2 * kMaxW + kMaxXp + kMaxCgRows * kMaxW;

// The most input floats per neighbour a slice may take with hr hidden rows
// and sh staged harmonics: kMaxXp, or what each warp's share of shared
// memory holds beside its ring's hidden rows and harmonics, its B tile and
// kMaxW CG-weight columns.
inline int xp_cap(int hr, int sh) {
  const int per_warp = (kMaxSmemBytes / 4 - kTableFloats) / kWarps;
  const int room = per_warp - kKC * kBStride - kKC * kMaxW - kStages * kKC * (hr + 8 + sh);
  const int cap = room / (kStages * kKC);
  return cap < kMaxXp ? cap : kMaxXp;
}

// The class and path tables of one tensor product. Every output class is
// a row, those without a path too (fan 0: zeros). Path columns are
// relative to their class: u_off into its fan, col into its CG columns
// (from col0).
struct Tables {
  int n_classes, n_paths;
  int fan[kMaxClasses], d3[kMaxClasses], mul[kMaxClasses], out_off[kMaxClasses];
  int w_off[kMaxClasses];  // the class's first column of out_kernel and out_bias
  int col0[kMaxClasses], path0[kMaxClasses], np[kMaxClasses];
  float scale[kMaxClasses];  // 1/sqrt(fan) in float32
  int us[kMaxClasses];       // u per column slice
  int n_slices[kMaxClasses];
  int slice_base[kMaxClasses];  // slices of the classes before this one
  int u_off[kMaxPaths], pmul[kMaxPaths], d1[kMaxPaths], x_start[kMaxPaths];
  int col[kMaxPaths], sh_start[kMaxPaths], d2[kMaxPaths];
};

// Every operand is float32; x, sh and h are (N, K, width) and mw (N, K),
// each with a contiguous last axis and the given row strides.
struct Operands {
  const float* x;       // x_nbr (N, K, X)
  const float* sh;      // edge_sh (N, K, J)
  const float* h;       // (N, K, H)
  const float* mw;      // (N, K)
  const float* cg;      // (cg_rows, cg_cols)
  const float* kernel;  // out_kernel (H, WN)
  const float* bias;    // out_bias (WN)
  long long x_n, x_k, sh_n, sh_k, h_n, h_k, mw_n, mw_k;
};

struct Dims {
  long long n_rows;
  int K, X, J, H, WN, cg_rows, cg_cols, D;
  int n_groups, n_sl, s_max, xs_max, nc_max, sh_max;
};

// The paths pa..pb of class c that a slice [u0, u0 + nu) touches, its
// input floats per neighbour (xs), its CG-weight columns (nc, from column
// cw0 of the class) and its window of harmonics (nsh from sh0). Path p of
// the slice covers u in [max(u0, u_off), min(u0 + nu, u_off + mul)); its
// inputs are a contiguous run of a neighbour's row, staged after those of
// the paths before it.
struct Slice {
  int pa, pb, xs, cw0, nc, sh0, nsh;
};

__host__ __device__ inline Slice slice_of(const Tables& tb, int c, int u0, int nu) {
  Slice sl;
  const int pend = tb.path0[c] + tb.np[c];
  int p = tb.path0[c];
  while (tb.u_off[p] + tb.pmul[p] <= u0) ++p;
  sl.pa = p;
  sl.xs = 0;
  int lo = 1 << 30, hi = 0;
  for (; p < pend && tb.u_off[p] < u0 + nu; ++p) {
    const int ua = u0 > tb.u_off[p] ? u0 : tb.u_off[p];
    const int ub = u0 + nu < tb.u_off[p] + tb.pmul[p] ? u0 + nu : tb.u_off[p] + tb.pmul[p];
    sl.xs += tb.d1[p] * (ub - ua);
    lo = tb.sh_start[p] < lo ? tb.sh_start[p] : lo;
    hi = tb.sh_start[p] + tb.d2[p] > hi ? tb.sh_start[p] + tb.d2[p] : hi;
  }
  sl.pb = p - 1;
  sl.cw0 = tb.col[sl.pa];
  sl.nc = tb.col[sl.pb] + tb.d1[sl.pb] * tb.d3[c] - sl.cw0;
  sl.sh0 = lo;
  sl.nsh = hi - lo;
  return sl;
}

// ---- the kernel ---------------------------------------------------------

// MT: m16 tiles of hidden rows per block (1-5: the hidden rows in the
// fewest groups of at most 80, balanced)
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
fused_tp3_kernel(Operands op, float* __restrict__ dst, Tables tb, Dims dm) {
  constexpr int HR = MT * 16;          // hidden rows per block
  constexpr int AStride = HR + 8;      // 8 or 24 mod 32: conflict-free fragment reads
  const int K = dm.K, xs_s = dm.xs_max, nc_s = dm.nc_max, sh_s = dm.sh_max;
  const int stage_floats = kKC * (AStride + sh_s + xs_s);
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
  int c = 0;  // classes without a path have no slices: skipped here
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
  // colinfo[j]: coupled column j reads its d1 inputs at x + i of a stage
  //   row and its CG weights at w + i*d3 (x, w, d1);
  // wcol[cc]: CG-weight column cc sums sh[t0 + t] * cg[t][cc] for t < n
  //   (t0 in the slice's window of harmonics, n);
  // xmap[e]: the staged input float e, as an offset into a neighbour's row
  //   of x_nbr; cg_s: the slice's CG columns
  int4* colinfo = reinterpret_cast<int4*>(smem + kWarps * warp_floats);  // [24]
  int2* wcol = reinterpret_cast<int2*>(colinfo + kSliceCols);             // [nc_s]
  int* xmap = reinterpret_cast<int*>(wcol + nc_s);                        // [kMaxXp]
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
          ci = make_int4(base + (u - ua) * tb.d1[p], tb.col[p] - sl.cw0 + d, tb.d1[p], 0);
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
    wcol[cc] = make_int2(tb.sh_start[p] - sl.sh0, tb.d2[p]);
  }
  for (int e = tid; e < sl.xs; e += kThreads) {
    int base = 0;
    for (int p = sl.pa; p <= sl.pb; ++p) {
      const int ua = max(u0, tb.u_off[p]);
      const int n = tb.d1[p] * (min(u0 + nu, tb.u_off[p] + tb.pmul[p]) - ua);
      if (e < base + n) {
        xmap[e] = tb.x_start[p] + (ua - tb.u_off[p]) * tb.d1[p] + e - base;
        break;
      }
      base += n;
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
  const int n_steps = (K + kKC - 1) / kKC;

  // stage `st` of the ring <- neighbours [kc*8, kc*8+8): the hidden rows
  // (A, k-major; row H from mw, rows past it zero), the slice's window of
  // harmonics and its input floats
  auto load_stage = [&](int kc, int st) {
    float* as = ring + st * stage_floats;
    float* shs = as + kKC * AStride;
    float* xs = shs + kKC * sh_s;
    const int k0 = kc * kKC;
    const int n_k = row_ok ? min(kKC, K - k0) : 0;  // live neighbours of the stage
#pragma unroll 1
    for (int ha = lane; ha < HR; ha += 32) {
      // consecutive lanes read consecutive hidden rows, each lane its row
      // for the 8 neighbours
      const int hh = h0 + ha;
      const bool h_ok = hh <= dm.H;
      const float* src = hh < dm.H ? op.h + rr * op.h_n + k0 * op.h_k + hh
                                   : op.mw + rr * op.mw_n + k0 * op.mw_k;
      const long long step = hh < dm.H ? op.h_k : op.mw_k;
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk, src += step) {
        const bool ok = h_ok && kk < n_k;
        cp_async4(as + kk * AStride + ha, ok ? src : op.h, ok);
      }
    }
    const float* sh_row = op.sh + rr * op.sh_n + k0 * op.sh_k + sl.sh0;
    for (int e = lane; e < kKC * sl.nsh; e += 32) {
      const int kk = e / sl.nsh, t = e - kk * sl.nsh;
      const bool ok = kk < n_k;
      cp_async4(shs + kk * sh_s + t, ok ? sh_row + kk * op.sh_k + t : op.sh, ok);
    }
    // each input float's 8 neighbours, one row stride apart
    const float* x_row = op.x + rr * op.x_n + k0 * op.x_k;
    for (int e = lane; e < sl.xs; e += 32) {
      const float* src = x_row + xmap[e];
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk, src += op.x_k) {
        const bool ok = kk < n_k;
        cp_async4(xs + kk * xs_s + e, ok ? src : op.x, ok);
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
    const float* xs = shs + kKC * sh_s;

    // CG weights: ws[kk][cc] = sum_t sh[kk][t0 + t] * cg[t][cc], a chain of
    // fused multiply-adds from t = 0; lane cc (and cc + 32) sums the 8
    // neighbours side by side
    for (int cc = lane; cc < nc; cc += 32) {
      const int2 wc = wcol[cc];
      float v[kKC];
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) v[kk] = 0.f;
      for (int t = 0; t < wc.y; ++t) {
        const float gv = cg_s[t * nc_s + cc];
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk) v[kk] = fmaf(shs[kk * sh_s + wc.x + t], gv, v[kk]);
      }
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) ws[kk * nc_s + cc] = v[kk];
    }
    __syncwarp();

    // coupled columns into the B tile: bs[kk][j] = sum_i x[kk][xo + i] *
    // ws[kk][wo + i*d3]; lane j (zero past the slice), the 8 neighbours
    // side by side. Each product is rounded, then added (no fused
    // multiply-add), in the order i = 0, 1, ...: the arithmetic of the plain
    // version's chain (tensor_product.py:coupled_class_merged)
    if (lane < nt_used * 8) {
      const int4 ci = colinfo[lane];
      float v[kKC];
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) v[kk] = 0.f;
      for (int i = 0; i < ci.z; ++i) {
        const float* xr = xs + ci.x + i;
        const float* wr = ws + ci.y + i * d3;
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk)
          v[kk] = __fadd_rn(v[kk], __fmul_rn(xr[kk * xs_s], wr[kk * nc_s]));
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

  // ---- weight product: O[w][t*d3+d] = sum_(u,h) s_c*T_c[h0+hh, u0+uu, w] * ps
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

  // the weight row of depth row k = uu*HR + hh: out_kernel's row for a
  // hidden row, out_bias for row H, null past it
  const long long w_col = tb.w_off[c] + static_cast<long long>(u0) * mul;
  auto w_row = [&](int k) -> const float* {
    const int hh = h0 + k % HR;
    const long long col = w_col + static_cast<long long>(k / HR) * mul;
    if (hh < dm.H) return op.kernel + static_cast<long long>(hh) * dm.WN + col;
    return hh == dm.H ? op.bias + col : nullptr;
  };
  const float scale = tb.scale[c];
  auto ld_w = [scale](const float* row, int w) { return __ldg(row + w) * scale; };

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

  // ---- sum the depth parts in order and store ----------------------------
  // one part (one group, one slice) writes `out`; else scratch part
  // (s * n_groups + g), summed by fused_tp3_reduce
  const bool direct = dm.n_groups * dm.s_max == 1;
  float* base =
      direct ? dst : dst + (static_cast<long long>(s) * dm.n_groups + g) * dm.n_rows * dm.D;
  const int wd = mul * d3;
  for (int e = tid; e < kWarps * wd; e += kThreads) {
    // consecutive threads: consecutive outputs (w, d) of one receiver t
    const int t = e / wd, o = e - t * wd;
    const int w = o / d3, n = t * d3 + o - w * d3;
    float sum = 0.f;
    for (int p = 0; p < parts; ++p) sum += red[(p * n_m * 16 + w) * nstride + n];
    const long long ro = r0 + t;
    if (ro < dm.n_rows) base[ro * dm.D + tb.out_off[c] + o] = sum;
  }
  // writing `out` directly, the tile's first block also writes the zeros
  // of the classes without a path (else fused_tp3_reduce does)
  if (direct && sl_id == 0) {
    for (int ce = 0; ce < tb.n_classes; ++ce) {
      if (tb.fan[ce] > 0) continue;
      const int we = tb.mul[ce] * tb.d3[ce];
      for (int e = tid; e < kWarps * we; e += kThreads) {
        const int t = e / we;
        const long long ro = r0 + t;
        if (ro < dm.n_rows) dst[ro * dm.D + tb.out_off[ce] + e - t * we] = 0.f;
      }
    }
  }
}

// out[r, col] = sum over the class's slices s and the groups g, in order
// (zero for a class without a path)
__global__ void fused_tp3_reduce(const float* __restrict__ parts, float* __restrict__ out,
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

// class_rows: n_classes rows of 8 int32 (fan, d3, mul, out_off, w_off,
// col0, path0, n_paths); path_rows: n_paths rows of 7 int32 (u_off, mul,
// d1, x_start, col, sh_start, d2)
bool read_tables(const int* class_rows, int n_classes, const int* path_rows, int n_paths,
                 Tables& tb) {
  if (n_classes < 1 || n_classes > kMaxClasses || n_paths < 1 || n_paths > kMaxPaths)
    return false;
  tb = Tables{};
  tb.n_classes = n_classes;
  tb.n_paths = n_paths;
  for (int c = 0; c < n_classes; ++c) {
    const int* row = class_rows + 8 * c;
    tb.fan[c] = row[0];
    tb.d3[c] = row[1];
    tb.mul[c] = row[2];
    tb.out_off[c] = row[3];
    tb.w_off[c] = row[4];
    tb.col0[c] = row[5];
    tb.path0[c] = row[6];
    tb.np[c] = row[7];
    tb.scale[c] = row[0] > 0 ? static_cast<float>(1.0 / std::sqrt(static_cast<double>(row[0]))) : 0.f;
  }
  for (int p = 0; p < n_paths; ++p) {
    const int* row = path_rows + 7 * p;
    tb.u_off[p] = row[0];
    tb.pmul[p] = row[1];
    tb.d1[p] = row[2];
    tb.x_start[p] = row[3];
    tb.col[p] = row[4];
    tb.sh_start[p] = row[5];
    tb.d2[p] = row[6];
  }
  return true;
}

// The tables are consistent and every read they imply lies inside its
// operand: classes follow each other in `out` and in the weights' columns,
// paths tile their class's u and CG columns in order, input runs lie
// inside X, harmonics inside J, CG blocks inside the CG matrix; at least
// one class has a path.
bool tables_ok(const Tables& tb, int X, int J, int cg_rows, int cg_cols, int D, int WN) {
  if (J < 1 || cg_rows < 1 || cg_rows > kMaxCgRows) return false;
  int out_end = 0, w_end = 0, live = 0;
  for (int c = 0; c < tb.n_classes; ++c) {
    const int fan = tb.fan[c], d3 = tb.d3[c], mul = tb.mul[c];
    if (fan < 0 || d3 < 1 || d3 > kSliceCols || mul < 1 || mul * d3 > kMaxOutputs ||
        fan * d3 > kMaxColumns || tb.out_off[c] != out_end || tb.w_off[c] != w_end)
      return false;
    out_end += mul * d3;
    w_end += fan * mul;
    if (fan == 0) {
      if (tb.np[c] != 0) return false;
      continue;
    }
    ++live;
    if (tb.np[c] < 1 || tb.path0[c] < 0 || tb.path0[c] + tb.np[c] > tb.n_paths || tb.col0[c] < 0)
      return false;
    int u = 0, col = 0;
    for (int p = tb.path0[c]; p < tb.path0[c] + tb.np[c]; ++p) {
      const int d1 = tb.d1[p];
      if (tb.u_off[p] != u || tb.pmul[p] < 1 || tb.col[p] != col || d1 < 1 || d1 > kMaxXp ||
          d1 * d3 > kMaxW || tb.x_start[p] < 0 || tb.x_start[p] + d1 * tb.pmul[p] > X ||
          tb.col0[c] + col + d1 * d3 > cg_cols || tb.d2[p] < 1 || tb.d2[p] > cg_rows ||
          tb.sh_start[p] < 0 || tb.sh_start[p] + tb.d2[p] > J)
        return false;
      u += tb.pmul[p];
      col += d1 * d3;
    }
    if (u != fan) return false;
  }
  return live > 0 && out_end == D && w_end == WN;
}

struct Plan {
  int mt;        // m16 tiles of hidden rows per block (0: refused)
  int n_groups;  // hidden-row groups
  int s_max;     // most column slices of a class
  int n_sl;      // column slices of all classes
  int xs_max;    // most input floats per neighbour of a slice
  int nc_max;    // most CG-weight columns of a slice
  int sh_max;    // most harmonics per neighbour of a slice
  long long smem_floats;
};

// Fills the slice columns of `tb` and returns the launch plan: the hidden
// rows in the fewest groups of at most 80 (m16 tiles, balanced), per class
// the fewest slices of at most 24 columns, balanced, that keep every slice
// within xp_cap input floats, kMaxW CG-weight columns and kMaxSh harmonics
// (which keeps the block's shared memory within the card's).
Plan make_plan(Tables& tb, int Ha, int J, int cg_rows) {
  Plan p = {};
  p.n_groups = (Ha + 16 * kMaxMT - 1) / (16 * kMaxMT);
  const int mt = (Ha + 16 * p.n_groups - 1) / (16 * p.n_groups);
  const int hr = 16 * mt;
  long long wp_need = 0;
  const int cap = xp_cap(hr, std::min(J, kMaxSh));
  for (int c = 0; c < tb.n_classes; ++c) {
    const int fan = tb.fan[c], d3 = tb.d3[c], mul = tb.mul[c];
    tb.slice_base[c] = p.n_sl;
    if (fan == 0) continue;
    int n = (fan + kSliceCols / d3 - 1) / (kSliceCols / d3);
    int us = 0, ns = 0;
    for (;; ++n) {
      us = (fan + n - 1) / n;
      ns = (fan + us - 1) / us;
      bool fits = true;
      for (int s = 0; s < ns && fits; ++s) {
        const Slice sl = slice_of(tb, c, s * us, std::min(us, fan - s * us));
        fits = sl.xs <= cap && sl.nc <= kMaxW && sl.nsh <= kMaxSh;
      }
      if (fits) break;
      if (us == 1) return p;  // mt = 0: one u alone does not fit
    }
    tb.us[c] = us;
    tb.n_slices[c] = ns;
    p.n_sl += ns;
    p.s_max = std::max(p.s_max, ns);
    for (int s = 0; s < ns; ++s) {
      const Slice sl = slice_of(tb, c, s * us, std::min(us, fan - s * us));
      p.xs_max = std::max(p.xs_max, sl.xs);
      p.nc_max = std::max(p.nc_max, sl.nc);
      p.sh_max = std::max(p.sh_max, sl.nsh);
    }
    // as the kernel's weight product splits its depth
    const int n_m = (mul + 15) / 16, n_n = kWarps * d3 / 8;
    const int parts = n_n <= kMaxWN && n_m <= kWarps ? kWarps / n_m : 1;
    const long long nstride = static_cast<long long>(kWarps) * d3 + 8;
    wp_need = std::max(wp_need, hr * static_cast<long long>(us) * nstride +
                                    static_cast<long long>(parts) * n_m * 16 * nstride);
  }
  const long long warp_floats =
      static_cast<long long>(kStages) * kKC * (hr + 8 + p.sh_max + p.xs_max) + kKC * kBStride +
      kKC * p.nc_max;
  const long long ring = kWarps * warp_floats + 4LL * kSliceCols + 2LL * p.nc_max + kMaxXp +
                         static_cast<long long>(cg_rows) * p.nc_max;
  p.smem_floats = std::max(ring, wp_need);
  if (p.n_sl == 0 || p.smem_floats * 4 > kMaxSmemBytes) return p;
  p.mt = mt;
  return p;
}

long long scratch_floats(const Plan& p, long long n_rows, int D) {
  const long long n_parts = static_cast<long long>(p.n_groups) * p.s_max;
  return n_parts == 1 ? 0 : n_parts * n_rows * D;
}

template <int MT>
cudaError_t launch_mt(const Operands& op, float* out, float* scratch, const Tables& tb,
                      const Dims& dm, const Plan& plan, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(plan.smem_floats);
  cudaError_t err = cudaFuncSetAttribute(fused_tp3_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_tiles = (dm.n_rows + kWarps - 1) / kWarps;
  const long long n_blocks = n_tiles * plan.n_sl * plan.n_groups;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool direct = plan.n_groups * plan.s_max == 1;
  fused_tp3_kernel<MT><<<static_cast<unsigned>(n_blocks), kThreads, smem, stream>>>(
      op, direct ? out : scratch, tb, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  const long long total = dm.n_rows * dm.D;
  const long long blocks = std::min<long long>((total + 255) / 256, 32LL * sm_count());
  fused_tp3_reduce<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(scratch, out, tb,
                                                                      dm.n_rows, dm.D,
                                                                      plan.n_groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_tp3_max_classes() { return kMaxClasses; }
int fused_tp3_max_paths() { return kMaxPaths; }
// the widest class a block takes: mul*d3 outputs, fan*d3 coupled columns
int fused_tp3_max_outputs() { return kMaxOutputs; }
int fused_tp3_max_columns() { return kMaxColumns; }

// The launch plan into plan_out (8 + 2*kMaxClasses ints: n_groups, s_max,
// n_sl, xs_max, nc_max, sh_max, hidden rows per group, shared memory
// floats, then us and n_slices of each class); returns the floats of
// scratch the call needs (0 when the kernel writes `out` directly), or -1
// if the tables or H are refused.
long long fused_tp3_plan(const int* class_rows, int n_classes, const int* path_rows, int n_paths,
                         long long n_rows, int X, int J, int H, int cg_rows, int cg_cols, int D,
                         int WN, int* plan_out) {
  Tables tb;
  if (!read_tables(class_rows, n_classes, path_rows, n_paths, tb) || H < 1 ||
      !tables_ok(tb, X, J, cg_rows, cg_cols, D, WN))
    return -1;
  const Plan plan = make_plan(tb, H + 1, J, cg_rows);
  if (plan.mt == 0) return -1;
  const int head[8] = {plan.n_groups, plan.s_max, plan.n_sl, plan.xs_max, plan.nc_max,
                       plan.sh_max, 16 * plan.mt, static_cast<int>(plan.smem_floats)};
  for (int i = 0; i < 8; ++i) plan_out[i] = head[i];
  for (int c = 0; c < kMaxClasses; ++c) {
    plan_out[8 + c] = c < n_classes ? tb.us[c] : 0;
    plan_out[8 + kMaxClasses + c] = c < n_classes ? tb.n_slices[c] : 0;
  }
  return scratch_floats(plan, n_rows, D);
}

// x_n ... mw_k: the row strides (N, K) of x, sh, h and mw, in elements;
// scratch: the floats fused_tp3_plan asks for. Returns a cudaError_t.
int fused_tp3_forward(const float* x, const float* sh, const float* h, const float* mw,
                      const float* cg, const float* kernel, const float* bias, float* out,
                      float* scratch, long long x_n, long long x_k, long long sh_n,
                      long long sh_k, long long h_n, long long h_k, long long mw_n,
                      long long mw_k, const int* class_rows,
                      int n_classes, const int* path_rows, int n_paths, long long n_rows, int K,
                      int X, int J, int H, int cg_rows, int cg_cols, int D, int WN,
                      void* stream) {
  Tables tb;
  if (!read_tables(class_rows, n_classes, path_rows, n_paths, tb) || K < 1 || H < 1 ||
      !tables_ok(tb, X, J, cg_rows, cg_cols, D, WN))
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(tb, H + 1, J, cg_rows);
  if (plan.mt == 0) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const Operands op = {x, sh, h, mw, cg, kernel, bias, x_n, x_k, sh_n, sh_k, h_n, h_k, mw_n, mw_k};
  Dims dm = {};
  dm.n_rows = n_rows;
  dm.K = K;
  dm.X = X;
  dm.J = J;
  dm.H = H;
  dm.WN = WN;
  dm.cg_rows = cg_rows;
  dm.cg_cols = cg_cols;
  dm.D = D;
  dm.n_groups = plan.n_groups;
  dm.n_sl = plan.n_sl;
  dm.s_max = plan.s_max;
  dm.xs_max = plan.xs_max;
  dm.nc_max = plan.nc_max;
  dm.sh_max = plan.sh_max;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (plan.mt) {
    case 1: return launch_mt<1>(op, out, scratch, tb, dm, plan, s);
    case 2: return launch_mt<2>(op, out, scratch, tb, dm, plan, s);
    case 3: return launch_mt<3>(op, out, scratch, tb, dm, plan, s);
    case 4: return launch_mt<4>(op, out, scratch, tb, dm, plan, s);
    default: return launch_mt<5>(op, out, scratch, tb, dm, plan, s);
  }
}

}  // extern "C"
