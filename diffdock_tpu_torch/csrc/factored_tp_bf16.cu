// Gen-2 and gen-1 factored tensor-product contraction in bfloat16, for
// Hopper, with the Clebsch-Gordan coupling built on the chip.
//
// Replaces the bfloat16 operand modes of diffdock_tpu/ops/pallas_tpconv2.py:
// _forward_pallas (:212, `dt` :219, call :266, body `_kernel` :125) and of
// diffdock_tpu/ops/pallas_tpconv.py:factored_tp_messages_pallas (:201, casts
// :140-198, call :262, body `_kernel` :118). Per receiver row r and output
// class c (fan, d3, mul), for each path p of c (input entry i_p, harmonic
// entry j_p, d1 = dim i_p, d2 = dim j_p):
//
//     W_p[k, i*d3+d] = bf16( sum_{t < d2} sh[r, k, sh_p + t] * CG_p[t, i*d3+d] )
//     C[k, u*d3+d]   = x[r, k, x_p + u*d1 + 0] * W_p[k, d] + ... + x[.. + d1-1] * W_p[k, (d1-1)*d3+d]
//     P[h, u*d3+d]   = bf16( sum_k h[r, k, h] * C[k, u*d3+d] ),  h < H; row H from mw
//     out[r, o_c + w*d3+d] = ( sum_h sum_u P[h, u*d3+d] * T_c[h, u, w] ) / sqrt(fan)
//
// with the Pallas bodies' rounding points: the CG weights summed in float32
// and rounded to bfloat16; the chain C in bfloat16 arithmetic, each product
// and each partial sum rounded, in the order i = 0, 1, ...; gen 1 leaves the
// chain's last step in float32 where a class has one path and d3 = 1
// (chain_f32, as XLA runs its Pallas body); P summed in float32 over all
// neighbours and rounded once; the weight product on the unscaled bfloat16
// weights (T_c with the bias b_c as row H) summed in float32, 1/sqrt(fan)
// applied to the float32 result. x is x_nbr in its own e3nn layout (no
// packed copy per path), sh the edge harmonics (bfloat16, or float32 in gen
// 1's mixed case), h and mw the edge MLP's hidden rows (bfloat16; gen 1's
// float32 h and mw arrive as three bfloat16 parts each, whose sum is exact,
// each multiplied, summed in float32).
//
// What bounds it on an H100 (chip_smoke.py:factored_bf16_work): operations
// and bytes by turns, both far below what the kernel takes. At the score
// model's rec<-lig block (3200 receivers, K = 32, H+1 = 145, 432 coupled
// columns) the products are 18.9 GFLOP (0.019 ms at 989 TFLOP/s) and the
// coupling 0.2 GFLOP, against 58 MB that must be read (x_nbr, sh, h, mw once,
// 2 bytes each; 0.017 ms); at the confidence model's lig<-atom block (320
// receivers, K = 2560) 272 MB bound it (0.081 ms). The coupled operand, 432
// columns per edge where x_nbr has 118, is never written to memory. The
// design, point by point (the neighbour product and the weight product are
// those of fused_tp3_bf16.cu, whose coupled operand comes from HBM):
//   - TMA: a ring of stages in shared memory, each a box of one receiver's
//     KC neighbours of [sh | x] (one row per neighbour, as the wrapper packs
//     it: sh in 16 columns, or a float32 sh's three bfloat16 parts in 48,
//     then x_nbr, zeros to a multiple of 8),
//     ceil(H/64) boxes of h with the 128-byte swizzle (plus those of h's lo
//     part) and a box of KC mw values (plus mw's lo part). Each slot has a
//     producer thread of its own, in its own warp (a TMA issue holds its
//     thread long, whatever its size); completion is counted by mbarriers;
//     zeros arrive past K and past the last receiver;
//   - the coupling is built once per (receiver, neighbour, coupled column),
//     by the consumer warpgroup that multiplies it: a slice is up to 64
//     coupled columns of whole u groups of one class; per stage the
//     warpgroup computes the slice's CG weights for the KC neighbours (each
//     CG-weight column of a touched path: its d2 harmonics against its CG
//     column, as one mma.sync product of the harmonics by the slice's CG
//     matrix made dense over the 16 harmonics, float32 sums rounded to
//     bfloat16; gen 1's float32 sh in float32 on the CUDA cores), then the
//     coupled columns,
//     two neighbours at a time in packed bfloat16x2 arithmetic (fma.rn with
//     a zero or a unit term: one rounding per product and per sum), straight
//     into the 128-byte-swizzled, MN-major tile that the wgmma A descriptor
//     reads, then fence.proxy.async; the stage goes back to the producers as
//     soon as its products are done (a warpgroup that kept it through the
//     next stage's coupling, to overlap that coupling with the products,
//     left the ring no free slot to prefetch into: measured slower);
//   - the neighbour product on wgmma m64nNk16: M = 64 coupled columns, N =
//     all hidden rows in one product (32, 72 or 144: H <= 144) plus an m64n8k16
//     product for the bias row from mw, depth = neighbours. A chain_f32
//     column adds a lo tile and a product, each further part of h and mw one;
//   - blocks: R receivers (even, up to 16) and every slice, or, with fewer
//     receiver groups than SMs, every slice of one class per block, so the
//     output is always written directly, never through scratch; the two
//     consumer warpgroups take alternate receivers of a slice, or, from K >=
//     256 (lig<-rec, lig<-atom), the two halves of each receiver's
//     neighbours, added in a fixed order (first half + second half) before P
//     is rounded;
//   - the weight product from bfloat16 P in shared memory (depth u*HP + h,
//     the bias at h = He): mma.sync m16n8k16 over ldmatrix fragments, the
//     weights of each slice brought by bulk copies of pre-swizzled 64-deep
//     chunks through the same ring, each chunk feeding every receiver of
//     the block;
//   - determinism: every sum in a fixed order (each block's own slice and
//     chunk order, the four depth phases in order); no atomics.
// What holds it back, measured (scripts/tp21_bf16_parts.py times copies of
// this kernel with one part taken out; NVIDIA H100 80GB HBM3, 700 W): it
// reaches 1-6 % of the bound. The chains run on the CUDA cores, latency-bound
// on shared memory at 8 consumer warps per SM: at lig<-atom (K = 2560) they
// take half the time, the TMA and wgmma pipeline the other half. The weight
// stream: every block streams each slice's weights once for its R receivers
// (1.2 MB per 6 receivers in the score model), half the time at rec<-lig and
// rec<-rec. Unchanged by larger ring slots or more chains per thread (the
// registers run out), both measured. Not the stages each slice fetches
// again: fetched for a block's first slice only, the kernel is at most 3 %
// faster (atom<-lig), so slices sharing one stage would gain little.
//
// Layouts (the wrapper packs them, diffdock_tpu_torch/ops/factored_tp2.py,
// prepare_bf16): the weights per slice as chunks of [mul][64 depth], the
// 16-byte groups of row w at group (q ^ (w & 7)), depth k = u*HP + h with
// HP = He+2, He = H rounded up to even; a geometry table per slice (each
// coupled column's x offset, d1 and first CG-weight column; each CG-weight
// column's first harmonic, d2 and CG column).
//
// Plain C interface (no PyTorch headers); cuTensorMapEncodeTiled is reached
// through cudaGetDriverEntryPoint, so nothing but the runtime is linked.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "tp_hopper.cuh"
#include "tp_mma.cuh"

namespace {

using namespace tp_hopper;

constexpr int kMaxClasses = 16;
constexpr int kMaxSlices = 48;
constexpr int kThreads = 3 * 128;  // two consumer warpgroups, one producer warpgroup
constexpr int kConsumerThreads = 256;
constexpr int kTB = 4;               // weight-product tiles per warp per pass
constexpr int kSmemBudget = 232448;  // bytes a block may use (227 KB)
constexpr int kMaxOutputs = 256;     // mul*d3 of one class
constexpr int kMaxHidden = 144;  // the widest hidden product
constexpr int kCols = 64;            // coupled columns of a slice (wgmma M)
constexpr int kMaxWCols = 64;        // CG-weight columns of a slice
constexpr int kMaxJ = 16;            // harmonics per neighbour (one k16 step of the CG product)
constexpr int kMaxRow = 256;         // elements of a neighbour's [sh | x] row
constexpr int kGeoRows = kCols + kMaxWCols;  // int4 rows of a slice's geometry
constexpr int kGStride = 24;         // bfloat16 per row of the slice's dense CG matrix G^T
// shared memory of the slice geometry: the rows, and G^T [cc][j]
constexpr int kGeoBytes = kGeoRows * 16 + kMaxWCols * kGStride * 2;
constexpr int kSliceFields = 10;     // int64 values per slice of the slice table
constexpr int kRMin = 6;             // the fewest receivers a block takes before its stages narrow
constexpr int kMinSlot = 16384;      // the least bytes of a ring slot: the weight product's loads

// one column slice: nu whole u groups of class cls from u0
struct Slice {
  int cls;
  int nu;
  int d3;
  int mul;
  int out_off;    // first output column of the class
  int depth;      // weight-product depth: nu*HP rounded up to 64
  int ncols;      // nu*d3 coupled columns
  int nw;         // CG-weight columns
  int chain_f32;  // gen 1, one path, d3 = 1: the chain's last step in float32
  float scale;    // 1/sqrt(fan)
  int w_off;      // element offset of the slice's packed weight chunks
};

struct Plan {
  int n_slices, n_classes;
  Slice sl[kMaxSlices];
  int cls_first[kMaxClasses], cls_n[kMaxClasses], cls_out[kMaxClasses], cls_width[kMaxClasses];
  long long n_rows;
  int K, H, He, HP, D;
  int W;        // [sh | x] row width (elements, a multiple of 8)
  int x_col;    // x's first element in the row: 16, or 48 after sh's three parts
  int sh_f32;   // 1: sh float32, as three bfloat16 parts (hi + mid + lo, exact)
  int parts;    // parts of h and mw: 1, or 3 (float32 ones as bfloat16 parts, exact)
  int hp;       // columns between h's parts (H + 1 rounded up to 8)
  int NW;       // wgmma N of the hidden product
  int R;        // receivers per block
  int whole;    // 1: every slice in each block; 0: every slice of one class
  int k_parts;  // 1, or 2: the two consumer warpgroups split each receiver's neighbours
  int KC;       // neighbours per stage
  int n_kc;     // stages per receiver
  int h0;       // stages of the first half (k_parts = 2)
  int h_boxes;  // 64-column boxes of h per stage (per part)
  int S;        // ring slots
  int slot_bytes, x_off;
  int a_off, a_bytes, n_tiles;  // each consumer warpgroup's coupled tile (hi, and lo)
  int m_off, m_bytes;           // the mw values of each slot (per part), apart from the ring
  int wt_off, wt_stride, wt_bytes;  // each warpgroup's CG weights [cc][KC + 2]
  int geo_off, p_off, x_half_off, red_off, obuf_off, bar_off, smem_bytes;
  long long n_groups, n_blocks;
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// a position in the ring of S slots: the slot, and the parity of the times
// the ring has wrapped (the mbarrier phase a wait names)
struct RingPos {
  int slot;
  uint32_t phase;
  __device__ __forceinline__ void advance(int n, int S) {
    slot += n;
    if (slot >= S) {
      const int wraps = slot / S;
      slot -= wraps * S;
      phase ^= wraps & 1;
    }
  }
};

// hidden-product widths the kernel is built for
constexpr int kWidths[] = {32, 72, 144};

int red_bytes(const Plan& p, int R) {
  int t_max = 1;
  for (int s = 0; s < p.n_slices; ++s) {
    const int n_m = (p.sl[s].mul + 15) / 16, n_n = (R * p.sl[s].d3 + 7) / 8;
    t_max = std::max(t_max, std::min(n_m * n_n, 2 * kTB));
  }
  return 4 * t_max * 128 * 4;
}

int p_bytes(const Plan& p, int R) {
  int b = 0;
  for (int s = 0; s < p.n_slices; ++s)
    b = std::max(b, R * p.sl[s].d3 * (p.sl[s].depth + 8) * 2);
  return round_up(b, 1024);
}

// the shared-memory layout for R receivers and S slots; returns the bytes
int layout(Plan& p, int R, int S) {
  int off = S * p.slot_bytes;
  p.a_off = off;
  off += 2 * p.n_tiles * p.a_bytes;
  p.m_off = off;
  off += S * p.parts * p.m_bytes;
  p.wt_off = off;
  off += 2 * p.wt_bytes;
  p.geo_off = off;
  off += kGeoBytes;
  p.p_off = off;
  off += p_bytes(p, R);
  p.x_half_off = off;
  if (p.k_parts == 2) off += (p.NW / 2 + 4) * 128 * 4;
  p.red_off = off;
  off += red_bytes(p, R);
  p.obuf_off = off;
  off += round_up(R * p.D * 4, 16);
  p.bar_off = off;
  off += 2 * S * 8;
  return off + 1024;  // alignment of the dynamic shared memory base
}

// Fills the plan from the slice table (n_slices rows of kSliceFields int64:
// cls, fan, d3, mul, out_off, u0, nu, nw, chain_f32, 0) and the shapes;
// false if the kernel does not take them. Slices of a class are contiguous
// and in u order, classes in order from 0, each class's output columns after
// the last one's.
bool make_plan(Plan& p, const long long* table, int n_slices, long long n_rows, int K, int H,
               int F, int J, int sh_f32, int parts, int D, int n_sm) {
  p = Plan{};
  if (n_slices < 1 || n_slices > kMaxSlices || K < 1 || H < 1 || H > kMaxHidden || F < 1 ||
      J < 1 || J > kMaxJ || n_rows < 0)
    return false;
  p.n_slices = n_slices;
  p.n_rows = n_rows;
  p.K = K;
  p.H = H;
  p.He = H + (H & 1);
  p.HP = p.He + 2;
  p.D = D;
  p.sh_f32 = sh_f32 != 0;
  if (parts != 1 && parts != 3) return false;
  p.parts = parts;
  p.hp = round_up(H + 1, 8);
  p.x_col = p.sh_f32 ? 3 * kMaxJ : kMaxJ;
  p.W = round_up(p.x_col + F, 8);
  if (p.W > kMaxRow) return false;
  p.NW = 0;
  for (int w : kWidths)
    if (p.NW == 0 && w >= H) p.NW = w;
  int w_off = 0, max_mul = 0, max_nw = 0, any_f32 = 0, u_next = 0, fan_c = 0;
  for (int s = 0; s < n_slices; ++s) {
    const long long* row = table + kSliceFields * s;
    const int cls = static_cast<int>(row[0]), fan = static_cast<int>(row[1]);
    const int d3 = static_cast<int>(row[2]), mul = static_cast<int>(row[3]);
    const int out_off = static_cast<int>(row[4]), u0 = static_cast<int>(row[5]);
    const int nu = static_cast<int>(row[6]), nw = static_cast<int>(row[7]);
    const int f32 = static_cast<int>(row[8]);
    const bool new_cls = s == 0 || cls != p.sl[s - 1].cls;
    if (new_cls) {
      if (cls != p.n_classes || p.n_classes == kMaxClasses || (s > 0 && u_next != fan_c)) return false;
      const int end = cls == 0 ? 0 : p.cls_out[cls - 1] + p.cls_width[cls - 1];
      if (out_off != end || u0 != 0) return false;
      p.cls_first[cls] = s;
      p.cls_out[cls] = out_off;
      p.cls_width[cls] = mul * d3;
      ++p.n_classes;
      fan_c = fan;
      u_next = 0;
    } else if (out_off != p.cls_out[cls] || mul * d3 != p.cls_width[cls] || fan != fan_c) {
      return false;
    }
    if (fan < 1 || d3 < 1 || mul < 1 || nu < 1 || u0 != u_next || nu * d3 > kCols || nw < 1 ||
        nw > kMaxWCols || mul * d3 > kMaxOutputs || (f32 != 0 && f32 != 1))
      return false;
    ++p.cls_n[cls];
    u_next += nu;
    Slice& sl = p.sl[s];
    sl.cls = cls;
    sl.nu = nu;
    sl.d3 = d3;
    sl.mul = mul;
    sl.out_off = out_off;
    sl.depth = round_up(nu * p.HP, 64);
    sl.ncols = nu * d3;
    sl.nw = nw;
    sl.chain_f32 = f32;
    sl.scale = 1.0f / sqrtf(static_cast<float>(fan));
    sl.w_off = w_off;
    if (static_cast<long long>(w_off) + static_cast<long long>(sl.depth) * mul > 0x7fffffffLL)
      return false;
    w_off += sl.depth * mul;
    max_mul = std::max(max_mul, mul);
    max_nw = std::max(max_nw, nw);
    any_f32 |= f32;
  }
  if (u_next != fan_c || p.cls_out[p.n_classes - 1] + p.cls_width[p.n_classes - 1] != D) return false;
  p.k_parts = K >= 256 ? 2 : 1;
  p.h_boxes = (p.NW + 63) / 64;
  p.n_tiles = any_f32 ? 2 : 1;
  // stages of KC neighbours
  auto stage = [&](int kc) {
    p.KC = kc;
    p.n_kc = (K + kc - 1) / kc;
    p.h0 = (p.n_kc + 1) / 2;
    p.x_off = kc * 128 * p.h_boxes * p.parts;
    p.m_bytes = round_up(2 * kc + 128, 128);  // mw, and the rows the bias product reads past it
    p.slot_bytes = round_up(
        std::max({p.x_off + round_up(kc * p.W * 2, 128), max_mul * 128 + 2048, kMinSlot}), 1024);
    p.a_bytes = kc * 128;
    p.wt_stride = (kc + 2) * 2;
    p.wt_bytes = round_up(max_nw * p.wt_stride, 16);
  };
  // the most receivers (even, up to 16) that fit S slots, or 0
  auto most = [&](int S) {
    for (int r = 16; r >= 2; r -= 2)
      if (layout(p, r, S) <= kSmemBudget) return r;
    return 0;
  };
  // the widest stage (up to 64 neighbours, no wider than K needs) that
  // leaves 4, else 3, slots and room for at least 8 receivers (2 when the
  // warpgroups split long neighbour lists, and then 4 slots); else 16 or
  // 32 neighbours and 2 slots
  const int r_min = p.k_parts == 2 ? 2 : kRMin;
  int R = 0, S = 0;
  for (int kc = K <= 16 ? 16 : K <= 32 ? 32 : 64; kc >= 16 && R == 0; kc /= 2) {
    stage(kc);
    for (int s = 4; s >= 2 + p.k_parts && R == 0; --s)
      if (most(s) >= r_min) {
        R = most(s);
        S = s;
      }
  }
  if (R == 0) {
    stage(K <= 16 ? 16 : 32);
    R = most(2);
    S = 2;
    if (R == 0) return false;
  }
  // few receiver groups: every slice of one class per block, with fewer
  // receivers per block, so that the blocks cover the SMs twice
  p.whole = (n_rows + R - 1) / R >= n_sm ? 1 : 0;
  const int r_low = p.k_parts == 2 ? 1 : 2;
  if (!p.whole)
    while (R > r_low && (n_rows + R - 1) / R * p.n_classes < 2LL * n_sm)
      R = p.k_parts == 2 ? R / 2 : std::max(2, (R / 2 + 1) / 2 * 2);
  p.R = R;
  p.S = S;
  p.smem_bytes = layout(p, R, S);
  p.n_groups = (n_rows + R - 1) / R;
  p.n_blocks = p.whole ? p.n_groups : p.n_groups * p.n_classes;
  return true;
}

// ---- device helpers ---------------------------------------------------------

// two bfloat16 values, each rounded once: a * b, and a + b (fma with a
// signed zero, and with a unit factor)
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3f803f80u), "r"(b));
  return d;
}
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ unsigned short bf_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// The chains of one u group of a slice (its D3 coupled columns, d1 = D1
// terms each) for kU neighbour pairs kp = kb + u*step side by side: term i
// of column d reads the x pair x0[2*kp*W + i], x0[(2*kp+1)*W + i] (shared by
// the D3 columns) and the CG-weight pair w[(i*D3 + d)*wrow + kp]. Every load
// is issued before the arithmetic; a pair past `half` recomputes the last
// one (its result is not stored)
template <int D1, int D3, int kU>
__device__ __forceinline__ void chains(uint32_t (&v)[kU][D3], const unsigned short* x0, int W,
                                       const uint32_t* w, int wrow, int kb, int step, int half) {
  uint32_t xv[kU][D1], wv[kU][D1 * D3];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int kp = min(kb + u * step, half - 1);
    const unsigned short* xr = x0 + 2 * kp * W;
#pragma unroll
    for (int i = 0; i < D1; ++i) {
      xv[u][i] = static_cast<uint32_t>(xr[i]) | (static_cast<uint32_t>(xr[W + i]) << 16);
#pragma unroll
      for (int d = 0; d < D3; ++d) wv[u][i * D3 + d] = w[(i * D3 + d) * wrow + kp];
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int d = 0; d < D3; ++d) {
      uint32_t a = bf2_mul(xv[u][0], wv[u][d]);
#pragma unroll
      for (int i = 1; i < D1; ++i) a = bf2_add(a, bf2_mul(xv[u][i], wv[u][i * D3 + d]));
      v[u][d] = a;
    }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the kernel ---------------------------------------------------------

// kExtra: the call has gen 1's float32 hidden rows (parts) or a chain_f32
// slice; the products they add are in branches, which the compiler
// serializes wgmma around, so the plain calls (every gen-2 call) take an
// instantiation without them
template <int NW, bool kExtra>
__global__ void __launch_bounds__(kThreads, 1)
factored_tp_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_h,
                        const __grid_constant__ CUtensorMap map_m, const int4* __restrict__ geo,
                        const unsigned short* __restrict__ cg, int cg_cols,
                        const __nv_bfloat16* __restrict__ weights, float* __restrict__ out,
                        const __grid_constant__ Plan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.S;
  float* obuf = reinterpret_cast<float*>(smem + p.obuf_off);
  const int tid = threadIdx.x;
  const int S = p.S;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producers' arrival with the stage's bytes
      mbar_init(&empty[s], 8);  // eight consumer-warp arrivals
    }
    mbar_fence_init();
  }
  for (int e = tid; e < p.R * p.D; e += kThreads) obuf[e] = 0.f;
  __syncthreads();

  // block -> receiver group and its slices: all, or those of one class
  const long long bid = blockIdx.x;
  const long long grp = p.whole ? bid : bid / p.n_classes;
  const int cls = p.whole ? 0 : static_cast<int>(bid % p.n_classes);
  const int s_first = p.whole ? 0 : p.cls_first[cls];
  const int n_sl = p.whole ? p.n_slices : p.cls_n[cls];
  const long long r0 = grp * p.R;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  // blocks start at different slices, and each block streams a slice's
  // weight chunks from its own starting chunk, so that the blocks do not
  // all read the same weights at once (every block sums in its own fixed
  // order)
  auto slice_at = [&](int sj) { return s_first + static_cast<int>((sj + bid) % n_sl); };
  // P items per slice: each consumer warpgroup's items alternate in the ring
  const int n_q = p.k_parts == 1 ? (p.R / 2) * p.n_kc : p.R * p.h0;
  const int n_pi = 2 * n_q;

  if (wg == 2) {
    // ---- producers: lane 0 of warp `pw` of the third warpgroup fills ring
    // slot pw (a TMA issue holds its thread long, and threads of different
    // warps issue in parallel) ---------------------------------------------
    const int pw = (tid - 256) >> 5;
    if (lane != 0 || pw >= S) return;
    if (pw == 0) {
      prefetch_tensormap(&map_x);
      prefetch_tensormap(&map_h);
      prefetch_tensormap(&map_m);
    }
    const int hb = p.h_boxes, parts = p.parts;
    const uint32_t stage_tx =
        static_cast<uint32_t>(parts * (p.KC * 128 * hb + p.KC * 2) + p.KC * p.W * 2);
    // x, sh and h are read once per slice, by neighbouring blocks; the
    // weights by every block: they stay in L2
    const uint64_t shared = l2_evict_last();
    RingPos pos = {0, 0};  // the position of the current item
    for (int sj = 0; sj < n_sl; ++sj) {
      const int si = slice_at(sj);
      for (int w = 0; w < n_pi; ++w, pos.advance(1, S)) {
        // item w: warpgroup w & 1's item q = w >> 1
        const int q = w >> 1, g = w & 1;
        int r_local, kc;
        if (p.k_parts == 1) {
          r_local = 2 * (q / p.n_kc) + g;
          kc = q % p.n_kc;
        } else {
          r_local = q / p.h0;
          kc = g * p.h0 + q % p.h0;
        }
        const int r = static_cast<int>(r0 + r_local), k0 = kc * p.KC;
        const int slot = pos.slot;
        if (slot != pw) continue;
        mbar_wait(&empty[slot], pos.phase ^ 1);
        unsigned char* st = smem + slot * p.slot_bytes;
        unsigned char* mt = smem + p.m_off + slot * parts * p.m_bytes;
        mbar_arrive_expect_tx(&full[slot], stage_tx);
        // [sh | x], then per part of h and mw its h boxes (part q from
        // column q*hp) and its mw values
        tma_load_3d(st + p.x_off, &map_x, &full[slot], 0, k0, r, shared);
        for (int q = 0; q < parts; ++q) {
          for (int b = 0; b < hb; ++b)
            tma_load_3d(st + (q * hb + b) * p.KC * 128, &map_h, &full[slot], q * p.hp + 64 * b, k0,
                        r, shared);
          tma_load_3d(mt + q * p.m_bytes, &map_m, &full[slot], k0, q, r, shared);
        }
      }
      // the slice's weight chunks, once per pass of the weight product
      const Slice& sl = p.sl[si];
      const int n_m = (sl.mul + 15) / 16, n_n = (p.R * sl.d3 + 7) / 8;
      const int n_passes = (n_m * n_n + 2 * kTB - 1) / (2 * kTB);
      const int n_sub = sl.depth / 64;
      const int sps = max(1, (p.slot_bytes - 2048) / (sl.mul * 128));
      const int n_wl = (n_sub + sps - 1) / sps;
      const int rot = static_cast<int>(bid % n_wl);
      for (int pass = 0; pass < n_passes; ++pass) {
        for (int wl = 0; wl < n_wl; ++wl, pos.advance(1, S)) {
          const int slot = pos.slot;
          if (slot != pw) continue;
          mbar_wait(&empty[slot], pos.phase ^ 1);
          const int wr = (wl + rot) % n_wl;
          const int cnt = min(sps, n_sub - wr * sps);
          const uint32_t bytes = static_cast<uint32_t>(cnt * sl.mul * 128);
          mbar_arrive_expect_tx(&full[slot], bytes);
          bulk_load(smem + slot * p.slot_bytes,
                    weights + sl.w_off + static_cast<long long>(wr) * sps * sl.mul * 64, bytes,
                    &full[slot], shared);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups 0 and 1 --------------------------------------
  const int wi = (tid >> 5) & 3;   // warp within the warpgroup
  const int cw = tid >> 5;         // consumer warp, 0..7
  const int g = lane >> 2, t4 = lane & 3;
  const int ctid = tid & 127;
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + p.p_off);
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  int4* geo_s = reinterpret_cast<int4*>(smem + p.geo_off);  // the slice's [64] column rows
  // the slice's CG matrix, dense over the harmonics: G^T[cc][j] = CG[j - first][col] on
  // the column's own harmonics, else 0 (rows past nw are zero)
  unsigned short* gt = reinterpret_cast<unsigned short*>(smem + p.geo_off + kGeoRows * 16);
  unsigned short* wt = reinterpret_cast<unsigned short*>(smem + p.wt_off + wg * p.wt_bytes);
  const uint32_t a_base = smem_addr(smem + p.a_off + wg * p.n_tiles * p.a_bytes);
  unsigned char* a_gen = smem + p.a_off + wg * p.n_tiles * p.a_bytes;
  float acc[NW / 2];
  float accb[4];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) accb[i] = 0.f;
  const uint32_t h_lead = p.KC * 128, h_stride = 1024;  // 64-column boxes, 8-row groups
  const int k16 = p.KC / 16;
  const int parts = p.parts;
  const int bar_wg = 5 + wg;          // the warpgroup's own named barrier

  RingPos pos = {0, 0};  // the position of the slice's first item
  for (int sj = 0; sj < n_sl; ++sj) {
    const int si = slice_at(sj);
    const Slice sl = p.sl[si];
    const int d3 = sl.d3, ncols = sl.ncols, prs = sl.depth + 8, nrow = p.R * d3;
    const int inv_d3 = (65536 + d3 - 1) / d3;
    // the slice's column rows and its dense CG matrix (from its CG-weight
    // rows); zero the depth padding of its P rows
    {
      const int4* gsrc = geo + static_cast<long long>(si) * kGeoRows;
      for (int e = tid; e < kCols; e += kConsumerThreads) geo_s[e] = gsrc[e];
      for (int e = tid; e < kMaxWCols * kMaxJ; e += kConsumerThreads) {
        const int cc = e / kMaxJ, j = e - cc * kMaxJ;
        unsigned short v = 0;
        if (cc < sl.nw) {
          const int4 wc = gsrc[kCols + cc];
          if (j >= wc.x && j < wc.x + wc.y) v = cg[(j - wc.x) * cg_cols + wc.z];
        }
        gt[cc * kGStride + j] = v;
      }
      const int pad0 = sl.nu * p.HP, npad = sl.depth - pad0;
      for (int e = tid; e < nrow * npad; e += kConsumerThreads) {
        const int rw = e / npad;
        P[rw * prs + pad0 + e - rw * npad] = __float2bfloat16_rn(0.f);
      }
    }
    named_sync(1, kConsumerThreads);
    // this thread's u group (its d3 coupled columns share their x values),
    // and its first neighbour pair and step: every thread of the warpgroup
    // has work
    const int c_step = 128 / sl.nu, c_u = ctid % sl.nu, c_k0 = ctid / sl.nu;
    const int4 ci = geo_s[c_u * d3];  // the group's x offset, d1, first CG-weight column

    // round the accumulators to bfloat16 into the P rows of receiver r_local
    auto store_p = [&](int r_local) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * wi + g + 8 * half;  // tile row -> slice column
        if (j < ncols) {
          const int uu = (j * inv_d3) >> 16, d = j - uu * d3;
          __nv_bfloat16* row = P + (r_local * d3 + d) * prs + uu * p.HP;
#pragma unroll
          for (int i = 0; i < NW / 8; ++i) {
            const int h = 8 * i + 2 * t4;
            if (h < p.He)
              *reinterpret_cast<__nv_bfloat162*>(row + h) =
                  __floats2bfloat162_rn(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
          }
          if (t4 == 0)
            *reinterpret_cast<__nv_bfloat162*>(row + p.He) =
                __floats2bfloat162_rn(accb[2 * half], 0.f);
        }
      }
    };
    // the coupled tile(s) of one stage from its [sh | x] rows: the CG
    // weights W (KC x nw) = sh (KC x 16) @ G on the tensor cores (exact
    // products, float32 sums, rounded to bfloat16; the four warps take the
    // m16 x n8 tiles in turn), stored W^T [cc][kk]; then
    // the chains of each (u group, neighbour pair): a thread takes a u group
    // (whose d3 columns read the same x values) and several neighbour pairs
    // side by side (8 to 1, as d1*d3 allows), all their loads first:
    // independent chains, so the build is not one shared-memory latency per
    // term
    auto build = [&](const unsigned char* xs) {
      const int KC = p.KC, W = p.W, wts = KC + 2;
      const unsigned short* xrow = reinterpret_cast<const unsigned short*>(xs);
      if (p.sh_f32) {
        // a float32 sh (three bfloat16 parts, summed exactly): float32 sums
        // on the CUDA cores in the harmonics' order, as a float32 matmul
        // takes them (the tensor cores' accumulation moved the rounded
        // weights of gen 1's mixed case further from its plain version)
        constexpr int kU = 4;
        const int w_step = 128 / sl.nw, w_col = ctid % sl.nw, w_k0 = ctid / sl.nw;
        const unsigned short* gr = gt + w_col * kGStride;
        for (int kb = w_k0; w_k0 < w_step && kb < KC; kb += kU * w_step) {
          float acc_w[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) acc_w[u] = 0.f;
          for (int j = 0; j < kMaxJ; ++j) {
            const float c = __uint_as_float(static_cast<uint32_t>(gr[j]) << 16);
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const unsigned short* r = xrow + min(kb + u * w_step, KC - 1) * W + j;
              const float v = (__uint_as_float(static_cast<uint32_t>(r[0]) << 16) +
                               __uint_as_float(static_cast<uint32_t>(r[kMaxJ]) << 16)) +
                              __uint_as_float(static_cast<uint32_t>(r[2 * kMaxJ]) << 16);
              acc_w[u] = fmaf(v, c, acc_w[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (kb + u * w_step < KC) wt[w_col * wts + kb + u * w_step] = bf_bits(acc_w[u]);
        }
      } else {
        const int n_nt = (sl.nw + 7) / 8, n_tt = (KC / 16) * n_nt;
        const uint32_t xa = smem_addr(xs), ga = smem_addr(gt);
        for (int tt = wi; tt < n_tt; tt += 4) {
          const int mt = tt / n_nt, nt = tt - mt * n_nt;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          uint32_t b[2];
          ldmatrix_x2(b, ga + ((nt * 8 + (lane & 7)) * kGStride + ((lane >> 3) & 1) * 8) * 2);
          uint32_t a[4];
          ldmatrix_x4(a, xa + ((mt * 16 + (lane & 15)) * W + (lane >> 4) * 8) * 2);
          tp_mma::mma_bf16_k16(d, a, b[0], b[1]);
          const int cc = nt * 8 + 2 * t4, kk = mt * 16 + g;
          if (cc < sl.nw) {
            wt[cc * wts + kk] = bf_bits(d[0]);
            wt[cc * wts + kk + 8] = bf_bits(d[2]);
          }
          if (cc + 1 < sl.nw) {
            wt[(cc + 1) * wts + kk] = bf_bits(d[1]);
            wt[(cc + 1) * wts + kk + 8] = bf_bits(d[3]);
          }
        }
      }
      named_sync(bar_wg, 128);
      if (c_k0 < c_step) {
        unsigned char* hi = a_gen;
        unsigned char* lo = hi + p.a_bytes;  // chain_f32: the lo tile after the hi one
        const uint32_t* wt2 = reinterpret_cast<const uint32_t*>(wt);
        const int half = KC / 2, wrow = wts / 2;  // neighbour pairs; words per CG-weight column
        const unsigned short* x0 = xrow + p.x_col + ci.x;
        const uint32_t* w0 = wt2 + ci.z * wrow;
        // the two neighbours' cells of pair kp in a tile, column c_u*d3 + d
        auto cells = [&](unsigned char* tile, int kp, int d, unsigned short a, unsigned short b) {
          const int kk = 2 * kp, j = c_u * d3 + d, jx = j >> 3, jo = (j & 7) << 1;
          *reinterpret_cast<unsigned short*>(tile + kk * 128 + (((jx ^ (kk & 7)) << 4) | jo)) = a;
          *reinterpret_cast<unsigned short*>(tile + (kk + 1) * 128 +
                                             (((jx ^ ((kk + 1) & 7)) << 4) | jo)) = b;
        };
        // the group's chains, U pairs at a time, for D1 and D3 known at
        // compile time
        auto run = [&](auto d1c, auto d3c, auto uc) {
          constexpr int D1 = decltype(d1c)::value, D3 = decltype(d3c)::value;
          constexpr int U = decltype(uc)::value;
          for (int kb = c_k0; kb < half; kb += U * c_step) {
            uint32_t v[U][D3];
            chains<D1, D3, U>(v, x0, W, w0, wrow, kb, c_step, half);
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int kp = kb + u * c_step;
              if (kp < half)
#pragma unroll
                for (int d = 0; d < D3; ++d)
                  cells(hi, kp, d, static_cast<unsigned short>(v[u][d] & 0xffffu),
                        static_cast<unsigned short>(v[u][d] >> 16));
            }
          }
        };
        using I1 = std::integral_constant<int, 1>;
        using I2 = std::integral_constant<int, 2>;
        using I3 = std::integral_constant<int, 3>;
        using I4 = std::integral_constant<int, 4>;
        using I5 = std::integral_constant<int, 5>;
        using I8 = std::integral_constant<int, 8>;
        const int dd = sl.chain_f32 ? 0 : ci.y * 8 + d3;  // (d1, d3), 0 for the general loop
        if (dd == 1 * 8 + 1) {
          run(I1{}, I1{}, I8{});
        } else if (dd == 1 * 8 + 3) {
          run(I1{}, I3{}, I4{});
        } else if (dd == 3 * 8 + 1) {
          run(I3{}, I1{}, I4{});
        } else if (dd == 3 * 8 + 3) {
          run(I3{}, I3{}, I2{});
        } else if (dd == 1 * 8 + 5) {
          run(I1{}, I5{}, I2{});
        } else if (dd == 5 * 8 + 1) {
          run(I5{}, I1{}, I2{});
        } else if (dd == 3 * 8 + 5) {
          run(I3{}, I5{}, I1{});
        } else if (dd == 5 * 8 + 3) {
          run(I5{}, I3{}, I1{});
        } else {
          // any d1 and d3, and the chain_f32 columns (d3 = 1): one pair at a time
          for (int kp = c_k0; kp < half; kp += c_step) {
            for (int d = 0; d < d3; ++d) {
              uint32_t v = 0;
              float f0 = 0.f, f1 = 0.f;
              for (int i = 0; i < ci.y; ++i) {
                const unsigned short* xr = x0 + 2 * kp * W + i;
                const uint32_t xv = static_cast<uint32_t>(xr[0]) | (static_cast<uint32_t>(xr[W]) << 16);
                const uint32_t wv = w0[(i * d3 + d) * wrow + kp];
                const uint32_t pr = bf2_mul(xv, wv);
                if (sl.chain_f32 && i + 1 == ci.y) {
                  // the last step in float32: the product itself for a
                  // one-term chain, else the rounded chain plus the rounded
                  // product
                  f0 = i == 0 ? bf_lo(xv) * bf_lo(wv) : bf_lo(v) + bf_lo(pr);
                  f1 = i == 0 ? bf_hi(xv) * bf_hi(wv) : bf_hi(v) + bf_hi(pr);
                } else {
                  v = i == 0 ? pr : bf2_add(v, pr);
                }
              }
              if (sl.chain_f32) {
                const unsigned short h0 = bf_bits(f0), h1 = bf_bits(f1);
                cells(hi, kp, d, h0, h1);
                cells(lo, kp, d, bf_bits(f0 - __uint_as_float(static_cast<uint32_t>(h0) << 16)),
                      bf_bits(f1 - __uint_as_float(static_cast<uint32_t>(h1) << 16)));
              } else {
                cells(hi, kp, d, static_cast<unsigned short>(v & 0xffffu),
                      static_cast<unsigned short>(v >> 16));
              }
            }
          }
        }
      }
      fence_async_smem();  // the tile, written by threads, is read by wgmma
      named_sync(bar_wg, 128);
    };
    // a P item's slot is released by the four warps of one warpgroup
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[slot]);
        mbar_arrive(&empty[slot]);
      }
    };

    // ---- P: this warpgroup's items (every other one) --------------------
    RingPos mine = pos;
    mine.advance(wg, S);
    for (int q = 0; q < n_q; ++q, mine.advance(2, S)) {
      const int slot = mine.slot;
      int r_local, first, last;
      if (p.k_parts == 1) {
        const int kc = q % p.n_kc;
        r_local = 2 * (q / p.n_kc) + wg;
        first = kc == 0;
        last = kc == p.n_kc - 1;
      } else {
        const int j = q % p.h0;
        r_local = q / p.h0;
        first = j == 0;
        last = j == p.h0 - 1;
      }
      mbar_wait(&full[slot], mine.phase);
      unsigned char* stp = smem + slot * p.slot_bytes;
      build(stp + p.x_off);
      const uint32_t st = smem_addr(stp);
      const uint32_t mt = smem_addr(smem + p.m_off + slot * parts * p.m_bytes);
      const uint32_t at = a_base;
      fence_operands(acc);
      fence_operands(accb);
      wgmma_fence();
      for (int t = 0; t < k16; ++t) {
        const int scale = first && t == 0 ? 0 : 1;
        const uint64_t da = make_desc(at + t * 2048, 1024, 1024, 1);
        const uint64_t db = make_desc(st + t * 2048, h_lead, h_stride, 1);
        // the bias operand (16 x 8, K-major, no swizzle) read from the KC mw
        // values: core matrices along K 16 bytes apart, so column 0 of core
        // matrix g is mw[8g..8g+7]; columns 1-7 read the values after it and
        // land in bias columns that are never stored
        const uint64_t dm = make_desc(mt + t * 32, 16, 128, 0);
        Wgmma<NW>::mma(acc, da, db, scale);
        WgmmaN8K::mma(accb, da, dm, scale);
        for (int q = 1; kExtra && q < parts; ++q) {
          const uint64_t dbq =
              make_desc(st + q * p.h_boxes * p.KC * 128 + t * 2048, h_lead, h_stride, 1);
          const uint64_t dmq = make_desc(mt + q * p.m_bytes + t * 32, 16, 128, 0);
          Wgmma<NW>::mma(acc, da, dbq, 1);
          WgmmaN8K::mma(accb, da, dmq, 1);
        }
        if (kExtra && sl.chain_f32) {
          const uint64_t dal = make_desc(at + p.a_bytes + t * 2048, 1024, 1024, 1);
          Wgmma<NW>::mma(acc, dal, db, 1);
          WgmmaN8K::mma(accb, dal, dm, 1);
        }
      }
      wgmma_commit();
      // the slot goes back to the producers at once: a warpgroup holds one
      // slot, so the ring's others take the next stages' copies meanwhile
      wgmma_wait<0>();
      release(slot);
      if (last) {
        fence_operands(acc);
        fence_operands(accb);
        if (p.k_parts == 1) {
          store_p(r_local);
        } else {
          // first half (warpgroup 0) + second half (warpgroup 1), in order
          float* xb = reinterpret_cast<float*>(smem + p.x_half_off);
          if (wg == 1) {
#pragma unroll
            for (int i = 0; i < NW / 2; ++i) xb[i * 128 + ctid] = acc[i];
#pragma unroll
            for (int i = 0; i < 4; ++i) xb[(NW / 2 + i) * 128 + ctid] = accb[i];
          }
          named_sync(2, kConsumerThreads);
          if (wg == 0) {
#pragma unroll
            for (int i = 0; i < NW / 2; ++i) acc[i] += xb[i * 128 + ctid];
#pragma unroll
            for (int i = 0; i < 4; ++i) accb[i] += xb[(NW / 2 + i) * 128 + ctid];
            store_p(r_local);
          }
          named_sync(3, kConsumerThreads);
        }
      }
    }
    pos.advance(n_pi, S);
    named_sync(1, kConsumerThreads);  // every P row of the slice is in place

    // ---- weight product: out[(r,d)][w] += sum_k P[(r,d)][k] Wt[w][k] -----
    // m16 tiles over w, n8 tiles over (receiver, d); warp cw takes the k16
    // step (cw & 3) of every 64-deep chunk and the tiles of parity (cw >> 2)
    const int mul = sl.mul;
    const int n_m = (mul + 15) / 16, n_n = (nrow + 7) / 8, n_tiles = n_m * n_n;
    const int n_passes = (n_tiles + 2 * kTB - 1) / (2 * kTB);
    const int n_sub = sl.depth / 64;
    const int sps = max(1, (p.slot_bytes - 2048) / (mul * 128));
    const int n_wl = (n_sub + sps - 1) / sps;
    const int rot = static_cast<int>(bid % n_wl);
    const int kk = cw & 3, par = cw >> 2;
    const uint32_t p_addr = smem_addr(P);
    for (int pass = 0; pass < n_passes; ++pass) {
      const int t_begin = pass * 2 * kTB;
      const int cnt = min(2 * kTB, n_tiles - t_begin);
      float wacc[kTB][4];
      // per tile of this warp, the lane's ldmatrix offsets: A, W rows
      // mt*16.. at depth groups 2kk, 2kk+1 (swizzled) within a 64-deep
      // chunk; B, P rows nt*8.. (clamped to the real ones) at depth kk*16
      uint32_t a_off[kTB], b_off[kTB];
      int n_mine = 0;
#pragma unroll
      for (int i = 0; i < kTB; ++i) {
#pragma unroll
        for (int v = 0; v < 4; ++v) wacc[i][v] = 0.f;
        const int ts = 2 * i + par;
        const int tile = t_begin + min(ts, cnt - 1);
        const int mt = tile / n_n, nt = tile - mt * n_n;
        const int wrow = mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int qg = 2 * kk + (lane >> 4);
        a_off[i] = wrow * 128 + ((qg ^ (wrow & 7)) << 4);
        const int n = min(nt * 8 + (lane & 7), nrow - 1);
        b_off[i] = p_addr + (n * prs + kk * 16 + ((lane >> 3) & 1) * 8) * 2;
        n_mine += ts < cnt;
      }
      for (int wl = 0; wl < n_wl; ++wl, pos.advance(1, S)) {
        const int slot = pos.slot;
        mbar_wait(&full[slot], pos.phase);
        const int wcn = (wl + rot) % n_wl;  // this block's chunk order
        const int n_here = min(sps, n_sub - wcn * sps);
        uint32_t wsub = smem_addr(smem + slot * p.slot_bytes);
        uint32_t pk = wcn * sps * 128;  // bytes of depth before this load's first chunk
        for (int j = 0; j < n_here; ++j, wsub += mul * 128, pk += 128) {
#pragma unroll
          for (int i = 0; i < kTB; ++i) {
            if (i < n_mine) {
              uint32_t a[4], b[2];
              ldmatrix_x4(a, wsub + a_off[i]);
              ldmatrix_x2(b, b_off[i] + pk);
              tp_mma::mma_bf16_k16(wacc[i], a, b[0], b[1]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
      // the four depth phases' partial sums, added in order, then scaled
      // by 1/sqrt(fan)
#pragma unroll
      for (int i = 0; i < kTB; ++i) {
        const int ts = 2 * i + par;
        if (ts < cnt) {
          float* rt = red + (ts * 4 + kk) * 128;
          rt[g * 8 + 2 * t4] = wacc[i][0];
          rt[g * 8 + 2 * t4 + 1] = wacc[i][1];
          rt[(g + 8) * 8 + 2 * t4] = wacc[i][2];
          rt[(g + 8) * 8 + 2 * t4 + 1] = wacc[i][3];
        }
      }
      named_sync(4, kConsumerThreads);
      for (int e = tid; e < cnt * 128; e += kConsumerThreads) {
        const int ts = e >> 7, el = e & 127;
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) v += red[(ts * 4 + q) * 128 + el];
        const int tile = t_begin + ts;
        const int mt = tile / n_n, nt = tile - mt * n_n;
        const int w = mt * 16 + (el >> 3), n = nt * 8 + (el & 7);
        if (w < mul && n < nrow) {
          const int rl = n / d3, d = n - rl * d3;
          obuf[rl * p.D + sl.out_off + w * d3 + d] += v * sl.scale;
        }
      }
      named_sync(4, kConsumerThreads);
    }
  }

  // ---- store: the block's columns of its receivers ---------------------------
  const int c0 = p.whole ? 0 : p.cls_out[cls];
  const int width = p.whole ? p.D : p.cls_width[cls];
  for (int e = tid; e < p.R * width; e += kConsumerThreads) {
    const int rl = e / width, c = c0 + e - rl * width;
    const long long r = r0 + rl;
    if (r < p.n_rows) out[r * p.D + c] = obuf[rl * p.D + c];
  }
}

// ---- host side ------------------------------------------------------------

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (N, K, width) bfloat16 tensor whose rows are `stride` elements apart,
// read in boxes of `box` columns x KC neighbours of one receiver, with the
// 128-byte swizzle (box = 64) or none
bool make_map(CUtensorMap* m, const void* base, long long width, long long K, long long N,
              long long stride, int box, int KC, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(stride * 2),
                                 static_cast<cuuint64_t>(K * stride * 2)};
  const cuuint32_t boxd[3] = {static_cast<cuuint32_t>(box), static_cast<cuuint32_t>(KC), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                boxd, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// mw (N, parts, K) bfloat16 with rows `stride` elements apart, read KC
// neighbours of one part of one receiver at a time
bool make_mw_map(CUtensorMap* m, const void* base, long long K, int parts, long long N,
                 long long stride, int KC) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(parts),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(stride * 2),
                                 static_cast<cuuint64_t>(parts * stride * 2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(KC), 1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap x, h, m;
};

template <int NW>
cudaError_t launch(const Maps& mp, const int4* geo, const unsigned short* cg, int cg_cols,
                   const __nv_bfloat16* weights, float* out, const Plan& p, cudaStream_t stream) {
  bool extra = p.parts > 1;
  for (int s = 0; s < p.n_slices; ++s) extra = extra || p.sl[s].chain_f32;
  auto kernel = extra ? factored_tp_bf16_kernel<NW, true> : factored_tp_bf16_kernel<NW, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return err;
  if (p.n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(p.n_blocks), kThreads, p.smem_bytes, stream>>>(
      mp.x, mp.h, mp.m, geo, cg, cg_cols, weights, out, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for the Python side to check against its own: writes
// (R, whole, k_parts, KC, S, NW, smem_bytes, n_blocks, packed weight
// elements) to `info` (int64) and returns 0, or -1 if the kernel refuses
// the slices or shapes. n_sm <= 0 takes the current device's SM count.
int factored_tp_bf16_plan(const long long* slice_table, int n_slices, long long n_rows, int K,
                          int H, int F, int J, int sh_f32, int parts, int D, int n_sm,
                          long long* info) {
  Plan p;
  if (!make_plan(p, slice_table, n_slices, n_rows, K, H, F, J, sh_f32, parts, D,
                 n_sm > 0 ? n_sm : sm_count()))
    return -1;
  const Slice& last = p.sl[p.n_slices - 1];
  const long long v[9] = {p.R, p.whole, p.k_parts, p.KC, p.S, p.NW, p.smem_bytes, p.n_blocks,
                          static_cast<long long>(last.w_off) + static_cast<long long>(last.depth) * last.mul};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return 0;
}

// xs (N, K, W) bfloat16, each neighbour's row: sh (J <= 16 harmonics in
// columns 0-15; a float32 sh as three bfloat16 parts hi, mid, lo in columns
// 0-15, 16-31, 32-47, whose sum is exact), then x_nbr (F) from column 16
// (48), zeros to W = that end rounded up to 8; h (N, K, H) bfloat16 with
// rows `h_stride` elements apart (a multiple of 8), or with 3 parts (N, K,
// 3*hp), part q from column q*hp, hp = H + 1 rounded up to 8 (zeros past
// H); mw (N, parts, K) with rows `mw_stride` apart (a multiple of 8); geo
// the slices' geometry (n_slices x 128 int4); cg (cg_rows, cg_cols)
// bfloat16; weights packed as the header describes; out (N, D) float32;
// every pointer 16-byte aligned. Returns a cudaError_t.
int factored_tp_bf16_forward(const void* xs, const void* h, const void* mw, const void* geo,
                             const void* cg, int cg_cols, const void* weights, float* out,
                             const long long* slice_table, int n_slices, long long n_rows, int K,
                             int F, int J, int sh_f32, int H, long long h_stride,
                             long long mw_stride, int parts, int D, void* stream) {
  Plan p;
  auto aligned = [](const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; };
  if (!make_plan(p, slice_table, n_slices, n_rows, K, H, F, J, sh_f32, parts, D, sm_count()))
    return cudaErrorInvalidValue;
  const long long h_width = parts == 1 ? H : static_cast<long long>(parts) * p.hp;
  if (h_stride % 8 != 0 || mw_stride % 8 != 0 || h_stride < h_width || mw_stride < K ||
      !aligned(xs) || !aligned(h) || !aligned(mw) || !aligned(weights) || !aligned(geo))
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  Maps mp;
  if (!make_map(&mp.x, xs, p.W, K, n_rows, p.W, p.W, p.KC, false) ||
      !make_map(&mp.h, h, h_width, K, n_rows, h_stride, 64, p.KC, true) ||
      !make_mw_map(&mp.m, mw, K, parts, n_rows, mw_stride, p.KC))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const int4*>(geo);
  const auto* c = static_cast<const unsigned short*>(cg);
  const auto* w = static_cast<const __nv_bfloat16*>(weights);
  switch (p.NW) {
    case kWidths[0]: return launch<kWidths[0]>(mp, g, c, cg_cols, w, out, p, s);
    case kWidths[1]: return launch<kWidths[1]>(mp, g, c, cg_cols, w, out, p, s);
    default: return launch<kWidths[2]>(mp, g, c, cg_cols, w, out, p, s);
  }
}

}  // extern "C"
