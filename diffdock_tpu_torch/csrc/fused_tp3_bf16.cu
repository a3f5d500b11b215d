// Gen-3 fused factored tensor-product contraction in bfloat16, for Hopper.
//
// Replaces diffdock_tpu/ops/pallas_tpconv3.py:_forward_pallas (:93, call
// :158) in its bfloat16 operand mode (`dt`, :99), and computes what the JAX
// model path computes with compute_dtype="bfloat16"
// (models/tpconv.py:_tp_message_reduced, its einsums). Per receiver row r
// and live output class c:
//
//     P_c[h, u*d3+d] = sum_k h_aug[r, k, h] * coupled[r, k, f_off_c + u*d3+d]
//     out[r, o_off_c + w*d3+d] = sum_h sum_u P_c[h, u*d3+d] * W_c[h, u, w]
//
// where h runs over the H hidden channels plus the bias row, whose
// activation is mw = mask*edge_weight. The kernel takes h (N, K, H) and mw
// (N, K) apart and forms the bias row itself. Products of bfloat16 values
// are exact and summed in float32; P is rounded to bfloat16 (to nearest
// even) after the whole neighbour sum; the weight product is summed in
// float32 into a float32 output.
//
// What bounds it on an H100: bytes. At the score model's rec<-lig block
// (3200 receivers, K = 32, H+1 = 145, 432 coupled columns) the two products
// are 18.9 GFLOP against 118 MB that must be read (coupled is 75 % of it):
// about 156 FLOP per byte, under the 295 at which the bfloat16 tensor cores
// become the limit. The design, point by point:
//   - no odd widths: h is read as (N, K, H) with its row stride a multiple
//     of 8 elements (the wrapper pads it where it is not), and the bias row
//     comes from mw through a separate n8 product, so every operand row is
//     16-byte aligned;
//   - TMA: a ring of stages in shared memory, each a 3-D box of `coupled`
//     (64 columns x KC neighbours of one receiver, starting on a 16-byte
//     aligned column: TMA faults on others, so a slice sits at offset
//     f_col % 8 in its box and is cut to fit), ceil(H/64) boxes of h, both
//     with the 128-byte swizzle, and a box of KC mw values, which the bias
//     product reads as its K-major operand. A TMA issue holds its thread
//     long, whatever the size, so stages are as wide as K and
//     shared memory allow (16 to 64 neighbours) and each slot has a producer
//     thread of its own. Out-of-bounds neighbours, receivers and columns
//     arrive as zeros; completion is counted by mbarriers; bfloat16 stays
//     bfloat16 in shared memory; a stage is released once its products are
//     done;
//   - the neighbour product on wgmma: a consumer warpgroup takes one
//     receiver's 64-column slice: M = 64 coupled columns (MN-major A), N =
//     the hidden rows (MN-major B; 32, 72, 144 or 256), depth = neighbours
//     in k16 steps, and an m64n8k16 product for the bias row. All hidden
//     rows live in one block, so each coupled byte is read from HBM once;
//   - blocks: R receivers (8-16) and every slice, or, with fewer receiver
//     groups than SMs, one slice of a group per block, so that groups x
//     slices blocks cover the 132 SMs; from K >= 256 (lig<-rec, lig<-atom)
//     the two consumer warpgroups split each receiver's neighbours in
//     halves, whose float32 partial sums are added in a fixed order (first
//     half + second half) before P is rounded;
//   - the weight product from bfloat16 P: P is stored in shared memory as
//     bfloat16 (depth index u*HP + h), and mma.sync m16n8k16 runs over it
//     with ldmatrix; W arrives through the same ring by 1-D bulk copies of
//     pre-swizzled 64-deep chunks, each chunk feeding every receiver of the
//     block, kept in L2 (evict-last) and read by different blocks in
//     different orders;
//   - determinism: every sum runs in a fixed order (each block's own slice
//     and chunk order, the weight product's four depth phases in order,
//     scratch parts in order in a second small kernel); no atomics.
// What holds it back, measured: the traffic from L2 into the SMs. Each
// block streams the weights of every slice (1.2 MB per 8 receivers in the
// score model) and re-reads h for each column slice, so the ring's few
// stages, each round trip taking 2-3 us, bound the blocks.
// Layouts (the wrapper packs them, diffdock_tpu_torch/ops/fused_tp3.py):
// weights per slice as n_sub chunks of [mul][64 depth], the 16-byte groups
// of row w stored at group (q ^ (w & 7)); depth k = u*HP + h with HP = He+2,
// He = H rounded up to even, hidden rows h < H, the bias at h = He.
//
// Plain C interface (no PyTorch headers); cuTensorMapEncodeTiled is reached
// through cudaGetDriverEntryPoint, so nothing but the runtime is linked.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "tp_hopper.cuh"
#include "tp_mma.cuh"

namespace {

using namespace tp_hopper;


constexpr int kMaxClasses = 16;
constexpr int kMaxSlices = 48;
constexpr int kThreads = 3 * 128;  // two consumer warpgroups, one producer warpgroup
constexpr int kConsumerThreads = 256;
constexpr int kTB = 4;              // weight-product tiles per warp per pass
constexpr int kSmemBudget = 232448;  // bytes a block may use (227 KB)
constexpr int kMaxOutputs = 256;    // mul*d3 of one class
constexpr int kMaxColumns = 4096;   // fan*d3 of one class
constexpr int kMaxHidden = 256;

// one column slice of a class: nu whole u groups, whose columns lie in the
// 64-column box that starts on the 8-aligned column at or below the first
struct Slice {
  int f_col;     // first column in `coupled`
  int off;       // f_col % 8: the slice's first row in the box
  int nu;        // u of this slice
  int d3;
  int mul;
  int out_off;   // first output column of the class
  int depth;     // weight-product depth: nu*HP rounded up to 64
  int part;      // index of the slice within its class
  int n_parts;   // slices of the class
  long long w_off;  // element offset of the slice's packed weight chunks
};

struct Plan {
  int n_slices, n_classes;
  Slice sl[kMaxSlices];
  int cls_out[kMaxClasses], cls_width[kMaxClasses], cls_parts[kMaxClasses];
  long long n_rows;
  int K, H, He, HP, D;
  int NW;       // wgmma N of the hidden product
  int R;        // receivers per block
  int whole;    // 1: every slice in each block; 0: one slice per block
  int k_parts;  // 1, or 2: the two consumer warpgroups split each receiver's neighbours
  int KC;       // neighbours per stage
  int n_kc;     // stages per receiver
  int h0;       // stages of the first half (k_parts = 2)
  int h_boxes;  // 64-column boxes of h per stage
  int S;        // ring slots
  int slot_bytes, h_off;
  int m_off, m_bytes;  // the mw values of each slot, apart from the ring
  int p_off, x_off, red_off, obuf_off, bar_off, smem_bytes;
  long long n_groups, n_blocks;
  int s_max;    // most slices of a class
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// a position in the ring of S slots: the slot, and the parity of the times
// the ring has wrapped (the mbarrier phase a wait names). A wait tells two
// phases apart by parity only, so each wait on a slot's `full` barrier must
// come from a waiter that has itself waited on the slot's previous stage, or
// that a named barrier holds behind it. The P items alternate between the
// two consumer warpgroups, so S must be even: with S odd, consecutive uses
// of a slot go to different warpgroups, and a warpgroup a lap ahead of the
// other passes its wait while the other's stage is still in flight (the
// phase before counts as complete), reads the stage early, releases the
// slot a phase early, and the ring hangs until the waits trap (cudaError
// 719). tests/test_torch_port_tp3_bf16_tiles.py searches every
// interleaving of this protocol for such a wait.
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
constexpr int kWidths[] = {32, 72, 144, 256};

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
  p.m_off = off;
  off += S * p.m_bytes;
  p.p_off = off;
  off += p_bytes(p, R);
  p.x_off = off;
  if (p.k_parts == 2) off += (p.NW / 2 + 4) * 128 * 4;
  p.red_off = off;
  off += red_bytes(p, R);
  p.obuf_off = off;
  off += round_up(R * p.D * 4, 16);
  p.bar_off = off;
  off += 2 * S * 8;
  return off + 1024;  // alignment of the dynamic shared memory base
}

// Fills the plan from the class table (rows f_off, fan, d3, mul, out_off,
// w_off) and the shapes; false if the kernel does not take them.
bool make_plan(Plan& p, const long long* table, int n_classes, long long n_rows, int K, int H,
               int D, int n_sm) {
  p = Plan{};
  if (n_classes < 1 || n_classes > kMaxClasses || K < 1 || H < 1 || H > kMaxHidden) return false;
  p.n_classes = n_classes;
  p.n_rows = n_rows;
  p.K = K;
  p.H = H;
  p.He = H + (H & 1);
  p.HP = p.He + 2;
  p.D = D;
  p.NW = 0;
  for (int w : kWidths)
    if (p.NW == 0 && w >= H) p.NW = w;
  long long w_off = 0;
  int max_mul = 0;
  for (int c = 0; c < n_classes; ++c) {
    const long long* row = table + 6 * c;
    const int f_off = static_cast<int>(row[0]), fan = static_cast<int>(row[1]);
    const int d3 = static_cast<int>(row[2]), mul = static_cast<int>(row[3]);
    if (fan < 1 || d3 < 1 || mul < 1 || d3 > 64 || mul * d3 > kMaxOutputs || fan * d3 > kMaxColumns)
      return false;
    // TMA boxes start on 16-byte aligned columns: a slice's columns plus
    // its offset from the aligned start fit 64. The fewest slices (as
    // greedy slicing gives them), balanced where the offsets allow
    auto cut = [&](int us, int* nus) {
      int n = 0;
      for (int u = 0; u < fan; ++n) {
        const int nu = std::min({us, (64 - (f_off + u * d3) % 8) / d3, fan - u});
        if (nus != nullptr) nus[n] = nu;
        u += nu;
      }
      return n;
    };
    const int n_greedy = cut(64, nullptr);
    const int us = cut((fan + n_greedy - 1) / n_greedy, nullptr) == n_greedy
                       ? (fan + n_greedy - 1) / n_greedy : 64;
    if (p.n_slices + n_greedy > kMaxSlices) return false;
    int nus[kMaxSlices];
    const int n = cut(us, nus);
    p.cls_out[c] = static_cast<int>(row[4]);
    p.cls_width[c] = mul * d3;
    p.cls_parts[c] = n;
    p.s_max = std::max(p.s_max, n);
    max_mul = std::max(max_mul, mul);
    for (int s = 0, u0 = 0; s < n; u0 += nus[s++]) {
      Slice& sl = p.sl[p.n_slices++];
      sl.nu = nus[s];
      sl.f_col = f_off + u0 * d3;
      sl.off = sl.f_col % 8;
      sl.d3 = d3;
      sl.mul = mul;
      sl.out_off = p.cls_out[c];
      sl.depth = round_up(sl.nu * p.HP, 64);
      sl.part = s;
      sl.n_parts = n;
      sl.w_off = w_off;
      w_off += static_cast<long long>(sl.depth) * mul;
    }
  }
  p.k_parts = K >= 256 ? 2 : 1;
  p.h_boxes = (p.NW + 63) / 64;
  // stages of KC neighbours
  auto stage = [&](int kc) {
    p.KC = kc;
    p.n_kc = (K + kc - 1) / kc;
    p.h0 = (p.n_kc + 1) / 2;
    p.h_off = kc * 128;
    p.m_bytes = round_up(2 * kc + 128, 128);  // mw, and the rows the bias product reads past it
    p.slot_bytes = round_up(std::max(p.h_off * (1 + p.h_boxes), max_mul * 128 + 2048), 1024);
  };
  // the most receivers (even, up to 16) that fit S slots, or 0
  auto most = [&](int S) {
    for (int r = 16; r >= 2; r -= 2)
      if (layout(p, r, S) <= kSmemBudget) return r;
    return 0;
  };
  // a TMA copy holds its issuing thread long whatever its size: the
  // widest stage (up to 64 neighbours, no wider than K needs; stages of 128
  // fault on the card) that leaves 4 slots and room for at least 8
  // receivers (2 when the warpgroups split long neighbour lists); else 16
  // or 32 neighbours and 2 slots. The ring is even (see RingPos): 3 slots
  // hung on the card now and then, at 4480 rows of 64 neighbours with every
  // slice in one block and at 768 rows of 96 with one slice per block
  const int r_min = p.k_parts == 2 ? 2 : 8;
  int R = 0, S = 0;
  for (int kc = K <= 16 ? 16 : K <= 32 ? 32 : 64; kc >= 16 && R == 0; kc /= 2) {
    stage(kc);
    const int r = most(4);
    if (r >= r_min) {
      R = r;
      S = 4;
    }
  }
  if (R == 0) {
    stage(K <= 16 ? 16 : 32);
    R = most(2);
    S = 2;
    if (R == 0) return false;
  }
  // few receivers: one slice per block; with long neighbour lists fewer
  // receivers per block, so that the blocks cover the SMs twice
  const int n_sl = p.n_slices;
  p.whole = (n_rows + R - 1) / R >= n_sm ? 1 : 0;
  if (!p.whole && p.k_parts == 2)
    while (R > 1 && (n_rows + R - 1) / R * n_sl < 2LL * n_sm) R /= 2;
  p.R = R;
  p.S = S;
  p.smem_bytes = layout(p, R, S);
  p.n_groups = (n_rows + R - 1) / R;
  p.n_blocks = p.whole ? p.n_groups : p.n_groups * n_sl;
  return true;
}

long long scratch_floats(const Plan& p) {
  return p.whole || p.s_max == 1 ? 0 : static_cast<long long>(p.s_max) * p.n_rows * p.D;
}

// ---- the kernel ---------------------------------------------------------

template <int NW>
__global__ void __launch_bounds__(kThreads, 1)
fused_tp3_bf16_kernel(const __grid_constant__ CUtensorMap map_c,
                      const __grid_constant__ CUtensorMap map_h,
                      const __grid_constant__ CUtensorMap map_m,
                      const __nv_bfloat16* __restrict__ weights, float* __restrict__ out,
                      float* __restrict__ scratch, const __grid_constant__ Plan p) {
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
      mbar_init(&full[s], 1);   // the producer's arrival with its bytes
      mbar_init(&empty[s], 8);  // eight consumer-warp arrivals
    }
    mbar_fence_init();
  }
  for (int e = tid; e < p.R * p.D; e += kThreads) obuf[e] = 0.f;
  __syncthreads();

  // block -> receiver group and its slices (one slice per block unless
  // whole; the slices of one group are neighbours in launch order)
  const long long bid = blockIdx.x;
  const long long grp = p.whole ? bid : bid / p.n_slices;
  const int s_begin = p.whole ? 0 : static_cast<int>(bid % p.n_slices);
  const int s_end = p.whole ? p.n_slices : s_begin + 1;
  const long long r0 = grp * p.R;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  // the blocks of a whole-mode launch start at different slices, and each
  // block streams a slice's weight chunks from its own starting chunk, so
  // that the blocks do not all read the same weights at once (every block
  // sums in its own fixed order)
  auto slice_at = [&](int sj) {
    return p.whole ? static_cast<int>((sj + bid) % p.n_slices) : sj;
  };
  // P items per slice: each consumer warpgroup's items alternate in the ring
  const int n_q = p.k_parts == 1 ? (p.R / 2) * p.n_kc : p.R * p.h0;
  const int n_pi = 2 * n_q;

  if (wg == 2) {
    // ---- producers: lane 0 of warp `pw` of the third warpgroup fills ring
    // slot pw (a TMA issue holds its thread long, and
    // threads of different warps issue in parallel) -------------------------
    const int pw = (tid - 256) >> 5;
    if (lane != 0 || pw >= S) return;
    if (pw == 0) {
      prefetch_tensormap(&map_c);
      prefetch_tensormap(&map_h);
      prefetch_tensormap(&map_m);
    }
    const uint32_t stage_tx = static_cast<uint32_t>(p.KC * 128 * (1 + p.h_boxes) + p.KC * 2);
    // coupled is read once; h once per slice, by neighbouring blocks; the
    // weights by every block: they stay in L2
    const uint64_t once = l2_evict_first(), shared = l2_evict_last();
    RingPos pos = {0, 0};  // the position of the current item
    for (int sj = s_begin; sj < s_end; ++sj) {
      const int si = slice_at(sj);
      const int f_col = p.sl[si].f_col - p.sl[si].off;  // 8-aligned box start
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
        mbar_arrive_expect_tx(&full[slot], stage_tx);
        tma_load_3d(st, &map_c, &full[slot], f_col, k0, r, once);
        for (int b = 0; b < p.h_boxes; ++b)
          tma_load_3d(st + p.h_off + b * p.KC * 128, &map_h, &full[slot], 64 * b, k0, r, shared);
        tma_load_2d(smem + p.m_off + slot * p.m_bytes, &map_m, &full[slot], k0, r);
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
  float acc[NW / 2];
  float accb[4];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) accb[i] = 0.f;
  const uint32_t h_lead = p.KC * 128, h_stride = 1024;  // 64-column boxes, 8-row groups
  const int k16 = p.KC / 16;

  RingPos pos = {0, 0};  // the position of the slice's first item
  for (int sj = s_begin; sj < s_end; ++sj) {
    const Slice sl = p.sl[slice_at(sj)];
    const int d3 = sl.d3, ncols = sl.nu * d3, prs = sl.depth + 8, nrow = p.R * d3;
    const int inv_d3 = (65536 + d3 - 1) / d3;
    // zero the depth padding of the slice's P rows
    {
      const int pad0 = sl.nu * p.HP, npad = sl.depth - pad0;
      for (int e = tid; e < nrow * npad; e += kConsumerThreads) {
        const int rw = e / npad;
        P[rw * prs + pad0 + e - rw * npad] = __float2bfloat16_rn(0.f);
      }
    }
    // round the accumulators to bfloat16 into the P rows of receiver r_local
    auto store_p = [&](int r_local) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * wi + g + 8 * half - sl.off;  // box row -> slice column
        if (j >= 0 && j < ncols) {
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
      __syncwarp();
      const uint32_t st = smem_addr(smem + slot * p.slot_bytes);
      const uint32_t mt = smem_addr(smem + p.m_off + slot * p.m_bytes);
      fence_operands(acc);
      fence_operands(accb);
      wgmma_fence();
      for (int t = 0; t < k16; ++t) {
        const int scale = first && t == 0 ? 0 : 1;
        const uint64_t da = make_desc(st + t * 2048, 1024, 1024, 1);
        const uint64_t db = make_desc(st + p.h_off + t * 2048, h_lead, h_stride, 1);
        // the bias operand (16 x 8, K-major, no swizzle) read from the KC mw
        // values: core matrices along K 16 bytes apart, so column 0 of core
        // matrix g is mw[8g..8g+7]; columns 1-7 read the values after it and
        // land in bias columns that are never stored
        const uint64_t dm = make_desc(mt + t * 32, 16, 128, 0);
        Wgmma<NW>::mma(acc, da, db, scale);
        WgmmaN8K::mma(accb, da, dm, scale);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(accb);
      __syncwarp();
      if (lane == 0) {  // a P item is released by the four warps of one warpgroup
        mbar_arrive(&empty[slot]);
        mbar_arrive(&empty[slot]);
      }
      if (last) {
        if (p.k_parts == 1) {
          store_p(r_local);
        } else {
          // first half (warpgroup 0) + second half (warpgroup 1), in order
          float* xb = reinterpret_cast<float*>(smem + p.x_off);
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
        const int wc = (wl + rot) % n_wl;  // this block's chunk order
        const int n_here = min(sps, n_sub - wc * sps);
        uint32_t wsub = smem_addr(smem + slot * p.slot_bytes);
        uint32_t pk = wc * sps * 128;  // bytes of depth before this load's first chunk
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
      // the four depth phases' partial sums, added in order
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
          obuf[rl * p.D + sl.out_off + w * d3 + d] += v;
        }
      }
      named_sync(4, kConsumerThreads);
    }
  }

  // ---- store ----------------------------------------------------------------
  if (p.whole) {
    for (int e = tid; e < p.R * p.D; e += kConsumerThreads) {
      const long long r = r0 + e / p.D;
      if (r < p.n_rows) out[r * p.D + e % p.D] = obuf[e];
    }
  } else {
    // the block's slice: its class's columns, to out or to its scratch part
    const Slice& sl = p.sl[s_begin];
    const int width = sl.mul * sl.d3;
    float* dst = sl.n_parts == 1 ? out : scratch + static_cast<long long>(sl.part) * p.n_rows * p.D;
    for (int e = tid; e < p.R * width; e += kConsumerThreads) {
      const int rl = e / width, c = e - rl * width;
      const long long r = r0 + rl;
      if (r < p.n_rows) dst[r * p.D + sl.out_off + c] = obuf[rl * p.D + sl.out_off + c];
    }
  }
}

// out[r, col] = the sum of the class's scratch parts, in order, for the
// classes cut into several slices (one slice per block)
__global__ void fused_tp3_bf16_reduce(const float* __restrict__ scratch, float* __restrict__ out,
                                      const __grid_constant__ Plan p) {
  const long long total = p.n_rows * p.D;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(e % p.D);
    int c = 0;
    while (c + 1 < p.n_classes && col >= p.cls_out[c + 1]) ++c;
    const int n = p.cls_parts[c];
    if (n < 2 || col >= p.cls_out[c] + p.cls_width[c]) continue;
    float sum = 0.f;
    for (int q = 0; q < n; ++q) sum += scratch[q * total + e];
    out[e] = sum;
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
// read in boxes of 64 columns x KC neighbours of one receiver
bool make_map(CUtensorMap* m, const void* base, long long width, long long K, long long N,
              long long stride, int KC) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(stride * 2),
                                 static_cast<cuuint64_t>(K * stride * 2)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(KC), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// mw (N, K) bfloat16 with rows `stride` elements apart, read KC neighbours
// of one receiver at a time
bool make_mw_map(CUtensorMap* m, const void* base, long long K, long long N, long long stride,
                 int KC) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride * 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(KC), 1};
  const cuuint32_t estr[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NW>
cudaError_t launch(const CUtensorMap& mc, const CUtensorMap& mh, const CUtensorMap& mm,
                   const __nv_bfloat16* weights, float* out, float* scratch, const Plan& p,
                   cudaStream_t stream) {
  auto kernel = fused_tp3_bf16_kernel<NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return err;
  if (p.n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(p.n_blocks), kThreads, p.smem_bytes, stream>>>(
      mc, mh, mm, weights, out, scratch, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || scratch_floats(p) == 0) return err;
  const long long total = p.n_rows * p.D;
  const long long blocks = std::min<long long>((total + 255) / 256, 32LL * sm_count());
  fused_tp3_bf16_reduce<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(scratch, out, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for the Python side to check against its own: writes
// (R, whole, k_parts, KC, S, NW, smem_bytes, n_blocks, scratch floats) to
// `info` (int64) and returns 0, or -1 if the kernel refuses the shapes.
// n_sm <= 0 takes the current device's SM count.
int fused_tp3_bf16_plan(const long long* class_table, int n_classes, long long n_rows, int K,
                        int H, int D, int n_sm, long long* info) {
  Plan p;
  if (!make_plan(p, class_table, n_classes, n_rows, K, H, D, n_sm > 0 ? n_sm : sm_count()))
    return -1;
  const long long v[9] = {p.R, p.whole, p.k_parts, p.KC, p.S, p.NW, p.smem_bytes, p.n_blocks,
                          scratch_floats(p)};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return 0;
}

// h (N, K, H) bfloat16 with rows `h_stride` elements apart (a multiple of
// 8), mw (N, K) bfloat16 with rows `mw_stride` apart (a multiple of 8),
// coupled (N, K, F) bfloat16 with rows `f_stride` apart (a multiple of 8),
// all three 16-byte aligned, weights packed as the header describes, out
// (N, D) float32, scratch the floats fused_tp3_bf16_plan asks for;
// class_table: host array of n_classes rows of 6 int64 values (f_off, fan,
// d3, mul, out_off, w_off). Returns a cudaError_t.
int fused_tp3_bf16_forward(const void* h, const void* mw, const void* coupled,
                           const void* weights, float* out, float* scratch,
                           const long long* class_table, int n_classes, long long n_rows, int K,
                           int H, long long h_stride, int F, long long f_stride,
                           long long mw_stride, int D, void* stream) {
  Plan p;
  auto aligned = [](const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; };
  if (!make_plan(p, class_table, n_classes, n_rows, K, H, D, sm_count()) || h_stride % 8 != 0 ||
      f_stride % 8 != 0 || mw_stride % 8 != 0 || h_stride < H || f_stride < F || mw_stride < K ||
      !aligned(h) || !aligned(coupled) || !aligned(mw) || !aligned(weights))
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  CUtensorMap mc, mh, mm;
  if (!make_map(&mc, coupled, F, K, n_rows, f_stride, p.KC) ||
      !make_map(&mh, h, H, K, n_rows, h_stride, p.KC) || !make_mw_map(&mm, mw, K, n_rows, mw_stride, p.KC))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(weights);
  switch (p.NW) {
    case kWidths[0]: return launch<kWidths[0]>(mc, mh, mm, w, out, scratch, p, s);
    case kWidths[1]: return launch<kWidths[1]>(mc, mh, mm, w, out, scratch, p, s);
    case kWidths[2]: return launch<kWidths[2]>(mc, mh, mm, w, out, scratch, p, s);
    default: return launch<kWidths[3]>(mc, mh, mm, w, out, scratch, p, s);
  }
}

}  // extern "C"
