// Gen-3 fused factored tensor-product contraction, hand-written for Hopper.
//
// Replaces diffdock_tpu/ops/pallas_tpconv3.py:_kernel (the body of
// _forward_pallas). Per receiver row r and live output class c it computes
//
//     P_c[h, u*d3+d] = sum_k h_aug[r, k, h] * coupled[r, k, f_off_c + u*d3+d]
//     out[r, o_off_c + w*d3+d] = sum_h sum_u P_c[h, u*d3+d] * W_c[h, u, w]
//
// where h runs over the H hidden channels plus the bias row (h = H, whose
// activation is mask*edge_weight), and W_c (H+1, fan_c, mul_c) carries the
// class's last-layer weights and bias with 1/sqrt(fan_c) folded in. This is
// the TPU kernel's sum_h P[h] @ T3[h] with T3's block-diagonal d3-identity
// structure read from the compact W_c, so neither zero blocks nor the
// identity's zeros are ever multiplied.
//
// What bounds it on an H100: float32 FMAs. At the main path's shapes
// (K = 32 neighbours, H+1 = 145, fan*d3 <= 234) both contractions do
// 30-80 FLOP per byte they must read, above the card's fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte. The design therefore keeps P out
// of device memory (it lives in shared memory, one 16-row chunk of hidden
// channels at a time, the role VMEM plays on the TPU) and walks the hidden
// channels in a loop inside the block where the TPU walked its sequential
// grid:
//   - P phase: each thread owns one column j of P for all 16 hidden rows
//     of the chunk (16 register accumulators); h_aug's chunk is staged in
//     shared memory and read as float4 broadcasts, so every global load
//     of `coupled` feeds 16 FMAs;
//   - weight phase: the reduction over (h, u) is split into contiguous u
//     slices across the threads that would otherwise idle (a block has far
//     fewer outputs than threads), and the partial sums are added in a
//     fixed order, so the result does not depend on scheduling.
// Blocks own TR receivers and one class. TR = 4 shares each weight load
// among 4 rows; when that leaves too few blocks to fill the card (few
// receivers with many neighbours, as in the ligand-receivers cross block)
// TR = 1. Tensor cores are not used: the port keeps full float32 (no TF32),
// so wgmma/TMA and bf16 are a later step.
//
// Plain C interface (no PyTorch headers), built with nvcc into a shared
// library and called through ctypes; see diffdock_tpu_torch/ops/fused_tp3.py.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxClasses = 16;
constexpr int kHChunk = 16;
constexpr int kKChunk = 32;
constexpr int kThreads = 256;

struct ClassTable {
  int f_off[kMaxClasses];    // column offset of the class in `coupled`
  int fan[kMaxClasses];
  int d3[kMaxClasses];
  int mul[kMaxClasses];
  int out_off[kMaxClasses];  // column offset of the class in `out`
  long long w_off[kMaxClasses];  // element offset of the class's W_c
};

template <int TR>
__global__ void __launch_bounds__(kThreads)
fused_tp3_kernel(const float* __restrict__ h_aug,    // (n_rows, K, Ha)
                 const float* __restrict__ coupled,  // (n_rows, K, F)
                 const float* __restrict__ weights,  // packed W_c blocks
                 float* __restrict__ out,            // (n_rows, D)
                 ClassTable tbl, long long n_rows, int K, int Ha, int F,
                 int D, int fd_max) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int c = blockIdx.y;
  const int fan = tbl.fan[c];
  const int d3 = tbl.d3[c];
  const int mul = tbl.mul[c];
  const int fd = fan * d3;
  const int wd = mul * d3;
  const int f_off = tbl.f_off[c];
  const float* __restrict__ wc = weights + tbl.w_off[c];

  // shared memory: h chunk (16-byte aligned rows of kHChunk floats), the
  // P chunk, the weight phase's partial sums and the block's outputs
  float* h_s = smem;                                // [TR][kKChunk][kHChunk]
  float* p_s = h_s + TR * kKChunk * kHChunk;        // [TR][kHChunk][fd]
  float* part_s = p_s + TR * kHChunk * fd_max;      // [kThreads]
  float* acc_s = part_s + kThreads;                 // [TR * wd] <= [kThreads]

  const long long r0 = static_cast<long long>(blockIdx.x) * TR;
  const int tid = threadIdx.x;
  // the weight phase's outputs: n_out = TR * wd <= kThreads (checked by the
  // launcher), each reduced over n_split slices of u
  const int n_out = TR * wd;
  const int n_split = kThreads / n_out;
  if (tid < n_out) acc_s[tid] = 0.f;

  for (int h0 = 0; h0 < Ha; h0 += kHChunk) {
    const int hb = min(kHChunk, Ha - h0);

    // ---- P chunk: P[t][hh][j] = sum_k h_aug[r0+t, k, h0+hh] * coupled[r0+t, k, f_off+j]
    for (int base = 0; base < TR * fd; base += kThreads) {
      const int i = base + tid;
      const bool active = i < TR * fd;
      const int t = active ? i / fd : 0;
      const int j = active ? i - t * fd : 0;
      const long long r = r0 + t;
      const bool live = active && r < n_rows;
      float a[kHChunk];
#pragma unroll
      for (int hh = 0; hh < kHChunk; ++hh) a[hh] = 0.f;

      for (int k0 = 0; k0 < K; k0 += kKChunk) {
        const int kc = min(kKChunk, K - k0);
        __syncthreads();  // earlier readers of h_s, p_s and part_s are done
        for (int q = tid; q < TR * kKChunk * kHChunk; q += kThreads) {
          const int hh = q % kHChunk;
          const int kk = (q / kHChunk) % kKChunk;
          const int tt = q / (kHChunk * kKChunk);
          const long long rr = r0 + tt;
          float v = 0.f;
          if (rr < n_rows && kk < kc && hh < hb)
            v = __ldg(h_aug + (rr * K + k0 + kk) * Ha + h0 + hh);
          h_s[q] = v;
        }
        __syncthreads();
        if (live) {
          const float* __restrict__ cp = coupled + (r * K + k0) * F + f_off + j;
          const float4* h4 = reinterpret_cast<const float4*>(h_s + t * kKChunk * kHChunk);
          for (int kk = 0; kk < kc; ++kk) {
            const float cv = __ldg(cp + static_cast<long long>(kk) * F);
#pragma unroll
            for (int q4 = 0; q4 < kHChunk / 4; ++q4) {
              const float4 hv = h4[kk * (kHChunk / 4) + q4];
              a[4 * q4 + 0] = fmaf(hv.x, cv, a[4 * q4 + 0]);
              a[4 * q4 + 1] = fmaf(hv.y, cv, a[4 * q4 + 1]);
              a[4 * q4 + 2] = fmaf(hv.z, cv, a[4 * q4 + 2]);
              a[4 * q4 + 3] = fmaf(hv.w, cv, a[4 * q4 + 3]);
            }
          }
        }
      }
      if (active) {
#pragma unroll
        for (int hh = 0; hh < kHChunk; ++hh) p_s[(t * kHChunk + hh) * fd + j] = a[hh];
      }
    }
    __syncthreads();  // the P chunk is complete

    // ---- weights: out[t][w*d3+d] += sum_hh sum_u P[t][hh][u*d3+d] * W_c[h0+hh, u, w];
    // thread tid takes output tid % n_out and the tid / n_out-th contiguous
    // slice of u (unit stride, so the loop unrolls and its loads issue early)
    const int my_split = tid / n_out;
    if (my_split < n_split) {
      const int my_out = tid - my_split * n_out;
      const int bt = my_out / wd;
      const int bw = (my_out - bt * wd) / d3;
      const int bd = my_out - bt * wd - bw * d3;
      const int u0 = my_split * fan / n_split;
      const int u1 = (my_split + 1) * fan / n_split;
      float sum = 0.f;
      for (int hh = 0; hh < hb; ++hh) {
        const float* pr = p_s + (bt * kHChunk + hh) * fd + bd;
        const float* __restrict__ wr =
            wc + static_cast<long long>(h0 + hh) * fan * mul + bw;
        for (int u = u0; u < u1; ++u)
          sum = fmaf(pr[u * d3], __ldg(wr + static_cast<long long>(u) * mul), sum);
      }
      part_s[tid] = sum;
    }
    __syncthreads();
    if (tid < n_out) {
      float s = 0.f;
      for (int q = 0; q < n_split; ++q) s += part_s[q * n_out + tid];
      acc_s[tid] += s;
    }
  }

  if (tid < n_out) {
    const int t = tid / wd;
    const long long r = r0 + t;
    if (r < n_rows) out[r * D + tbl.out_off[c] + tid - t * wd] = acc_s[tid];
  }
}

size_t smem_bytes(int tile_rows, int fd_max) {
  return sizeof(float) *
         (static_cast<size_t>(tile_rows) * kKChunk * kHChunk +
          static_cast<size_t>(tile_rows) * kHChunk * fd_max + 2 * kThreads);
}

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

// Shared memory a block may opt in to on this device (227 KB on an H100).
size_t smem_limit() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      n = 232448;
  }
  return static_cast<size_t>(n);
}

// Rows per block for these shapes (4 or 1), or 0 if a class is too wide
// for one block (mul*d3 > kThreads, or its P chunk exceeds shared memory).
int tile_rows(long long n_rows, int n_classes, int wd_max, int fd_max) {
  if (wd_max > kThreads || smem_bytes(1, fd_max) > smem_limit()) return 0;
  const long long blocks4 = (n_rows + 3) / 4 * n_classes;
  return (4 * wd_max <= kThreads && smem_bytes(4, fd_max) <= smem_limit() &&
          blocks4 >= 4LL * sm_count()) ? 4 : 1;
}

template <int TR>
cudaError_t launch(const float* h_aug, const float* coupled, const float* weights,
                   float* out, const ClassTable& tbl, int n_classes, long long n_rows,
                   int K, int Ha, int F, int D, int fd_max, cudaStream_t stream) {
  const size_t smem = smem_bytes(TR, fd_max);
  cudaError_t err = cudaFuncSetAttribute(
      fused_tp3_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n_rows + TR - 1) / TR;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(n_classes));
  fused_tp3_kernel<TR><<<grid, kThreads, smem, stream>>>(
      h_aug, coupled, weights, out, tbl, n_rows, K, Ha, F, D, fd_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_tp3_max_classes() { return kMaxClasses; }
// the widest class a block takes: mul*d3 outputs, fan*d3 coupled columns
int fused_tp3_max_outputs() { return kThreads; }
int fused_tp3_max_columns() {
  return static_cast<int>((smem_limit() / sizeof(float) - kKChunk * kHChunk - 2 * kThreads) /
                          kHChunk);
}

// class_table: host array of n_classes rows of 6 int64 values
// (f_off, fan, d3, mul, out_off, w_off). Returns a cudaError_t.
int fused_tp3_forward(const float* h_aug, const float* coupled,
                      const float* weights, float* out,
                      const long long* class_table, int n_classes,
                      long long n_rows, int K, int Ha, int F, int D,
                      void* stream) {
  if (n_classes < 1 || n_classes > kMaxClasses || K < 1 || Ha < 1)
    return cudaErrorInvalidValue;
  ClassTable tbl = {};
  int fd_max = 0, wd_max = 0;
  for (int c = 0; c < n_classes; ++c) {
    const long long* row = class_table + 6 * c;
    tbl.f_off[c] = static_cast<int>(row[0]);
    tbl.fan[c] = static_cast<int>(row[1]);
    tbl.d3[c] = static_cast<int>(row[2]);
    tbl.mul[c] = static_cast<int>(row[3]);
    tbl.out_off[c] = static_cast<int>(row[4]);
    tbl.w_off[c] = row[5];
    fd_max = std::max(fd_max, tbl.fan[c] * tbl.d3[c]);
    wd_max = std::max(wd_max, tbl.mul[c] * tbl.d3[c]);
  }
  if (n_rows == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile_rows(n_rows, n_classes, wd_max, fd_max)) {
    case 4:
      return launch<4>(h_aug, coupled, weights, out, tbl, n_classes, n_rows, K, Ha, F, D,
                       fd_max, s);
    case 1:
      return launch<1>(h_aug, coupled, weights, out, tbl, n_classes, n_rows, K, Ha, F, D,
                       fd_max, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
