// Gen-2 factored tensor-product contraction with the coupling inside the
// kernel, hand-written for Hopper.
//
// Replaces diffdock_tpu/ops/pallas_tpconv2.py:_kernel (the body of
// _forward_pallas). Per receiver row r and output class c it computes
//
//     W[k, col]      = sum_j sh[r, k, j] * CG[j, col]              (all of c's paths)
//     C[k, u*d3+d]   = sum_i xp[r, k, path(u), i, u] * W[k, col(path(u)) + i*d3 + d]
//     P[h, u*d3+d]   = sum_k ht[r, h, k] * C[k, u*d3+d]
//     out[r, o_c + w*d3+d] = sum_h sum_u P[h, u*d3+d] * T_c[h, u, w] / sqrt(fan_c)
//
// where ht holds the hidden activations (already scaled by mask*edge_weight)
// transposed to (N, He, K), with the mask*edge_weight vector as row H, so
// T_c's row H is the bias (the TPU kernel's trick); rows past H are zero
// padding and are not walked. xp is the neighbour features packed
// [path][i][u], CG one (J, cols) matrix for every path, T_c (He, fan, mul).
// The TPU kernel stacks the d components on a leading axis and writes
// d-major; this one keeps (u, d) merged u-major and writes the e3nn layout
// (w-major, d-minor) directly.
//
// What bounds it on an H100: float32 FMAs, as for gen 3: at the main
// path's shapes the neighbour reduction P does ~K*(H+1)*fan*d3 FMAs per
// receiver and class against ~K*(XP+J+H+1) floats read. The coupling
// itself (sh @ CG and the d1-term sums) is cheap next to P, so the design
// recomputes it where that saves shared memory:
//   - P does not fit a block (He x fan*d3 = 160 x 234 floats = 150 KB per
//     receiver and class, and the coupled segment K x fan*d3 is 300 KB at
//     K = 320), so the block walks the hidden rows in chunks of 16 and,
//     inside each, the neighbours in chunks of 32: per neighbour chunk it
//     builds W and the coupled chunk C (32 x fan*d3) in shared memory, and
//     each thread accumulates a 16-row column of P in registers. With
//     more than one neighbour chunk the coupling is rebuilt once per
//     hidden chunk (10 times at H+1 = 145); with K <= 32 it is built once
//     and stays in shared memory for every hidden chunk;
//   - the weight phase is fused_tp3.cu's: each output (w, d) is reduced
//     over (h, u) by the threads that would otherwise idle, in contiguous
//     u slices, and the partial sums are added in a fixed order, so the
//     result does not depend on scheduling.
// One block per receiver and class; blocks own whole outputs, so there are
// no atomics. Full float32, no tensor cores: a simple kernel that is right.
//
// Plain C interface (no PyTorch headers), built with nvcc into a shared
// library and called through ctypes; see diffdock_tpu_torch/ops/factored_tp2.py.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxClasses = 16;
constexpr int kMaxPaths = 64;
constexpr int kHChunk = 16;
constexpr int kKChunk = 32;
constexpr int kThreads = 256;
constexpr int kMaxCols = 4;  // coupled columns per thread: fan*d3 <= 1024

// per class: fan, d3, mul, out_off, col0, ncols, path0, n_paths, w_off
// per path:  u_off, mul, d1, xp_start, col (relative to the class's col0)
struct Tables {
  int cls[kMaxClasses][9];
  int path[kMaxPaths][5];
};

__global__ void __launch_bounds__(kThreads)
factored_tp2_kernel(const float* __restrict__ xp,       // (n_rows, K, XP)
                    const float* __restrict__ sh,       // (n_rows, K, J)
                    const float* __restrict__ ht,       // (n_rows, He, K)
                    const float* __restrict__ cg,       // (J, CG)
                    const float* __restrict__ weights,  // packed (He, fan, mul) per class
                    float* __restrict__ out,            // (n_rows, D)
                    Tables tb, int K, int XP, int J, int He, int Ha, int CG,
                    int D, int fd_max, int nc_max) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int path_s[kMaxPaths][5];

  const long long r = blockIdx.x;
  const int c = blockIdx.y;
  const int fan = tb.cls[c][0];
  const int d3 = tb.cls[c][1];
  const int mul = tb.cls[c][2];
  const int out_off = tb.cls[c][3];
  const int col0 = tb.cls[c][4];
  const int ncols = tb.cls[c][5];
  const int p0 = tb.cls[c][6];
  const int n_paths = tb.cls[c][7];
  const float* __restrict__ wc = weights + tb.cls[c][8];
  const int fd = fan * d3;
  const int wd = mul * d3;
  const int tid = threadIdx.x;

  // shared memory: the hidden chunk (16-byte aligned rows of kHChunk
  // floats), the harmonics, CG weights and coupled columns of one
  // neighbour chunk, the P chunk, the weight phase's partial sums and the
  // block's outputs
  float* h_s = smem;                          // [kKChunk][kHChunk]
  float* sh_s = h_s + kKChunk * kHChunk;      // [kKChunk][J]
  float* w_s = sh_s + kKChunk * J;            // [kKChunk][nc_max]
  float* c_s = w_s + kKChunk * nc_max;        // [kKChunk][fd_max]
  float* p_s = c_s + kKChunk * fd_max;        // [kHChunk][fd_max]
  float* part_s = p_s + kHChunk * fd_max;     // [kThreads]
  float* acc_s = part_s + kThreads;           // [wd] <= [kThreads]

  for (int q = tid; q < n_paths * 5; q += kThreads) path_s[q / 5][q % 5] = tb.path[p0 + q / 5][q % 5];
  if (tid < wd) acc_s[tid] = 0.f;
  const int n_split = kThreads / wd;

  const float* __restrict__ xr = xp + r * K * XP;
  const float* __restrict__ shr = sh + r * K * J;
  const float* __restrict__ htr = ht + r * He * K;

  for (int h0 = 0; h0 < Ha; h0 += kHChunk) {
    const int hb = min(kHChunk, Ha - h0);
    float a[kMaxCols][kHChunk];
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q)
#pragma unroll
      for (int hh = 0; hh < kHChunk; ++hh) a[q][hh] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kKChunk) {
      const int kc = min(kKChunk, K - k0);
      // with one neighbour chunk (K <= kKChunk) the CG weights and coupled
      // columns built for the first hidden chunk stay valid for the others
      const bool couple = h0 == 0 || K > kKChunk;
      __syncthreads();  // earlier readers of every buffer are done
      if (couple)
        for (int q = tid; q < kc * J; q += kThreads)
          sh_s[q] = __ldg(shr + static_cast<long long>(k0) * J + q);
      for (int q = tid; q < kKChunk * kHChunk; q += kThreads) {
        const int kk = q % kKChunk;  // neighbours fastest: ht rows are contiguous in k
        const int hh = q / kKChunk;
        float v = 0.f;
        if (kk < kc && hh < hb) v = __ldg(htr + static_cast<long long>(h0 + hh) * K + k0 + kk);
        h_s[kk * kHChunk + hh] = v;
      }
      __syncthreads();

      if (couple) {
        // CG weights of the class's columns: W[kk][cl] = sum_j sh[kk][j] * CG[j][col0 + cl]
        for (int q = tid; q < kc * ncols; q += kThreads) {
          const int kk = q / ncols;
          const int cl = q - kk * ncols;
          float s = 0.f;
          for (int j = 0; j < J; ++j)
            s = fmaf(sh_s[kk * J + j], __ldg(cg + static_cast<long long>(j) * CG + col0 + cl), s);
          w_s[kk * nc_max + cl] = s;
        }
        __syncthreads();

        // coupled columns: C[kk][u*d3+d] = sum_i x[k, path, i, u] * W[kk][col + i*d3 + d]
        for (int q = tid; q < kc * fd; q += kThreads) {
          const int kk = q / fd;
          const int jj = q - kk * fd;
          const int u = jj / d3;
          const int d = jj - u * d3;
          int p = 0;
          while (p < n_paths - 1 && u >= path_s[p + 1][0]) ++p;
          const int pm = path_s[p][1];
          const int d1 = path_s[p][2];
          const float* __restrict__ xk =
              xr + static_cast<long long>(k0 + kk) * XP + path_s[p][3] + (u - path_s[p][0]);
          const float* wk = w_s + kk * nc_max + path_s[p][4] + d;
          float s = 0.f;
          for (int i = 0; i < d1; ++i) s = fmaf(__ldg(xk + i * pm), wk[i * d3], s);
          c_s[kk * fd_max + jj] = s;
        }
      }
      __syncthreads();

      // P chunk: thread owns columns j = tid + q*kThreads, 16 hidden rows each
      const float4* h4 = reinterpret_cast<const float4*>(h_s);
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q) {
        const int j = tid + q * kThreads;
        if (j < fd) {
          for (int kk = 0; kk < kc; ++kk) {
            const float cv = c_s[kk * fd_max + j];
#pragma unroll
            for (int q4 = 0; q4 < kHChunk / 4; ++q4) {
              const float4 hv = h4[kk * (kHChunk / 4) + q4];
              a[q][4 * q4 + 0] = fmaf(hv.x, cv, a[q][4 * q4 + 0]);
              a[q][4 * q4 + 1] = fmaf(hv.y, cv, a[q][4 * q4 + 1]);
              a[q][4 * q4 + 2] = fmaf(hv.z, cv, a[q][4 * q4 + 2]);
              a[q][4 * q4 + 3] = fmaf(hv.w, cv, a[q][4 * q4 + 3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q) {
      const int j = tid + q * kThreads;
      if (j < fd) {
#pragma unroll
        for (int hh = 0; hh < kHChunk; ++hh) p_s[hh * fd_max + j] = a[q][hh];
      }
    }
    __syncthreads();  // the P chunk is complete

    // ---- weights: out[w*d3+d] += sum_hh sum_u P[hh][u*d3+d] * T_c[h0+hh, u, w]; thread
    // tid takes output tid % wd and the tid / wd-th contiguous slice of u
    const int my_split = tid / wd;
    if (my_split < n_split) {
      const int my_out = tid - my_split * wd;
      const int bw = my_out / d3;
      const int bd = my_out - bw * d3;
      const int u0 = my_split * fan / n_split;
      const int u1 = (my_split + 1) * fan / n_split;
      float sum = 0.f;
      for (int hh = 0; hh < hb; ++hh) {
        const float* pr = p_s + hh * fd_max + bd;
        const float* __restrict__ wr = wc + static_cast<long long>(h0 + hh) * fan * mul + bw;
        for (int u = u0; u < u1; ++u)
          sum = fmaf(pr[u * d3], __ldg(wr + static_cast<long long>(u) * mul), sum);
      }
      part_s[tid] = sum;
    }
    __syncthreads();
    if (tid < wd) {
      float s = 0.f;
      for (int q = 0; q < n_split; ++q) s += part_s[q * wd + tid];
      acc_s[tid] += s;
    }
  }

  if (tid < wd) out[r * D + out_off + tid] = acc_s[tid] * (1.0f / sqrtf(static_cast<float>(fan)));
}

size_t smem_bytes(int J, int nc_max, int fd_max) {
  return sizeof(float) * (static_cast<size_t>(kKChunk) * (kHChunk + J + nc_max + fd_max) +
                          static_cast<size_t>(kHChunk) * fd_max + 2 * kThreads);
}

}  // namespace

extern "C" {

int factored_tp2_max_classes() { return kMaxClasses; }
int factored_tp2_max_paths() { return kMaxPaths; }
int factored_tp2_max_columns() { return kMaxCols * kThreads; }
int factored_tp2_max_outputs() { return kThreads; }

// class_rows: host array of n_classes rows of 9 int32, path_rows of n_paths
// rows of 5 int32 (see Tables). Returns a cudaError_t.
int factored_tp2_forward(const float* xp, const float* sh, const float* ht, const float* cg,
                         const float* weights, float* out, const int* class_rows,
                         int n_classes, const int* path_rows, int n_paths, long long n_rows,
                         int K, int XP, int J, int He, int Ha, int CG, int D, void* stream) {
  if (n_classes < 1 || n_classes > kMaxClasses || n_paths < 1 || n_paths > kMaxPaths || K < 1 ||
      Ha < 1 || Ha > He)
    return cudaErrorInvalidValue;
  Tables tb = {};
  int fd_max = 0, nc_max = 0;
  for (int c = 0; c < n_classes; ++c) {
    for (int q = 0; q < 9; ++q) tb.cls[c][q] = class_rows[9 * c + q];
    const int fd = tb.cls[c][0] * tb.cls[c][1];
    const int wd = tb.cls[c][2] * tb.cls[c][1];
    if (tb.cls[c][0] < 1 || fd > kMaxCols * kThreads || wd < 1 || wd > kThreads)
      return cudaErrorInvalidValue;
    fd_max = std::max(fd_max, fd);
    nc_max = std::max(nc_max, tb.cls[c][5]);
  }
  for (int p = 0; p < n_paths; ++p)
    for (int q = 0; q < 5; ++q) tb.path[p][q] = path_rows[5 * p + q];
  if (n_rows == 0) return cudaSuccess;
  if (n_rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(J, nc_max, fd_max);
  cudaError_t err = cudaFuncSetAttribute(
      factored_tp2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(n_rows), static_cast<unsigned>(n_classes));
  factored_tp2_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, sh, ht, cg, weights, out, tb, K, XP, J, He, Ha, CG, D, fd_max, nc_max);
  return cudaGetLastError();
}

}  // extern "C"
