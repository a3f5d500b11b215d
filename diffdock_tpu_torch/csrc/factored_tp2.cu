// Gen-2 factored tensor-product contraction with the coupling inside the
// kernel, on Hopper's tensor cores, in float32 operands.
//
// Replaces diffdock_tpu/ops/pallas_tpconv2.py:_kernel (the body of
// _forward_pallas). Per receiver row r and output class c it computes
//
//     W[k, col]      = sum_j sh[r, k, j] * CG[j, col]              (all of c's paths)
//     C[k, u*d3+d]   = sum_i xp[r, k, path(u), i, u] * W[k, col(path(u)) + i*d3 + d]
//     P[h, u*d3+d]   = sum_k h_aug[r, k, h] * C[k, u*d3+d]
//     out[r, o_c + w*d3+d] = sum_h sum_u P[h, u*d3+d] * T_c[h, u, w] / sqrt(fan_c)
//
// where h_aug (N, K, He) holds the hidden activations (already scaled by
// mask*edge_weight) with the mask*edge_weight vector as row H, so T_c's row
// H is the bias (the TPU kernel's trick); rows past H are zero padding and
// are not walked. The TPU kernel takes them transposed, (N, He, K); here
// each neighbour's hidden rows are contiguous, as the loads want. xp is
// the neighbour features packed [path][i][u], CG one (J, cols) matrix for
// every path, T_c (He, fan, mul).
// The TPU kernel stacks the d components on a leading axis and writes
// d-major; this one keeps (u, d) merged u-major and writes the e3nn layout
// (w-major, d-minor) directly.
//
// The kernel, its design and what bounds it are in factored_tp.cuh (shared
// with gen 1): 3xTF32 tensor-core products, the coupling built per stage
// of 8 neighbours by the warp that multiplies it, deterministic partial
// sums. Gen 2's own parts: the hidden rows come from h_aug, the CG weights
// of a column are the dense sh @ CG over the rows where that column is not
// zero, and the weight rows from one (He, fan, mul) block per class. Its
// bfloat16 mode (_forward_pallas's dt, :219) is factored_tp_bf16.cu.
//
// Plain C interface (no PyTorch headers), built with nvcc into a shared
// library and called through ctypes; see diffdock_tpu_torch/ops/factored_tp2.py.

#include "factored_tp.cuh"

namespace {

// class_rows: n_classes rows of 9 int32 (fan, d3, mul, out_off, col0,
// ncols, path0, n_paths, w_off); path_rows: n_paths rows of 5 int32
// (u_off, mul, d1, xp_start, col)
bool read_tables(const int* class_rows, int n_classes, const int* path_rows, int n_paths,
                 Tables& tb) {
  if (n_classes < 1 || n_classes > kMaxClasses || n_paths < 1 || n_paths > kMaxPaths)
    return false;
  tb = Tables{};
  tb.n_classes = n_classes;
  tb.n_paths = n_paths;
  for (int c = 0; c < n_classes; ++c) {
    const int* row = class_rows + 9 * c;
    tb.fan[c] = row[0];
    tb.d3[c] = row[1];
    tb.mul[c] = row[2];
    tb.out_off[c] = row[3];
    tb.col0[c] = row[4];
    tb.path0[c] = row[6];
    tb.np[c] = row[7];
    tb.w_off[c] = row[8];
  }
  for (int p = 0; p < n_paths; ++p) {
    const int* row = path_rows + 5 * p;
    tb.u_off[p] = row[0];
    tb.pmul[p] = row[1];
    tb.d1[p] = row[2];
    tb.xp_start[p] = row[3];
    tb.col[p] = row[4];
  }
  return true;
}

}  // namespace

extern "C" {

int factored_tp2_max_classes() { return kMaxClasses; }
int factored_tp2_max_paths() { return kMaxPaths; }
// the widest class: fan*d3 coupled columns, mul*d3 outputs
int factored_tp2_max_columns() { return kMaxColumns; }
int factored_tp2_max_outputs() { return kMaxOutputs; }

// The launch plan (see write_plan) into plan_out; returns the floats of
// scratch the call needs (0 when the kernel writes `out` directly), or -1
// if the tables are refused.
long long factored_tp2_plan(const int* class_rows, int n_classes, const int* path_rows,
                            int n_paths, long long n_rows, int XP, int J, int Ha, int CG,
                            int D, int* plan_out) {
  Tables tb;
  if (!read_tables(class_rows, n_classes, path_rows, n_paths, tb) || Ha < 1 ||
      !tables_ok(tb, XP, J, J, CG, D, false))
    return -1;
  const Plan plan = make_plan(tb, Ha, J, J);
  if (plan.mt == 0) return -1;
  write_plan(plan, tb, plan_out);
  return scratch_floats(plan, n_rows, D);
}

// scratch: the floats factored_tp2_plan asks for; every operand float32.
// Returns a cudaError_t.
int factored_tp2_forward(const float* xp, const float* sh, const float* h_aug, const float* cg,
                         const float* weights, float* out, float* scratch, const int* class_rows,
                         int n_classes, const int* path_rows, int n_paths, long long n_rows,
                         int K, int XP, int J, int He, int Ha, int CG, int D, void* stream) {
  Tables tb;
  if (!read_tables(class_rows, n_classes, path_rows, n_paths, tb) || K < 1 || Ha < 1 ||
      Ha > He || !tables_ok(tb, XP, J, J, CG, D, false))
    return cudaErrorInvalidValue;
  const Operands op = {xp, sh, h_aug, nullptr, cg, weights, nullptr};
  Dims dm = {};
  dm.n_rows = n_rows;
  dm.K = K;
  dm.XP = XP;
  dm.J = J;
  dm.H = Ha - 1;
  dm.Ha = Ha;
  dm.He = He;
  dm.cg_rows = J;
  dm.cg_cols = CG;
  dm.D = D;
  return launch<false>(op, out, scratch, tb, dm, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
