// Gen-1 factored tensor-product contraction, per class and path, on
// Hopper's tensor cores, in float32 operands.
//
// Replaces diffdock_tpu/ops/pallas_tpconv.py:_kernel (the body of
// factored_tp_messages_pallas). Per receiver row r and output class c it
// computes, for each path p of c (input entry i_p, harmonic entry j_p):
//
//     W_p[k, i*d3+d] = sum_{j < d2_p} sh[r, k, sh_p + j] * CG[j, col_p + i*d3+d]
//     C[k, u*d3+d]   = sum_i xp[r, k, p, i, u] * W_p[k, i*d3+d]     (u in p's slice)
//     p_h[h, :] = sum_k h[r, k, h] * C[k, :],   p_b[:] = sum_k mw[r, k] * C[k, :]
//     out[r, o_c + w*d3+d] = (sum_h sum_u p_h[h, u*d3+d] * T_c[h, u, w]
//                             + sum_u p_b[u*d3+d] * b_c[u, w]) / sqrt(fan_c)
//
// with h (N, K, H) the hidden activations already scaled by mask*edge_weight
// and mw (N, K) that mask*edge_weight, T_c (H, fan, mul) and b_c (fan, mul)
// the class's last-layer weights and bias, all taken apart as the TPU kernel
// takes them. Each path's CG dot reads only its own harmonic slice (d2_p
// rows of the packed (max_d2, cols) CG matrix, from row 0). The TPU kernel
// writes d-major; this one writes the e3nn layout (w-major, d-minor)
// directly.
//
// The kernel, its design and what bounds it are in factored_tp.cuh (shared
// with gen 2): 3xTF32 tensor-core products, the coupling built per stage
// of 8 neighbours by the warp that multiplies it, deterministic partial
// sums. Gen 1's own parts: the hidden rows are read from h, with mw as
// row H of the A operand (p_b is P's row H); the CG weights of a column
// are its path's d2-term dot; the weight rows come from T_c, with b_c as
// row H. Rows past H+1 are not walked. Its bfloat16 mode (the casts to
// xp.dtype, :140-198) is factored_tp_bf16.cu.
//
// Plain C interface (no PyTorch headers), built with nvcc into a shared
// library and called through ctypes; see diffdock_tpu_torch/ops/factored_tp1.py.

#include "factored_tp.cuh"

namespace {

// class_rows: n_classes rows of 10 int32 (fan, d3, mul, out_off, col0,
// ncols, path0, n_paths, t_off, b_off); path_rows: n_paths rows of 7 int32
// (u_off, mul, d1, xp_start, col, sh_start, d2)
bool read_tables(const int* class_rows, int n_classes, const int* path_rows, int n_paths,
                 Tables& tb) {
  if (n_classes < 1 || n_classes > kMaxClasses || n_paths < 1 || n_paths > kMaxPaths)
    return false;
  tb = Tables{};
  tb.n_classes = n_classes;
  tb.n_paths = n_paths;
  for (int c = 0; c < n_classes; ++c) {
    const int* row = class_rows + 10 * c;
    tb.fan[c] = row[0];
    tb.d3[c] = row[1];
    tb.mul[c] = row[2];
    tb.out_off[c] = row[3];
    tb.col0[c] = row[4];
    tb.path0[c] = row[6];
    tb.np[c] = row[7];
    tb.w_off[c] = row[8];
    tb.b_off[c] = row[9];
  }
  for (int p = 0; p < n_paths; ++p) {
    const int* row = path_rows + 7 * p;
    tb.u_off[p] = row[0];
    tb.pmul[p] = row[1];
    tb.d1[p] = row[2];
    tb.xp_start[p] = row[3];
    tb.col[p] = row[4];
    tb.sh_start[p] = row[5];
    tb.d2[p] = row[6];
  }
  return true;
}

}  // namespace

extern "C" {

int factored_tp1_max_classes() { return kMaxClasses; }
int factored_tp1_max_paths() { return kMaxPaths; }
// the widest class: fan*d3 coupled columns, mul*d3 outputs
int factored_tp1_max_columns() { return kMaxColumns; }
int factored_tp1_max_outputs() { return kMaxOutputs; }

// The launch plan (see write_plan) into plan_out; returns the floats of
// scratch the call needs (0 when the kernel writes `out` directly), or -1
// if the tables are refused.
long long factored_tp1_plan(const int* class_rows, int n_classes, const int* path_rows,
                            int n_paths, long long n_rows, int XP, int J, int H, int CG_rows,
                            int CG, int D, int* plan_out) {
  Tables tb;
  if (!read_tables(class_rows, n_classes, path_rows, n_paths, tb) || H < 1 ||
      !tables_ok(tb, XP, J, CG_rows, CG, D, true))
    return -1;
  const Plan plan = make_plan(tb, H + 1, J, CG_rows);
  if (plan.mt == 0) return -1;
  write_plan(plan, tb, plan_out);
  return scratch_floats(plan, n_rows, D);
}

// scratch: the floats factored_tp1_plan asks for; every operand float32.
// Returns a cudaError_t.
int factored_tp1_forward(const float* xp, const float* sh, const float* h, const float* mw,
                         const float* cg, const float* t_all, const float* b_all, float* out,
                         float* scratch, const int* class_rows, int n_classes,
                         const int* path_rows, int n_paths, long long n_rows, int K, int XP,
                         int J, int H, int CG_rows, int CG, int D, void* stream) {
  Tables tb;
  if (!read_tables(class_rows, n_classes, path_rows, n_paths, tb) || K < 1 || H < 1 ||
      !tables_ok(tb, XP, J, CG_rows, CG, D, true))
    return cudaErrorInvalidValue;
  const Operands op = {xp, sh, h, mw, cg, t_all, b_all};
  Dims dm = {};
  dm.n_rows = n_rows;
  dm.K = K;
  dm.XP = XP;
  dm.J = J;
  dm.H = H;
  dm.Ha = H + 1;
  dm.He = H + 1;
  dm.cg_rows = CG_rows;
  dm.cg_cols = CG;
  dm.D = D;
  return launch<true>(op, out, scratch, tb, dm, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
