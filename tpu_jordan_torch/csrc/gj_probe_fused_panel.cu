// Batched Gauss–Jordan inverse of a pivot-candidate stack by b-wide panels
// with unnormalized steps and a deferred width-m update: the dispatch probe's
// panel body, as a hand-written kernel for Hopper (sm_90a).
//
// Replaces tpu_jordan/ops/pallas_block_inverse.py::_gj_fused_panel_kernel
// (reached through pallas_batched_block_inverse).  For each m x m block of a
// contiguous (nc, m, m) fp32 or fp64 stack: its inverse and a singular flag,
// raised when the input holds a non-finite value, when ‖block‖∞ < eps, or when
// a raw pivot has |piv| < eps·‖block‖∞.  The algebra is the JAX kernel's (and
// that of its plain twin, tpu_jordan_torch/ops/gj_fused_panel.py):
//
//   W = A (width m, no [A | I]).  For each panel K of b columns (k0 = K·b):
//     S = W[:, k0:k0+b], U = 0 (m, b).  For j in 0..b-1 (the micro-steps):
//       r   = the unused row with the largest |S[r, j]|, lowest row on ties;
//       piv = S[r, j] (recorded raw);  v = −S[:, j]/piv with v[r] = 0;
//       S  += v ⊗ S[r, :];  U += v ⊗ U[r, :];  U[:, j] = v;
//     W += U·P with P = the b raw pivot rows of W (R·W), and the panel's own
//     columns W[:, k0 + j] = e_{r_j} + U[:, j] (column r_j of T = I + U·R).
//   inv[a][c] = W[perm[a]][pinv[c]]·(1/piv_a)           (D⁻¹·M·W·M)
//
// The steps are E_j = I + v_j·e_{r_j}ᵀ: the pivot rows keep their raw scale
// and every row is divided once, at the end, so the candidate values a later
// step sees are those of normalized Gauss–Jordan and the pivot sequence is
// the same.
//
// Design.  Three kernels on the caller's stream, 2·m/b + 1 launches a call:
//   micro   one block per candidate, one thread per matrix row, one launch
//           per panel.  Thread i holds its row of the strip in registers:
//           with the b steps unrolled, S[i, c] is live only for c ≥ j and
//           U[i, c] only for c ≤ j, so the pair takes b values.  A step is a
//           warp-shuffle argmax; the warp's winner writes its (U | S) row and
//           its value to a per-warp slot in shared memory; ONE barrier; then
//           every thread reduces the warps' winners itself, reads the pivot
//           row from the winning slot and updates its own row (the slots are
//           double-buffered by step parity, which is what lets one barrier a
//           step suffice).  At the end the block stores U and copies the b
//           raw pivot rows to a scratch P.  Panel 0 reads the input stack
//           directly and takes ‖block‖∞ and the finite check.
//   update  one block per (64-column tile, 64-row tile, candidate): W += U·P
//           over all columns but the panel's, which take e_{r_j} + U[:, j].
//           Each element is read and written by one thread, so W is updated
//           in place (panel 0 reads the input and writes W).
//   store   one warp per output row: inv[a][:] gathers row perm[a] of W
//           through pinv (held in shared memory) and scales it by 1/piv_a.
// Why the split: a panel's b steps are one candidate's serial chain, but the
// deferred update (2·m²·b flops per candidate) is independent across
// (candidate, tile) and fills the card, where one block per candidate keeps
// most SMs idle at nc ≤ Nr.  W lives in a global scratch that the L2 cache
// holds (26 MB at nc = 22, m = 384).
//
// Accuracy.  W, S, U and the pivots are kept in fp64 for both input types,
// and the output is rounded once, at the store.  Each micro-step update is
// one fma an element; the fp32 body sums the deferred product in fp64; the
// fp64 body sums it in double-double (products split exactly by fma) and
// rounds once into W.  The JAX kernel rounds its fp32 dot at every term: its
// plain twin reads a per-block residual ‖B·inv − I‖∞ of 1.3–1.5× that of
// gj_probe.cu's rank-1 algebra on average, and up to 2.5× on single blocks.
//
// What bounds it.  The micro-steps: m serial steps of one barrier each on one
// SM per candidate, latency-bound far above the 2m³-flop bound.  The update
// moves W through L2 once per panel, m/b times in all.
//
// Arithmetic: FMAs outside the tensor cores (the JAX dots run at
// Precision.HIGHEST, so no TF32) and exact IEEE divisions: built by
// tpu_jordan_torch/_build.py without fast-math.
//
// Limits: m ≤ 1024 (one thread a row), b in {8, 16, 32} dividing m, m > b.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTile = 64;          // update: rows and columns per block
constexpr int kUpdateThreads = 256;
constexpr int kStoreWarps = 8;     // store: output rows per block

// The scratch, fp64 whatever the input type.
struct Work {
  double* W;       // (nc, m, m)
  double* U;       // (nc, m, b)
  double* P;       // (nc, b, m)
  double* piv;     // (nc, m): raw pivot of each step
  double* thresh;  // (nc): eps·‖block‖∞
  int* perm;       // (nc, m): pivot row of each step
  int* used;       // (nc, m): row already a pivot
};

size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

// Byte offsets of the regions, in Work's order; the last entry is the total.
void layout(int nc, int m, int b, size_t off[8]) {
  const size_t c = nc, mm = m, bb = b;
  const size_t sizes[7] = {c * mm * mm * 8, c * mm * bb * 8, c * bb * mm * 8,
                           c * mm * 8,      c * 8,           c * mm * 4,
                           c * mm * 4};
  off[0] = 0;
  for (int i = 0; i < 7; ++i) off[i + 1] = off[i] + align_up(sizes[i]);
}

Work carve(void* base, int nc, int m, int b) {
  size_t off[8];
  layout(nc, m, b, off);
  char* p = static_cast<char*>(base);
  return Work{reinterpret_cast<double*>(p + off[0]),
              reinterpret_cast<double*>(p + off[1]),
              reinterpret_cast<double*>(p + off[2]),
              reinterpret_cast<double*>(p + off[3]),
              reinterpret_cast<double*>(p + off[4]),
              reinterpret_cast<int*>(p + off[5]),
              reinterpret_cast<int*>(p + off[6])};
}

// Four consecutive values, 16-byte aligned, as vector accesses, widened to
// fp64 on the way in.
__device__ __forceinline__ void ld4(const float* p, double (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&x)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void st4(double* p, const double (&x)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
}

// (v, i) <- the better of (v, i) and (ov, oi): larger value, lower row on
// ties.  A total order, so a butterfly gives every lane one winner.
__device__ __forceinline__ void take_better(double& v, int& i, double ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(double& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(kFullMask, v, o);
    const int oi = __shfl_xor_sync(kFullMask, i, o);
    take_better(v, i, ov, oi);
  }
}

// One panel's B micro-steps for one candidate (block); thread i owns row i.
// Panel 0 reads the input (T); later panels read W.
template <typename T, int B, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
    gj_probe_fused_panel_micro(const T* __restrict__ blocks,
                               uint8_t* __restrict__ sing, Work w, int m,
                               double eps, int K) {
  __shared__ __align__(16) double s_row[2][32][B];  // each warp's winner
  __shared__ double s_val[2][32];
  __shared__ int s_idx[2][32];
  __shared__ int s_rows[B];
  __shared__ double s_red[32];

  const int i = threadIdx.x, nt = blockDim.x;
  const int lane = i & 31, warp = i >> 5, nwarps = nt >> 5;
  const bool active = i < m;
  const size_t cand = blockIdx.x, mm = size_t(m) * m;
  const int k0 = K * B;
  const T* a = blocks + cand * mm;
  const double* Wc = w.W + cand * mm;

  double thresh;
  bool used = false;
  bool bad = false;
  double S[B], U[B];
  if (K == 0) {
    // ‖block‖∞ and the finite check: one warp per row, coalesced.
    int nonfinite = 0;
    double row_max = 0.0;
    for (int r = warp; r < m; r += nwarps) {
      double s = 0.0;
      for (int c = lane; c < m; c += 32) {
        const double x = a[size_t(r) * m + c];
        nonfinite |= !isfinite(x);
        s += fabs(x);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
      row_max = fmax(row_max, s);
    }
    if (lane == 0) s_red[warp] = row_max;
    nonfinite = __syncthreads_or(nonfinite);
    double norm = 0.0;
    for (int k = 0; k < nwarps; ++k) norm = fmax(norm, s_red[k]);
    thresh = eps * norm;
    bad = nonfinite || norm < eps;
    if (i == 0) w.thresh[cand] = thresh;
#pragma unroll
    for (int c4 = 0; c4 < B / 4; ++c4) {
      double x[4] = {0.0, 0.0, 0.0, 0.0};
      if (active) ld4(a + size_t(i) * m + k0 + c4 * 4, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) S[c4 * 4 + e] = x[e];
    }
  } else {
    thresh = w.thresh[cand];
    if (active) used = w.used[cand * m + i] != 0;
#pragma unroll
    for (int c4 = 0; c4 < B / 4; ++c4) {
      double x[4] = {0.0, 0.0, 0.0, 0.0};
      if (active) ld4(Wc + size_t(i) * m + k0 + c4 * 4, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) S[c4 * 4 + e] = x[e];
    }
  }
#pragma unroll
  for (int c = 0; c < B; ++c) U[c] = 0.0;

#pragma unroll
  for (int j = 0; j < B; ++j) {
    // Pivot: the unused row with the largest |S[r, j]|, lowest row on
    // ties; NaN ranks highest, as in argmax.
    double best = -1.0;
    int bi = INT_MAX;
    if (active && !used) {
      double v = fabs(S[j]);
      if (isnan(v)) v = INFINITY;
      best = v;
      bi = i;
    }
    warp_argmax(best, bi);
    const int par = j & 1;
    if (lane == 0) {
      s_val[par][warp] = best;
      s_idx[par][warp] = bi;
    }
    if (bi == i) {
      // This warp's winner publishes its row: U where the step has passed,
      // S from the pivot column on.
      double* dst = s_row[par][warp];
#pragma unroll
      for (int c4 = 0; c4 < B / 4; ++c4) {
        double x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c4 * 4 + e;
          x[e] = c < j ? U[c] : S[c];
        }
        st4(dst + c4 * 4, x);
      }
    }
    __syncthreads();
    // Every thread reduces the warps' winners itself.
    best = -1.0;
    bi = INT_MAX;
    if (lane < nwarps) {
      best = s_val[par][lane];
      bi = s_idx[par][lane];
    }
    warp_argmax(best, bi);
    const int r = bi;
    const double* pivot_row = s_row[par][r >> 5];
    const double piv = pivot_row[j];
    const double safe = piv == 0.0 ? 1.0 : piv;
    bad |= fabs(piv) < thresh;
    const double v = i == r ? 0.0 : -(S[j] / safe);
    if (i == r) used = true;
    // S += v ⊗ S[r, :] past the pivot column, U += v ⊗ U[r, :] before it,
    // U[:, j] = v; four values of the pivot row at a time.
#pragma unroll
    for (int c4 = 0; c4 < B / 4; ++c4) {
      double x[4];
      ld4(pivot_row + c4 * 4, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c4 * 4 + e;
        if (c > j) S[c] = fma(x[e], v, S[c]);
        if (c < j) U[c] = fma(x[e], v, U[c]);
      }
    }
    U[j] = v;
    if (i == 0) {
      s_rows[j] = r;
      w.perm[cand * m + k0 + j] = r;
      w.piv[cand * m + k0 + j] = piv;
    }
  }

  // U for the update, the state for the next panel, the flag.
  if (active) {
    double* Ug = w.U + (cand * m + i) * B;
#pragma unroll
    for (int c4 = 0; c4 < B / 4; ++c4) {
      const double x[4] = {U[c4 * 4], U[c4 * 4 + 1], U[c4 * 4 + 2],
                           U[c4 * 4 + 3]};
      st4(Ug + c4 * 4, x);
    }
    w.used[cand * m + i] = used;
  }
  if (i == 0) {
    if (K == 0)
      sing[cand] = bad ? 1 : 0;
    else if (bad)
      sing[cand] = 1;
  }
  __syncthreads();  // s_rows
  // The panel's raw pivot rows (W is not yet updated): P = R·W.
  double* Pg = w.P + cand * B * m;
  const int quads = m / 4;
  for (int e = i; e < B * quads; e += nt) {
    const int jj = e / quads, c = (e % quads) * 4;
    const size_t at = size_t(s_rows[jj]) * m + c;
    double x[4];
    if (K == 0)
      ld4(a + at, x);
    else
      ld4(Wc + at, x);
    st4(Pg + size_t(jj) * m + c, x);
  }
}

// s + lo += x·y with the product split exactly (fma) and the sum carried by
// TwoSum: a double-double accumulation.
__device__ __forceinline__ void dd_fma(double x, double y, double& s,
                                       double& lo) {
  const double p = x * y;
  const double pe = fma(x, y, -p);
  const double t = s + p;
  const double bv = t - s;
  const double se = (s - (t - bv)) + (p - bv);
  s = t;
  lo += se + pe;
}

// W += U·P for one candidate (grid z), one 64-column tile (grid x) and one
// 64-row tile (grid y); the panel's columns take e_{r_j} + U[:, j].  Thread
// (tx, ty) owns rows ty·4 .. ty·4+3 and columns tx·4 .. tx·4+3 of the tile.
// kDD: sum in double-double (the fp64 body), else in fp64.
template <typename T, int B, bool kDD>
__global__ void __launch_bounds__(kUpdateThreads)
    gj_probe_fused_panel_update(const T* __restrict__ blocks, Work w, int m,
                                int K) {
  __shared__ __align__(16) double Us[B][kTile];  // U tile, transposed
  __shared__ __align__(16) double Ps[B][kTile];
  __shared__ int s_rows[B];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t cand = blockIdx.z, mm = size_t(m) * m;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile, k0 = K * B;
  double* dst = w.W + cand * mm;
  const double* Ug = w.U + cand * m * B;
  const double* Pg = w.P + cand * B * m;
  for (int e = tid; e < kTile * B; e += kUpdateThreads) {
    const int rr = e / B, k = e % B;
    Us[k][rr] = r0 + rr < m ? Ug[size_t(r0 + rr) * B + k] : 0.0;
  }
  for (int e = tid; e < kTile * B; e += kUpdateThreads) {
    const int k = e / kTile, cc = e % kTile;
    Ps[k][cc] = c0 + cc < m ? Pg[size_t(k) * m + c0 + cc] : 0.0;
  }
  if (tid < B) s_rows[tid] = w.perm[cand * m + k0 + tid];
  __syncthreads();
  const int c = c0 + tx * 4;
  if (c >= m) return;  // m % 4 == 0: a group of four is all in or all out
  if (c >= k0 && c < k0 + B) {
    // The panel's freed columns: T[:, r_j] = e_{r_j} + U[:, j].
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + ty * 4 + q;
      if (r >= m) break;
      double x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = c + e - k0;
        x[e] = Us[jj][ty * 4 + q] + (r == s_rows[jj] ? 1.0 : 0.0);
      }
      st4(dst + size_t(r) * m + c, x);
    }
    return;
  }
  // The deferred product, summed from the old W and rounded once into W.
  double acc[4][4], lo[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + ty * 4 + q;
    double x[4] = {0.0, 0.0, 0.0, 0.0};
    if (r < m) {
      if (K == 0)
        ld4(blocks + cand * mm + size_t(r) * m + c, x);
      else
        ld4(dst + size_t(r) * m + c, x);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[q][e] = x[e];
      lo[q][e] = 0.0;
    }
  }
#pragma unroll 4
  for (int k = 0; k < B; ++k) {
    double u[4], p[4];
    ld4(&Us[k][ty * 4], u);
    ld4(&Ps[k][tx * 4], p);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kDD)
          dd_fma(u[q], p[e], acc[q][e], lo[q][e]);
        else
          acc[q][e] = fma(u[q], p[e], acc[q][e]);
      }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + ty * 4 + q;
    if (r >= m) break;
    const double x[4] = {acc[q][0] + lo[q][0], acc[q][1] + lo[q][1],
                         acc[q][2] + lo[q][2], acc[q][3] + lo[q][3]};
    st4(dst + size_t(r) * m + c, x);
  }
}

// inv[a][c] = W[perm[a]][pinv[c]]·(1/piv_a), the JAX kernel's reciprocal:
// one warp per output row a, kStoreWarps rows per block (grid x), one
// candidate per grid y.
template <typename T>
__global__ void __launch_bounds__(kStoreWarps * 32)
    gj_probe_fused_panel_store(T* __restrict__ inv, Work w, int m) {
  extern __shared__ int s_pinv[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cand = blockIdx.y, mm = size_t(m) * m;
  const int* perm = w.perm + cand * m;
  for (int k = tid; k < m; k += kStoreWarps * 32) s_pinv[perm[k]] = k;
  __syncthreads();
  const int a = blockIdx.x * kStoreWarps + warp;
  if (a >= m) return;
  const double piv = w.piv[cand * m + a];
  const double rcp = 1.0 / (piv == 0.0 ? 1.0 : piv);
  const double* src = w.W + cand * mm + size_t(perm[a]) * m;
  T* out = inv + cand * mm + size_t(a) * m;
  for (int c = lane; c < m; c += 32) out[c] = T(src[s_pinv[c]] * rcp);
}

template <typename T, int B, int kMaxThreads>
int launch(const T* blocks, T* inv, uint8_t* sing, void* work, int nc, int m,
           double eps, cudaStream_t stream) {
  constexpr bool kDD = sizeof(T) == 8;
  const Work w = carve(work, nc, m, B);
  const int threads = (m + 31) / 32 * 32;
  const int tiles = (m + kTile - 1) / kTile;
  cudaError_t err;
  for (int K = 0; K < m / B; ++K) {
    gj_probe_fused_panel_micro<T, B, kMaxThreads>
        <<<nc, threads, 0, stream>>>(blocks, sing, w, m, eps, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    gj_probe_fused_panel_update<T, B, kDD>
        <<<dim3(tiles, tiles, nc), kUpdateThreads, 0, stream>>>(blocks, w, m,
                                                                 K);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  gj_probe_fused_panel_store<T>
      <<<dim3((m + kStoreWarps - 1) / kStoreWarps, nc), kStoreWarps * 32,
         m * sizeof(int), stream>>>(inv, w, m);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* blocks, void* inv, void* sing, void* work, int nc,
             int m, int b, double eps, void* stream) {
  if (nc <= 0 || m <= b || m > 1024 || m % b)
    return int(cudaErrorInvalidValue);
  const T* in = static_cast<const T*>(blocks);
  T* out = static_cast<T*>(inv);
  uint8_t* flags = static_cast<uint8_t*>(sing);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = m > 512;
  switch (b) {
    case 32:
      return wide ? launch<T, 32, 1024>(in, out, flags, work, nc, m, eps, s)
                  : launch<T, 32, 512>(in, out, flags, work, nc, m, eps, s);
    case 16:
      return wide ? launch<T, 16, 1024>(in, out, flags, work, nc, m, eps, s)
                  : launch<T, 16, 512>(in, out, flags, work, nc, m, eps, s);
    case 8:
      return wide ? launch<T, 8, 1024>(in, out, flags, work, nc, m, eps, s)
                  : launch<T, 8, 512>(in, out, flags, work, nc, m, eps, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Bytes of the scratch a launch at (nc, m, b) needs.
size_t gj_probe_fused_panel_work_bytes(int nc, int m, int b) {
  size_t off[8];
  layout(nc, m, b, off);
  return off[7];
}

// Launch the panel probe on `stream`: blocks and inv are contiguous
// (nc, m, m) and 16-byte aligned, sing is (nc,) uint8, work holds
// gj_probe_fused_panel_work_bytes(nc, m, b) bytes.  b is the panel width: 32,
// 16 or 8, dividing m, with b < m <= 1024.  Returns the first CUDA error code
// of the launches (0 on success).
int gj_probe_fused_panel_f32(const void* blocks, void* inv, void* sing,
                             void* work, int nc, int m, int b, float eps,
                             void* stream) {
  return dispatch<float>(blocks, inv, sing, work, nc, m, b, eps, stream);
}

int gj_probe_fused_panel_f64(const void* blocks, void* inv, void* sing,
                             void* work, int nc, int m, int b, double eps,
                             void* stream) {
  return dispatch<double>(blocks, inv, sing, work, nc, m, b, eps, stream);
}

}  // extern "C"
