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
// Design.  Five kernels:
//   micro   one block per candidate, one thread per matrix row, one launch
//           per panel.  Thread i holds its row of the strip in registers:
//           with the b steps unrolled, S[i, c] is live only for c ≥ j and
//           U[i, c] only for c ≤ j, so the pair takes b values.  A step is a
//           warp-shuffle argmax; the warp's winner writes its (U | S) row and
//           its value to a per-warp slot in shared memory; ONE barrier; then
//           every thread reduces the warps' winners itself, reads the pivot
//           row from the winning slot and updates its own row (the slots are
//           double-buffered by step parity, which is what lets one barrier a
//           step suffice).  At the end the block stores U (double-buffered
//           by panel parity) and, on the serial schedule, copies the b raw
//           pivot rows to a scratch P.  Panel 0 reads the input stack
//           directly and takes ‖block‖∞ and the finite check.
//   update  one block per (64-column tile, 64-row tile, candidate): W += U·P,
//           the panel's own columns taking e_{r_j} + U[:, j].  Each element
//           is read and written by one thread, so W is updated in place
//           (panel 0 reads the input and writes W).
//   strip   the look-ahead schedule's part of the update that the next
//           panel's micro-steps read (b columns), in tiles of 16 rows (b =
//           32) so that it spreads over the card: the same sums.
//   gather  one block per (pivot row, candidate): P = R·W, the look-ahead
//           schedule's copy of the raw pivot rows.
//   store   one warp per output row: inv[a][:] gathers row perm[a] of W
//           through pinv (held in shared memory) and scales it by 1/piv_a.
// Why the split: a panel's b steps are one candidate's serial chain, but the
// deferred update (2·m²·b flops per candidate) is independent across
// (candidate, tile) and fills the card, where one block per candidate keeps
// most SMs idle at nc ≤ Nr.  W lives in a global scratch that the L2 cache
// holds (26 MB at nc = 22, m = 384).
//
// Two schedules, the same arithmetic.  Serial (2·m/b + 1 launches a call):
// micro K, update K, micro K + 1, ...  Look-ahead (4·m/b launches), where
// the micro grid leaves most SMs idle (ops/gj_fused_panel.py's
// panel_lookahead): micro K + 1 reads only strip K + 1 of W, so update K is
// split.  The strip goes first, alone; then micro K + 1 runs on the caller's
// stream beside the rest of update K on a side stream; after the join,
// gather K + 1 copies P.  Micro K + 1 follows the strip in stream order and
// the update waits on an event, so the micro grid's few blocks are placed
// first (with the two swapped, the profiler showed the micro-steps starting
// up to 28 µs after the update had taken the SMs).  U is double-buffered,
// so micro K + 1 never writes the U that update K reads, and P is copied
// only once W has all of update K.  Every element of W gets the same sum
// over the same k in the same order, so the inverses, flags, perm and piv
// are the serial schedule's, bit for bit.  The side stream's work is joined
// into the caller's stream before the call returns, so the caller sees one
// ordered call.
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
// SM per candidate, latency-bound far above the 2m³-flop bound.  On the
// serial schedule the other SMs wait for them; the look-ahead schedule hides
// the shorter of a panel's micro-steps and its update behind the other, and
// adds the strip update and the gather to each panel's chain.  The update
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

#include <mutex>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTile = 64;          // update: rows and columns per block
constexpr int kUpdateThreads = 256;
constexpr int kStripThreads = 128;  // strip: one row and four columns each
constexpr int kStoreWarps = 8;     // store: output rows per block

// The scratch, fp64 whatever the input type.
struct Work {
  double* W;       // (nc, m, m)
  double* U[2];    // (nc, m, b) each: panel K's U in U[K & 1]
  double* P;       // (nc, b, m)
  double* piv;     // (nc, m): raw pivot of each step
  double* thresh;  // (nc): eps·‖block‖∞
  int* perm;       // (nc, m): pivot row of each step
  int* used;       // (nc, m): row already a pivot
};

size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

// The regions, in Work's order.
constexpr int kRegions = 8;

// Byte offsets of the regions, in Work's order; the last entry is the total.
void layout(int nc, int m, int b, size_t off[kRegions + 1]) {
  const size_t c = nc, mm = m, bb = b;
  const size_t sizes[kRegions] = {c * mm * mm * 8, c * mm * bb * 8,
                                  c * mm * bb * 8, c * bb * mm * 8,
                                  c * mm * 8,      c * 8,
                                  c * mm * 4,      c * mm * 4};
  off[0] = 0;
  for (int i = 0; i < kRegions; ++i) off[i + 1] = off[i] + align_up(sizes[i]);
}

Work carve(void* base, int nc, int m, int b) {
  size_t off[kRegions + 1];
  layout(nc, m, b, off);
  char* p = static_cast<char*>(base);
  return Work{reinterpret_cast<double*>(p + off[0]),
              {reinterpret_cast<double*>(p + off[1]),
               reinterpret_cast<double*>(p + off[2])},
              reinterpret_cast<double*>(p + off[3]),
              reinterpret_cast<double*>(p + off[4]),
              reinterpret_cast<double*>(p + off[5]),
              reinterpret_cast<int*>(p + off[6]),
              reinterpret_cast<int*>(p + off[7])};
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
// Panel 0 reads the input (T); later panels read W.  copy_p: copy the raw
// pivot rows to P at the end (the serial schedule, where W is not yet
// updated; the look-ahead schedule gathers them after the update instead).
template <typename T, int B, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
    gj_probe_fused_panel_micro(const T* __restrict__ blocks,
                               uint8_t* __restrict__ sing, Work w, int m,
                               double eps, int K, bool copy_p) {
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
    double* Ug = (K & 1 ? w.U[1] : w.U[0]) + (cand * m + i) * B;
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
  if (!copy_p) return;
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
// 64-row tile (grid y), but for the columns in [skip_lo, skip_hi) (a
// multiple of B each; empty on the serial schedule); the panel's columns
// take e_{r_j} + U[:, j].  Thread (tx, ty) owns rows ty·4 .. ty·4+3 and
// columns tx·4 .. tx·4+3 of the tile.  kDD: sum in double-double (the fp64
// body), else in fp64.
template <typename T, int B, bool kDD>
__global__ void __launch_bounds__(kUpdateThreads)
    gj_probe_fused_panel_update(const T* __restrict__ blocks, Work w, int m,
                                int K, int skip_lo, int skip_hi) {
  __shared__ __align__(16) double Us[B][kTile];  // U tile, transposed
  __shared__ __align__(16) double Ps[B][kTile];
  __shared__ int s_rows[B];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t cand = blockIdx.z, mm = size_t(m) * m;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int k0 = K * B;
  double* dst = w.W + cand * mm;
  const double* Ug = (K & 1 ? w.U[1] : w.U[0]) + cand * m * B;
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
  // m % 4 == 0 and B % 4 == 0: a group of four is all in or all out.
  if (c >= m || (c >= skip_lo && c < skip_hi)) return;
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

// The part of update K that micro K + 1 reads: W[:, s0:s0+B] += U·P[:, s0:
// s0+B] with s0 = (K + 1)·B, for one candidate (grid y) and kStripThreads /
// (B/4) rows (grid x), one row and four columns a thread.  Each element gets
// the update kernel's sum, term for term, so the same bits; the tile is
// narrower, so that a strip of nc candidates spreads over the card.
template <typename T, int B, bool kDD>
__global__ void __launch_bounds__(kStripThreads)
    gj_probe_fused_panel_strip(const T* __restrict__ blocks, Work w, int m,
                               int K) {
  constexpr int kQuads = B / 4, kRows = kStripThreads / kQuads;
  __shared__ __align__(16) double Ps[B][B];
  const int tid = threadIdx.x, c4 = (tid % kQuads) * 4;
  const int r = blockIdx.x * kRows + tid / kQuads, s0 = (K + 1) * B;
  const size_t cand = blockIdx.y, mm = size_t(m) * m;
  const double* Pg = w.P + cand * B * m + s0;
  for (int e = tid; e < B * B; e += kStripThreads)
    Ps[e / B][e % B] = Pg[size_t(e / B) * m + e % B];
  __syncthreads();
  if (r >= m) return;
  const double* Ug = (K & 1 ? w.U[1] : w.U[0]) + (cand * m + r) * B;
  const size_t at = cand * mm + size_t(r) * m + s0 + c4;
  double acc[4], lo[4] = {0.0, 0.0, 0.0, 0.0};
  if (K == 0)
    ld4(blocks + at, acc);
  else
    ld4(w.W + at, acc);
#pragma unroll
  for (int k4 = 0; k4 < B / 4; ++k4) {
    double u[4];
    ld4(Ug + k4 * 4, u);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      double p[4];
      ld4(&Ps[k4 * 4 + kk][c4], p);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kDD)
          dd_fma(u[kk], p[e], acc[e], lo[e]);
        else
          acc[e] = fma(u[kk], p[e], acc[e]);
      }
    }
  }
  const double x[4] = {acc[0] + lo[0], acc[1] + lo[1], acc[2] + lo[2],
                       acc[3] + lo[3]};
  st4(w.W + at, x);
}

// P = R·W for panel K: row j of P is row perm[k0 + j] of W (of the input at
// K = 0), one block per (j, candidate), four values a thread.
template <typename T, int B>
__global__ void gj_probe_fused_panel_gather(const T* __restrict__ blocks,
                                            Work w, int m, int K) {
  const int jj = blockIdx.x, c = threadIdx.x * 4;
  const size_t cand = blockIdx.y, mm = size_t(m) * m;
  if (c >= m) return;
  const size_t at = size_t(w.perm[cand * m + K * B + jj]) * m + c;
  double x[4];
  if (K == 0)
    ld4(blocks + cand * mm + at, x);
  else
    ld4(w.W + cand * mm + at, x);
  st4(w.P + (cand * B + jj) * m + c, x);
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

// The look-ahead schedule's side stream for a caller's stream: one per
// device and priority, created once, non-blocking (no implicit order with
// the legacy default stream), of the caller's priority, so that the update
// it runs keeps the caller's standing against other work on the card.
// Callers share it; each call orders its own work on it by its own events.
constexpr int kMaxDevices = 64, kMaxPriorities = 8;

cudaError_t side_stream(cudaStream_t caller, cudaStream_t* out) {
  static std::mutex mu;
  static cudaStream_t streams[kMaxDevices][kMaxPriorities] = {};
  int dev, prio, least, greatest;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaStreamGetPriority(caller, &prio)) ||
      (err = cudaDeviceGetStreamPriorityRange(&least, &greatest)))
    return err;
  const int level = prio - greatest;
  if (dev >= kMaxDevices || level < 0 || level >= kMaxPriorities)
    return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> hold(mu);
  cudaStream_t& side = streams[dev][level];
  if (!side &&
      (err = cudaStreamCreateWithPriority(&side, cudaStreamNonBlocking, prio)))
    return err;
  *out = side;
  return cudaSuccess;
}

template <typename T, int B, int kMaxThreads>
class Launcher {
 public:
  static constexpr bool kDD = sizeof(T) == 8;

  Launcher(const T* blocks, uint8_t* sing, Work w, int nc, int m, double eps)
      : blocks_(blocks), sing_(sing), w_(w), nc_(nc), m_(m), eps_(eps),
        tiles_((m + kTile - 1) / kTile) {}

  cudaError_t micro(int K, bool copy_p, cudaStream_t s) const {
    gj_probe_fused_panel_micro<T, B, kMaxThreads>
        <<<nc_, (m_ + 31) / 32 * 32, 0, s>>>(blocks_, sing_, w_, m_, eps_, K,
                                             copy_p);
    return cudaGetLastError();
  }
  // Update K but for the columns [skip_lo, skip_hi).
  cudaError_t update(int K, int skip_lo, int skip_hi, cudaStream_t s) const {
    gj_probe_fused_panel_update<T, B, kDD>
        <<<dim3(tiles_, tiles_, nc_), kUpdateThreads, 0, s>>>(
            blocks_, w_, m_, K, skip_lo, skip_hi);
    return cudaGetLastError();
  }
  cudaError_t strip(int K, cudaStream_t s) const {
    constexpr int rows = kStripThreads / (B / 4);
    gj_probe_fused_panel_strip<T, B, kDD>
        <<<dim3((m_ + rows - 1) / rows, nc_), kStripThreads, 0, s>>>(
            blocks_, w_, m_, K);
    return cudaGetLastError();
  }
  cudaError_t gather(int K, cudaStream_t s) const {
    gj_probe_fused_panel_gather<T, B>
        <<<dim3(B, nc_), (m_ / 4 + 31) / 32 * 32, 0, s>>>(blocks_, w_, m_, K);
    return cudaGetLastError();
  }

  cudaError_t serial(cudaStream_t stream) const {
    cudaError_t err;
    for (int K = 0; K < m_ / B; ++K)
      if ((err = micro(K, true, stream)) || (err = update(K, 0, 0, stream)))
        return err;
    return cudaSuccess;
  }

  // Per panel K: strip K; fork; micro K + 1 on the caller's stream beside
  // the rest of update K on the side stream; join; gather K + 1.  Micro
  // K + 1 follows the strip in stream order, so its few blocks are placed
  // before the update's many, which wait on the fork event.
  cudaError_t lookahead(cudaStream_t stream) const {
    cudaStream_t side;
    cudaEvent_t fork, join;
    cudaError_t err = side_stream(stream, &side);
    if (err) return err;
    if ((err = cudaEventCreateWithFlags(&fork, cudaEventDisableTiming)))
      return err;
    if ((err = cudaEventCreateWithFlags(&join, cudaEventDisableTiming))) {
      cudaEventDestroy(fork);
      return err;
    }
    const int panels = m_ / B;
    if (!(err = micro(0, false, stream))) err = gather(0, stream);
    for (int K = 0; !err && K + 1 < panels; ++K) {
      const int s0 = (K + 1) * B;
      if ((err = strip(K, stream)) || (err = cudaEventRecord(fork, stream)) ||
          (err = micro(K + 1, false, stream)) ||
          (err = cudaStreamWaitEvent(side, fork, 0)))
        break;
      err = update(K, s0, s0 + B, side);
      // Joined whatever failed since the fork, so that no work of this call
      // is left on the side stream.
      cudaError_t join_err = cudaEventRecord(join, side);
      if (!join_err) join_err = cudaStreamWaitEvent(stream, join, 0);
      if (!err) err = join_err;
      if (!err) err = gather(K + 1, stream);
    }
    if (!err) err = update(panels - 1, 0, 0, stream);
    cudaEventDestroy(fork);
    cudaEventDestroy(join);
    return err;
  }

 private:
  const T* blocks_;
  uint8_t* sing_;
  Work w_;
  int nc_, m_;
  double eps_;
  int tiles_;
};

template <typename T, int B, int kMaxThreads>
int launch(const T* blocks, T* inv, uint8_t* sing, void* work, int nc, int m,
           double eps, bool lookahead, cudaStream_t stream) {
  const Work w = carve(work, nc, m, B);
  const Launcher<T, B, kMaxThreads> run(blocks, sing, w, nc, m, eps);
  const cudaError_t err = lookahead ? run.lookahead(stream) : run.serial(stream);
  if (err) return int(err);
  gj_probe_fused_panel_store<T>
      <<<dim3((m + kStoreWarps - 1) / kStoreWarps, nc), kStoreWarps * 32,
         m * sizeof(int), stream>>>(inv, w, m);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* blocks, void* inv, void* sing, void* work, int nc,
             int m, int b, double eps, int lookahead, void* stream) {
  if (nc <= 0 || m <= b || m > 1024 || m % b)
    return int(cudaErrorInvalidValue);
  const T* in = static_cast<const T*>(blocks);
  T* out = static_cast<T*>(inv);
  uint8_t* flags = static_cast<uint8_t*>(sing);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = m > 512, la = lookahead != 0;
  switch (b) {
    case 32:
      return wide ? launch<T, 32, 1024>(in, out, flags, work, nc, m, eps, la, s)
                  : launch<T, 32, 512>(in, out, flags, work, nc, m, eps, la, s);
    case 16:
      return wide ? launch<T, 16, 1024>(in, out, flags, work, nc, m, eps, la, s)
                  : launch<T, 16, 512>(in, out, flags, work, nc, m, eps, la, s);
    case 8:
      return wide ? launch<T, 8, 1024>(in, out, flags, work, nc, m, eps, la, s)
                  : launch<T, 8, 512>(in, out, flags, work, nc, m, eps, la, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Bytes of the scratch a launch at (nc, m, b) needs.
size_t gj_probe_fused_panel_work_bytes(int nc, int m, int b) {
  size_t off[kRegions + 1];
  layout(nc, m, b, off);
  return off[kRegions];
}

// Byte offset in that scratch of region r, in the order W, U (two), P, piv
// (fp64), thresh (fp64), perm (int32), used (int32), each (nc, ...) as
// Work says; r = 8 gives the total.  After a call, perm and piv hold each
// step's pivot row and raw pivot.
size_t gj_probe_fused_panel_work_offset(int nc, int m, int b, int r) {
  size_t off[kRegions + 1];
  layout(nc, m, b, off);
  return r >= 0 && r <= kRegions ? off[r] : 0;
}

// Launch the panel probe on `stream`: blocks and inv are contiguous
// (nc, m, m) and 16-byte aligned, sing is (nc,) uint8, work holds
// gj_probe_fused_panel_work_bytes(nc, m, b) bytes.  b is the panel width: 32,
// 16 or 8, dividing m, with b < m <= 1024.  lookahead (0 or 1) picks the
// schedule; both give the same bits.  Returns the first CUDA error code of
// the launches (0 on success).
int gj_probe_fused_panel_f32(const void* blocks, void* inv, void* sing,
                             void* work, int nc, int m, int b, float eps,
                             int lookahead, void* stream) {
  return dispatch<float>(blocks, inv, sing, work, nc, m, b, eps, lookahead,
                         stream);
}

int gj_probe_fused_panel_f64(const void* blocks, void* inv, void* sing,
                             void* work, int nc, int m, int b, double eps,
                             int lookahead, void* stream) {
  return dispatch<double>(blocks, inv, sing, work, nc, m, b, eps, lookahead,
                          stream);
}

}  // extern "C"
