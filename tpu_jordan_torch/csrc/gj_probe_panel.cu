// Batched Gauss–Jordan inverse of a pivot-candidate stack by b-wide panels
// with a deferred full-width update: the probe's panel variant, as a
// hand-written kernel for Hopper (sm_90a).
//
// Replaces tpu_jordan/ops/pallas_block_inverse.py::_gj_panel_kernel (v2,
// reached through pallas_batched_block_inverse_panel).  For each m x m block
// of a contiguous (nc, m, m) fp32 stack: its inverse and a singular flag,
// raised when the input holds a non-finite value, when ‖block‖∞ < eps, or
// when any pivot has |piv| < eps·‖block‖∞ — the rule of
// tpu_jordan_torch/ops/probe_variants.py::gj_panel_plain, whose algebra this
// kernel follows:
//
//   W = [A | I], (m, 2m).  For each panel K of b columns (k0 = K·b):
//     S = W[:, k0:k0+b], U = 0 (m, b).  For j in 0..b-1 (the micro-steps):
//       r   = the unused row with the largest |S[r, j]|, lowest row on ties;
//       piv = S[r, j];  u = (1/piv − 1 at r, −S[:, j]/piv elsewhere);
//       S  += u ⊗ S[r, :];  U += u ⊗ U[r, :];  U[:, j] += u;
//     P = the b raw (pre-panel) pivot rows of W;  W += U·P.
//   inv[a, :] = W[perm[a], m:2m].
//
// Each micro-step is E_j = I + u_j·e_{r_j}ᵀ, so a panel's composition is
// I + U·R with R the pivot-row selectors, and W += U·(R·W) applies it.
// Columns left of the panel hold eliminated unit columns that no later
// output reads, so each update runs over columns k0+b..2m only.
//
// Design.  Two schedules, picked by ops/probe_variants.py::panel_schedule by
// m and refused here when they do not fit:
//
//   cluster  where the (m, 2m) state, 8m² bytes, fits C ≤ 16 blocks' shared
//            memory (m ≤ ~600): ONE launch a call, one cluster of C blocks
//            per candidate (C = 1 at m = 128, 8 at 384, 16 at 512), each
//            block owning ⌈m/C⌉ rows of W.  Per panel:
//     - the leader block (rank 0) reads the (m, b) strip over distributed
//       shared memory, one thread a row with its strip row in b registers
//       (with the steps unrolled, S[i, c] is live for c ≥ j and U[i, c] for
//       c < j, so the pair takes b values), and runs the b micro-steps at
//       one block barrier each: a warp-shuffle argmax, the warp's winner
//       publishes its row to a slot double-buffered by step parity, and
//       every thread reduces the slots itself;
//     - it pushes each row of U to the block that owns the row and the
//       panel's pivot rows' indices to every block; a cluster barrier;
//     - every block copies the b raw pivot rows, in 128-column chunks, from
//       their owners into its own buffer, and applies W_own += U_own·P to
//       its own rows.  The pivot rows are rows of W too, so every block
//       must have copied chunk c before any block writes it: a cluster
//       barrier between copy and write, with the chunks double-buffered so
//       that the copy of chunk c+1 runs beside the update of chunk c.  The
//       last panel writes the B half straight into the output rows,
//       unscrambled.
//   l2       beyond that, three kernels (init, then per panel micro and
//            update: 1 + 2·m/b launches), W in a global scratch that the
//            L2 cache holds: micro runs one block per candidate on the
//            strip in shared memory and stores U and the raw pivot rows;
//            update runs one block per (64-column tile, 128-row chunk,
//            candidate).
//
// What bounds it.  The micro-steps: m serial steps of one barrier each on
// one SM per candidate, latency-bound far above the 4m³-flop bound.  The
// deferred update is ≈ 2m·b·2m flops a panel a candidate; on the cluster
// schedule it runs from shared memory on C SMs at a cluster barrier a
// chunk, on the l2 schedule it moves the live part of W through L2 once a
// panel.
//
// Arithmetic: fp32 FMAs (the JAX dots run at Precision.HIGHEST, so no TF32)
// and exact IEEE divisions: built by tpu_jordan_torch/_build.py without
// fast-math, like gj_probe.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTileCols = 64;     // update: columns per block
constexpr int kTileRows = 128;    // update: rows per block
constexpr int kUpdateThreads = 256;
constexpr int kMaxThreads = 1024;  // init and micro

// (v, i) <- the better of (v, i) and (ov, oi): larger value, lower row on
// ties.  A total order, so the warp butterfly gives every lane one winner.
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The scratch, in 4-byte words, one region after another:
//   W (nc, m, 2m) | U (nc, m, b) | P (nc, b, 2m) | thresh (nc) |
//   used (nc, m) | perm (nc, m) | pinv (nc, m)      [the last three int]
struct Work {
  float* W;
  float* U;
  float* P;
  float* thresh;
  int* used;
  int* perm;
  int* pinv;
};

size_t work_words(int nc, int m, int b) {
  const size_t c = nc, mm = m, bb = b;
  return c * (mm * 2 * mm + mm * bb + bb * 2 * mm + 1 + 3 * mm);
}

Work carve(void* base, int nc, int m, int b) {
  Work w;
  const size_t c = nc, mm = m, bb = b;
  float* f = static_cast<float*>(base);
  w.W = f;
  w.U = w.W + c * mm * 2 * mm;
  w.P = w.U + c * mm * bb;
  w.thresh = w.P + c * bb * 2 * mm;
  int* i = reinterpret_cast<int*>(w.thresh + c);
  w.used = i;
  w.perm = i + c * mm;
  w.pinv = i + 2 * c * mm;
  return w;
}

// W ← [A | I]; thresh = eps·‖A‖∞; sing = (non-finite input or ‖A‖∞ < eps);
// no row used.  One block per candidate, one warp per row.
__global__ void __launch_bounds__(kMaxThreads)
    gj_probe_panel_init(const float* __restrict__ blocks,
                        uint8_t* __restrict__ sing, Work w, int m,
                        float eps) {
  __shared__ float red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t cand = blockIdx.x, m2 = 2 * size_t(m);
  const float* a = blocks + cand * m * m;
  float* W = w.W + cand * m * m2;
  int nonfinite = 0;
  float row_max = 0.f;
  for (int i = warp; i < m; i += nwarps) {
    float s = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float x = a[size_t(i) * m + j];
      W[i * m2 + j] = x;
      W[i * m2 + m + j] = i == j ? 1.f : 0.f;
      nonfinite |= !isfinite(x);
      s += fabsf(x);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
    row_max = fmaxf(row_max, s);
  }
  for (int i = tid; i < m; i += nt) w.used[cand * m + i] = 0;
  if (lane == 0) red[warp] = row_max;
  nonfinite = __syncthreads_or(nonfinite);
  if (tid == 0) {
    float norm = 0.f;
    for (int k = 0; k < nwarps; ++k) norm = fmaxf(norm, red[k]);
    w.thresh[cand] = eps * norm;
    sing[cand] = (nonfinite || norm < eps) ? 1 : 0;
  }
}

template <int B>
size_t micro_smem_bytes(int m) {
  // S and U with a padded row stride (B + 1: a column read is free of bank
  // conflicts), u, S[r, :], U[r, :], the warps' winners, used, the panel's
  // pivot rows.
  return 2 * size_t(m) * (B + 1) * 4 + size_t(m) * 4 + 2 * B * 4 +
         32 * 4 + 32 * 4 + size_t(m) * 4 + B * 4;
}

// One panel's b micro-steps for one candidate (block), then U and the raw
// pivot rows P to global memory.  Panel K covers columns k0 = K·B ..
// k0 + B - 1; the update that follows runs over columns c0 = k0 + B .. 2m.
template <int B>
__global__ void __launch_bounds__(kMaxThreads)
    gj_probe_panel_micro(uint8_t* __restrict__ sing, Work w, int m, int K) {
  constexpr int LD = B + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t cand = blockIdx.x, m2 = 2 * size_t(m);
  const int k0 = K * B;
  float* W = w.W + cand * m * m2;

  float* S = reinterpret_cast<float*>(smem);
  float* U = S + size_t(m) * LD;
  float* u = U + size_t(m) * LD;
  float* s_r = u + m;
  float* u_r = s_r + B;
  float* red_val = u_r + B;
  int* red_idx = reinterpret_cast<int*>(red_val + 32);
  int* used = red_idx + 32;
  int* rows = used + m;

  for (int e = tid; e < m * B; e += nt) {
    const int i = e / B, c = e % B;
    S[i * LD + c] = W[i * m2 + k0 + c];
    U[i * LD + c] = 0.f;
  }
  for (int i = tid; i < m; i += nt) used[i] = w.used[cand * m + i];
  const float thresh = w.thresh[cand];
  int bad = 0;
  __syncthreads();

  for (int j = 0; j < B; ++j) {
    // Pivot: the unused row with the largest |S[r, j]|, lowest row on
    // ties; NaN ranks highest, as in argmax.
    float best = -1.f;
    int bi = m;
    for (int r = tid; r < m; r += nt) {
      if (!used[r]) {
        float v = fabsf(S[r * LD + j]);
        if (isnan(v)) v = INFINITY;
        take_better(best, bi, v, r);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, best, o);
      const int oi = __shfl_xor_sync(kFullMask, bi, o);
      take_better(best, bi, ov, oi);
    }
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = bi;
    }
    __syncthreads();
    // Every thread reduces the warps' winners itself: no third barrier.
    best = red_val[0];
    bi = red_idx[0];
    for (int k = 1; k < nwarps; ++k) take_better(best, bi, red_val[k],
                                                 red_idx[k]);
    const int r = bi;
    const float piv = S[r * LD + j];
    const float safe = piv == 0.f ? 1.f : piv;
    if (tid == 0) {
      used[r] = 1;
      rows[j] = r;
      w.perm[cand * m + k0 + j] = r;
      bad |= fabsf(piv) < thresh;
    }
    // u = (1/piv − 1 at r, −S[:, j]/piv elsewhere), and row r of S and U
    // as they stand before this step.
    for (int i = tid; i < m; i += nt)
      u[i] = i == r ? 1.f / safe - 1.f : -S[i * LD + j] / safe;
    if (tid < B) {
      s_r[tid] = S[r * LD + tid];
      u_r[tid] = U[r * LD + tid];
    }
    __syncthreads();
    // S += u ⊗ S[r, :];  U += u ⊗ U[r, :];  U[:, j] += u.
    for (int e = tid; e < m * B; e += nt) {
      const int i = e / B, c = e % B;
      const float ui = u[i];
      S[i * LD + c] = S[i * LD + c] + ui * s_r[c];
      float x = U[i * LD + c] + ui * u_r[c];
      if (c == j) x = x + ui;
      U[i * LD + c] = x;
    }
    __syncthreads();
  }

  // U and the panel's raw pivot rows (W is not yet updated) for the
  // update; the state for the next panel.
  float* Ug = w.U + cand * m * B;
  for (int e = tid; e < m * B; e += nt) Ug[e] = U[(e / B) * LD + e % B];
  float* Pg = w.P + cand * B * m2;
  const int c0 = k0 + B;
  const int width = int(m2) - c0;
  for (int e = tid; e < B * width; e += nt) {
    const int jj = e / width, c = c0 + e % width;
    Pg[jj * m2 + c] = W[rows[jj] * m2 + c];
  }
  for (int i = tid; i < m; i += nt) w.used[cand * m + i] = used[i];
  if (tid == 0 && bad) sing[cand] = 1;
  if (c0 == m) {
    // Last panel: perm is complete; the update scatters row i of the B
    // half to output row pinv[i].
    __syncthreads();  // perm's last entries were written by thread 0
    for (int a = tid; a < m; a += nt)
      w.pinv[cand * m + w.perm[cand * m + a]] = a;
  }
}

// W[:, c] += U·P[:, c] over the live columns c0 = k0 + B .. 2m of one
// candidate (grid z), one 64-column tile (grid x) and one 128-row chunk
// (grid y).  On the last panel (c0 == m) the sum goes to the output
// instead: inv[pinv[i], c − m].
template <int B>
__global__ void __launch_bounds__(kUpdateThreads)
    gj_probe_panel_update(float* __restrict__ inv, Work w, int m, int K) {
  __shared__ float Us[kTileRows * B];
  const int tid = threadIdx.x;
  const int tx = tid % kTileCols, ty = tid / kTileCols;
  constexpr int kRowGroups = kUpdateThreads / kTileCols;
  const size_t cand = blockIdx.z, m2 = 2 * size_t(m);
  const int c0 = (K + 1) * B;
  const int c = c0 + blockIdx.x * kTileCols + tx;
  const int i0 = blockIdx.y * kTileRows;
  const int nrows = min(kTileRows, m - i0);
  const float* Ug = w.U + cand * m * B + size_t(i0) * B;
  for (int e = tid; e < nrows * B; e += kUpdateThreads) Us[e] = Ug[e];
  float p[B];
  const bool live = c < int(m2);
  const float* Pg = w.P + cand * B * m2;
#pragma unroll
  for (int j = 0; j < B; ++j) p[j] = live ? Pg[j * m2 + c] : 0.f;
  __syncthreads();
  if (!live) return;
  float* W = w.W + cand * m * m2;
  const bool last = c0 == m;
  const int* pinv = w.pinv + cand * m;
  float* out = inv + cand * m * m;
  for (int r = ty; r < nrows; r += kRowGroups) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < B; ++j) acc = fmaf(Us[r * B + j], p[j], acc);
    const int i = i0 + r;
    const float x = W[i * m2 + c] + acc;
    if (last)
      out[size_t(pinv[i]) * m + (c - m)] = x;
    else
      W[i * m2 + c] = x;
  }
}

// ---------------------------------------------------------------------------
// The cluster schedule: one launch a call, the state in shared memory.

constexpr int kChunk = 128;  // columns of a pivot-row chunk
// Most threads a block: one a row up to m = 640, which no state that fits
// 16 blocks exceeds.
constexpr int kClusterThreads = 640;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// The cluster schedule's dynamic shared memory of one block, region by
// region; ops/probe_variants.py::panel_smem_bytes mirrors it.
struct Layout {
  size_t W, U, P, perm, pinv, srow, sval, sidx, nsum, nfin, total;
};

__host__ __device__ inline Layout cluster_layout(int m, int b, int C) {
  const size_t R = (m + C - 1) / C, S = 32 * size_t(C);
  const size_t sizes[10] = {R * 2 * m * 4,  R * b * 4,
                            2 * size_t(b) * kChunk * 4,
                            size_t(m) * 4,   R * 4,
                            2 * 32 * size_t(b) * 4,
                            2 * 32 * 4,      2 * 32 * 4,
                            S * 4,           S * 4};
  size_t off[11];
  off[0] = 0;
  for (int i = 0; i < 10; ++i) off[i + 1] = off[i] + align16(sizes[i]);
  return Layout{off[0], off[1], off[2], off[3], off[4], off[5],
                off[6], off[7], off[8], off[9], off[10]};
}

// Threads a block: one a row (the leader's micro-steps), at least a chunk.
int cluster_threads(int m) {
  const int t = (m + 31) / 32 * 32;
  return t < kChunk ? kChunk : t;
}

// The warp's best (key, row) by take_better's order, in every lane: keys
// are never negative, so their bits order as unsigned integers; an empty
// candidate is (0, INT_MAX), and any row beats it.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  const unsigned b = __float_as_uint(v);
  const unsigned mb = __reduce_max_sync(kFullMask, b);
  i = int(__reduce_min_sync(kFullMask,
                            b == mb ? unsigned(i) : unsigned(INT_MAX)));
  v = __uint_as_float(mb);
}

// One cluster of C = cluster size blocks per candidate (grid x: nc·C).
template <int B>
__global__ void __launch_bounds__(kClusterThreads)
    gj_probe_panel_cluster(const float* __restrict__ blocks,
                           float* __restrict__ inv,
                           uint8_t* __restrict__ sing, int m, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t cand = blockIdx.x / C;
  const int m2 = 2 * m;
  const int R = (m + C - 1) / C, r0 = rank * R;
  const int nloc = max(0, min(R, m - r0));
  const Layout L = cluster_layout(m, B, C);
  float* W = reinterpret_cast<float*>(smem + L.W);         // [R][2m] own rows
  float* Ul = reinterpret_cast<float*>(smem + L.U);        // [R][B]
  float* Pc = reinterpret_cast<float*>(smem + L.P);        // [2][B][kChunk]
  int* perm = reinterpret_cast<int*>(smem + L.perm);       // [m]
  int* pinv = reinterpret_cast<int*>(smem + L.pinv);       // [R] own rows
  float* s_row = reinterpret_cast<float*>(smem + L.srow);  // [2][32][B]
  float* s_val = reinterpret_cast<float*>(smem + L.sval);  // [2][32]
  int* s_idx = reinterpret_cast<int*>(smem + L.sidx);      // [2][32]
  float* s_nsum = reinterpret_cast<float*>(smem + L.nsum); // [C·32] leader
  int* s_nfin = reinterpret_cast<int*>(smem + L.nfin);     // [C·32] leader
  float* out = inv + cand * m * m;

  // 1. W ← [A | I] on the own rows; their largest row sum and the finite
  //    check go to the leader.
  {
    const float* a = blocks + cand * m * m;
    int nonfinite = 0;
    float row_max = 0.f;
    for (int i = warp; i < nloc; i += nwarps) {
      const int g = r0 + i;
      float s = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float x = a[size_t(g) * m + j];
        W[i * m2 + j] = x;
        W[i * m2 + m + j] = g == j ? 1.f : 0.f;
        nonfinite |= !isfinite(x);
        s += fabsf(x);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
      row_max = fmaxf(row_max, s);
    }
    nonfinite = __any_sync(kFullMask, nonfinite);
    if (lane == 0) {
      *cluster.map_shared_rank(s_nsum + rank * nwarps + warp, 0) = row_max;
      *cluster.map_shared_rank(s_nfin + rank * nwarps + warp, 0) = nonfinite;
    }
  }
  cluster.sync();

  const bool leader = rank == 0;
  int bad = 0;
  float thresh = 0.f;
  if (leader && tid == 0) {
    float norm = 0.f;
    for (int w = 0; w < C * nwarps; ++w) {
      norm = fmaxf(norm, s_nsum[w]);
      bad |= s_nfin[w];
    }
    bad = bad || norm < eps;
    thresh = eps * norm;
  }
  // The leader's thread i holds row i of the strip: U[i, c] for c < j and
  // S[i, c] for c ≥ j at micro-step j.
  const int i = tid;
  const bool active = leader && i < m;
  const int oq = active ? i / R : 0, oi = active ? i % R : 0;
  bool used = false;

  for (int K = 0; K < m / B; ++K) {
    const int k0 = K * B;
    if (leader) {
      float row[B];
      if (active) {
        const float* src =
            cluster.map_shared_rank(W, oq) + size_t(oi) * m2 + k0;
#pragma unroll
        for (int c4 = 0; c4 < B / 4; ++c4) {
          const float4 t = reinterpret_cast<const float4*>(src)[c4];
          row[c4 * 4] = t.x;
          row[c4 * 4 + 1] = t.y;
          row[c4 * 4 + 2] = t.z;
          row[c4 * 4 + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < B; ++c) row[c] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < B; ++j) {
        // Pivot: the unused row with the largest |S[r, j]|, lowest row on
        // ties; NaN ranks highest, as in argmax.
        float best = 0.f;
        int bi = INT_MAX;
        if (active && !used) {
          float v = fabsf(row[j]);
          if (isnan(v)) v = INFINITY;
          best = v;
          bi = i;
        }
        warp_argmax(best, bi);
        const int par = j & 1;
        if (lane == 0) {
          s_val[par * 32 + warp] = best;
          s_idx[par * 32 + warp] = bi;
        }
        if (bi == i) {
          float4* dst = reinterpret_cast<float4*>(s_row + (par * 32 + warp) * B);
#pragma unroll
          for (int c4 = 0; c4 < B / 4; ++c4)
            dst[c4] = make_float4(row[c4 * 4], row[c4 * 4 + 1],
                                  row[c4 * 4 + 2], row[c4 * 4 + 3]);
        }
        __syncthreads();
        // Every thread reduces the warps' winners itself.
        best = 0.f;
        bi = INT_MAX;
        if (lane < nwarps) {
          best = s_val[par * 32 + lane];
          bi = s_idx[par * 32 + lane];
        }
        warp_argmax(best, bi);
        const int r = bi;
        const float4* prow =
            reinterpret_cast<const float4*>(s_row + (par * 32 + (r >> 5)) * B);
        const float piv = s_row[(par * 32 + (r >> 5)) * B + j];
        const float safe = piv == 0.f ? 1.f : piv;
        // u = (1/piv − 1 at r, −S[:, j]/piv elsewhere); S += u ⊗ S[r, :]
        // past the pivot column, U += u ⊗ U[r, :] before it, U[:, j] = u.
        const float u = i == r ? 1.f / safe - 1.f : -row[j] / safe;
        if (i == r) used = true;
#pragma unroll
        for (int c4 = 0; c4 < B / 4; ++c4) {
          const float4 t = prow[c4];
          const float x[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c4 * 4 + e;
            if (c != j) row[c] = row[c] + u * x[e];
          }
        }
        row[j] = u;
        if (tid == 0) {
          bad |= fabsf(piv) < thresh;
          perm[k0 + j] = r;
        }
      }
      // The panel's pivot rows to the other blocks.
      __syncthreads();
      for (int e = tid; e < B * (C - 1); e += nt)
        *cluster.map_shared_rank(perm + k0 + e % B, 1 + e / B) =
            perm[k0 + e % B];
      // Each row of U to the block that owns the row.
      if (active) {
        float4* dst = reinterpret_cast<float4*>(
            cluster.map_shared_rank(Ul, oq) + size_t(oi) * B);
#pragma unroll
        for (int c4 = 0; c4 < B / 4; ++c4)
          dst[c4] = make_float4(row[c4 * 4], row[c4 * 4 + 1], row[c4 * 4 + 2],
                                row[c4 * 4 + 3]);
      }
    }
    cluster.sync();  // U and the pivot rows' indices in place

    // 2. W_own += U_own·P over the live columns c0 .. 2m, chunk by chunk.
    const int c0 = k0 + B;
    const bool last = c0 == m;
    if (last) {
      // perm is complete: the output row of each own row.
      for (int a = tid; a < m; a += nt) {
        const int g = perm[a];
        if (g >= r0 && g < r0 + nloc) pinv[g - r0] = a;
      }
    }
    const int nch = (m2 - c0 + kChunk - 1) / kChunk;
    for (int ch = 0; ch <= nch; ++ch) {
      if (ch < nch) {
        // Copy chunk ch of the b raw pivot rows from their owners.
        float4* dst = reinterpret_cast<float4*>(Pc + (ch & 1) * B * kChunk);
        const int cb = c0 + ch * kChunk;
        for (int e = tid; e < B * kChunk / 4; e += nt) {
          const int jj = e / (kChunk / 4), c = cb + (e % (kChunk / 4)) * 4;
          if (c < m2) {
            const int g = perm[k0 + jj];
            dst[e] = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(W, g / R) + size_t(g % R) * m2 + c);
          }
        }
      }
      if (ch > 0) {
        // Update chunk ch - 1: each thread one column, P's in registers.
        const int cc = tid % kChunk, ty = tid / kChunk, ng = nt / kChunk;
        const int c = c0 + (ch - 1) * kChunk + cc;
        if (c < m2 && ty < ng) {
          const float* src = Pc + ((ch - 1) & 1) * B * kChunk + cc;
          float p[B];
#pragma unroll
          for (int jj = 0; jj < B; ++jj) p[jj] = src[jj * kChunk];
          for (int li = ty; li < nloc; li += ng) {
            const float4* ur = reinterpret_cast<const float4*>(Ul + li * B);
            float acc = 0.f;
#pragma unroll
            for (int j4 = 0; j4 < B / 4; ++j4) {
              const float4 uu = ur[j4];
              acc = fmaf(uu.x, p[j4 * 4], acc);
              acc = fmaf(uu.y, p[j4 * 4 + 1], acc);
              acc = fmaf(uu.z, p[j4 * 4 + 2], acc);
              acc = fmaf(uu.w, p[j4 * 4 + 3], acc);
            }
            const float x = W[li * m2 + c] + acc;
            if (last)
              out[size_t(pinv[li]) * m + (c - m)] = x;
            else
              W[li * m2 + c] = x;
          }
        }
      }
      // Every block's copy of a chunk lands before any block writes it.
      cluster.sync();
    }
  }
  if (leader && tid == 0) sing[cand] = bad ? 1 : 0;
}

int max_optin_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// Returned when a schedule does not fit (or the card cannot schedule its
// cluster); CUDA's own codes stay below 1000.
constexpr int kRefused = 1000;

// What a launch needs from the runtime, asked once per (device, kernel,
// block size, shared memory, cluster size) and kept: the kernel's
// shared-memory limit raised to what the launch takes, and how many of its
// clusters the card holds at once.  A later launch of the same key costs
// the host a lookup, not attribute calls and an occupancy query.
struct Prepared {
  int dev;
  const void* kernel;
  unsigned threads;
  size_t smem;
  int C;         // blocks a cluster; 0: no cluster
  int clusters;  // clusters the card holds at once; 1 with no cluster
};
std::mutex prepared_mu;
std::vector<Prepared> prepared;  // guarded by prepared_mu

void set_cluster(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int C) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// How many clusters of C blocks (C = 0: a launch without a cluster, and
// the answer 1) of `kernel` by `cfg` the card holds at once, or -(CUDA
// error); the first call for a key sets the kernel's attributes.
int prepare(const void* kernel, cudaLaunchConfig_t cfg, int C) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -int(err);
  std::lock_guard<std::mutex> lock(prepared_mu);
  size_t top = 0;  // the kernel's shared-memory limit as set so far
  for (const Prepared& p : prepared) {
    if (p.dev != dev || p.kernel != kernel) continue;
    if (p.threads == cfg.blockDim.x && p.smem == cfg.dynamicSmemBytes &&
        p.C == C)
      return p.clusters;
    top = std::max(top, p.smem);
  }
  if (cfg.dynamicSmemBytes > top) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(cfg.dynamicSmemBytes));
    if (err != cudaSuccess) return -int(err);
  }
  int n = 1;
  if (C > 0) {
    if (C > 8) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return -int(err);
    }
    cudaLaunchAttribute attr[1];
    set_cluster(cfg, attr, C);
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return -int(err);
  }
  prepared.push_back(
      {dev, kernel, cfg.blockDim.x, cfg.dynamicSmemBytes, C, n});
  return n;
}

template <int B>
int launch_l2(const float* blocks, float* inv, uint8_t* sing, void* work,
           int nc, int m, float eps, cudaStream_t stream) {
  const Work w = carve(work, nc, m, B);
  const int threads = m <= 64 ? 256 : (m <= 128 ? 512 : kMaxThreads);
  const size_t smem = micro_smem_bytes<B>(m);
  if (smem > size_t(max_optin_smem())) return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  const int n = prepare((const void*)gj_probe_panel_micro<B>, cfg, 0);
  if (n < 0) return -n;
  cudaError_t err;
  gj_probe_panel_init<<<nc, threads, 0, stream>>>(blocks, sing, w, m, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int rows = (m + kTileRows - 1) / kTileRows;
  for (int K = 0; K < m / B; ++K) {
    gj_probe_panel_micro<B><<<nc, threads, smem, stream>>>(sing, w, m, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    const int width = 2 * m - (K + 1) * B;
    const dim3 grid((width + kTileCols - 1) / kTileCols, rows, nc);
    gj_probe_panel_update<B>
        <<<grid, kUpdateThreads, 0, stream>>>(inv, w, m, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  return 0;
}

template <int B>
int launch_cluster(const float* blocks, float* inv, uint8_t* sing, int nc,
                   int m, float eps, int C, cudaStream_t stream) {
  if (C < 1 || C > 16 || C > m || cluster_threads(m) > kClusterThreads)
    return kRefused;
  const size_t smem = cluster_layout(m, B, C).total;
  if (smem > size_t(max_optin_smem())) return kRefused;
  auto kernel = gj_probe_panel_cluster<B>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(nc) * C);
  cfg.blockDim = dim3(cluster_threads(m));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  const int clusters = prepare((const void*)kernel, cfg, C);
  if (clusters < 0) return -clusters;
  if (clusters < 1) return kRefused;
  cudaLaunchAttribute attr[1];
  set_cluster(cfg, attr, C);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, blocks, inv, sing, m, eps);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Words (4 bytes each) of the scratch the l2 schedule at (nc, m, b) needs.
size_t gj_probe_panel_work_words(int nc, int m, int b) {
  return work_words(nc, m, b);
}

// Launch the panel probe on `stream`: blocks and inv are contiguous
// (nc, m, m) fp32, sing is (nc,) uint8.  b is the panel width: 32, 16 or 8,
// dividing m, with m > b.  schedule 1 (cluster): `cluster` blocks a
// candidate, 1..16, work null; schedule 0 (l2): cluster 1, work holds
// gj_probe_panel_work_words(nc, m, b) words.  Returns 0, the first CUDA
// error code of the launches, or 1000 when the schedule does not fit this
// card.
int gj_probe_panel_f32(const void* blocks, void* inv, void* sing, void* work,
                       int nc, int m, int b, float eps, int schedule,
                       int cluster, void* stream) {
  if (nc <= 0 || m <= b || m % b) return int(cudaErrorInvalidValue);
  const float* in = static_cast<const float*>(blocks);
  float* out = static_cast<float*>(inv);
  uint8_t* flags = static_cast<uint8_t*>(sing);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (schedule == 1) {
    if (work != nullptr) return kRefused;
    switch (b) {
      case 32: return launch_cluster<32>(in, out, flags, nc, m, eps, cluster, s);
      case 16: return launch_cluster<16>(in, out, flags, nc, m, eps, cluster, s);
      case 8: return launch_cluster<8>(in, out, flags, nc, m, eps, cluster, s);
      default: return int(cudaErrorInvalidValue);
    }
  }
  if (schedule != 0 || cluster != 1 || work == nullptr) return kRefused;
  switch (b) {
    case 32: return launch_l2<32>(in, out, flags, work, nc, m, eps, s);
    case 16: return launch_l2<16>(in, out, flags, work, nc, m, eps, s);
    case 8: return launch_l2<8>(in, out, flags, work, nc, m, eps, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
