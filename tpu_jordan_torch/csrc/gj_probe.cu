// Batched Gauss–Jordan inverse of a pivot-candidate stack: the probe of the
// block Jordan elimination for every block size without a panel width (and
// v3, the width-m in-place probe), as a hand-written kernel for Hopper
// (sm_90a).
//
// Replaces tpu_jordan/ops/pallas_block_inverse.py::_gj_probe_kernel (the
// dispatch body for m without a panel width) and _gj_inplace_kernel (v3).
// Both compute one function: for each m x m block of a contiguous (nc, m, m)
// stack, its inverse and a singular flag.  The flag is raised when the input
// holds a non-finite value, when s < eps, or when any pivot has
// |piv| < eps·s, where the scale s is ‖block‖∞, or |scale[0]| when the
// caller passes a one-element device scale (the augmented engine's global
// scale ‖A‖∞, main.cpp:782/972; a pointer, so the host never reads it) —
// the rule of the plain version, tpu_jordan_torch/ops/block_inverse.py.
//
// Value types.  fp32 and fp64, and complex64 and complex128 (the JAX
// package runs its complex probes through XLA's batched_block_inverse; the
// port has no XLA, so these bodies are that function's counterpart on the
// card).  Every body is templated on the value type V and its key type K,
// the real component type: keys, row sums, the scale and the threshold are
// real (|z| by hypot, NaN highest), so the slot reductions stay hardware
// reductions over real key bits, and only the raw pivot value (two
// shuffles for a complex one) and W are of type V.  A complex pivot is
// inverted once a step by Smith's method (no |z|² that could overflow or
// underflow) and the pivot row multiplied by that reciprocal; a real one
// keeps its exact IEEE divisions.
//
// Algebra.  Gauss–Jordan with implicit partial pivoting and the width-m
// in-place step: at step k the pivot is the unused row r with the largest
// |W[r,k]| (lowest row on ties, NaN highest), its row is divided by the
// pivot (one IEEE division an element; its column-k entry becomes 1/piv),
// and every other row takes w − f·prow with f = W[i,k] and column k taken
// as 0, so column k ends as column perm[k] of the permuted inverse and the
// [A | I] right half is never stored.  No row moves during the sweep: the
// store gathers inv[a][b] = W[perm[a]][pinv[b]].  The flag goes straight
// into a uint8 output.
//
// Design.  Every step is the same chain: find the pivot, form the pivot
// row, update.  Rows are owned: a warp owns a set of rows, its lanes the
// columns j ≡ lane (mod 32).  The update of step k computes each row's new
// column k+1, so the lane that holds it also takes the warp's candidate
// for step k+1 (|v|, row, v).  A step is then:
//   barrier X; every warp reduces the slots itself (redux.sync over the
//   key bits: no serial pass by one thread); the owner of row r divides it
//   into the prow buffer;
//   barrier Y; every warp updates its rows and publishes its candidate.
// Two barriers a step; the slots and prow are double-buffered by step
// parity.  Three schedules, picked by ops/gj_probe.py::probe_schedule and
// refused here when they do not fit:
//   block    m ≤ 128 (m ≤ 64 in complex128, whose 8 x 4 values a thread
//            would fill the 128 registers of a 512-thread block alone):
//            one block of 16 warps per candidate, W in its
//            registers: lane l of warp w holds W at rows w + 16·t and
//            columns l + 32·u in v[t][u] (at most 8 x 4 values).  A step
//            loads prow once a thread and costs an element an FMA and a
//            select; the factor W[i, k] of a row comes by a shuffle from
//            the lane that holds column k;
//   cluster  a thread-block cluster of C blocks of 32 warps per candidate
//            (2 ≤ C ≤ 16), each holding ⌈m/C⌉ rows of W in its shared
//            memory (fp32 to m = 896, fp64 to m = 609).  The warps'
//            candidates meet in their block first; warp 0 pushes the
//            block's winner, and the owner of row r pushes prow, into
//            every block's shared memory over distributed shared memory
//            (map_shared_rank stores).  X and Y are cluster barriers
//            (barrier.cluster arrive.release / wait.acquire); the last X
//            comes after the last remote store, so no block exits while
//            another may still write to it.  The update runs over column
//            batches: a lane loads prow at 8 of its columns once, then,
//            row by row, W there before it stores any;
//   global   the cluster schedule's code with each block's rows split: as
//            many as its shared memory holds stay there, the rest live in
//            a global scratch that the wrapper allocates and the L2 cache
//            holds.  It serves every m beyond a 16-block cluster (m = 1100
//            over 16 blocks), and a stack that no cluster holding all of W
//            runs in one wave (fp64 (22, 384) over 5 blocks, 8 of 77 rows
//            each in L2, against two waves of 8-block clusters).
// C is picked with the card's answer how many clusters it holds at once
// (cudaOccupancyMaxActiveClusters): the most blocks a candidate that
// still run all nc candidates in one wave, else those in the fewest waves.
// The answer and the kernel's attributes are asked once per shape
// (`prepare`), not at every launch.
// Measured on the card (PERF.md): with W in shared memory the block
// schedule was bound by instruction issue (a load and a store of W, a load
// of prow and the bookkeeping an element), and registers took (32, 128)
// from 0.53 to 0.33 ms; the cluster schedule's blocks hold more rows than
// their registers can, and there shared memory was the faster.
//
// What bounds it.  A candidate needs ≈ 2m³ flops but runs m serial steps,
// each closed by two barriers, with nc ≤ Nr candidates: latency and
// instruction issue, far above the bytes-or-flops bound.  A cluster cuts
// the work of a step by spreading W over C SMs; its barriers and remote
// stores cost more than a block's.
//
// Built by tpu_jordan_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no fast-math: the divisions by the pivots are exact IEEE divisions.

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
constexpr int kMaxWarps = 32;     // global: warps a block
constexpr int kRegWarps = 16;     // block and cluster: warps a block
constexpr int kMaxCluster = 16;
enum Schedule { kBlock = 0, kCluster = 1, kGlobal = 2 };

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Rows of W a block of a C-block cluster owns.
__host__ __device__ inline int rows_per_block(int m, int C) {
  return (m + C - 1) / C;
}

// The dynamic shared memory of one block, region by region (the slots are
// sized for 32 warps a block): w_rows rows of W (all the block's rows on
// the cluster schedule, as many as fit on the global one, none on the
// block one), then
// prow, the factors, the slots, the warps' slots, the flags and the
// permutation.  Values take `elem` bytes, keys and row sums `key`.
// ops/gj_probe.py::probe_smem_bytes mirrors it.
struct Layout {
  size_t W, prow, fcol, key, raw, row, wkey, wraw, wrow, nsum, nfin, used,
      perm, pinv, total;
};

__host__ __device__ inline Layout layout(int m, int C, int elem, int key,
                                         int w_rows) {
  const size_t R = rows_per_block(m, C), S = size_t(kMaxWarps) * C;
  const size_t sizes[14] = {size_t(w_rows) * m * elem,
                            2 * size_t(m) * elem,
                            R * elem,
                            2 * S * key,
                            2 * S * elem,
                            2 * S * 4,
                            size_t(kMaxWarps) * key,
                            size_t(kMaxWarps) * elem,
                            size_t(kMaxWarps) * 4,
                            S * key,
                            S * 4,
                            R * 4,
                            size_t(m) * 4,
                            size_t(m) * 4};
  size_t off[15];
  off[0] = 0;
  for (int i = 0; i < 14; ++i) off[i + 1] = off[i] + align16(sizes[i]);
  return Layout{off[0], off[1], off[2],  off[3],  off[4],
                off[5], off[6], off[7],  off[8],  off[9],
                off[10], off[11], off[12], off[13], off[14]};
}

// Columns a lane of the cluster and global schedules updates between its
// loads and its stores.
constexpr int kBatch = 8;

// A complex value, laid out as torch's complex64 / complex128 (re, im).
template <typename R>
struct __align__(2 * sizeof(R)) Cpx {
  R re, im;
  Cpx() = default;
  __device__ __forceinline__ constexpr Cpx(R r, R i = R(0)) : re(r), im(i) {}
};

template <typename R>
__device__ __forceinline__ Cpx<R> operator*(Cpx<R> a, Cpx<R> b) {
  return {fma(a.re, b.re, -a.im * b.im), fma(a.re, b.im, a.im * b.re)};
}
template <typename R>
__device__ __forceinline__ Cpx<R> operator-(Cpx<R> a, Cpx<R> b) {
  return {a.re - b.re, a.im - b.im};
}

// The key type of a value type: the value type itself for a real one, the
// component type for a complex one.
template <typename V>
struct KeyOf {
  using type = V;
};
template <typename R>
struct KeyOf<Cpx<R>> {
  using type = R;
};
template <typename V>
using key_t = typename KeyOf<V>::type;

// |v| in the key type, whether v is finite, whether it is 0.
__device__ __forceinline__ float mag(float v) { return fabsf(v); }
__device__ __forceinline__ double mag(double v) { return fabs(v); }
__device__ __forceinline__ float mag(Cpx<float> v) { return hypotf(v.re, v.im); }
__device__ __forceinline__ double mag(Cpx<double> v) { return hypot(v.re, v.im); }
template <typename T>
__device__ __forceinline__ bool finite(T v) { return isfinite(v); }
template <typename R>
__device__ __forceinline__ bool finite(Cpx<R> v) {
  return isfinite(v.re) && isfinite(v.im);
}
template <typename T>
__device__ __forceinline__ bool is_zero(T v) { return v == T(0); }
template <typename R>
__device__ __forceinline__ bool is_zero(Cpx<R> v) {
  return v.re == R(0) && v.im == R(0);
}

// The pivot's reciprocal, once a step, and an element of the pivot row
// scaled by it: a real pivot divides (one exact IEEE division an element),
// a complex one multiplies by its reciprocal by Smith's method.
template <typename T>
__device__ __forceinline__ T recip(T p) { return T(1) / p; }
template <typename R>
__device__ __forceinline__ Cpx<R> recip(Cpx<R> p) {
  if (fabs(p.re) >= fabs(p.im)) {
    const R r = p.im / p.re, d = p.re + p.im * r;
    return {R(1) / d, -r / d};
  }
  const R r = p.re / p.im, d = p.re * r + p.im;
  return {r / d, R(-1) / d};
}
template <typename T>
__device__ __forceinline__ T over_pivot(T x, T piv, T) { return x / piv; }
template <typename R>
__device__ __forceinline__ Cpx<R> over_pivot(Cpx<R> x, Cpx<R>, Cpx<R> rp) {
  return x * rp;
}

// A lane's value from lane `src`: two shuffles for a complex one.
template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(kFullMask, v, src);
}
template <typename R>
__device__ __forceinline__ Cpx<R> shfl(Cpx<R> v, int src) {
  return {__shfl_sync(kFullMask, v.re, src), __shfl_sync(kFullMask, v.im, src)};
}

// (v, i, x) <- the better of it and (ov, oi, ox): larger key, lower row on
// ties.  A total order, so every reduction gives every lane one winner.
template <typename K, typename V>
__device__ __forceinline__ void take_better(K& v, int& i, V& x, K ov, int oi,
                                            V ox) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
    x = ox;
  }
}

// The pivot key of a value: |v|, NaN highest (as in argmax).  Keys are
// never negative, so their bits order as unsigned integers.  An empty
// candidate is (key 0, row INT_MAX), and any row beats it.
template <typename V>
__device__ __forceinline__ key_t<V> key_of(V v) {
  const key_t<V> a = mag(v);
  return isnan(a) ? key_t<V>(INFINITY) : a;
}

// Whether this lane holds the largest key of the warp: hardware reductions
// over the key bits (high, then low word for fp64).
__device__ __forceinline__ bool holds_max(float key) {
  const unsigned b = __float_as_uint(key);
  return b == __reduce_max_sync(kFullMask, b);
}
__device__ __forceinline__ bool holds_max(double key) {
  const unsigned long long b = __double_as_longlong(key);
  const unsigned hi = unsigned(b >> 32), lo = unsigned(b);
  const unsigned mh = __reduce_max_sync(kFullMask, hi);
  const unsigned ml = __reduce_max_sync(kFullMask, hi == mh ? lo : 0u);
  return hi == mh && lo == ml;
}

// The warp's best row by take_better's order (the lowest row among the
// lanes that hold the largest key), in every lane, and its raw value.
template <typename K, typename V>
__device__ __forceinline__ int warp_best(K key, int row, V& raw) {
  const bool win = holds_max(key);
  const int r = int(__reduce_min_sync(
      kFullMask, win ? unsigned(row) : unsigned(INT_MAX)));
  const unsigned from = __ballot_sync(kFullMask, win && row == r);
  raw = shfl(raw, __ffs(from) - 1);
  return r;
}

template <bool kClustered>
struct Sync {
  __device__ __forceinline__ static void all() {
    if constexpr (kClustered)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
  // The address of `p` in the shared memory of cluster rank q.
  template <typename P>
  __device__ __forceinline__ static P* at(P* p, int q) {
    if constexpr (kClustered)
      return cg::this_cluster().map_shared_rank(p, q);
    else
      return p;
  }
};

// What every schedule shares: the cluster shape, the shared regions, the
// slots, the flag and the threshold.  V is the value type, K its key type.
template <typename V, bool kClustered>
struct Frame {
  using Sy = Sync<kClustered>;
  using K = key_t<V>;
  int C, rank, tid, nt, lane, warp, nwarps, S, R, r0, nloc, slot;
  V* W;       // [w_rows][m], the first own rows (cluster, global)
  V* prow;    // [2][m]
  V* fcol;    // [R], own rows (cluster, global)
  K* s_key;   // [2][S]
  V* s_raw;   // [2][S]
  int* s_row; // [2][S]
  K* w_key;   // [32], the block's warps (cluster, global)
  V* w_raw;
  int* w_row;
  K* s_nsum;  // [S], rank 0's
  int* s_nfin;
  int* used;  // [R], own rows (cluster, global)
  int* perm;  // [m]
  int* pinv;  // [m]

  __device__ Frame(unsigned char* smem, int m, int w_rows = 0) {
    C = 1;
    rank = 0;
    if constexpr (kClustered) {
      C = int(cg::this_cluster().num_blocks());
      rank = int(cg::this_cluster().block_rank());
    }
    tid = threadIdx.x;
    nt = blockDim.x;
    lane = tid & 31;
    warp = tid >> 5;
    nwarps = nt >> 5;
    S = C * nwarps;
    R = rows_per_block(m, C);
    r0 = rank * R;
    nloc = max(0, min(R, m - r0));
    slot = rank * nwarps + warp;
    const Layout L = layout(m, C, sizeof(V), sizeof(K), w_rows);
    W = reinterpret_cast<V*>(smem + L.W);
    prow = reinterpret_cast<V*>(smem + L.prow);
    fcol = reinterpret_cast<V*>(smem + L.fcol);
    s_key = reinterpret_cast<K*>(smem + L.key);
    s_raw = reinterpret_cast<V*>(smem + L.raw);
    s_row = reinterpret_cast<int*>(smem + L.row);
    w_key = reinterpret_cast<K*>(smem + L.wkey);
    w_raw = reinterpret_cast<V*>(smem + L.wraw);
    w_row = reinterpret_cast<int*>(smem + L.wrow);
    s_nsum = reinterpret_cast<K*>(smem + L.nsum);
    s_nfin = reinterpret_cast<int*>(smem + L.nfin);
    used = reinterpret_cast<int*>(smem + L.used);
    perm = reinterpret_cast<int*>(smem + L.perm);
    pinv = reinterpret_cast<int*>(smem + L.pinv);
  }

  // The warp's candidate (held by lane q) into its slot of parity par in
  // every block of the cluster: lanes 0..C-1 push one each.
  __device__ void publish(int par, int q, K best, int bi, V bx) const {
    best = __shfl_sync(kFullMask, best, q);
    bi = __shfl_sync(kFullMask, bi, q);
    bx = shfl(bx, q);
    if (lane < C) {
      const int at = par * S + slot;
      *Sy::at(s_key + at, lane) = best;
      *Sy::at(s_raw + at, lane) = bx;
      *Sy::at(s_row + at, lane) = bi;
    }
  }

  // The block's candidate into slot `rank` of parity par in every block of
  // the cluster: each warp's candidate (held by lane q) to the block's
  // warp slots, a block barrier, then warp 0 reduces them and its lanes
  // 0..C-1 push the winner, one remote store each.
  __device__ void publish_block(int par, int q, K best, int bi, V bx) const {
    best = __shfl_sync(kFullMask, best, q);
    bi = __shfl_sync(kFullMask, bi, q);
    bx = shfl(bx, q);
    if (lane == 0) {
      w_key[warp] = best;
      w_raw[warp] = bx;
      w_row[warp] = bi;
    }
    __syncthreads();
    if (warp != 0) return;
    K kb = K(0);
    V xb = V(0);
    int rb = INT_MAX;
    if (lane < nwarps) {
      kb = w_key[lane];
      xb = w_raw[lane];
      rb = w_row[lane];
    }
    rb = warp_best(kb, rb, xb);
    if (lane < C) {
      const int at = par * C + rank;
      *Sy::at(s_key + at, lane) = rb == INT_MAX ? K(0) : key_of(xb);
      *Sy::at(s_raw + at, lane) = xb;
      *Sy::at(s_row + at, lane) = rb;
    }
  }

  // The warp's largest own-row sum and non-finite flag to rank 0.
  __device__ void publish_norm(K row_max, int nonfinite) const {
    nonfinite = __any_sync(kFullMask, nonfinite);
    if (lane == 0) {
      *Sy::at(s_nsum + slot, 0) = row_max;
      *Sy::at(s_nfin + slot, 0) = nonfinite;
    }
  }

  // Rank 0's thread 0: the flag so far and the threshold eps·s, with s
  // the caller's |scale[0]| if given (a real value), else ‖block‖∞.
  __device__ void start_flag(K eps, const K* scale, int& bad,
                             K& thresh) const {
    bad = 0;
    thresh = K(0);
    if (rank == 0 && tid == 0) {
      K norm = K(0);
      for (int w = 0; w < S; ++w) {
        norm = fmax(norm, s_nsum[w]);
        bad |= s_nfin[w];
      }
      if (scale != nullptr) norm = fabs(*scale);
      bad = bad || norm < eps;
      thresh = eps * norm;
    }
  }

  // Every warp reduces the n slots of parity par (n = S, or C after
  // publish_block): the pivot row of step k and its raw value; thread 0
  // records it.
  __device__ int pick(int par, int k, V& piv, int& bad, K thresh,
                      int n) const {
    K best = K(0);
    piv = V(0);
    int r = INT_MAX;
    for (int w = lane; w < n; w += 32)
      take_better(best, r, piv, s_key[par * n + w], s_row[par * n + w],
                  s_raw[par * n + w]);
    r = warp_best(best, r, piv);
    if (tid == 0) {
      perm[k] = r;
      pinv[r] = k;
      if (rank == 0 && mag(piv) < thresh) bad = 1;
    }
    return r;
  }
};

// Block and cluster schedules: W lives in the registers of its blocks.
// Warp w of a block owns its local rows w + kRegWarps·t (t < RM), lane l
// the columns l + 32·u (u < CM); thread (w, l) holds W at those rows and
// columns in v[t][u].  A step loads prow once a thread (CM values) and
// updates its RM·CM values in place; the factor W[i, k] of a row comes
// from the lane that holds column k by a shuffle.
template <typename V, int CM, int RM>
__global__ void __launch_bounds__(kRegWarps * 32)
    gj_probe_reg_kernel(const V* __restrict__ blocks, V* __restrict__ inv,
                        uint8_t* __restrict__ sing, int m, key_t<V> eps,
                        const key_t<V>* __restrict__ scale) {
  using K = key_t<V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Frame<V, false> F(smem, m);
  using Sy = Sync<false>;
  const int lane = F.lane, warp = F.warp;
  const size_t mm = size_t(m) * m;
  const size_t cand = blockIdx.x / F.C;
  const V* a = blocks + cand * mm;

  // Row t of this thread is local row warp + kRegWarps·t, column u is
  // lane + 32·u; has_row and has_col mark those that exist.
  auto row_of = [&](int t) { return warp + kRegWarps * t; };
  auto has_row = [&](int t) { return row_of(t) < F.nloc; };
  auto has_col = [&](int u) { return lane + 32 * u < m; };

  // 1. Load the own rows, check that they are finite, take their largest
  //    row sum (for ‖block‖∞, on rank 0), and column 0's candidate.
  V v[RM][CM];
  int nonfinite = 0;
  K row_max = K(0), best = K(0);
  V bx = V(0);
  int bi = INT_MAX;
#pragma unroll
  for (int t = 0; t < RM; ++t) {
    const bool rt = has_row(t);
    const V* ai = a + size_t(F.r0 + row_of(t)) * m;
    K s = K(0);
#pragma unroll
    for (int u = 0; u < CM; ++u) {
      const int j = lane + 32 * u;
      const V x = rt && has_col(u) ? ai[j] : V(0);
      v[t][u] = x;
      nonfinite |= !finite(x);
      s += mag(x);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
    row_max = fmax(row_max, s);
    if (rt && lane == 0)
      take_better(best, bi, bx, key_of(v[t][0]), F.r0 + row_of(t), v[t][0]);
  }
  F.publish_norm(row_max, nonfinite);
  F.publish(0, 0, best, bi, bx);
  Sy::all();  // X_0

  int bad;
  K thresh;
  F.start_flag(eps, scale, bad, thresh);
  unsigned used = 0;  // bit t: own row t was a pivot

  for (int k = 0; k < m; ++k) {
    const int par = k & 1;
    // 2a. The pivot row r and its raw value.
    V piv;
    const int r = F.pick(par, k, piv, bad, thresh, F.S);
    // 2b. The warp that holds row r divides it by the pivot into every
    //     block's prow (its column-k entry becomes 1/piv, the inverse's
    //     column).
    V* pr = F.prow + par * m;
    const int lr = r - F.r0;
    if (lr >= 0 && lr < F.nloc && lr % kRegWarps == warp) {
      const int tr = lr / kRegWarps;
      const V safe = is_zero(piv) ? V(1) : piv;
      const V rp = recip(safe);
#pragma unroll
      for (int u = 0; u < CM; ++u) {
        V x = V(0);
#pragma unroll
        for (int t = 0; t < RM; ++t)
          if (t == tr) x = v[t][u];
        const int j = lane + 32 * u;
        if (has_col(u)) {
          const V y = j == k ? rp : over_pivot(x, safe, rp);
          for (int q = 0; q < F.C; ++q) *Sy::at(pr + j, q) = y;
        }
      }
    }
    Sy::all();  // Y_k

    // 2c. Rank-1 update of every other own row (column k of those rows
    //     starts from 0, so it becomes -f/piv); row r takes prow.  The lane
    //     of column k+1 takes the warp's candidate for the next step.
    const int lk = k & 31, uk = k >> 5;
    const int kn = k + 1, lkn = kn & 31, ukn = kn >> 5;
    V p[CM];
    bool zero[CM];
#pragma unroll
    for (int u = 0; u < CM; ++u) {
      p[u] = has_col(u) ? pr[lane + 32 * u] : V(0);
      zero[u] = u == uk && lane == lk;
    }
    K nb = K(0);
    V nx = V(0);
    int ni = INT_MAX;
#pragma unroll
    for (int t = 0; t < RM; ++t) {
      if (!has_row(t)) continue;
      const int g = F.r0 + row_of(t);
      if (g == r) {
#pragma unroll
        for (int u = 0; u < CM; ++u) v[t][u] = p[u];
        used |= 1u << t;
        continue;
      }
      V f = V(0);
#pragma unroll
      for (int u = 0; u < CM; ++u)
        if (u == uk) f = v[t][u];
      f = shfl(f, lk);
      V y = V(0);
#pragma unroll
      for (int u = 0; u < CM; ++u) {
        const V w = zero[u] ? V(0) : v[t][u];
        v[t][u] = w - f * p[u];
        if (u == ukn) y = v[t][u];
      }
      if (lane == lkn && !(used >> t & 1u))
        take_better(nb, ni, nx, key_of(y), g, y);
    }
    if (kn < m) F.publish(par ^ 1, lkn, nb, ni, nx);
    Sy::all();  // X_{k+1}
  }

  // 3. Unscramble in the store: inv[a][b] = W[perm[a]][pinv[b]], so
  //    W[g][j] goes to inv[pinv[g]][perm[j]].
  if (F.rank == 0 && F.tid == 0) sing[cand] = bad ? 1 : 0;
  V* out = inv + cand * mm;
#pragma unroll
  for (int t = 0; t < RM; ++t) {
    if (!has_row(t)) continue;
    V* o = out + size_t(F.pinv[F.r0 + row_of(t)]) * m;
#pragma unroll
    for (int u = 0; u < CM; ++u)
      if (has_col(u)) o[F.perm[lane + 32 * u]] = v[t][u];
  }
}

// Cluster and global schedules: W's rows split over the blocks of a
// cluster (2 ≤ C ≤ 16), all in their shared memory (kGlobalW false), or
// the first w_rows of each block's there and the rest in a global scratch
// that the L2 cache holds (kGlobalW true); warp w owns the local rows
// w + nwarps·t.  The update runs over column batches: a lane loads prow
// at kBatch of its columns once, then, row by row, W at those columns
// before it stores any.  The warps' candidates meet in the block first,
// so each block pushes one slot a step to the others.
template <typename V, bool kGlobalW>
__global__ void __launch_bounds__(kMaxWarps * 32)
    gj_probe_kernel(const V* __restrict__ blocks, V* __restrict__ inv,
                    uint8_t* __restrict__ sing, V* __restrict__ scratch,
                    int m, key_t<V> eps, const key_t<V>* __restrict__ scale,
                    int w_rows) {
  using K = key_t<V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Frame<V, true> F(smem, m, w_rows);
  using Sy = Sync<true>;
  const int tid = F.tid, nt = F.nt, lane = F.lane, warp = F.warp;
  const int nwarps = F.nwarps, nloc = F.nloc, r0 = F.r0;
  const size_t mm = size_t(m) * m;
  const size_t cand = blockIdx.x / F.C;
  const V* a = blocks + cand * mm + size_t(r0) * m;
  V* G = scratch + cand * mm + size_t(r0) * m;  // own rows (global)
  auto row = [&](int i) {
    return kGlobalW && i >= w_rows ? G + size_t(i) * m : F.W + size_t(i) * m;
  };

  // 1. Load the own rows into W, check that they are finite, take their
  //    largest row sum (for ‖block‖∞, on rank 0), and column 0's candidate.
  {
    int nonfinite = 0;
    K row_max = K(0), best = K(0);
    V bx = V(0);
    int bi = INT_MAX;
    for (int i = warp; i < nloc; i += nwarps) {
      const V* ai = a + size_t(i) * m;
      V* wi = row(i);
      K s = K(0);
      for (int j = lane; j < m; j += 32) {
        const V x = ai[j];
        wi[j] = x;
        nonfinite |= !finite(x);
        s += mag(x);
        if (j == 0) take_better(best, bi, bx, key_of(x), r0 + i, x);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
      row_max = fmax(row_max, s);
    }
    for (int i = tid; i < nloc; i += nt) F.used[i] = 0;
    F.publish_norm(row_max, nonfinite);
    F.publish_block(0, 0, best, bi, bx);
  }
  Sy::all();  // X_0

  int bad;
  K thresh;
  F.start_flag(eps, scale, bad, thresh);

  for (int k = 0; k < m; ++k) {
    const int par = k & 1;
    // 2a. The pivot row r and its raw value.
    V piv;
    const int r = F.pick(par, k, piv, bad, thresh, F.C);
    // 2b. The factors f = W[i, k] of the own rows, and the owner of row r
    //     divides it by the pivot into every block's prow.
    for (int i = tid; i < nloc; i += nt) F.fcol[i] = row(i)[k];
    V* pr = F.prow + par * m;
    if (r >= r0 && r < r0 + nloc) {
      const V safe = is_zero(piv) ? V(1) : piv;
      const V rp = recip(safe);
      const V* wr = row(r - r0);
      for (int j = tid; j < m; j += nt) {
        const V y = j == k ? rp : over_pivot(wr[j], safe, rp);
        for (int q = 0; q < F.C; ++q) *Sy::at(pr + j, q) = y;
      }
    }
    Sy::all();  // Y_k

    // 2c. Rank-1 update of every other own row (column k of those rows
    //     starts from 0, so it becomes -f/piv); row r takes prow.  The lane
    //     of column k+1 takes the warp's candidate for the next step.
    const int kn = k + 1;
    K nb = K(0);
    V nx = V(0);
    int ni = INT_MAX;
    for (int j0 = lane; j0 < m; j0 += 32 * kBatch) {
      V p[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + 32 * u;
        p[u] = j < m ? pr[j] : V(0);
      }
      for (int i = warp; i < nloc; i += nwarps) {
        V* wi = row(i);
        const int g = r0 + i;
        const bool pivot = g == r;
        const V f = F.fcol[i];
        const bool open = !F.used[i] && !pivot;
        V x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + 32 * u;
          x[u] = j < m && !pivot ? wi[j] : V(0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + 32 * u;
          if (j < m) {
            const V w = j == k ? V(0) : x[u];
            const V y = pivot ? p[u] : w - f * p[u];
            wi[j] = y;
            if (j == kn && open) take_better(nb, ni, nx, key_of(y), g, y);
          }
        }
      }
    }
    if (r >= r0 && r < r0 + nloc && tid == 0) F.used[r - r0] = 1;
    if (kn < m) F.publish_block(par ^ 1, kn & 31, nb, ni, nx);
    Sy::all();  // X_{k+1}
  }

  // 3. Unscramble in the store: inv[pinv[g]][b] = W[g][pinv[b]] for the
  //    own rows g.
  if (F.rank == 0 && tid == 0) sing[cand] = bad ? 1 : 0;
  V* out = inv + cand * mm;
  for (int i = warp; i < nloc; i += nwarps) {
    const V* wi = row(i);
    V* o = out + size_t(F.pinv[r0 + i]) * m;
    for (int j = lane; j < m; j += 32) o[j] = wi[F.pinv[j]];
  }
}

// Returned when a schedule does not fit (or the card cannot schedule its
// cluster); CUDA's own codes stay below 1000.
constexpr int kRefused = 1000;

int max_optin_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// The block schedule's register classes: (CM, RM), the columns a lane and
// the rows a warp hold; (2, 4) to m = 64, (4, 8) to m = 128.  In
// complex128 the (4, 8) class would hold 128 registers of W a thread, all
// that a 512-thread block has, so that type stops at m = 64
// (ops/gj_probe.py::reg_max_m).
template <typename V>
constexpr int reg_max_m() {
  return sizeof(V) > 8 ? 64 : 128;
}

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

// Launch `kernel` by `cfg` in clusters of C blocks (C = 1: no cluster), or
// refuse when the card cannot hold one.  `clusters` (if not null) gets the
// card's answer how many it holds at once instead of a launch (0 for
// C = 1).
template <typename K, typename... Args>
int run(K kernel, cudaLaunchConfig_t cfg, int C, int* clusters,
        Args... args) {
  const int cdim = C > 1 ? C : 0;
  const int n = prepare((const void*)kernel, cfg, cdim);
  if (n < 0) return -n;
  if (clusters != nullptr) {
    *clusters = cdim ? n : 0;
    return 0;
  }
  if (n < 1) return kRefused;
  cudaLaunchAttribute attr[1];
  if (cdim) set_cluster(cfg, attr, cdim);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

// Launch (or, with `clusters`, ask how many clusters the card holds).
template <typename V>
int launch(const void* blocks, void* inv, void* sing, void* scratch, int nc,
           int m, key_t<V> eps, const void* scale, int schedule, int C,
           void* stream, int* clusters = nullptr) {
  using K = key_t<V>;
  if (nc <= 0 || m <= 0) return int(cudaErrorInvalidValue);
  const bool global = schedule == kGlobal;
  if (C < 1 || C > kMaxCluster || C > m || schedule < kBlock ||
      schedule > kGlobal || (schedule == kBlock && C != 1) ||
      (schedule != kBlock && C < 2))
    return kRefused;
  if (clusters == nullptr && global != (scratch != nullptr)) return kRefused;
  if (schedule == kBlock && m > reg_max_m<V>()) return kRefused;
  const size_t optin = size_t(max_optin_smem());
  const int R = rows_per_block(m, C);
  int w_rows = schedule == kCluster ? R : 0;
  if (schedule == kGlobal) {
    // As many of the block's rows as its shared memory holds.
    const size_t base = layout(m, C, sizeof(V), sizeof(K), 0).total;
    const size_t fit =
        optin > base ? (optin - base) / (size_t(m) * sizeof(V)) : 0;
    w_rows = int(fit < size_t(R) ? fit : size_t(R));
    while (w_rows > 0 &&
           layout(m, C, sizeof(V), sizeof(K), w_rows).total > optin)
      --w_rows;
  }
  const size_t smem = layout(m, C, sizeof(V), sizeof(K), w_rows).total;
  if (smem > optin) return kRefused;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(nc) * C);
  cfg.blockDim = dim3(32 * (schedule == kBlock ? kRegWarps : kMaxWarps));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const V* in = static_cast<const V*>(blocks);
  V* o = static_cast<V*>(inv);
  uint8_t* flags = static_cast<uint8_t*>(sing);
  V* w = static_cast<V*>(scratch);
  const K* sc = static_cast<const K*>(scale);
  if (schedule == kBlock) {
    if (m <= 64)
      return run(gj_probe_reg_kernel<V, 2, 4>, cfg, 1, clusters, in, o, flags,
                 m, eps, sc);
    if constexpr (reg_max_m<V>() > 64)
      return run(gj_probe_reg_kernel<V, 4, 8>, cfg, 1, clusters, in, o, flags,
                 m, eps, sc);
    return kRefused;
  }
  if (schedule == kCluster)
    return run(gj_probe_kernel<V, false>, cfg, C, clusters, in, o, flags, w,
               m, eps, sc, w_rows);
  return run(gj_probe_kernel<V, true>, cfg, C, clusters, in, o, flags, w, m,
             eps, sc, w_rows);
}

}  // namespace

extern "C" {

// How many clusters of the schedule the card holds at once at block size
// m (0 for one block a candidate, or when it cannot hold one), for values
// of elem_bytes and keys of key_bytes: (4, 4) fp32, (8, 8) fp64, (8, 4)
// complex64, (16, 8) complex128.
int gj_probe_active_clusters(int m, int elem_bytes, int key_bytes,
                             int schedule, int cluster) {
  int n = 0;
  int err = kRefused;
  if (elem_bytes == 4 && key_bytes == 4)
    err = launch<float>(nullptr, nullptr, nullptr, nullptr, 1, m, 0.f,
                        nullptr, schedule, cluster, nullptr, &n);
  else if (elem_bytes == 8 && key_bytes == 8)
    err = launch<double>(nullptr, nullptr, nullptr, nullptr, 1, m, 0.0,
                         nullptr, schedule, cluster, nullptr, &n);
  else if (elem_bytes == 8 && key_bytes == 4)
    err = launch<Cpx<float>>(nullptr, nullptr, nullptr, nullptr, 1, m, 0.f,
                             nullptr, schedule, cluster, nullptr, &n);
  else if (elem_bytes == 16 && key_bytes == 8)
    err = launch<Cpx<double>>(nullptr, nullptr, nullptr, nullptr, 1, m, 0.0,
                              nullptr, schedule, cluster, nullptr, &n);
  return err ? 0 : n;
}

// Launch the probe on `stream`: blocks and inv are contiguous (nc, m, m),
// sing is (nc,) uint8.  schedule 0 (block: W in the registers of one block
// a candidate, cluster 1, m ≤ 128; complex128 m ≤ 64), 1 (cluster: W's
// rows in the shared memory of `cluster` blocks a candidate, 2..16) or 2
// (global: W in scratch, (nc, m, m), its rows over `cluster` blocks,
// 2..16); scratch is null unless global.  scale is null (each block's
// threshold scale is its own ‖block‖∞) or one device value of the blocks'
// real (component) type, the scale of every block; eps is of that type
// too.  The complex entries take interleaved (re, im) values.
// Returns 0, a CUDA error code, or 1000 when the schedule does not fit
// this card.
int gj_probe_f32(const void* blocks, void* inv, void* sing, void* scratch,
                 int nc, int m, float eps, const void* scale, int schedule,
                 int cluster, void* stream) {
  return launch<float>(blocks, inv, sing, scratch, nc, m, eps, scale,
                       schedule, cluster, stream);
}

int gj_probe_f64(const void* blocks, void* inv, void* sing, void* scratch,
                 int nc, int m, double eps, const void* scale, int schedule,
                 int cluster, void* stream) {
  return launch<double>(blocks, inv, sing, scratch, nc, m, eps, scale,
                        schedule, cluster, stream);
}

int gj_probe_c64(const void* blocks, void* inv, void* sing, void* scratch,
                 int nc, int m, float eps, const void* scale, int schedule,
                 int cluster, void* stream) {
  return launch<Cpx<float>>(blocks, inv, sing, scratch, nc, m, eps, scale,
                            schedule, cluster, stream);
}

int gj_probe_c128(const void* blocks, void* inv, void* sing, void* scratch,
                  int nc, int m, double eps, const void* scale, int schedule,
                  int cluster, void* stream) {
  return launch<Cpx<double>>(blocks, inv, sing, scratch, nc, m, eps, scale,
                             schedule, cluster, stream);
}

}  // extern "C"
