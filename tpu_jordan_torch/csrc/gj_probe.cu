// Batched Gauss–Jordan inverse of a pivot-candidate stack: the probe of the
// block Jordan elimination, as a hand-written kernel for Hopper (sm_90a).
//
// Replaces tpu_jordan/ops/pallas_block_inverse.py::pallas_batched_block_inverse
// and the two kernel bodies it dispatches to, _gj_fused_panel_kernel (m % 128
// == 0) and _gj_probe_kernel (every other m).  Both compute one function: for
// each m x m block of a contiguous (nc, m, m) stack, its inverse and a
// singular flag.  The flag is raised when the input holds a non-finite value,
// when ‖block‖∞ < eps, or when any pivot has |piv| < eps·‖block‖∞ — the rule
// of the plain version, tpu_jordan_torch/ops/block_inverse.py.
//
// Design.  One thread block per candidate.  Gauss–Jordan with implicit
// partial pivoting and the width-m in-place algebra: at step k the pivot is
// the unused row r with the largest |W[r,k]| (lowest row on ties, found by a
// warp-shuffle argmax and a pass over the warps' winners), its row is divided
// by the pivot, and every other row takes a rank-1 update; column k then holds
// column perm[k] of the permuted inverse, so the [A | I] right half is never
// stored.  No row is moved during the sweep: the store gathers
// inv[a][b] = W[perm[a]][pinv[b]], writing rows of the output contiguously.
// The flag goes straight into a uint8 output.
//
// Memory.  W lives in dynamic shared memory when it fits the card's opt-in
// limit (227 KB on an H100: fp32 up to m ≈ 232, fp64 up to m ≈ 164), and
// otherwise in a global scratch that the wrapper allocates, where the L2
// cache holds it (at n = 8192, m = 384 the whole stack is 22 x 576 KB).  One
// kernel body serves both cases through the pointer W.
//
// What bounds it.  A block needs ≈ 2m³ flops but runs m sequential steps,
// each closed by block-wide barriers, and there are only nc ≤ Nr blocks (32 at
// n = 4096, m = 128), so most SMs idle and each step's cost is barrier and
// shared-memory latency rather than arithmetic: the kernel is latency-bound,
// far above its bytes-or-flops bound.  The design keeps every step inside one
// SM (no global round trip when W fits shared memory) and takes three barriers
// per step; spreading a block over a cluster, or deferring updates in panels,
// is left to later work.
//
// Built by tpu_jordan_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no fast-math: the divisions by the pivots are exact IEEE divisions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr size_t kHeaderBytes = 64;

template <typename T>
struct Header {
  T norm;   // ‖block‖∞
  T piv;    // this step's raw pivot
  int row;  // this step's pivot row
  int bad;  // singular flag
};

// (v, i) <- the better of (v, i) and (ov, oi): larger value, lower row on
// ties.  A total order, so the warp butterfly gives every lane one winner.
template <typename T>
__device__ __forceinline__ void take_better(T& v, int& i, T ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <typename T>
__host__ __device__ size_t smem_bytes(int m, bool w_in_smem) {
  return kHeaderBytes + (w_in_smem ? size_t(m) * m * sizeof(T) : 0) +
         2 * size_t(m) * sizeof(T) + 32 * sizeof(T) + 32 * sizeof(int) +
         3 * size_t(m) * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gj_probe_kernel(const T* __restrict__ blocks, T* __restrict__ inv,
                    uint8_t* __restrict__ sing, T* scratch, int m, T eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const size_t mm = size_t(m) * m;
  const T* a = blocks + blockIdx.x * mm;
  T* out = inv + blockIdx.x * mm;

  Header<T>* hd = reinterpret_cast<Header<T>*>(smem);
  unsigned char* p = smem + kHeaderBytes;
  T* W;
  if (scratch != nullptr) {
    W = scratch + blockIdx.x * mm;
  } else {
    W = reinterpret_cast<T*>(p);
    p += mm * sizeof(T);
  }
  T* prow = reinterpret_cast<T*>(p);
  p += m * sizeof(T);
  T* fcol = reinterpret_cast<T*>(p);
  p += m * sizeof(T);
  T* red_val = reinterpret_cast<T*>(p);
  p += 32 * sizeof(T);
  int* red_idx = reinterpret_cast<int*>(p);
  p += 32 * sizeof(int);
  int* perm = reinterpret_cast<int*>(p);
  p += m * sizeof(int);
  int* pinv = reinterpret_cast<int*>(p);
  p += m * sizeof(int);
  int* used = reinterpret_cast<int*>(p);

  // 1. Load the block into W, check that it is finite, take ‖block‖∞
  //    (one warp per row, a butterfly sum over the lanes).
  int nonfinite = 0;
  T row_max = T(0);
  for (int i = warp; i < m; i += nwarps) {
    T s = T(0);
    for (int j = lane; j < m; j += 32) {
      const T x = a[size_t(i) * m + j];
      W[size_t(i) * m + j] = x;
      nonfinite |= !isfinite(x);
      s += fabs(x);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
    row_max = fmax(row_max, s);
  }
  for (int i = tid; i < m; i += nt) used[i] = 0;
  if (lane == 0) red_val[warp] = row_max;
  nonfinite = __syncthreads_or(nonfinite);
  if (tid == 0) {
    T norm = T(0);
    for (int w = 0; w < nwarps; ++w) norm = fmax(norm, red_val[w]);
    hd->norm = norm;
    hd->bad = nonfinite || norm < eps;
  }
  __syncthreads();
  const T thresh = eps * hd->norm;

  for (int k = 0; k < m; ++k) {
    // 2a. Pivot: the unused row with the largest |W[r,k]|, lowest row on
    //     ties; NaN ranks highest, as in argmax.
    T best = T(-1);
    int bi = m;
    for (int r = tid; r < m; r += nt) {
      if (!used[r]) {
        T v = fabs(W[size_t(r) * m + k]);
        if (isnan(v)) v = T(INFINITY);
        take_better(best, bi, v, r);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const T ov = __shfl_xor_sync(kFullMask, best, o);
      const int oi = __shfl_xor_sync(kFullMask, bi, o);
      take_better(best, bi, ov, oi);
    }
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nwarps; ++w)
        take_better(best, bi, red_val[w], red_idx[w]);
      const T piv = W[size_t(bi) * m + k];
      hd->row = bi;
      hd->piv = piv;
      used[bi] = 1;
      perm[k] = bi;
      pinv[bi] = k;
      if (fabs(piv) < thresh) hd->bad = 1;
    }
    __syncthreads();

    // 2b. The pivot row divided by the pivot (its column-k entry becomes
    //     1/piv, the inverse's column), and the factor column.
    const int r = hd->row;
    const T piv = hd->piv;
    const T safe = piv == T(0) ? T(1) : piv;
    for (int j = tid; j < m; j += nt) {
      prow[j] = j == k ? T(1) / safe : W[size_t(r) * m + j] / safe;
      fcol[j] = j == r ? T(0) : W[size_t(j) * m + k];
    }
    __syncthreads();

    // 2c. Rank-1 update of every other row; column k of those rows starts
    //     from 0, so it becomes -f/piv.
    for (int i = warp; i < m; i += nwarps) {
      T* wi = W + size_t(i) * m;
      if (i == r) {
        for (int j = lane; j < m; j += 32) wi[j] = prow[j];
      } else {
        const T f = fcol[i];
        for (int j = lane; j < m; j += 32) {
          const T w = j == k ? T(0) : wi[j];
          wi[j] = w - f * prow[j];
        }
      }
    }
    __syncthreads();
  }

  // 3. Unscramble in the store: inv[a][b] = W[perm[a]][pinv[b]].
  if (tid == 0) sing[blockIdx.x] = hd->bad ? 1 : 0;
  for (int i = warp; i < m; i += nwarps) {
    const T* wr = W + size_t(perm[i]) * m;
    for (int j = lane; j < m; j += 32) out[size_t(i) * m + j] = wr[pinv[j]];
  }
}

int max_optin_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <typename T>
int launch(const void* blocks, void* inv, void* sing, void* scratch, int nc,
           int m, T eps, void* stream) {
  if (nc <= 0 || m <= 0) return int(cudaErrorInvalidValue);
  const int threads = m <= 64 ? 256 : (m <= 256 ? 512 : kMaxThreads);
  const size_t smem = smem_bytes<T>(m, scratch == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      gj_probe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  gj_probe_kernel<T><<<nc, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<T*>(inv),
      static_cast<uint8_t*>(sing), static_cast<T*>(scratch), m, eps);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// 1 when an m x m block of elem_bytes-wide values fits the card's shared
// memory (the wrapper then passes no scratch), 0 when it must live in a
// global scratch of nc*m*m values.
int gj_probe_w_in_smem(int m, int elem_bytes) {
  const size_t need = elem_bytes == 8 ? smem_bytes<double>(m, true)
                                      : smem_bytes<float>(m, true);
  return need <= size_t(max_optin_smem()) ? 1 : 0;
}

// Launch the probe on `stream`: blocks and inv are contiguous (nc, m, m),
// sing is (nc,) uint8, scratch is null or (nc, m, m).  Returns the CUDA
// error code of the launch (0 on success).
int gj_probe_f32(const void* blocks, void* inv, void* sing, void* scratch,
                 int nc, int m, float eps, void* stream) {
  return launch<float>(blocks, inv, sing, scratch, nc, m, eps, stream);
}

int gj_probe_f64(const void* blocks, void* inv, void* sing, void* scratch,
                 int nc, int m, double eps, void* stream) {
  return launch<double>(blocks, inv, sing, scratch, nc, m, eps, stream);
}

}  // extern "C"
