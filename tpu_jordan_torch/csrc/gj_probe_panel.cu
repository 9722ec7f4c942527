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
//
// Design.  Three kernels (gj_probe_panel_init, _micro, _update), all on the
// caller's stream:
//   init    one block per candidate: W ← [A | I], ‖A‖∞, the finite check;
//   micro   one block per candidate, one launch per panel: the b serial
//           micro-steps on S and U held in shared memory (the strip is
//           (m, b): 64 KB at m=256, 128 KB at m=512 for the pair), with the
//           warp-shuffle argmax of gj_probe.cu; it then stores U and the b
//           raw pivot rows P to global memory;
//   update  one block per (64-column tile, 128-row chunk, candidate), one
//           launch per panel: W += U·P on the live columns, each thread
//           holding its column of P in registers.  The last panel writes
//           the B half straight into the output rows, unscrambled by perm.
// Why two launches per panel, and not one block per candidate throughout:
// the deferred update is ≈ 2m·b·2m flops per panel per candidate and is
// independent across (candidate, column tile, row chunk), so it fills the
// card (nc·tiles·chunks blocks) where a block per candidate would keep most
// SMs idle at nc ≤ Nr.  W (m x 2m fp32: 128 KB at m=128, 1.18 MB at m=384)
// therefore lives in a global scratch that the wrapper allocates and the
// L2 cache holds (26 MB at nc=22, m=384).  Columns left of the panel hold
// eliminated unit columns that no later output reads, so each update runs
// over columns k0+b..2m only; that changes no output value.
//
// What bounds it.  The micro-steps are m serial steps of three barriers
// each on one SM per candidate, but on an (m, b) strip instead of the
// (m, m) state of gj_probe.cu: latency, not flops or bytes.  The update moves
// the live part of W through L2 once per panel, m/b times in all.
//
// Arithmetic: fp32 FMAs (the JAX dots run at Precision.HIGHEST, so no TF32)
// and exact IEEE divisions: built by tpu_jordan_torch/_build.py without
// fast-math, like gj_probe.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

int max_optin_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <int B>
int launch(const float* blocks, float* inv, uint8_t* sing, void* work,
           int nc, int m, float eps, cudaStream_t stream) {
  const Work w = carve(work, nc, m, B);
  const int threads = m <= 64 ? 256 : (m <= 128 ? 512 : kMaxThreads);
  const size_t smem = micro_smem_bytes<B>(m);
  if (smem > size_t(max_optin_smem())) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gj_probe_panel_micro<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
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

}  // namespace

extern "C" {

// Words (4 bytes each) of the scratch a launch at (nc, m, b) needs.
size_t gj_probe_panel_work_words(int nc, int m, int b) {
  return work_words(nc, m, b);
}

// Launch the panel probe on `stream`: blocks and inv are contiguous
// (nc, m, m) fp32, sing is (nc,) uint8, work holds
// gj_probe_panel_work_words(nc, m, b) words.  b is the panel width: 32, 16
// or 8, dividing m, with m > b.  Returns the first CUDA error code of the
// launches (0 on success).
int gj_probe_panel_f32(const void* blocks, void* inv, void* sing, void* work,
                       int nc, int m, int b, float eps, void* stream) {
  if (nc <= 0 || m <= b || m % b) return int(cudaErrorInvalidValue);
  const float* in = static_cast<const float*>(blocks);
  float* out = static_cast<float*>(inv);
  uint8_t* flags = static_cast<uint8_t*>(sing);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 32: return launch<32>(in, out, flags, work, nc, m, eps, s);
    case 16: return launch<16>(in, out, flags, work, nc, m, eps, s);
    case 8: return launch<8>(in, out, flags, work, nc, m, eps, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
