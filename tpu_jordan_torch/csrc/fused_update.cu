// The group-closing update of the delayed-group-update engine, as a
// hand-written kernel for Hopper (sm_90a).
//
// Replaces tpu_jordan/ops/pallas_update.py::_fused_update_kernel (reached
// through fused_normalize_eliminate).  It computes, for the working matrix
// V (N x N), the pending panels U (N x KM) and P (KM x N), the inverted pivot
// block H (m x m) and the raw pivot block-row rows_p (m x N):
//
//   prow = H @ rows_p, with prow[:, t*m:(t+1)*m] = H exactly;
//   P_eff = P with row block j replaced by prow;
//   V <- V' - U @ P_eff, where V' is V with its pivot column block zeroed;
//   V[t*m:(t+1)*m, :] <- prow.
//
// In bf16 mode every operand of both products (H, rows_p, U, P_eff) is
// rounded to bf16 (round to nearest even) as it is staged into shared memory
// and multiplied in fp32: a product of two bf16 values is exact in fp32, so
// only the summation order can differ from the plain version.  The H
// insertion and the stored values stay fp32 in both modes.
//
// Design.  The TPU kernel recomputes prow inside every grid program with
// one-hot dots; on this card that would repeat the m x m x N normalize once
// per row tile, as many flops as the update itself at m = 128.  So there are
// two launches of one tiled kernel body:
//   1. prow (m x N) = H @ rows_p into a scratch the wrapper allocates, with
//      the H block written in the epilogue;
//   2. the update: a 2-D grid of 128 x 128 output tiles of V; 256 threads,
//      an 8 x 8 fp32 register tile each; the contraction KM walks through
//      shared memory in chunks of 16, the next chunk's global loads in flight
//      in registers while the current chunk is multiplied.  A chunk row of B
//      comes from P, or from prow inside slot j.  The epilogue reads V as 0 in
//      the pivot column block, writes v - acc, and writes prow in the pivot
//      row block.  Each output element reads only its own V element, so V is
//      updated in place.
// Every output accumulates its contraction in ascending order with one fmaf
// per term, so in bf16 mode prow equals the plain version's sequential fp32
// sum bit for bit, and its second rounding (prow as an operand of the
// update) is the plain version's too.
//
// What bounds it.  At N = 8192, KM = 256 the update is 2*N*N*KM = 3.4e10
// flops against 553 MB of traffic (V in and out, U, P): fp32 outside the
// tensor cores (67 TFLOP/s) makes it operation-bound at 0.51 ms.  A SIMT
// kernel like this one sits well below that rate; the tensor-core (mma.sync /
// wgmma, TMA) version is later work.  Ragged edges (N or KM not a multiple of
// the tile) are guarded on every load and store.
//
// Built by tpu_jordan_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output tile rows
constexpr int kBN = 128;       // output tile columns
constexpr int kBK = 16;        // contraction chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPad = 4;        // keeps the transposed A tile's rows 16B-aligned
constexpr int kLoads = kBM * kBK / kThreads;  // A (and B) values per thread

enum Stage { kProw = 0, kUpdate = 1 };

struct Args {
  int rows, cols, depth;  // output rows x cols, contraction length
  const float* a;         // rows x depth, leading dimension lda
  int lda;
  const float* b;         // depth x cols, leading dimension ldb
  const float* slot;      // replaces b's rows [slot0, slot0 + m), or null
  int ldb, slot0;
  float* out;             // rows x cols, leading dimension ldo
  const float* prow;      // m x cols: the pivot rows (update stage)
  const float* h;         // m x m: the H block (prow stage)
  int ldo, m, t;
};

template <bool kBf16>
__device__ __forceinline__ float stage_operand(float x) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Row of the 8 x 8 register tile i (0..7) of thread row ty, inside the tile;
// the same map serves columns.  Two groups of four, 64 apart, so the shared
// memory reads are conflict-free float4s.
__device__ __forceinline__ int frag_index(int ty, int i) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}

template <int kStage, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    fused_update_tile(const Args args) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];  // A tile, transposed
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;

  float a_next[kLoads], b_next[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      // A: 16 consecutive k of one row per half-warp.
      const int ar = r0 + e / kBK, ak = k0 + e % kBK;
      a_next[i] = (ar < args.rows && ak < args.depth)
                      ? args.a[size_t(ar) * args.lda + ak]
                      : 0.f;
      // B: 128 consecutive columns of one contraction row per four warps.
      const int bk = k0 + e / kBN, bc = c0 + e % kBN;
      float v = 0.f;
      if (bk < args.depth && bc < args.cols) {
        const bool in_slot = args.slot != nullptr && bk >= args.slot0 &&
                             bk < args.slot0 + args.m;
        v = in_slot ? args.slot[size_t(bk - args.slot0) * args.ldb + bc]
                    : args.b[size_t(bk) * args.ldb + bc];
      }
      b_next[i] = v;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      As[e % kBK][e / kBK] = stage_operand<kBf16>(a_next[i]);
      Bs[e / kBN][e % kBN] = stage_operand<kBf16>(b_next[i]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < args.depth; k0 += kBK) {
    const bool more = k0 + kBK < args.depth;
    if (more) load(k0 + kBK);  // next chunk's loads fly during this one
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float af[8], bf[8];
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      af[0] = a_lo.x; af[1] = a_lo.y; af[2] = a_lo.z; af[3] = a_lo.w;
      af[4] = a_hi.x; af[5] = a_hi.y; af[6] = a_hi.z; af[7] = a_hi.w;
      bf[0] = b_lo.x; bf[1] = b_lo.y; bf[2] = b_lo.z; bf[3] = b_lo.w;
      bf[4] = b_hi.x; bf[5] = b_hi.y; bf[6] = b_hi.z; bf[7] = b_hi.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // Epilogue: the bookkeeping masks of the TPU kernel, per element.
  const int p0 = args.t * args.m, p1 = p0 + args.m;  // pivot block bounds
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + frag_index(ty, i);
    if (r >= args.rows) continue;
    float* orow = args.out + size_t(r) * args.ldo;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + frag_index(tx, j);
      if (c >= args.cols) continue;
      const bool pivot_col = c >= p0 && c < p1;
      if (kStage == kProw) {
        // prow = H @ rows_p, with H inserted exactly at the pivot columns.
        orow[c] = pivot_col ? args.h[size_t(r) * args.m + (c - p0)]
                            : acc[i][j];
      } else if (r >= p0 && r < p1) {
        // Pivot rows take the normalized row verbatim.
        orow[c] = args.prow[size_t(r - p0) * args.cols + c];
      } else {
        // The pivot column block reads as zero: the update writes the
        // inverse-building column -E.H there.
        const float v = pivot_col ? 0.f : orow[c];
        orow[c] = v - acc[i][j];
      }
    }
  }
}

template <bool kBf16>
int launch(float* v, const float* u, const float* p, const float* h,
           const float* rows_p, float* prow, int n, int km, int m, int t,
           int j, cudaStream_t stream) {
  // Launch 1: prow (m x n) = H @ rows_p, H inserted at the pivot columns.
  Args a1{};
  a1.rows = m;
  a1.cols = n;
  a1.depth = m;
  a1.a = h;
  a1.lda = m;
  a1.b = rows_p;
  a1.slot = nullptr;
  a1.ldb = n;
  a1.slot0 = 0;
  a1.out = prow;
  a1.prow = nullptr;
  a1.h = h;
  a1.ldo = n;
  a1.m = m;
  a1.t = t;
  const dim3 g1((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  fused_update_tile<kProw, kBf16><<<g1, kThreads, 0, stream>>>(a1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  // Launch 2: V <- V' - U @ [P with slot j = prow], pivot rows = prow.
  Args a2{};
  a2.rows = n;
  a2.cols = n;
  a2.depth = km;
  a2.a = u;
  a2.lda = km;
  a2.b = p;
  a2.slot = prow;
  a2.ldb = n;
  a2.slot0 = j * m;
  a2.out = v;
  a2.prow = prow;
  a2.h = h;
  a2.ldo = n;
  a2.m = m;
  a2.t = t;
  const dim3 g2((n + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  fused_update_tile<kUpdate, kBf16><<<g2, kThreads, 0, stream>>>(a2);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The group-closing update on `stream`.  v is (n, n), u (n, km), p (km, n),
// h (m, m), rows_p (m, n) and prow an (m, n) scratch, all contiguous fp32 on
// the device; v is updated in place.  bf16 != 0 selects bf16 operands with
// fp32 accumulation.  Returns the CUDA error code of the launches (0 on
// success), or cudaErrorInvalidValue for shapes the caller contract excludes.
int fused_update_f32(void* v, const void* u, const void* p, const void* h,
                     const void* rows_p, void* prow, int n, int km, int m,
                     int t, int j, int bf16, void* stream) {
  if (n <= 0 || km <= 0 || m <= 0 || n % m != 0 || km % m != 0 || t < 0 ||
      t >= n / m || j < 0 || j >= km / m)
    return int(cudaErrorInvalidValue);
  auto fn = bf16 ? &launch<true> : &launch<false>;
  return fn(static_cast<float*>(v), static_cast<const float*>(u),
            static_cast<const float*>(p), static_cast<const float*>(h),
            static_cast<const float*>(rows_p), static_cast<float*>(prow), n,
            km, m, t, j, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
