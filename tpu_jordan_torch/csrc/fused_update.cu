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
// rounded to bf16 (round to nearest even) and multiplied with fp32
// accumulation: a product of two bf16 values is exact in fp32, so only the
// summation order can differ from the plain version.  The H insertion and the
// stored values stay fp32 in both modes.
//
// Design.  The TPU kernel recomputes prow inside every grid program with
// one-hot dots; on this card that would repeat the m x m x N normalize once
// per row tile, so prow has its own launch:
//   prow    prow (m x N) = H @ rows_p into a scratch the wrapper allocates,
//           64 x 64 tiles, SIMT fp32 FMAs summed in ascending order (so in
//           bf16 mode prow equals the plain version's sequential sum bit for
//           bit), H written in the epilogue.  In bf16 mode it also writes
//           bf16(prow) straight into P_eff's slot j of the bf16 operand.
//   to_bf16 (bf16 mode) U and the rest of P rounded to bf16 once, into
//           buffers the wrapper allocates (U negated, which is exact), with
//           their leading dimensions padded to a multiple of 8 with zeros.
//   update  V <- V' - U @ P_eff in one pass over V: each block owns a tile of
//           V, runs the contraction through a cp.async ring of
//           shared-memory stages (one barrier a stage), and writes the tile
//           back, or prow in the pivot row block; the pivot column block of V
//           reads as 0.  Each output element reads only its own V element,
//           so V is updated in place.  V is read and written once, with
//           16-byte accesses.
//     bf16: 128 x 128 tiles, 8 warps of 64 x 32, mma.sync m16n8k16
//           (bf16 x bf16 -> fp32) fed by ldmatrix from a 4-stage ring of
//           16-deep chunks.  The V tile streams into shared memory behind
//           the contraction, one bulk (TMA) copy a row counted by an
//           mbarrier that only the epilogue waits on; the epilogue adds it
//           to the accumulators, and lane pairs swap halves of their
//           fragments so that V is written as float4.  Two blocks an SM.
//     fp32: true fp32 on the FMA pipes (no TF32): 256 threads, V loaded
//           into the accumulators, a 3-stage ring of 32-deep chunks;
//           128 x 128 tiles with an 8 x 8 register tile a thread (at most
//           128 registers: two blocks an SM) where there are two tiles for
//           every SM, else 64 x 64 tiles with 4 x 4 a thread, which spread
//           a small matrix (N = 1536) more evenly.
//
// What bounds it.  At N = 8192, KM = 256 the update is 2*N*N*KM = 3.4e10
// flops against 553 MB of traffic (V in and out, U, P).  fp32 outside the
// tensor cores (67 TFLOP/s) makes the fp32 mode operation-bound at 0.51 ms;
// the bf16 tensor cores take the flops in a fraction of the 0.16 ms that V's
// fp32 read and write need, so the bf16 mode is bound by V's bytes; each
// 128 x 128 tile also reads 2·128·KM bytes of bf16 operands from L2.
//
// Built by tpu_jordan_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and no fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBK = 32;  // contraction chunk of the fp32 update

struct Close {
  int n, km, m, t, j;
  float* v;             // n x n, updated in place
  const float* u;       // n x km
  const float* p;       // km x n
  const float* h;       // m x m
  const float* rows_p;  // m x n
  float* prow;          // m x n scratch
  bf16* ub;             // n x kmp: bf16(-U), bf16 mode
  bf16* pb;             // km x np: bf16(P_eff), bf16 mode
  int kmp, np;          // padded leading dimensions of ub, pb
  bool vec;             // n % 4 == 0, km % 4 == 0 and 16-byte aligned data
};

__host__ __device__ constexpr int round8(int x) { return (x + 7) / 8 * 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (or 4-byte) global -> shared copy; zero-filled when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
// A bulk copy (the TMA engine) of `bytes` contiguous bytes into shared
// memory, reported to the mbarrier `bar`; and the barrier's set-up and wait.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The pivot bookkeeping of an output element.
__device__ __forceinline__ bool in_block(int x, int lo, int m) {
  return x >= lo && x < lo + m;
}

// V' (V with the pivot column block zeroed) at row r, columns c..c+3, as
// the accumulators start; 0 outside the matrix and in the pivot row block.
// Branch-free (a masked element loads V[0] and is then zeroed), so that a
// thread's loads of a whole tile are all in flight together.
__device__ __forceinline__ float4 load_v4(const Close& a, int r, int c) {
  const int p0 = a.t * a.m;
  const bool ok = r < a.n && c < a.n && !in_block(r, p0, a.m);
  float4 x = *reinterpret_cast<const float4*>(
      a.v + (ok ? size_t(r) * a.n + c : 0));
  x.x = ok && !in_block(c, p0, a.m) ? x.x : 0.f;
  x.y = ok && !in_block(c + 1, p0, a.m) ? x.y : 0.f;
  x.z = ok && !in_block(c + 2, p0, a.m) ? x.z : 0.f;
  x.w = ok && !in_block(c + 3, p0, a.m) ? x.w : 0.f;
  return x;
}

// Row r, columns c..c+3 of the output: the accumulators, or prow in the
// pivot row block.
__device__ __forceinline__ void store_v4(const Close& a, int r, int c,
                                         float4 x) {
  if (r >= a.n || c >= a.n) return;
  const int p0 = a.t * a.m;
  if (in_block(r, p0, a.m))
    x = *reinterpret_cast<const float4*>(a.prow + size_t(r - p0) * a.n + c);
  *reinterpret_cast<float4*>(a.v + size_t(r) * a.n + c) = x;
}

// The same, one element at a time (n % 4 != 0 or unaligned data).
__device__ __forceinline__ float load_v1(const Close& a, int r, int c) {
  const int p0 = a.t * a.m;
  const bool ok = r < a.n && c < a.n && !in_block(r, p0, a.m) &&
                  !in_block(c, p0, a.m);
  const float x = a.v[ok ? size_t(r) * a.n + c : 0];
  return ok ? x : 0.f;
}
__device__ __forceinline__ void store_v1(const Close& a, int r, int c,
                                         float x) {
  if (r >= a.n || c >= a.n) return;
  const int p0 = a.t * a.m;
  if (in_block(r, p0, a.m)) x = a.prow[size_t(r - p0) * a.n + c];
  a.v[size_t(r) * a.n + c] = x;
}

// ---------------------------------------------------------------- prow ---

constexpr int kPM = 64;         // prow tile rows
constexpr int kPT = 64;         // prow tile columns
constexpr int kPK = 16;         // prow contraction chunk
constexpr int kPR = kPM / 16;   // rows a thread

template <bool kBf16>
__device__ __forceinline__ float stage_operand(float x) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// prow = H @ rows_p with H at the pivot columns; 256 threads, kPR x 4 each.
// The next chunk's global loads fly in registers while the current chunk is
// multiplied.
template <bool kBf16>
__global__ void __launch_bounds__(256) fused_update_prow(const Close a) {
  __shared__ __align__(16) float Hs[kPK][kPM + 4];  // H tile, transposed
  __shared__ __align__(16) float Rs[kPK][kPT];
  constexpr int kLoadsH = kPM * kPK / 256, kLoadsR = kPT * kPK / 256;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * kPM, c0 = blockIdx.x * kPT;
  float h_next[kLoadsH], r_next[kLoadsR];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoadsH; ++i) {
      const int e = tid + i * 256;
      const int hr = e / kPK, hk = e % kPK;
      h_next[i] = (r0 + hr < a.m && k0 + hk < a.m)
                      ? a.h[size_t(r0 + hr) * a.m + k0 + hk]
                      : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoadsR; ++i) {
      const int e = tid + i * 256;
      const int rk = e / kPT, rc = e % kPT;
      r_next[i] = (k0 + rk < a.m && c0 + rc < a.n)
                      ? a.rows_p[size_t(k0 + rk) * a.n + c0 + rc]
                      : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kLoadsH; ++i) {
      const int e = tid + i * 256;
      Hs[e % kPK][e / kPK] = stage_operand<kBf16>(h_next[i]);
    }
#pragma unroll
    for (int i = 0; i < kLoadsR; ++i) {
      const int e = tid + i * 256;
      Rs[e / kPT][e % kPT] = stage_operand<kBf16>(r_next[i]);
    }
  };
  float acc[kPR][4] = {};
  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < a.m; k0 += kPK) {
    const bool more = k0 + kPK < a.m;
    if (more) load(k0 + kPK);
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk) {
      const float4 r4 = *reinterpret_cast<const float4*>(&Rs[kk][tx * 4]);
      const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int q = 0; q < kPR; ++q) {
        const float hv = Hs[kk][ty * kPR + q];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = fmaf(hv, rv[e], acc[q][e]);
      }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }
  const int p0 = a.t * a.m;
#pragma unroll
  for (int q = 0; q < kPR; ++q) {
    const int r = r0 + ty * kPR + q;
    if (r >= a.m) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + tx * 4 + e;
      if (c >= a.n) continue;
      const float x =
          in_block(c, p0, a.m) ? a.h[size_t(r) * a.m + (c - p0)] : acc[q][e];
      a.prow[size_t(r) * a.n + c] = x;
      if (kBf16)
        a.pb[size_t(a.j * a.m + r) * a.np + c] = __float2bfloat16_rn(x);
    }
  }
}

// ------------------------------------------------------------- to_bf16 ---

// ub = bf16(-U) (n x kmp) and pb = bf16(P) (km x np) outside slot j, zero
// in the padding; one 8-wide chunk (one 16-byte store) a thread.
__global__ void __launch_bounds__(256) fused_update_to_bf16(const Close a) {
  const size_t chunks_u = size_t(a.n) * (a.kmp / 8);
  const size_t chunks_p = size_t(a.km) * (a.np / 8);
  for (size_t e = blockIdx.x * size_t(blockDim.x) + threadIdx.x;
       e < chunks_u + chunks_p; e += size_t(gridDim.x) * blockDim.x) {
    const bool is_u = e < chunks_u;
    const size_t f = is_u ? e : e - chunks_u;
    const int width = is_u ? a.kmp / 8 : a.np / 8;
    const int row = int(f / width), col = int(f % width) * 8;
    if (!is_u && in_block(row, a.j * a.m, a.m)) continue;  // prow's slot
    const float* src =
        is_u ? a.u + size_t(row) * a.km : a.p + size_t(row) * a.n;
    const int cols = is_u ? a.km : a.n;
    const float sign = is_u ? -1.f : 1.f;
    __align__(16) bf16 out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = __float2bfloat16_rn(col + i < cols ? sign * src[col + i] : 0.f);
    bf16* dst = is_u ? a.ub + size_t(row) * a.kmp : a.pb + size_t(row) * a.np;
    *reinterpret_cast<uint4*>(dst + col) =
        *reinterpret_cast<const uint4*>(out);
  }
}

// ------------------------------------------------------- update, bf16 ---

constexpr int kTBM = 128;              // bf16 tile rows (warps of 64 rows)
constexpr int kTBN = 128;              // bf16 tile columns (4 warps of 32)
constexpr int kThreadsB = kTBM * 2;    // (kTBM / 64) x 4 warps
constexpr int kStagesB = 4;
constexpr int kBKB = 16;               // contraction chunk (one k16 step)
constexpr int kALd = kBKB + 8;         // A row: 48 B, ldmatrix conflict-free
constexpr int kBLd = kTBN + 8;         // B row: 272 B
constexpr int kAStage = kTBM * kALd;   // elements
constexpr int kBStage = kBKB * kBLd;
constexpr int kVLd = kTBN + 8;         // V row: conflict-free fragment reads
constexpr size_t kSmemB = size_t(kStagesB) * (kAStage + kBStage) * 2 +
                          size_t(kTBM) * kVLd * 4;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane pairs (q even, q odd of a quad) swap halves so that each holds four
// consecutive columns of one row: the even lane row g, the odd lane row
// g + 8.  The map is its own inverse, for loads and stores alike.
__device__ __forceinline__ float4 pair_swap(float4 x, bool odd) {
  const float s0 = odd ? x.x : x.z, s1 = odd ? x.y : x.w;
  const float r0 = __shfl_xor_sync(kFullMask, s0, 1);
  const float r1 = __shfl_xor_sync(kFullMask, s1, 1);
  return odd ? make_float4(r0, r1, x.z, x.w) : make_float4(x.x, x.y, r0, r1);
}

__global__ void __launch_bounds__(kThreadsB, 2)
    fused_update_bf16(const Close a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStagesB * kAStage;
  float* Vs = reinterpret_cast<float*>(Bs + kStagesB * kBStage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warps of 64 x 32
  const int r0 = blockIdx.y * kTBM, c0 = blockIdx.x * kTBN;
  const int nk = (a.km + kBKB - 1) / kBKB;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kBKB;
    bf16* as = As + s * kAStage;
    bf16* bs = Bs + s * kBStage;
#pragma unroll
    for (int i = 0; i < kTBM * (kBKB / 8) / kThreadsB; ++i) {
      const int ch = tid + i * kThreadsB;
      const int row = ch / (kBKB / 8), kc = ch % (kBKB / 8) * 8;  // A rows
      const int gr = r0 + row, gk = k0 + kc;
      const bool ok = gr < a.n && gk < a.kmp;
      cp16(as + row * kALd + kc, ok ? a.ub + size_t(gr) * a.kmp + gk : a.ub,
           ok);
    }
#pragma unroll
    for (int i = 0; i < kBKB * 16 / kThreadsB; ++i) {
      const int ch = tid + i * kThreadsB;
      const int krow = ch >> 4, nc = (ch & 15) * 8;  // B: 16 chunks a row
      const int bk = k0 + krow, bc = c0 + nc;
      const bool okb = bk < a.km && bc < a.np;
      cp16(bs + krow * kBLd + nc, okb ? a.pb + size_t(bk) * a.np + bc : a.pb,
           okb);
    }
  };

  // The V tile streams into shared memory behind the contraction: one bulk
  // copy a row, counted by an mbarrier that only the epilogue waits on.
  // Outside the matrix the tile holds garbage that no output reads.  With
  // unaligned data, 4-byte copies in the first copy group instead.
  __shared__ uint64_t v_bar;
  const int v_rows = min(kTBM, a.n - r0), v_cols = min(kTBN, a.n - c0);
  if (a.vec) {
    if (tid == 0) mbar_init(&v_bar);
    __syncthreads();
    if (tid == 0) mbar_expect(&v_bar, uint32_t(v_rows) * v_cols * 4);
    if (tid < v_rows)
      bulk_copy(Vs + tid * kVLd, a.v + size_t(r0 + tid) * a.n + c0,
                uint32_t(v_cols) * 4, &v_bar);
  } else {
    for (int e = tid; e < kTBM * kTBN; e += kThreadsB) {
      const int row = e / kTBN, col = e % kTBN;
      const bool ok = row < v_rows && col < v_cols;
      cp4(Vs + row * kVLd + col,
          ok ? a.v + size_t(r0 + row) * a.n + c0 + col : a.v, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kStagesB - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_commit();
  }

  float acc[4][4][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStagesB - 2>();
    __syncthreads();
    const int nxt = kt + kStagesB - 1;
    if (nxt < nk) load_stage(nxt % kStagesB, nxt);
    cp_commit();
    const bf16* as = As + (kt % kStagesB) * kAStage;
    const bf16* bs = Bs + (kt % kStagesB) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBKB; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], as + (wm * 64 + mi * 16 + (lane & 15)) * kALd + kk +
                            (lane >> 4) * 8);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        uint32_t r[4];
        ldsm_x4_t(r, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kBLd +
                         wn * 32 + pr * 16 + (lane >> 4) * 8);
        bfr[pr * 2][0] = r[0];
        bfr[pr * 2][1] = r[1];
        bfr[pr * 2 + 1][0] = r[2];
        bfr[pr * 2 + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  if (a.vec) {
    mbar_wait(&v_bar);
  } else {
    cp_wait<0>();
    __syncthreads();
  }

  // Epilogue: V' + acc in mma's fragment order (the pivot column block of V
  // reads as 0), then the lane-pair swap so that each lane writes four
  // consecutive columns of one row; the pivot rows take prow.
  const int g = lane >> 2, q = lane & 3;
  const bool odd = q & 1;
  const int p0 = a.t * a.m;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int rt = wm * 64 + mi * 16 + g, ct = wn * 32 + ni * 8 + 2 * q;
      const float2 lo = *reinterpret_cast<const float2*>(Vs + rt * kVLd + ct);
      const float2 hi =
          *reinterpret_cast<const float2*>(Vs + (rt + 8) * kVLd + ct);
      const int c = c0 + ct;
      const bool z0 = in_block(c, p0, a.m), z1 = in_block(c + 1, p0, a.m);
      const float4 x = make_float4(acc[mi][ni][0] + (z0 ? 0.f : lo.x),
                                   acc[mi][ni][1] + (z1 ? 0.f : lo.y),
                                   acc[mi][ni][2] + (z0 ? 0.f : hi.x),
                                   acc[mi][ni][3] + (z1 ? 0.f : hi.y));
      const int rb = r0 + rt - g, cb = c0 + wn * 32 + ni * 8;
      if (a.vec) {
        store_v4(a, rb + g + (odd ? 8 : 0), cb + (q >> 1) * 4,
                 pair_swap(x, odd));
      } else {
        store_v1(a, rb + g, cb + 2 * q, x.x);
        store_v1(a, rb + g, cb + 2 * q + 1, x.y);
        store_v1(a, rb + g + 8, cb + 2 * q, x.z);
        store_v1(a, rb + g + 8, cb + 2 * q + 1, x.w);
      }
    }
}

// ------------------------------------------------------- update, fp32 ---

constexpr int kStagesF = 3;

// A kT x kT tile of V, 256 threads, a kR x kR register tile each.
template <int kT, int kR>
struct F32Tile {
  static constexpr int kTD = kT / kR;          // threads along each side
  static constexpr int kThreads = kTD * kTD;   // 256
  static constexpr int kGroups = kR / 4;       // float4 column groups
  static constexpr int kGroupStride = kT / kGroups;
  static constexpr int kUnroll = kR == 8 ? 1 : kBK / 2;
  static constexpr int kALd = kBK + 4;  // A tile row-major: k contiguous
  static constexpr int kBLd = kT + 4;
  static constexpr int kAStage = kT * kALd;
  static constexpr int kBStage = kBK * kBLd;
  static constexpr size_t kSmem = size_t(kStagesF) * (kAStage + kBStage) * 4;
};

// Thread (tx, ty) owns rows ty + kTD·i (i < kR) and columns
// tx·4 + kGroupStride·h + e (h < kR/4, e < 4).  kVec: 16-byte copies and
// float4 V accesses (n % 4 == 0, km % 4 == 0, aligned data).
template <int kT, int kR, bool kVec>
__global__ void __launch_bounds__(256, kR == 8 ? 2 : 4)
    fused_update_fp32(const Close a) {
  using L = F32Tile<kT, kR>;
  constexpr int TD = L::kTD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + kStagesF * L::kAStage;
  const int tid = threadIdx.x, tx = tid % TD, ty = tid / TD;
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const int nk = (a.km + kBK - 1) / kBK;
  const int slot0 = a.j * a.m;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kBK;
    float* as = As + s * L::kAStage;
    float* bs = Bs + s * L::kBStage;
    // A: kT rows x 8 chunks of 4; B: 32 rows x kT/4 chunks of 4.
#pragma unroll
    for (int it = 0; it < kT * 8 / L::kThreads; ++it) {
      const int ch = tid + it * L::kThreads;
      const int row = ch >> 3, kc = (ch & 7) * 4;
      const int gr = r0 + row, gk = k0 + kc;
      const float* src = a.u + size_t(gr) * a.km + gk;
      float* dst = as + row * L::kALd + kc;
      if (kVec) {
        const bool ok = gr < a.n && gk < a.km;
        cp16(dst, ok ? src : a.u, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gr < a.n && gk + e < a.km;
          cp4(dst + e, ok ? src + e : a.u, ok);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kBK * (kT / 4) / L::kThreads; ++it) {
      const int ch = tid + it * L::kThreads;
      const int krow = ch / (kT / 4), cc = (ch % (kT / 4)) * 4;
      const int bk = k0 + krow, bc = c0 + cc;
      const float* src = in_block(bk, slot0, a.m)
                             ? a.prow + size_t(bk - slot0) * a.n + bc
                             : a.p + size_t(bk) * a.n + bc;
      float* dst = bs + krow * L::kBLd + cc;
      if (kVec) {
        const bool ok = bk < a.km && bc < a.n;
        cp16(dst, ok ? src : a.p, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = bk < a.km && bc + e < a.n;
          cp4(dst + e, ok ? src + e : a.p, ok);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStagesF - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_commit();
  }

  float acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int h = 0; h < L::kGroups; ++h) {
      const int r = r0 + ty + TD * i;
      const int c = c0 + tx * 4 + L::kGroupStride * h;
      float4 x;
      if (kVec) {
        x = load_v4(a, r, c);
      } else {
        x = make_float4(load_v1(a, r, c), load_v1(a, r, c + 1),
                        load_v1(a, r, c + 2), load_v1(a, r, c + 3));
      }
      acc[i][h * 4] = x.x;
      acc[i][h * 4 + 1] = x.y;
      acc[i][h * 4 + 2] = x.z;
      acc[i][h * 4 + 3] = x.w;
    }

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStagesF - 2>();
    __syncthreads();
    const int nxt = kt + kStagesF - 1;
    if (nxt < nk) load_stage(nxt % kStagesF, nxt);
    cp_commit();
    const float* as = As + (kt % kStagesF) * L::kAStage + ty * L::kALd;
    const float* bs = Bs + (kt % kStagesF) * L::kBStage + tx * 4;
    // Unrolled fully for the 4 x 4 tile; the 8 x 8 tile keeps the loop (its
    // registers are full, and unrolling spills).
#pragma unroll L::kUnroll
    for (int kk = 0; kk < kBK; kk += 2) {
      float af[kR][2];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float2 t =
            *reinterpret_cast<const float2*>(as + TD * i * L::kALd + kk);
        af[i][0] = t.x;
        af[i][1] = t.y;
      }
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        float bv[kR];
#pragma unroll
        for (int h = 0; h < L::kGroups; ++h) {
          const float4 b = *reinterpret_cast<const float4*>(
              bs + (kk + k2) * L::kBLd + L::kGroupStride * h);
          bv[h * 4] = b.x;
          bv[h * 4 + 1] = b.y;
          bv[h * 4 + 2] = b.z;
          bv[h * 4 + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int jj = 0; jj < kR; ++jj)
            acc[i][jj] = fmaf(-af[i][k2], bv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int h = 0; h < L::kGroups; ++h) {
      const int r = r0 + ty + TD * i;
      const int c = c0 + tx * 4 + L::kGroupStride * h;
      const float4 x = make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                                   acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      if (kVec) {
        store_v4(a, r, c, x);
      } else {
        store_v1(a, r, c, x.x);
        store_v1(a, r, c + 1, x.y);
        store_v1(a, r, c + 2, x.z);
        store_v1(a, r, c + 3, x.w);
      }
    }
}

// ------------------------------------------------------------- launch ---

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

template <int kT, int kR, bool kVec>
int launch_f32(const Close& a, cudaStream_t stream) {
  using L = F32Tile<kT, kR>;
  cudaError_t err = cudaFuncSetAttribute(
      fused_update_fp32<kT, kR, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kSmem));
  if (err != cudaSuccess) return int(err);
  const int tiles = (a.n + kT - 1) / kT;
  fused_update_fp32<kT, kR, kVec>
      <<<dim3(tiles, tiles), L::kThreads, L::kSmem, stream>>>(a);
  return int(cudaGetLastError());
}

int launch(Close a, int bf16_mode, cudaStream_t stream) {
  const dim3 gp((a.n + kPT - 1) / kPT, (a.m + kPM - 1) / kPM);
  if (bf16_mode) {
    fused_update_prow<true><<<gp, 256, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    const size_t chunks =
        size_t(a.n) * (a.kmp / 8) + size_t(a.km) * (a.np / 8);
    const int blocks = int((chunks + 255) / 256 < 65535 ? (chunks + 255) / 256
                                                        : 65535);
    fused_update_to_bf16<<<blocks, 256, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    err = cudaFuncSetAttribute(
        fused_update_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(kSmemB));
    if (err != cudaSuccess) return int(err);
    fused_update_bf16<<<dim3((a.n + kTBN - 1) / kTBN,
                             (a.n + kTBM - 1) / kTBM),
                        kThreadsB, kSmemB, stream>>>(a);
    return int(cudaGetLastError());
  }
  fused_update_prow<false><<<gp, 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  // 128-wide tiles where there are two blocks for every SM, else 64-wide
  // tiles, which spread a small matrix more evenly over the SMs.
  const long tiles128 = long((a.n + 127) / 128) * ((a.n + 127) / 128);
  if (tiles128 >= 2L * sm_count())
    return a.vec ? launch_f32<128, 8, true>(a, stream)
                 : launch_f32<128, 8, false>(a, stream);
  return a.vec ? launch_f32<64, 4, true>(a, stream)
               : launch_f32<64, 4, false>(a, stream);
}

}  // namespace

extern "C" {

// Bytes of the scratch a close at (n, km) needs: the bf16 operands in bf16
// mode, none in fp32 mode.
size_t fused_update_work_bytes(int n, int km, int bf16_mode) {
  if (!bf16_mode) return 0;
  const size_t ub = size_t(n) * round8(km) * 2;
  return ((ub + 255) & ~size_t(255)) + size_t(km) * round8(n) * 2;
}

// The group-closing update on `stream`.  v is (n, n), u (n, km), p (km, n),
// h (m, m), rows_p (m, n) and prow an (m, n) scratch, all contiguous fp32 on
// the device; work holds fused_update_work_bytes(n, km, bf16) bytes, 256-byte
// aligned (null in fp32 mode); v is updated in place.  bf16 != 0 selects
// bf16 operands with fp32 accumulation.  Returns the CUDA error code of the
// launches (0 on success), or cudaErrorInvalidValue for shapes the caller
// contract excludes.
int fused_update_f32(void* v, const void* u, const void* p, const void* h,
                     const void* rows_p, void* prow, void* work, int n, int km,
                     int m, int t, int j, int bf16_mode, void* stream) {
  if (n <= 0 || km <= 0 || m <= 0 || n % m != 0 || km % m != 0 || t < 0 ||
      t >= n / m || j < 0 || j >= km / m || (bf16_mode && work == nullptr))
    return int(cudaErrorInvalidValue);
  Close a{};
  a.n = n;
  a.km = km;
  a.m = m;
  a.t = t;
  a.j = j;
  a.v = static_cast<float*>(v);
  a.u = static_cast<const float*>(u);
  a.p = static_cast<const float*>(p);
  a.h = static_cast<const float*>(h);
  a.rows_p = static_cast<const float*>(rows_p);
  a.prow = static_cast<float*>(prow);
  a.kmp = round8(km);
  a.np = round8(n);
  if (bf16_mode) {
    const size_t ub = size_t(n) * a.kmp * 2;
    a.ub = static_cast<bf16*>(work);
    a.pb = reinterpret_cast<bf16*>(static_cast<char*>(work) +
                                   ((ub + 255) & ~size_t(255)));
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(u) |
                         reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(prow);
  a.vec = n % 4 == 0 && km % 4 == 0 && bits % 16 == 0;
  return launch(a, bf16_mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
