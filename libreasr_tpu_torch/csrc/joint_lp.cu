// Fused RNN-T joint log-prob kernels for Hopper (sm_90a): F, G and H.
//
// Replaces the JAX package's Pallas TPU kernels in
// ops/pallas/joint_lp.py:
//   F  _joint_lp_fwd_kernel (joint_lp_fwd_pallas)       -> joint_lp_fwd
//   G  _joint_dx_kernel     (joint_lp_bwd_pallas, dx)   -> joint_lp_dx
//   H  _joint_dw_kernel     (joint_lp_bwd_pallas, dW)   -> joint_lp_dw
//
// Lattice rows r = (n, t, u), R = N * T * U1 of them. Per row:
//   h      = tanh(enc_proj[n, t] + pred_proj[n, u])            float32 [J]
//   logits = w(h) @ W_out + b_out     (float32 accumulation)    [V]
//   lse    = logsumexp(logits)
//   F: lp_blank = logits[blank] - lse; lp_emit = logits[label_u] - lse
//   G: p = exp(logits - lse);
//      dlogits = 1[v = blank] g_lpb + 1[v = label_u] g_lpe - p (g_lpb + g_lpe)
//      dh = (w(dlogits) @ W_out^T) * (1 - h^2);
//      d_enc_proj[n, t] = sum_u dh, d_pred_proj[n, u] = sum_t dh; and lse
//   H: dW_out = sum_rows w(h)^T w(dlogits), db_out = sum_rows dlogits,
//      the softmax taken with G's lse
// w() rounds to W_out's type (bf16 or float32); h, dlogits and every sum
// stay float32. Both one-hot terms are added, never if/else, so a label
// equal to the blank gets both. The emit column of u = U1 - 1 does not
// exist (label -1, g_lpe 0).
//
// What bounds them on an H100: the [rows, J] x [J, V] products, 2 R J V
// flops each (135 GFLOP at N 16, T 49, U1 41, J 1024, V 2048; F does one,
// G three, H two), against a few tens of MB of inputs and outputs: all
// three are compute-bound. The kernels exist to keep the [rows, V] logits
// and dlogits out of device memory, as the TPU kernels kept them in VMEM:
// here a block owns a tile of BM rows (BT frames x BU labels of one
// utterance), holds w(h) for its rows in shared memory and walks V in
// tiles, recomputing the logits tile by tile:
//   - the products are bf16 WMMA fragments (mma.sync 16x16x16) with
//     float32 accumulation when W_out is bf16, and a plain float32 loop
//     when W_out is float32 (no tensor-core mode is exact in float32);
//     W_out reaches shared memory in 64-row chunks by 16-byte cp.async
//     copies, the next chunk in flight while the current one is
//     multiplied; wgmma/TMA pipelines are later work;
//   - F keeps an online max/sum per row over the V tiles;
//   - G makes two passes over V: the first finds lse, the second forms
//     dlogits and accumulates w(dlogits) @ W_out^T into a [BM, J] float32
//     block. With bf16 W_out that block lives in the WMMA accumulators of
//     16 warps, and each 32-column tile of W_out is staged once per pass
//     for both of its products; with float32 W_out it sits in shared
//     memory and W_out is staged in chunks as for F;
//   - H's blocks own a 32-column V tile and a group of row tiles each.
//     With bf16 W_out the block keeps its [J, 32] column tile of W_out in
//     shared memory and its [J, 32] dW block in the WMMA accumulators of
//     16 warps, and rebuilds w(h) and the tile's logits per row tile; with
//     float32 W_out the dW block sits in shared memory.
// With bf16 W_out, G and H take J up to 1024 (16 warps x 4 accumulator
// fragments of 16 columns); a larger J is refused, not run elsewhere.
// The TPU kernels carried sums across a sequential grid (d_pred_proj over
// t, dW/db over all rows). Blocks here run in no order, so every
// cross-block sum goes through per-block partials and a second,
// deterministic reduction pass: G writes [N, T, ceil(U1/BU), J] and
// [N, ceil(T/BT), U1, J] partials, H one [J, V] slab and one [V] row per
// row group. G and H are therefore two launches each (the main kernel and
// its reduction); results do not change from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;    // F, G, and H with float32 W_out
constexpr int THREADS_H = 512;  // H with bf16 W_out
constexpr int MAXJF = 4;        // dW fragments along J per warp of that H
constexpr int BN = 64;    // V tile of F and G
constexpr int BNH = 32;   // V tile of H
constexpr int BK = 64;    // J chunk of W staged per step (also G's dh chunk)
constexpr int MAX_SMEM = 232448;  // per-block limit on sm_90

template <typename WT> struct Tile;
template <> struct Tile<bf16> { static constexpr int BT = 4, BU = 8; };
template <> struct Tile<float> { static constexpr int BT = 2, BU = 8; };

struct Shape {
  int N, T, U1, J, V, blank, Jp, nTB, nUB;
};

struct RowInfo {
  int t, u, valid, lab;
  float gb, ge, lse, m, s, lb, le, pad;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

template <typename WT> __device__ __forceinline__ WT from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c[M x N] (float32, row-major, ldc) += A[M x K] B[K x N] from shared
// memory. A(m, k) = a[k * lda + m] if A_T else a[m * lda + k];
// B(k, n) = b[n * ldb + k] if B_T else b[k * ldb + n]. M, N, K are
// multiples of 16. All threads of the block take part; no barrier.
template <bool A_T, bool B_T>
__device__ void smem_mma(const bf16* a, int lda, const bf16* b, int ldb,
                         float* c, int ldc, int M, int N, int K) {
  using namespace nvcuda;
  using LA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  const int tn = N / 16;
  for (int tile = warp; tile < (M / 16) * tn; tile += blockDim.x / 32) {
    const int m0 = (tile / tn) * 16, n0 = (tile % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, c + m0 * ldc + n0, ldc, wmma::mem_row_major);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
      wmma::load_matrix_sync(fa, A_T ? a + k0 * lda + m0 : a + m0 * lda + k0, lda);
      wmma::load_matrix_sync(fb, B_T ? b + n0 * ldb + k0 : b + k0 * ldb + n0, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + m0 * ldc + n0, acc, ldc, wmma::mem_row_major);
  }
}

template <bool A_T, bool B_T>
__device__ void smem_mma(const float* a, int lda, const float* b, int ldb,
                         float* c, int ldc, int M, int N, int K) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int m = idx / N, n = idx - (idx / N) * N;
    float acc = c[m * ldc + n];
    for (int k = 0; k < K; ++k) {
      const float av = A_T ? a[k * lda + m] : a[m * lda + k];
      const float bv = B_T ? b[n * ldb + k] : b[k * ldb + n];
      acc = fmaf(av, bv, acc);
    }
    c[m * ldc + n] = acc;
  }
}

// Row bookkeeping of one tile: utterance n, frames t0.., labels u0...
template <typename WT>
__device__ void setup_rows(int tile, const Shape& s, RowInfo* ri, int& n,
                           int& t0, int& u0, const int* labels,
                           const float* glpb, const float* glpe,
                           const float* lse_in) {
  constexpr int BT = Tile<WT>::BT, BU = Tile<WT>::BU, BM = BT * BU;
  n = tile / (s.nTB * s.nUB);
  const int rem = tile - n * s.nTB * s.nUB;
  t0 = (rem / s.nUB) * BT;
  u0 = (rem % s.nUB) * BU;
  const int U = s.U1 - 1;
  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    RowInfo r;
    r.t = t0 + i / BU;
    r.u = u0 + i % BU;
    r.valid = r.t < s.T && r.u < s.U1;
    r.lab = (r.valid && r.u < U) ? labels[n * U + r.u] : -1;
    r.gb = (glpb && r.valid) ? glpb[(n * s.T + r.t) * s.U1 + r.u] : 0.f;
    r.ge = (glpe && r.valid && r.u < U) ? glpe[(n * s.T + r.t) * U + r.u] : 0.f;
    r.lse = (lse_in && r.valid) ? lse_in[(n * s.T + r.t) * s.U1 + r.u] : 0.f;
    r.m = -INFINITY;
    r.s = 0.f;
    r.lb = 0.f;
    r.le = 0.f;
    r.pad = 0.f;
    ri[i] = r;
  }
}

// hs[i, j] = w(tanh(enc_proj[n, t_i, j] + pred_proj[n, u_i, j])), zero
// on invalid rows and for J <= j < Jp. One warp per row.
template <typename WT>
__device__ void fill_h(WT* hs, int ldh, const RowInfo* ri, int n,
                       const Shape& s, const float* enc, const float* pred) {
  constexpr int BM = Tile<WT>::BT * Tile<WT>::BU;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x / 32; i < BM; i += blockDim.x / 32) {
    WT* row = hs + i * ldh;
    const bool valid = ri[i].valid;
    const float* e = enc + ((size_t)n * s.T + ri[i].t) * s.J;
    const float* p = pred + ((size_t)n * s.U1 + ri[i].u) * s.J;
    for (int j = lane; j < s.Jp; j += 32)
      row[j] = from_f<WT>(valid && j < s.J ? tanhf(e[j] + p[j]) : 0.f);
  }
}

// Copies W_out[k0 : k0 + kc, v0 : v0 + W] into dst (row stride ldw), zero
// past J and V: 16-byte cp.async copies when the tile lies inside V and
// W_out's rows are 16-byte aligned (V a multiple of 16 / sizeof(WT)),
// plain loads otherwise. The caller commits the copies and waits.
template <typename WT, int W>
__device__ void stage_w(WT* dst, int ldw, const WT* w, int k0, int kc, int v0,
                        const Shape& s) {
  constexpr int VEC = 16 / sizeof(WT), SEGS = W / VEC;
  if (s.V % VEC == 0 && v0 + W <= s.V) {
    for (int idx = threadIdx.x; idx < kc * SEGS; idx += blockDim.x) {
      const int kk = idx / SEGS, seg = idx % SEGS, j = k0 + kk;
      WT* d = dst + kk * ldw + seg * VEC;
      if (j < s.J)
        cp_async16(d, w + (size_t)j * s.V + v0 + seg * VEC);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int idx = threadIdx.x; idx < kc * W; idx += blockDim.x) {
      const int kk = idx / W, vv = idx % W;
      const int j = k0 + kk, v = v0 + vv;
      dst[kk * ldw + vv] = (j < s.J && v < s.V) ? w[(size_t)j * s.V + v] : from_f<WT>(0.f);
    }
  }
}

// cs[BM x W] = hs @ W_out[:, v0 : v0 + W] (zero past V), J in BK chunks
// through two staging buffers in ws: the copy of chunk c + 1 is in
// flight while chunk c is multiplied. Ends with a barrier.
template <typename WT, int W>
__device__ void logits_tile(const WT* hs, int ldh, WT* ws, float* cs, int v0,
                            const Shape& s, const WT* w) {
  constexpr int BM = Tile<WT>::BT * Tile<WT>::BU;
  constexpr int PAD = 16 / sizeof(WT);
  constexpr int LDW = W + PAD, LDC = W + 4, BUF = BK * LDW;
  for (int idx = threadIdx.x; idx < BM * W; idx += blockDim.x)
    cs[(idx / W) * LDC + idx % W] = 0.f;
  const int nk = (s.Jp + BK - 1) / BK;
  stage_w<WT, W>(ws, LDW, w, 0, min(BK, s.Jp), v0, s);
  cp_async_commit();
  for (int c = 0; c < nk; ++c) {
    const int k0 = c * BK, kc = min(BK, s.Jp - k0);
    if (c + 1 < nk) {
      stage_w<WT, W>(ws + ((c + 1) & 1) * BUF, LDW, w, k0 + BK,
                     min(BK, s.Jp - k0 - BK), v0, s);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    smem_mma<false, false>(hs + k0, ldh, ws + (c & 1) * BUF, LDW, cs, LDC, BM, W, kc);
    __syncthreads();
  }
}

// Online max / sum of exp over one tile of logits (+ bias), and the
// blank and label logits when the tile holds them. One warp per row.
template <typename WT, int W>
__device__ void online_lse(const float* cs, RowInfo* ri, int v0,
                           const Shape& s, const float* bias) {
  constexpr int BM = Tile<WT>::BT * Tile<WT>::BU;
  constexpr int LDC = W + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < BM; i += blockDim.x / 32) {
    float x[W / 32];
    float tmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < W / 32; ++q) {
      const int vv = lane + 32 * q, v = v0 + vv;
      x[q] = -INFINITY;
      if (v < s.V) {
        x[q] = cs[i * LDC + vv] + bias[v];
        tmax = fmaxf(tmax, x[q]);
        if (v == s.blank) ri[i].lb = x[q];
        if (v == ri[i].lab) ri[i].le = x[q];
      }
    }
    tmax = warp_max(tmax);
    const float m_old = ri[i].m;
    const float m_new = fmaxf(m_old, tmax);
    float ts = 0.f;
#pragma unroll
    for (int q = 0; q < W / 32; ++q)
      if (v0 + lane + 32 * q < s.V) ts += expf(x[q] - m_new);
    ts = warp_sum(ts);
    __syncwarp();
    if (lane == 0) {
      ri[i].s = ri[i].s * expf(m_old - m_new) + ts;
      ri[i].m = m_new;
    }
  }
  __syncthreads();
}

// dlogits of a tile in float32, in place in cs (zero on invalid rows
// and columns), and rounded to W_out's type into ds.
template <typename WT, int W>
__device__ void dlogits_tile(float* cs, WT* ds, const RowInfo* ri, int v0,
                             const Shape& s, const float* bias) {
  constexpr int BM = Tile<WT>::BT * Tile<WT>::BU;
  constexpr int LDC = W + 4, LDD = W + 16 / sizeof(WT);
  for (int idx = threadIdx.x; idx < BM * W; idx += blockDim.x) {
    const int i = idx / W, vv = idx % W, v = v0 + vv;
    float d = 0.f;
    if (ri[i].valid && v < s.V) {
      const float p = expf(cs[i * LDC + vv] + bias[v] - ri[i].lse);
      d = (v == s.blank ? ri[i].gb : 0.f) + (v == ri[i].lab ? ri[i].ge : 0.f)
          - p * (ri[i].gb + ri[i].ge);
    }
    cs[i * LDC + vv] = d;
    ds[i * LDD + vv] = from_f<WT>(d);
  }
  __syncthreads();
}

// cs[BM x BNH] = hs @ wv, bf16 WMMA with float32 sums, wv the resident
// [Jp, BNH] column tile of W_out: each of the (BM / 16) * (BNH / 16)
// fragments is summed over J in equal parts by the block's warps, and the
// partials are added in a fixed order. Ends with a barrier.
__device__ void logits_ksplit(const bf16* hs, int ldh, const bf16* wv, int ldw,
                              float* cs, int ldc, float* stage, const Shape& s) {
  using namespace nvcuda;
  constexpr int BM = Tile<bf16>::BT * Tile<bf16>::BU;
  constexpr int NF = (BM / 16) * (BNH / 16);
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int f = warp % NF, split = warp / NF, splits = nwarps / NF;
  const int m0 = (f / (BNH / 16)) * 16, n0 = (f % (BNH / 16)) * 16;
  const int steps = s.Jp / 16, per = (steps + splits - 1) / splits;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
  wmma::fill_fragment(c, 0.f);
  for (int k = split * per; k < min(steps, (split + 1) * per); ++k) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
    wmma::load_matrix_sync(fa, hs + m0 * ldh + k * 16, ldh);
    wmma::load_matrix_sync(fb, wv + k * 16 * ldw + n0, ldw);
    wmma::mma_sync(c, fa, fb, c);
  }
  wmma::store_matrix_sync(stage + warp * 256, c, 16, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BNH; idx += blockDim.x) {
    const int m = idx / BNH, nn = idx % BNH;
    const int ff = (m / 16) * (BNH / 16) + nn / 16, e = (m % 16) * 16 + nn % 16;
    float sum = 0.f;
    for (int q = 0; q < splits; ++q) sum += stage[(q * NF + ff) * 256 + e];
    cs[m * ldc + nn] = sum;
  }
  __syncthreads();
}

template <typename WT>
struct Smem {
  static constexpr int BM = Tile<WT>::BT * Tile<WT>::BU;
  static constexpr int PAD = 16 / sizeof(WT);
  size_t hs, ws, cs, ds, acc, rows, total;
  // kind 0: F; 1: G and 2: H with float32 W_out; 3: H and 4: G with
  // bf16 W_out, whose ws holds a whole [Jp, BNH] column tile of W_out and
  // whose acc is two 16 x 16 float32 staging tiles per warp
  __host__ __device__ Smem(int Jp, int kind) {
    const int w = kind >= 2 ? BNH : BN;
    size_t o = 0;
    hs = o; o = align128(o + (size_t)BM * (Jp + PAD) * sizeof(WT));
    ws = o;
    o = align128(o + (kind >= 3 ? (size_t)Jp : 2 * (size_t)BK) * (w + PAD) * sizeof(WT));
    cs = o; o = align128(o + (size_t)BM * (w + 4) * sizeof(float));
    ds = o; o = align128(o + (kind ? (size_t)BM * (w + PAD) * sizeof(WT) : 0));
    acc = o;
    if (kind == 1) o = align128(o + (size_t)BM * (Jp + 4) * sizeof(float));
    if (kind == 2) o = align128(o + (size_t)Jp * BNH * sizeof(float));
    if (kind >= 3) o = align128(o + (size_t)(THREADS_H / 32) * 512 * sizeof(float));
    rows = o; o = align128(o + (size_t)BM * sizeof(RowInfo));
    total = o;
  }
};

template <typename WT>
__global__ void __launch_bounds__(THREADS)
joint_fwd_kernel(const float* enc, const float* pred, const WT* w,
                 const float* bias, const int* labels, float* lpb, float* lpe,
                 Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<WT> L(s.Jp, 0);
  constexpr int PAD = 16 / sizeof(WT);
  WT* hs = reinterpret_cast<WT*>(smem + L.hs);
  WT* ws = reinterpret_cast<WT*>(smem + L.ws);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  RowInfo* ri = reinterpret_cast<RowInfo*>(smem + L.rows);
  const int ldh = s.Jp + PAD;
  int n, t0, u0;
  setup_rows<WT>(blockIdx.x, s, ri, n, t0, u0, labels, nullptr, nullptr, nullptr);
  __syncthreads();
  fill_h<WT>(hs, ldh, ri, n, s, enc, pred);
  for (int v0 = 0; v0 < s.V; v0 += BN) {
    logits_tile<WT, BN>(hs, ldh, ws, cs, v0, s, w);
    online_lse<WT, BN>(cs, ri, v0, s, bias);
  }
  const int U = s.U1 - 1;
  for (int i = threadIdx.x; i < Smem<WT>::BM; i += blockDim.x) {
    const RowInfo r = ri[i];
    if (!r.valid) continue;
    const float lse = r.m + logf(r.s);
    lpb[((size_t)n * s.T + r.t) * s.U1 + r.u] = r.lb - lse;
    if (r.u < U) lpe[((size_t)n * s.T + r.t) * U + r.u] = r.le - lse;
  }
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
joint_dx_kernel(const float* enc, const float* pred, const WT* w,
                const float* bias, const int* labels, const float* glpb,
                const float* glpe, float* lse_out, float* part_enc,
                float* part_pred, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<WT> L(s.Jp, 1);
  constexpr int BT = Tile<WT>::BT, BU = Tile<WT>::BU, BM = BT * BU;
  constexpr int PAD = 16 / sizeof(WT);
  WT* hs = reinterpret_cast<WT*>(smem + L.hs);
  WT* ws = reinterpret_cast<WT*>(smem + L.ws);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  WT* ds = reinterpret_cast<WT*>(smem + L.ds);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  RowInfo* ri = reinterpret_cast<RowInfo*>(smem + L.rows);
  const int ldh = s.Jp + PAD, lda = s.Jp + 4, ldw = BN + PAD, ldd = BN + PAD;
  int n, t0, u0;
  setup_rows<WT>(blockIdx.x, s, ri, n, t0, u0, labels, glpb, glpe, nullptr);
  __syncthreads();
  fill_h<WT>(hs, ldh, ri, n, s, enc, pred);
  // pass 1: the row logsumexp
  for (int v0 = 0; v0 < s.V; v0 += BN) {
    logits_tile<WT, BN>(hs, ldh, ws, cs, v0, s, w);
    online_lse<WT, BN>(cs, ri, v0, s, bias);
  }
  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    ri[i].lse = ri[i].m + logf(ri[i].s);
    if (ri[i].valid)
      lse_out[((size_t)n * s.T + ri[i].t) * s.U1 + ri[i].u] = ri[i].lse;
  }
  for (int idx = threadIdx.x; idx < BM * s.Jp; idx += blockDim.x)
    acc[(idx / s.Jp) * lda + idx % s.Jp] = 0.f;
  __syncthreads();
  // pass 2: dlogits, and acc += w(dlogits) @ W_out[:, v-tile]^T
  for (int v0 = 0; v0 < s.V; v0 += BN) {
    logits_tile<WT, BN>(hs, ldh, ws, cs, v0, s, w);
    dlogits_tile<WT, BN>(cs, ds, ri, v0, s, bias);
    const int nj = (s.Jp + BK - 1) / BK;
    stage_w<WT, BN>(ws, ldw, w, 0, min(BK, s.Jp), v0, s);
    cp_async_commit();
    for (int c = 0; c < nj; ++c) {
      const int j0 = c * BK, jc = min(BK, s.Jp - j0);
      if (c + 1 < nj) {
        stage_w<WT, BN>(ws + ((c + 1) & 1) * BK * ldw, ldw, w, j0 + BK,
                        min(BK, s.Jp - j0 - BK), v0, s);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      smem_mma<false, true>(ds, ldd, ws + (c & 1) * BK * ldw, ldw, acc + j0, lda,
                            BM, jc, BN);
      __syncthreads();
    }
  }
  // dh = acc * (1 - h^2) with the float32 h, zero on invalid rows
  for (int idx = threadIdx.x; idx < BM * s.J; idx += blockDim.x) {
    const int i = idx / s.J, j = idx - (idx / s.J) * s.J;
    float d = 0.f;
    if (ri[i].valid) {
      const float h = tanhf(enc[((size_t)n * s.T + ri[i].t) * s.J + j] +
                            pred[((size_t)n * s.U1 + ri[i].u) * s.J + j]);
      d = acc[i * lda + j] * (1.f - h * h);
    }
    acc[i * lda + j] = d;
  }
  __syncthreads();
  // partial sums: over this tile's labels per frame, frames per label
  const int ub = u0 / BU, tb = t0 / BT;
  for (int idx = threadIdx.x; idx < BT * s.J; idx += blockDim.x) {
    const int bt = idx / s.J, j = idx - (idx / s.J) * s.J, t = t0 + bt;
    if (t >= s.T) continue;
    float sum = 0.f;
    for (int bu = 0; bu < BU; ++bu) sum += acc[(bt * BU + bu) * lda + j];
    part_enc[(((size_t)n * s.T + t) * s.nUB + ub) * s.J + j] = sum;
  }
  for (int idx = threadIdx.x; idx < BU * s.J; idx += blockDim.x) {
    const int bu = idx / s.J, j = idx - (idx / s.J) * s.J, u = u0 + bu;
    if (u >= s.U1) continue;
    float sum = 0.f;
    for (int bt = 0; bt < BT; ++bt) sum += acc[(bt * BU + bu) * lda + j];
    part_pred[(((size_t)n * s.nTB + tb) * s.U1 + u) * s.J + j] = sum;
  }
}

// G with bf16 W_out, on tensor cores throughout: per 32-column V tile the
// block stages that [Jp, BNH] column tile of W_out once and uses it for
// both products of the tile, the logits (split over the warps along J)
// and dh += w(dlogits) @ W_out[:, tile]^T, whose [BM, Jp] float32 sum
// stays in the WMMA accumulators of 16 warps (warp w owns J fragments
// w, w + 16, ...), so the accumulator takes no shared memory.
__global__ void __launch_bounds__(THREADS_H, 1)
joint_dx_kernel_bf16(const float* enc, const float* pred, const bf16* w,
                     const float* bias, const int* labels, const float* glpb,
                     const float* glpe, float* lse_out, float* part_enc,
                     float* part_pred, Shape s) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<bf16> L(s.Jp, 4);
  constexpr int BT = Tile<bf16>::BT, BU = Tile<bf16>::BU, BM = BT * BU;
  constexpr int PAD = Smem<bf16>::PAD, MF = BM / 16;
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* wv = reinterpret_cast<bf16*>(smem + L.ws);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  bf16* ds = reinterpret_cast<bf16*>(smem + L.ds);
  float* stage_all = reinterpret_cast<float*>(smem + L.acc);
  RowInfo* ri = reinterpret_cast<RowInfo*>(smem + L.rows);
  const int ldh = s.Jp + PAD, ldw = BNH + PAD, ldd = BNH + PAD, ldc = BNH + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  int n, t0, u0;
  setup_rows<bf16>(blockIdx.x, s, ri, n, t0, u0, labels, glpb, glpe, nullptr);
  __syncthreads();
  fill_h<bf16>(hs, ldh, ri, n, s, enc, pred);
  // pass 1: the row logsumexp
  for (int v0 = 0; v0 < s.V; v0 += BNH) {
    __syncthreads();
    stage_w<bf16, BNH>(wv, ldw, w, 0, s.Jp, v0, s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    logits_ksplit(hs, ldh, wv, ldw, cs, ldc, stage_all, s);
    online_lse<bf16, BNH>(cs, ri, v0, s, bias);
  }
  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    ri[i].lse = ri[i].m + logf(ri[i].s);
    if (ri[i].valid)
      lse_out[((size_t)n * s.T + ri[i].t) * s.U1 + ri[i].u] = ri[i].lse;
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXJF][MF];
#pragma unroll
  for (int q = 0; q < MAXJF; ++q)
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) wmma::fill_fragment(acc[q][mf], 0.f);
  // pass 2: dlogits, and dh += w(dlogits) @ W_out[:, tile]^T
  for (int v0 = 0; v0 < s.V; v0 += BNH) {
    __syncthreads();
    stage_w<bf16, BNH>(wv, ldw, w, 0, s.Jp, v0, s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    logits_ksplit(hs, ldh, wv, ldw, cs, ldc, stage_all, s);
    dlogits_tile<bf16, BNH>(cs, ds, ri, v0, s, bias);
#pragma unroll
    for (int q = 0; q < MAXJF; ++q) {
      const int j0 = (warp + q * nwarps) * 16;
      if (j0 >= s.Jp) continue;
#pragma unroll
      for (int k0 = 0; k0 < BNH; k0 += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, wv + j0 * ldw + k0, ldw);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, ds + mf * 16 * ldd + k0, ldd);
          wmma::mma_sync(acc[q][mf], fa, fb, acc[q][mf]);
        }
      }
    }
  }
  // dh = acc * (1 - h^2) with the float32 h, then this tile's partial sums
  // over labels (per frame) and frames (per label), one J fragment at a time
  float* st = stage_all + warp * (MF * 256);
  const int ub = u0 / BU, tb = t0 / BT;
#pragma unroll
  for (int q = 0; q < MAXJF; ++q) {
    const int j0 = (warp + q * nwarps) * 16;
    if (j0 >= s.Jp) continue;
    __syncwarp();
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
      wmma::store_matrix_sync(st + mf * 256, acc[q][mf], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < BM * 16; e += 32) {
      const int i = e / 16, j = j0 + e % 16;
      float d = 0.f;
      if (ri[i].valid && j < s.J) {
        const float h = tanhf(enc[((size_t)n * s.T + ri[i].t) * s.J + j] +
                              pred[((size_t)n * s.U1 + ri[i].u) * s.J + j]);
        d = st[e] * (1.f - h * h);
      }
      st[e] = d;
    }
    __syncwarp();
    for (int e = lane; e < BT * 16; e += 32) {
      const int bt = e / 16, j = j0 + e % 16, t = t0 + bt;
      if (t >= s.T || j >= s.J) continue;
      float sum = 0.f;
      for (int bu = 0; bu < BU; ++bu) sum += st[(bt * BU + bu) * 16 + e % 16];
      part_enc[(((size_t)n * s.T + t) * s.nUB + ub) * s.J + j] = sum;
    }
    for (int e = lane; e < BU * 16; e += 32) {
      const int bu = e / 16, j = j0 + e % 16, u = u0 + bu;
      if (u >= s.U1 || j >= s.J) continue;
      float sum = 0.f;
      for (int bt = 0; bt < BT; ++bt) sum += st[(bt * BU + bu) * 16 + e % 16];
      part_pred[(((size_t)n * s.nTB + tb) * s.U1 + u) * s.J + j] = sum;
    }
  }
}

__global__ void joint_dx_reduce(const float* part_enc, const float* part_pred,
                                float* d_enc, float* d_pred, Shape s) {
  const size_t n_enc = (size_t)s.N * s.T * s.J;
  const size_t n_all = n_enc + (size_t)s.N * s.U1 * s.J;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n_all;
       idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < n_enc) {
      const size_t row = idx / s.J, j = idx % s.J;  // row = n * T + t
      float sum = 0.f;
      for (int k = 0; k < s.nUB; ++k) sum += part_enc[(row * s.nUB + k) * s.J + j];
      d_enc[idx] = sum;
    } else {
      const size_t q = idx - n_enc;
      const size_t j = q % s.J, u = (q / s.J) % s.U1, n = q / ((size_t)s.J * s.U1);
      float sum = 0.f;
      for (int k = 0; k < s.nTB; ++k)
        sum += part_pred[((n * s.nTB + k) * s.U1 + u) * s.J + j];
      d_pred[q] = sum;
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
joint_dw_kernel(const float* enc, const float* pred, const WT* w,
                const float* bias, const int* labels, const float* glpb,
                const float* glpe, const float* lse_in, float* part_w,
                float* part_b, int tiles_per_group, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<WT> L(s.Jp, 2);
  constexpr int BM = Tile<WT>::BT * Tile<WT>::BU;
  constexpr int PAD = 16 / sizeof(WT);
  WT* hs = reinterpret_cast<WT*>(smem + L.hs);
  WT* ws = reinterpret_cast<WT*>(smem + L.ws);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  WT* ds = reinterpret_cast<WT*>(smem + L.ds);
  float* accw = reinterpret_cast<float*>(smem + L.acc);
  RowInfo* ri = reinterpret_cast<RowInfo*>(smem + L.rows);
  const int ldh = s.Jp + PAD, ldd = BNH + PAD, ldc = BNH + 4;
  const int v0 = blockIdx.x * BNH, g = blockIdx.y;
  const int n_tiles = s.N * s.nTB * s.nUB;
  const int first = g * tiles_per_group;
  const int last = min(first + tiles_per_group, n_tiles);
  for (int idx = threadIdx.x; idx < s.Jp * BNH; idx += blockDim.x) accw[idx] = 0.f;
  float db = 0.f;  // thread vv < BNH: this group's sum of column v0 + vv
  for (int tile = first; tile < last; ++tile) {
    int n, t0, u0;
    __syncthreads();
    setup_rows<WT>(tile, s, ri, n, t0, u0, labels, glpb, glpe, lse_in);
    __syncthreads();
    fill_h<WT>(hs, ldh, ri, n, s, enc, pred);
    logits_tile<WT, BNH>(hs, ldh, ws, cs, v0, s, w);
    dlogits_tile<WT, BNH>(cs, ds, ri, v0, s, bias);
    if (threadIdx.x < BNH)
      for (int i = 0; i < BM; ++i) db += cs[i * ldc + threadIdx.x];
    // accw[J x BNH] += w(h)^T @ w(dlogits)
    smem_mma<true, false>(hs, ldh, ds, ldd, accw, BNH, s.Jp, BNH, BM);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < s.J * BNH; idx += blockDim.x) {
    const int j = idx / BNH, vv = idx % BNH, v = v0 + vv;
    if (v < s.V) part_w[((size_t)g * s.J + j) * s.V + v] = accw[j * BNH + vv];
  }
  if (threadIdx.x < BNH && v0 + threadIdx.x < s.V)
    part_b[(size_t)g * s.V + v0 + threadIdx.x] = db;
}

// H with bf16 W_out, on tensor cores throughout: the block's [Jp, BNH]
// column tile of W_out stays in shared memory, and the [Jp, BNH] dW block
// accumulates in the warps' WMMA fragments (warp w owns J fragments
// w, w + 16, ...), so a row tile costs w(h), one [BM, Jp] x [Jp, BNH]
// product and one [Jp, BM] x [BM, BNH] product, with no staging of W.
__global__ void __launch_bounds__(THREADS_H, 1)
joint_dw_kernel_bf16(const float* enc, const float* pred, const bf16* w,
                     const float* bias, const int* labels, const float* glpb,
                     const float* glpe, const float* lse_in, float* part_w,
                     float* part_b, int tiles_per_group, Shape s) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<bf16> L(s.Jp, 3);
  constexpr int BM = Smem<bf16>::BM, PAD = Smem<bf16>::PAD;
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* wv = reinterpret_cast<bf16*>(smem + L.ws);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  bf16* ds = reinterpret_cast<bf16*>(smem + L.ds);
  RowInfo* ri = reinterpret_cast<RowInfo*>(smem + L.rows);
  float* stage_all = reinterpret_cast<float*>(smem + L.acc);
  const int ldh = s.Jp + PAD, ldw = BNH + PAD, ldd = BNH + PAD, ldc = BNH + 4;
  const int v0 = blockIdx.x * BNH, g = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  stage_w<bf16, BNH>(wv, ldw, w, 0, s.Jp, v0, s);
  cp_async_commit();
  cp_async_wait<0>();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXJF][BNH / 16];
#pragma unroll
  for (int q = 0; q < MAXJF; ++q)
#pragma unroll
    for (int f = 0; f < BNH / 16; ++f) wmma::fill_fragment(acc[q][f], 0.f);
  float db = 0.f;  // thread vv < BNH: this group's sum of column v0 + vv
  const int n_tiles = s.N * s.nTB * s.nUB;
  const int first = g * tiles_per_group;
  const int last = min(first + tiles_per_group, n_tiles);
  for (int tile = first; tile < last; ++tile) {
    int n, t0, u0;
    __syncthreads();
    setup_rows<bf16>(tile, s, ri, n, t0, u0, labels, glpb, glpe, lse_in);
    __syncthreads();
    fill_h<bf16>(hs, ldh, ri, n, s, enc, pred);
    __syncthreads();
    logits_ksplit(hs, ldh, wv, ldw, cs, ldc, stage_all, s);
    dlogits_tile<bf16, BNH>(cs, ds, ri, v0, s, bias);
    if (threadIdx.x < BNH)
      for (int i = 0; i < BM; ++i) db += cs[i * ldc + threadIdx.x];
    // dW[J x BNH] += w(h)^T @ w(dlogits)
#pragma unroll
    for (int q = 0; q < MAXJF; ++q) {
      const int j0 = (warp + q * nwarps) * 16;
      if (j0 >= s.Jp) continue;
#pragma unroll
      for (int k0 = 0; k0 < BM; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, hs + k0 * ldh + j0, ldh);
#pragma unroll
        for (int f = 0; f < BNH / 16; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, ds + k0 * ldd + f * 16, ldd);
          wmma::mma_sync(acc[q][f], fa, fb, acc[q][f]);
        }
      }
    }
  }
  __syncthreads();
  float* stage = stage_all + warp * 256;
#pragma unroll
  for (int q = 0; q < MAXJF; ++q) {
    const int j0 = (warp + q * nwarps) * 16;
    if (j0 >= s.Jp) continue;
#pragma unroll
    for (int f = 0; f < BNH / 16; ++f) {
      wmma::store_matrix_sync(stage, acc[q][f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int j = j0 + e / 16, v = v0 + f * 16 + e % 16;
        if (j < s.J && v < s.V) part_w[((size_t)g * s.J + j) * s.V + v] = stage[e];
      }
      __syncwarp();
    }
  }
  if (threadIdx.x < BNH && v0 + threadIdx.x < s.V)
    part_b[(size_t)g * s.V + v0 + threadIdx.x] = db;
}

__global__ void joint_dw_reduce(const float* part_w, const float* part_b,
                                float* dw, float* db, int groups, Shape s) {
  const size_t n_w = (size_t)s.J * s.V;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n_w + s.V;
       idx += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    if (idx < n_w) {
      for (int g = 0; g < groups; ++g) sum += part_w[g * n_w + idx];
      dw[idx] = sum;
    } else {
      for (int g = 0; g < groups; ++g) sum += part_b[(size_t)g * s.V + idx - n_w];
      db[idx - n_w] = sum;
    }
  }
}

template <typename WT>
Shape make_shape(int N, int T, int U1, int J, int V, int blank) {
  Shape s;
  s.N = N; s.T = T; s.U1 = U1; s.J = J; s.V = V; s.blank = blank;
  s.Jp = (J + 15) / 16 * 16;
  s.nTB = (T + Tile<WT>::BT - 1) / Tile<WT>::BT;
  s.nUB = (U1 + Tile<WT>::BU - 1) / Tile<WT>::BU;
  return s;
}

int n_groups(const Shape& s) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_v = (s.V + BNH - 1) / BNH;
  const int n_tiles = s.N * s.nTB * s.nUB;
  int g = (2 * sms + n_v - 1) / n_v;
  return g < 1 ? 1 : (g > n_tiles ? n_tiles : g);
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  if (bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int grid_1d(size_t n) {
  size_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < 4096 ? (b ? b : 1) : 4096);
}

template <typename WT>
int fwd(const void* enc, const void* pred, const void* w, const void* b,
        const void* labels, void* lpb, void* lpe, int N, int T, int U1, int J,
        int V, int blank, cudaStream_t st) {
  const Shape s = make_shape<WT>(N, T, U1, J, V, blank);
  const Smem<WT> L(s.Jp, 0);
  cudaError_t err = prepare(joint_fwd_kernel<WT>, L.total);
  if (err != cudaSuccess) return (int)err;
  joint_fwd_kernel<WT><<<N * s.nTB * s.nUB, THREADS, L.total, st>>>(
      (const float*)enc, (const float*)pred, (const WT*)w, (const float*)b,
      (const int*)labels, (float*)lpb, (float*)lpe, s);
  return (int)cudaGetLastError();
}

template <typename WT>
int dx(const void* enc, const void* pred, const void* w, const void* b,
       const void* labels, const void* glpb, const void* glpe, void* d_enc,
       void* d_pred, void* lse, void* part_enc, void* part_pred, int N, int T,
       int U1, int J, int V, int blank, cudaStream_t st) {
  constexpr bool TC = std::is_same<WT, bf16>::value;
  const Shape s = make_shape<WT>(N, T, U1, J, V, blank);
  if (TC && s.Jp > (THREADS_H / 32) * MAXJF * 16) return (int)cudaErrorInvalidValue;
  const Smem<WT> L(s.Jp, TC ? 4 : 1);
  cudaError_t err;
  if constexpr (TC) {
    err = prepare(joint_dx_kernel_bf16, L.total);
    if (err != cudaSuccess) return (int)err;
    joint_dx_kernel_bf16<<<N * s.nTB * s.nUB, THREADS_H, L.total, st>>>(
        (const float*)enc, (const float*)pred, (const bf16*)w, (const float*)b,
        (const int*)labels, (const float*)glpb, (const float*)glpe, (float*)lse,
        (float*)part_enc, (float*)part_pred, s);
  } else {
    err = prepare(joint_dx_kernel<WT>, L.total);
    if (err != cudaSuccess) return (int)err;
    joint_dx_kernel<WT><<<N * s.nTB * s.nUB, THREADS, L.total, st>>>(
        (const float*)enc, (const float*)pred, (const WT*)w, (const float*)b,
        (const int*)labels, (const float*)glpb, (const float*)glpe, (float*)lse,
        (float*)part_enc, (float*)part_pred, s);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  joint_dx_reduce<<<grid_1d((size_t)N * (T + U1) * J), THREADS, 0, st>>>(
      (const float*)part_enc, (const float*)part_pred, (float*)d_enc,
      (float*)d_pred, s);
  return (int)cudaGetLastError();
}

template <typename WT>
int dw(const void* enc, const void* pred, const void* w, const void* b,
       const void* labels, const void* glpb, const void* glpe, const void* lse,
       void* dwo, void* dbo, void* part_w, void* part_b, int groups, int N,
       int T, int U1, int J, int V, int blank, cudaStream_t st) {
  constexpr bool TC = std::is_same<WT, bf16>::value;
  const Shape s = make_shape<WT>(N, T, U1, J, V, blank);
  if (TC && s.Jp > (THREADS_H / 32) * MAXJF * 16) return (int)cudaErrorInvalidValue;
  const Smem<WT> L(s.Jp, TC ? 3 : 2);
  const int n_tiles = N * s.nTB * s.nUB;
  const int per = (n_tiles + groups - 1) / groups;
  dim3 grid((V + BNH - 1) / BNH, groups);
  cudaError_t err;
  if constexpr (TC) {
    err = prepare(joint_dw_kernel_bf16, L.total);
    if (err != cudaSuccess) return (int)err;
    joint_dw_kernel_bf16<<<grid, THREADS_H, L.total, st>>>(
        (const float*)enc, (const float*)pred, (const bf16*)w, (const float*)b,
        (const int*)labels, (const float*)glpb, (const float*)glpe,
        (const float*)lse, (float*)part_w, (float*)part_b, per, s);
  } else {
    err = prepare(joint_dw_kernel<WT>, L.total);
    if (err != cudaSuccess) return (int)err;
    joint_dw_kernel<WT><<<grid, THREADS, L.total, st>>>(
        (const float*)enc, (const float*)pred, (const WT*)w, (const float*)b,
        (const int*)labels, (const float*)glpb, (const float*)glpe,
        (const float*)lse, (float*)part_w, (float*)part_b, per, s);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  joint_dw_reduce<<<grid_1d((size_t)J * V + V), THREADS, 0, st>>>(
      (const float*)part_w, (const float*)part_b, (float*)dwo, (float*)dbo,
      groups, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch sizes, in float32 elements, that the wrapper allocates:
// out[0] G's enc partial, out[1] G's pred partial, out[2] H's row groups,
// out[3] H's dW partial, out[4] H's db partial; out[5] the largest
// shared-memory request of the three kernels, in bytes.
int joint_lp_scratch(int N, int T, int U1, int J, int V, int w_is_bf16,
                     long long* out) {
  Shape s;
  size_t smem;
  if (w_is_bf16) {
    s = make_shape<bf16>(N, T, U1, J, V, 0);
    smem = Smem<bf16>(s.Jp, 4).total;
    if (Smem<bf16>(s.Jp, 3).total > smem) smem = Smem<bf16>(s.Jp, 3).total;
  } else {
    s = make_shape<float>(N, T, U1, J, V, 0);
    smem = Smem<float>(s.Jp, 1).total;
    if (Smem<float>(s.Jp, 2).total > smem) smem = Smem<float>(s.Jp, 2).total;
  }
  const int g = n_groups(s);
  out[0] = (long long)N * T * s.nUB * J;
  out[1] = (long long)N * s.nTB * U1 * J;
  out[2] = g;
  out[3] = (long long)g * J * V;
  out[4] = (long long)g * V;
  out[5] = (long long)smem;
  return 0;
}

int joint_lp_max_smem() { return MAX_SMEM; }

int joint_lp_fwd(const void* enc, const void* pred, const void* w,
                 const void* b, const void* labels, void* lpb, void* lpe,
                 int N, int T, int U1, int J, int V, int blank, int w_is_bf16,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return w_is_bf16
      ? fwd<bf16>(enc, pred, w, b, labels, lpb, lpe, N, T, U1, J, V, blank, st)
      : fwd<float>(enc, pred, w, b, labels, lpb, lpe, N, T, U1, J, V, blank, st);
}

int joint_lp_dx(const void* enc, const void* pred, const void* w,
                const void* b, const void* labels, const void* glpb,
                const void* glpe, void* d_enc, void* d_pred, void* lse,
                void* part_enc, void* part_pred, int N, int T, int U1, int J,
                int V, int blank, int w_is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return w_is_bf16
      ? dx<bf16>(enc, pred, w, b, labels, glpb, glpe, d_enc, d_pred, lse,
                 part_enc, part_pred, N, T, U1, J, V, blank, st)
      : dx<float>(enc, pred, w, b, labels, glpb, glpe, d_enc, d_pred, lse,
                  part_enc, part_pred, N, T, U1, J, V, blank, st);
}

int joint_lp_dw(const void* enc, const void* pred, const void* w,
                const void* b, const void* labels, const void* glpb,
                const void* glpe, const void* lse, void* dwo, void* dbo,
                void* part_w, void* part_b, int groups, int N, int T, int U1,
                int J, int V, int blank, int w_is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return w_is_bf16
      ? dw<bf16>(enc, pred, w, b, labels, glpb, glpe, lse, dwo, dbo, part_w,
                 part_b, groups, N, T, U1, J, V, blank, st)
      : dw<float>(enc, pred, w, b, labels, glpb, glpe, lse, dwo, dbo, part_w,
                  part_b, groups, N, T, U1, J, V, blank, st);
}

const char* joint_lp_error_string(int code) {
  if (code == (int)cudaErrorInvalidValue)
    return "invalid value (J too large: shared memory above the per-block "
           "limit, or above 1024 for G and H with bf16 W_out)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
