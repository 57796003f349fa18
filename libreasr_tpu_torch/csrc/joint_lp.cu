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
//   F: lp_blank = logits[blank] - lse; lp_emit = logits[label_u] - lse,
//      where a label outside [0, V) (the padding -1) picks 0; and lse
//   G: p = exp(logits - lse), with F's lse;
//      dlogits = 1[v = blank] g_lpb + 1[v = label_u] g_lpe - p (g_lpb + g_lpe)
//      dh = (w(dlogits) @ W_out^T) * (1 - h^2);
//      d_enc_proj[n, t] = sum_u dh, d_pred_proj[n, u] = sum_t dh
//   H: dW_out = sum_rows w(h)^T w(dlogits), db_out = sum_rows dlogits,
//      the softmax taken with F's lse
// w() rounds to W_out's type (bf16 or float32); h, dlogits and every sum
// stay float32. Both one-hot terms are added, never if/else, so a label
// equal to the blank gets both. The emit column of u = U1 - 1 does not
// exist (label -1, g_lpe 0). The JAX backward recomputes lse in its dx
// kernel; here F computes it once and the loss saves it for G and H.
//
// What bounds them on an H100: the [rows, J] x [J, V] products, 2 R J V
// flops each (135 GFLOP at N 16, T 49, U1 41, J 1024, V 2048; F does one,
// G and H two each), against a few tens of MB of inputs and outputs: all
// three are compute-bound, at the tensor cores' rate (989 TFLOP/s bf16).
//
// With float32 W_out (no tensor-core mode is exact in float32) the three
// keep the [rows, V] logits and dlogits out of device memory, as the TPU
// kernels kept them in VMEM: a block owns a tile of BM rows (BT frames x
// BU labels of one utterance), holds h for its rows in shared memory and
// walks V in tiles, recomputing the logits tile by tile in a plain
// float32 loop; W_out reaches shared memory in 64-row chunks by 16-byte
// cp.async copies, the next chunk in flight while the current one is
// multiplied. F keeps an online max/sum per row over the V tiles; G forms
// dlogits from F's lse and accumulates w(dlogits) @ W_out^T into a
// [BM, J] float32 block in shared memory.
//
// With bf16 W_out all three run on one tensor-core engine,
// joint_dw_tc<MODE>: a 128 x 128 tile of a product per block, 64-deep K
// stages of both operands brought by TMA (cp.async.bulk.tensor, 128-byte
// swizzle) into a ring with full/empty mbarriers, one producer thread,
// and two consumer warpgroups issuing wgmma.mma_async m64n128k16 with
// float32 sums in registers; the epilogue is the MODE's. The lattice goes
// in chunks whose bf16 scratch stays under a cap the wrapper states
// (ops/kernels/joint_lp.py: lp_plan, dx_plan, dw_plan; one chunk each at
// the main path's shape), and every chunk starts with joint_dw_fill,
// which makes w(h) once per row into a bf16 scratch [rows_c, jp] (66 MB
// at the main shape).
//
// F, per chunk of lattice rows (3 launches). Its first design, a block
// of 32 rows walking V on 16x16 WMMA fragments and rebuilding w(h) per
// block, took 3.5 ms, 25x its bound.
//   1. joint_dw_fill, w(h);
//   2. joint_dw_tc<TC_LSE>, the logits product [rows_c, J] x [J, V]; the
//      epilogue writes each row's max and sum of exp over the tile's 128
//      columns to [2][ceil(V / 128)][rows_c], and the picks: the thread
//      that holds column blank of a row writes that logit (+ bias) to
//      lb[rows_c], the thread that holds column label_u writes it to
//      le[rows_c] (one thread per (row, column): no race, no atomic);
//   3. joint_lp_fold folds the V tiles in order into the row lse and
//      writes lse, lp_blank = lb - lse and lp_emit = le - lse (le counted
//      as 0 unless 0 <= label_u < V, read by the fold itself).
// A row's sums do not depend on which tile or chunk holds it, so the lse
// is the same bits under any cap.
//
// H, per chunk of lattice rows (4 launches). Its first design (64
// rebuilds of w(h) per row on 16x16 WMMA fragments) was 35x its bound.
//   1. joint_dw_fill, w(h);
//   2. joint_dw_tc<TC_DLOGITS>, the logits product again; the epilogue
//      forms dlogits in registers from F's lse, the cotangents and the
//      labels, writes w(dlogits) to a bf16 scratch [rows_c, vp] (132 MB)
//      and the tile's column sums of the float32 dlogits, db's partials;
//   3. joint_dw_tc<TC_DW>, dW = w(h)^T w(dlogits): both operands MN-major
//      from the two scratches (w(h)^T needs no copy: wgmma transposes
//      16-bit operands in its descriptor), K the chunk's rows, split over
//      blockIdx.z into partials when the J x V tiles alone would leave
//      SMs idle;
//   4. joint_dw_fold adds the group partials and db's row-tile partials
//      to dW and db in a fixed order.
//
// G, per chunk of whole frame groups (DX_FRAMES frames of one utterance;
// 3 launches, then one fold). Its first design (two passes over V on
// 16x16 WMMA) took 7.7 ms, 28x its bound.
//   1. joint_dw_fill, w(h);
//   2. joint_dw_tc<TC_DLOGITS>, as for H, writes w(dlogits) [rows_c, vp];
//   3. joint_dw_tc<TC_DH>, dh = w(dlogits) @ W_out^T [rows_c, V] x [V, J]:
//      A is w(dlogits) read through a 3-D tensor map in tiles of 8 frames
//      x 16 labels (the product's 128 rows), B is W_out's rows, already
//      K-major along V (no transposed copy). The epilogue multiplies by
//      1 - h^2 with h in float32 from enc_proj + pred_proj, sums each
//      frame's 16 labels in registers (d_enc_proj partials [N, T, nub, J])
//      and each label's 8 frames through shared memory (d_pred_proj
//      partials [N, ntb, U1, J]).
// After the chunks joint_dx_reduce adds the partials in a fixed order.
// No float atomics anywhere: every output is the same bits from run to
// run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// F, G and H with float32 W_out
constexpr int THREADS = 256;
constexpr int BT = 2, BU = 8, BM = BT * BU;  // a block's rows: BT frames x BU labels
constexpr int PAD = 4;    // row padding of the shared tiles, in floats (16 bytes)
constexpr int BN = 64;    // V tile of F and G
constexpr int BNH = 32;   // V tile of H
constexpr int BK = 64;    // J chunk of W staged per step (also G's dh chunk)
constexpr int MAX_SMEM = 232448;  // per-block limit on sm_90

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

// c[M x N] (row-major, ldc) += A[M x K] B[K x N] from shared memory, in
// float32. A(m, k) = a[k * lda + m] if A_T else a[m * lda + k];
// B(k, n) = b[n * ldb + k] if B_T else b[k * ldb + n]. All threads of the
// block take part; no barrier.
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
__device__ void setup_rows(int tile, const Shape& s, RowInfo* ri, int& n,
                           int& t0, int& u0, const int* labels,
                           const float* glpb, const float* glpe,
                           const float* lse_in) {
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

// hs[i, j] = tanh(enc_proj[n, t_i, j] + pred_proj[n, u_i, j]), zero on
// invalid rows and for J <= j < Jp. One warp per row.
__device__ void fill_h(float* hs, int ldh, const RowInfo* ri, int n,
                       const Shape& s, const float* enc, const float* pred) {
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x / 32; i < BM; i += blockDim.x / 32) {
    float* row = hs + i * ldh;
    const bool valid = ri[i].valid;
    const float* e = enc + ((size_t)n * s.T + ri[i].t) * s.J;
    const float* p = pred + ((size_t)n * s.U1 + ri[i].u) * s.J;
    for (int j = lane; j < s.Jp; j += 32)
      row[j] = valid && j < s.J ? tanhf(e[j] + p[j]) : 0.f;
  }
}

// Copies W_out[k0 : k0 + kc, v0 : v0 + W] into dst (row stride ldw), zero
// past J and V: 16-byte cp.async copies when the tile lies inside V and
// W_out's rows are 16-byte aligned (V a multiple of 4), plain loads
// otherwise. The caller commits the copies and waits.
template <int W>
__device__ void stage_w(float* dst, int ldw, const float* w, int k0, int kc, int v0,
                        const Shape& s) {
  constexpr int VEC = 4, SEGS = W / VEC;
  if (s.V % VEC == 0 && v0 + W <= s.V) {
    for (int idx = threadIdx.x; idx < kc * SEGS; idx += blockDim.x) {
      const int kk = idx / SEGS, seg = idx % SEGS, j = k0 + kk;
      float* d = dst + kk * ldw + seg * VEC;
      if (j < s.J)
        cp_async16(d, w + (size_t)j * s.V + v0 + seg * VEC);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int idx = threadIdx.x; idx < kc * W; idx += blockDim.x) {
      const int kk = idx / W, vv = idx % W;
      const int j = k0 + kk, v = v0 + vv;
      dst[kk * ldw + vv] = (j < s.J && v < s.V) ? w[(size_t)j * s.V + v] : 0.f;
    }
  }
}

// cs[BM x W] = hs @ W_out[:, v0 : v0 + W] (zero past V), J in BK chunks
// through two staging buffers in ws: the copy of chunk c + 1 is in
// flight while chunk c is multiplied. Ends with a barrier.
template <int W>
__device__ void logits_tile(const float* hs, int ldh, float* ws, float* cs, int v0,
                            const Shape& s, const float* w) {
  constexpr int LDW = W + PAD, LDC = W + 4, BUF = BK * LDW;
  for (int idx = threadIdx.x; idx < BM * W; idx += blockDim.x)
    cs[(idx / W) * LDC + idx % W] = 0.f;
  const int nk = (s.Jp + BK - 1) / BK;
  stage_w<W>(ws, LDW, w, 0, min(BK, s.Jp), v0, s);
  cp_async_commit();
  for (int c = 0; c < nk; ++c) {
    const int k0 = c * BK, kc = min(BK, s.Jp - k0);
    if (c + 1 < nk) {
      stage_w<W>(ws + ((c + 1) & 1) * BUF, LDW, w, k0 + BK, min(BK, s.Jp - k0 - BK), v0,
                 s);
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
template <int W>
__device__ void online_lse(const float* cs, RowInfo* ri, int v0, const Shape& s,
                           const float* bias) {
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

// dlogits of a tile, in place in cs and copied into ds (zero on invalid
// rows and columns).
template <int W>
__device__ void dlogits_tile(float* cs, float* ds, const RowInfo* ri, int v0,
                             const Shape& s, const float* bias) {
  constexpr int LDC = W + 4, LDD = W + PAD;
  for (int idx = threadIdx.x; idx < BM * W; idx += blockDim.x) {
    const int i = idx / W, vv = idx % W, v = v0 + vv;
    float d = 0.f;
    if (ri[i].valid && v < s.V) {
      const float p = expf(cs[i * LDC + vv] + bias[v] - ri[i].lse);
      d = (v == s.blank ? ri[i].gb : 0.f) + (v == ri[i].lab ? ri[i].ge : 0.f)
          - p * (ri[i].gb + ri[i].ge);
    }
    cs[i * LDC + vv] = d;
    ds[i * LDD + vv] = d;
  }
  __syncthreads();
}

struct Smem {
  size_t hs, ws, cs, ds, acc, rows, total;
  // kind 0: F; 1: G and 2: H
  __host__ __device__ Smem(int Jp, int kind) {
    const int w = kind == 2 ? BNH : BN;
    size_t o = 0;
    hs = o; o = align128(o + (size_t)BM * (Jp + PAD) * sizeof(float));
    ws = o;
    o = align128(o + 2 * (size_t)BK * (w + PAD) * sizeof(float));
    cs = o; o = align128(o + (size_t)BM * (w + 4) * sizeof(float));
    ds = o; o = align128(o + (kind ? (size_t)BM * (w + PAD) * sizeof(float) : 0));
    acc = o;
    if (kind == 1) o = align128(o + (size_t)BM * (Jp + 4) * sizeof(float));
    if (kind == 2) o = align128(o + (size_t)Jp * BNH * sizeof(float));
    rows = o; o = align128(o + (size_t)BM * sizeof(RowInfo));
    total = o;
  }
};

__global__ void __launch_bounds__(THREADS)
joint_fwd_kernel(const float* enc, const float* pred, const float* w,
                 const float* bias, const int* labels, float* lpb, float* lpe,
                 float* lse_out, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(s.Jp, 0);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  RowInfo* ri = reinterpret_cast<RowInfo*>(smem + L.rows);
  const int ldh = s.Jp + PAD;
  int n, t0, u0;
  setup_rows(blockIdx.x, s, ri, n, t0, u0, labels, nullptr, nullptr, nullptr);
  __syncthreads();
  fill_h(hs, ldh, ri, n, s, enc, pred);
  for (int v0 = 0; v0 < s.V; v0 += BN) {
    logits_tile<BN>(hs, ldh, ws, cs, v0, s, w);
    online_lse<BN>(cs, ri, v0, s, bias);
  }
  const int U = s.U1 - 1;
  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    const RowInfo r = ri[i];
    if (!r.valid) continue;
    const float lse = r.m + logf(r.s);
    const size_t row = ((size_t)n * s.T + r.t) * s.U1 + r.u;
    lse_out[row] = lse;
    lpb[row] = r.lb - lse;
    if (r.u < U) lpe[((size_t)n * s.T + r.t) * U + r.u] = r.le - lse;
  }
}

__global__ void __launch_bounds__(THREADS)
joint_dx_kernel(const float* enc, const float* pred, const float* w,
                const float* bias, const int* labels, const float* glpb,
                const float* glpe, const float* lse_in, float* part_enc,
                float* part_pred, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(s.Jp, 1);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  RowInfo* ri = reinterpret_cast<RowInfo*>(smem + L.rows);
  const int ldh = s.Jp + PAD, lda = s.Jp + 4, ldw = BN + PAD, ldd = BN + PAD;
  int n, t0, u0;
  setup_rows(blockIdx.x, s, ri, n, t0, u0, labels, glpb, glpe, lse_in);
  __syncthreads();
  fill_h(hs, ldh, ri, n, s, enc, pred);
  for (int idx = threadIdx.x; idx < BM * s.Jp; idx += blockDim.x)
    acc[(idx / s.Jp) * lda + idx % s.Jp] = 0.f;
  __syncthreads();
  // dlogits from F's lse, and acc += w(dlogits) @ W_out[:, v-tile]^T
  for (int v0 = 0; v0 < s.V; v0 += BN) {
    logits_tile<BN>(hs, ldh, ws, cs, v0, s, w);
    dlogits_tile<BN>(cs, ds, ri, v0, s, bias);
    const int nj = (s.Jp + BK - 1) / BK;
    stage_w<BN>(ws, ldw, w, 0, min(BK, s.Jp), v0, s);
    cp_async_commit();
    for (int c = 0; c < nj; ++c) {
      const int j0 = c * BK, jc = min(BK, s.Jp - j0);
      if (c + 1 < nj) {
        stage_w<BN>(ws + ((c + 1) & 1) * BK * ldw, ldw, w, j0 + BK,
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
  // dh = acc * (1 - h^2), zero on invalid rows
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

__global__ void __launch_bounds__(THREADS)
joint_dw_kernel(const float* enc, const float* pred, const float* w,
                const float* bias, const int* labels, const float* glpb,
                const float* glpe, const float* lse_in, float* part_w,
                float* part_b, int tiles_per_group, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(s.Jp, 2);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
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
    setup_rows(tile, s, ri, n, t0, u0, labels, glpb, glpe, lse_in);
    __syncthreads();
    fill_h(hs, ldh, ri, n, s, enc, pred);
    logits_tile<BNH>(hs, ldh, ws, cs, v0, s, w);
    dlogits_tile<BNH>(cs, ds, ri, v0, s, bias);
    if (threadIdx.x < BNH)
      for (int i = 0; i < BM; ++i) db += cs[i * ldc + threadIdx.x];
    // accw[J x BNH] += h^T @ dlogits
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

// ---------------------------------------------------------------------------
// F, G and H with bf16 W_out: per chunk of lattice rows, w(h) once, then
// TMA + wgmma products with the epilogue of each MODE
// ---------------------------------------------------------------------------

constexpr int GM = 128;        // product tile rows: two consumer warpgroups x 64
constexpr int GN = 128;        // product tile columns: one m64n128k16 per warpgroup
constexpr int GK = 64;         // K per stage: one 128-byte swizzle row of bf16
constexpr int GTHREADS = 288;  // warps 0-7: two wgmma warpgroups; warp 8: TMA
constexpr int BOX = 64 * 64 * 2;  // one {64, 64} bf16 TMA box, 128B-swizzled
constexpr int STAGE = 4 * BOX;    // A: 2 boxes, B: 2 boxes
// The products of F, G and H, one kernel (joint_dw_tc<MODE>) with four
// epilogues: TC_LSE, the logits with the (max, sum) and picks epilogue
// (F); TC_DLOGITS, the logits with the dlogits epilogue (G, H); TC_DW,
// dW = w(h)^T w(dlogits) (H); TC_DH, dh = w(dlogits) W_out^T with the
// (1 - h^2) and the label and frame sums in its epilogue (G).
enum : int { TC_DLOGITS = 0, TC_DW = 1, TC_LSE = 2, TC_DH = 3 };
// Ring depth: the logits passes run 4,032 short tiles (K 1024) at the
// main shape, so they take 3 stages and two blocks per SM, one block's
// epilogue under the other's products (so does dh: 2,688 tiles of K
// 2048); the dW pass runs ~128 long tiles (K = the chunk's rows), one
// block per SM with 5 stages.
template <int MODE> struct Ring {
  static constexpr int STAGES = MODE == TC_DW ? 5 : 3;
  static constexpr int BLOCKS_PER_SM = MODE == TC_DW ? 1 : 2;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8 + 8 * GN * 4;
};
constexpr int ERR_TENSOR_MAP = 100001;
constexpr int DX_FRAMES = 8;   // frames of a dh tile (ops/kernels/joint_lp.py)
constexpr int DX_LABELS = 16;  // labels of a dh tile
constexpr int DX_LD = GN + 4;  // row stride of the dh tile staged for the frame sums
static_assert(DX_FRAMES * DX_LABELS == GM, "a dh tile is the product's 128 rows");
static_assert(DX_FRAMES * DX_LABELS * DX_LD * 4 <= 3 * STAGE, "dh tile fits the ring");

struct DwChunk {
  const float* bias;
  const int* labels;
  const float* glpb;
  const float* glpe;
  const float* lse;
  bf16* d;        // [rows_c, vp] w(dlogits)
  float* dbpart;  // [ceil(rows_c / GM), V] column sums of dlogits per row tile, or null
  float* part;    // [groups, J, V] dW partials
  const float* enc;   // TC_DH: enc_proj, pred_proj (float32 h)
  const float* pred;
  float* enc_part;    // TC_DH: [N, T, nub, J] sums over each tile's labels
  float* pred_part;   // TC_DH: [N, ntb, U1, J] sums over each tile's frames
  float* mpart;       // TC_LSE: [ceil(V / GN), rows_c] row max, and sum of exp
  float* spart;
  float* lb;          // TC_LSE: [rows_c] the logit of the blank, and of the label
  float* le;
  int r0, rows_c, T, U1, J, V, vp, blank;
  int k_iters;    // logits: Jp / GK; dW: K stages per group; dh: ceil(vp / GK)
  int k_total;    // dW: K stages of the chunk
  int g0, f0, ntb, nub;  // TC_DH: first group and first frame of the chunk
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// returns once the phase of parity `parity` has completed; traps after
// ~2^35 cycles (~20 s), so that a lost transfer is an error, not a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 35)) asm volatile("trap;");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// box {c0 (inner), c1 (outer)} of `map` into shared memory at dst,
// completion counted on bar; out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// box {c0, c1, c2} of a 3-D `map`, as tma_load
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0,
                                          int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand at addr.
// K-major: sbo steps between 8-row groups (lbo unused). MN-major: lbo
// steps between 64-element atoms along M/N, sbo between 8-row groups
// along K.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator registers across the
// asynchronous products
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128], bf16 in, float32 sums; A K-major
// (TA 0) or MN-major (TA 1), B K-major (TB 0) or MN-major (TB 1)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// w(h) of the chunk's rows [r0, r0 + rows_c) into hs [rows_c, jp], zero
// for J <= j < jp. A thread owns 8 columns of one frame (n, t), reads that
// stretch of enc_proj once and walks the frame's labels u that fall in
// the chunk, one 16-byte store per row.
__global__ void joint_dw_fill(const float* enc, const float* pred, bf16* hs, int r0,
                              int rows_c, int N, int T, int U1, int J, int jp) {
  const int per_row = jp / 8;
  const int f0 = r0 / U1, f1 = (r0 + rows_c - 1) / U1;  // frames n T + t touched
  const size_t total = (size_t)(f1 - f0 + 1) * per_row;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int f = f0 + (int)(idx / per_row), j0 = (int)(idx % per_row) * 8;
    const int n = f / T;
    float e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = j0 + k < J ? enc[(size_t)f * J + j0 + k] : 0.f;
    const int ub = max(0, r0 - f * U1), ue = min(U1, r0 + rows_c - f * U1);
    for (int u = ub; u < ue; ++u) {
      const float* q = pred + ((size_t)n * U1 + u) * J;
      __align__(16) bf16 out[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = j0 + k;
        out[k] = __float2bfloat16_rn(j < J ? tanhf(e[k] + q[j]) : 0.f);
      }
      const size_t rl = (size_t)f * U1 + u - r0;
      *reinterpret_cast<uint4*>(hs + rl * jp + j0) = *reinterpret_cast<const uint4*>(out);
    }
  }
}

// One GM x GN tile of a product over K in GK-deep stages, A and B bf16
// through TMA into a ring of Ring<MODE>::STAGES (full/empty mbarriers),
// the float32 sum in the registers of two consumer warpgroups (64 rows
// each).
//   TC_DLOGITS, the logits: A = w(h) [rows_c, jp] K-major (tile rows m0..,
//     K along J), B = W_out [J, vw] MN-major; the epilogue forms dlogits
//     from the row lse, writes w(dlogits) to p.d and, when p.dbpart is not
//     null, the tile's column sums of the float32 dlogits to p.dbpart.
//   TC_LSE, the logits as above; the epilogue writes each row's max and
//     sum of exp over the tile's columns to p.mpart and p.spart, and the
//     picks: the logit of column blank to p.lb, of column label_u to p.le,
//     each by the one thread that holds that (row, column).
//   TC_DW, dW: A = w(h)^T, the same scratch read MN-major (tile rows =
//     J, K along the chunk's rows), B = w(dlogits) [rows_c, vp] MN-major;
//     K split over blockIdx.z into p.part[z].
//   TC_DH, dh: A = w(dlogits) read as [frames_c, U1, vp] in boxes of
//     DX_FRAMES frames x DX_LABELS labels (tile blockIdx.y of the chunk:
//     group g0 + y / nub, label block y % nub), K along V; B = W_out
//     K-major (tile columns = J, K along V: no transposed copy). The
//     epilogue multiplies by 1 - h^2 (h in float32 from enc_proj +
//     pred_proj) and writes the tile's sums over its labels and over its
//     frames to p.enc_part and p.pred_part.
template <int MODE>
__global__ void __launch_bounds__(GTHREADS, Ring<MODE>::BLOCKS_PER_SM)
joint_dw_tc(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            DwChunk p) {
  constexpr int GSTAGES = Ring<MODE>::STAGES;
  constexpr bool DW = MODE == TC_DW, DH = MODE == TC_DH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + GSTAGES * STAGE, empty0 = full0 + GSTAGES * 8;
  float* red = reinterpret_cast<float*>(smem + GSTAGES * STAGE + 2 * GSTAGES * 8);
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int kb = DW ? blockIdx.z * p.k_iters : 0;
  const int nk = DW ? min(p.k_iters, p.k_total - kb) : p.k_iters;
  // TC_DH: this tile's utterance un, frame block fb, label block ub
  const int gidx = p.g0 + (DH ? (int)blockIdx.y / p.nub : 0);
  const int ub = DH ? (int)blockIdx.y % p.nub : 0;
  const int un = DH ? gidx / p.ntb : 0, fb = DH ? gidx % p.ntb : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      const int fl = un * p.T + fb * DX_FRAMES - p.f0;  // TC_DH: frame in the chunk
      for (int i = 0; i < nk; ++i) {
        const int s = i % GSTAGES;
        const uint32_t full = full0 + 8 * s, st = base + s * STAGE;
        mbar_wait(empty0 + 8 * s, ((i / GSTAGES) & 1) ^ 1);
        mbar_expect_tx(full, STAGE);
        const int k = (kb + i) * GK;
        if (DW) {
          tma_load(st, &ta, m0, k, full);
          tma_load(st + BOX, &ta, m0 + 64, k, full);
        } else if (DH) {
          tma_load3(st, &ta, k, ub * DX_LABELS, fl, full);  // 128 rows, 2 boxes' bytes
        } else {
          tma_load(st, &ta, k, m0, full);
          tma_load(st + BOX, &ta, k, m0 + 64, full);
        }
        if (DH) {
          tma_load(st + 2 * BOX, &tb, k, n0, full);
          tma_load(st + 3 * BOX, &tb, k, n0 + 64, full);
        } else {
          tma_load(st + 2 * BOX, &tb, n0, k, full);
          tma_load(st + 3 * BOX, &tb, n0 + 64, k, full);
        }
      }
    }
    return;
  }
  const int c = warp / 4, w4 = warp % 4;  // consumer warpgroup, warp in it
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % GSTAGES;
    mbar_wait(full0 + 8 * s, (i / GSTAGES) & 1);
    const uint32_t a_st = base + s * STAGE + c * BOX, b_st = base + s * STAGE + 2 * BOX;
    acc_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      const uint64_t da = DW ? gmma_desc(a_st + kk * 2048, 1024, 1024)
                             : gmma_desc(a_st + kk * 32, 16, 1024);
      const uint64_t db = DH ? gmma_desc(b_st + kk * 32, 16, 1024)
                             : gmma_desc(b_st + kk * 2048, BOX, 1024);
      wgmma_m64n128<DW ? 1 : 0, DH ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    acc_fence(acc);
    wgmma_wait_all();
    acc_fence(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  // accumulator element i of this thread: row 16 w4 + lane / 4 + 8 ((i / 2) % 2)
  // of the warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + i % 2
  const int row0 = m0 + c * 64 + w4 * 16 + lane / 4;
  if constexpr (DW) {
    const size_t gbase = (size_t)blockIdx.z * p.J;
#pragma unroll
    for (int nb = 0; nb < GN / 8; ++nb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = row0 + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = n0 + nb * 8 + (lane % 4) * 2 + e;
          if (j < p.J && v < p.V) p.part[(gbase + j) * p.V + v] = acc[nb * 4 + 2 * h + e];
        }
      }
    }
    return;
  } else if constexpr (DH) {
    // this warp's 16 rows are one frame t of the tile, labels u0 + 0..15;
    // the thread's two rows are labels u0 + lane / 4 and u0 + lane / 4 + 8
    const int fi = c * 4 + w4, t = fb * DX_FRAMES + fi;
    const bool tok = t < p.T;
    const float* er = p.enc + ((size_t)un * p.T + (tok ? t : 0)) * p.J;
    int uu[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uu[h] = ub * DX_LABELS + lane / 4 + 8 * h;
      ok[h] = tok && uu[h] < p.U1;
    }
    // the ring is free once both warpgroups' last products have finished
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* tile = reinterpret_cast<float*>(smem);  // [frame][label][DX_LD]
#pragma unroll
    for (int nb = 0; nb < GN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nb * 8 + (lane % 4) * 2 + e, j = n0 + col;
        float x[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[h] = 0.f;
          if (ok[h] && j < p.J) {
            const float hv = tanhf(er[j] + p.pred[((size_t)un * p.U1 + uu[h]) * p.J + j]);
            x[h] = acc[nb * 4 + 2 * h + e] * (1.f - hv * hv);
          }
          tile[(fi * DX_LABELS + lane / 4 + 8 * h) * DX_LD + col] = x[h];
        }
        // d_enc_proj partial: the warp's 16 labels of column j
        float es = x[0] + x[1];
        es += __shfl_xor_sync(0xffffffffu, es, 4);
        es += __shfl_xor_sync(0xffffffffu, es, 8);
        es += __shfl_xor_sync(0xffffffffu, es, 16);
        if (lane < 4 && tok && j < p.J)
          p.enc_part[(((size_t)un * p.T + t) * p.nub + ub) * p.J + j] = es;
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    // d_pred_proj partial: the tile's frames, in order, per label and column
    for (int item = threadIdx.x; item < DX_LABELS * GN; item += 256) {
      const int li = item / GN, col = item % GN, u = ub * DX_LABELS + li, j = n0 + col;
      if (u >= p.U1 || j >= p.J) continue;
      float sum = 0.f;
#pragma unroll
      for (int f = 0; f < DX_FRAMES; ++f) sum += tile[(f * DX_LABELS + li) * DX_LD + col];
      p.pred_part[(((size_t)un * p.ntb + fb) * p.U1 + u) * p.J + j] = sum;
    }
    return;
  } else if constexpr (MODE == TC_LSE) {
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < GN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = n0 + nb * 8 + (lane % 4) * 2 + e;
        if (v < p.V)
#pragma unroll
          for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], acc[nb * 4 + 2 * h + e] + p.bias[v]);
      }
    // the picks: the logit (+ bias) of column blank and of column label_u
    // of each of the thread's two rows, written by the one thread that
    // holds that (row, column); most threads hold neither and skip
    const int U = p.U1 - 1, cq = n0 + (lane % 4) * 2;  // cq: the column of nb 0, e 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = row0 + 8 * h, r = p.r0 + rl, f = r / p.U1, u = r - f * p.U1;
      const int lab = rl < p.rows_c && u < U ? p.labels[(f / p.T) * U + u] : -1;
      const int db = p.blank - cq, dl = lab - cq;  // nb 8 + e of the column, if held
      const bool hb = db >= 0 && db < GN && (db & 6) == 0;
      const bool hl = lab >= 0 && lab < p.V && dl >= 0 && dl < GN && (dl & 6) == 0;
      if (rl < p.rows_c && (hb || hl)) {
#pragma unroll
        for (int nb = 0; nb < GN / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = nb * 8 + e;
            if ((hb && d == db) || (hl && d == dl)) {
              const float x = acc[nb * 4 + 2 * h + e] + p.bias[cq + d];
              if (hb && d == db) p.lb[rl] = x;
              if (hl && d == dl) p.le[rl] = x;
            }
          }
      }
    }
    // a row's 128 columns lie in the 4 lanes of equal lane / 4
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int nb = 0; nb < GN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = n0 + nb * 8 + (lane % 4) * 2 + e;
        if (v < p.V)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sm[h] += expf(acc[nb * 4 + 2 * h + e] + p.bias[v] - mx[h]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sm[h] += __shfl_xor_sync(0xffffffffu, sm[h], 1);
      sm[h] += __shfl_xor_sync(0xffffffffu, sm[h], 2);
      const int rl = row0 + 8 * h;
      if (lane % 4 == 0 && rl < p.rows_c) {
        p.mpart[(size_t)blockIdx.x * p.rows_c + rl] = mx[h];
        p.spart[(size_t)blockIdx.x * p.rows_c + rl] = sm[h];
      }
    }
    return;
  }
  // TC_DLOGITS: the two rows of this thread: lse, cotangents, label
  const int U = p.U1 - 1;
  bool ok[2];
  float lse[2], gb[2], ge[2];
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = row0 + 8 * h;
    ok[h] = rl < p.rows_c;
    lse[h] = gb[h] = ge[h] = 0.f;
    lab[h] = -1;
    if (ok[h]) {
      const int r = p.r0 + rl, n = r / (p.T * p.U1), rem = r - n * p.T * p.U1;
      const int t = rem / p.U1, u = rem - t * p.U1;
      lse[h] = p.lse[r];
      gb[h] = p.glpb[r];
      if (u < U) {
        ge[h] = p.glpe[((size_t)n * p.T + t) * U + u];
        lab[h] = p.labels[n * U + u];
      }
    }
  }
  float* red_w = red + (c * 4 + w4) * GN;
#pragma unroll
  for (int nb = 0; nb < GN / 8; ++nb) {
    const int v0 = n0 + nb * 8 + (lane % 4) * 2;
    float d[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = v0 + e;
      const float bv = v < p.V ? p.bias[v] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = 0.f;
        if (ok[h] && v < p.V) {
          const float pr = expf(acc[nb * 4 + 2 * h + e] + bv - lse[h]);
          x = (v == p.blank ? gb[h] : 0.f) + (v == lab[h] ? ge[h] : 0.f) -
              pr * (gb[h] + ge[h]);
        }
        d[h][e] = x;
      }
      // this warp's 16 rows of column v: lanes of equal lane % 4
      float cs = d[0][e] + d[1][e];
      cs += __shfl_xor_sync(0xffffffffu, cs, 4);
      cs += __shfl_xor_sync(0xffffffffu, cs, 8);
      cs += __shfl_xor_sync(0xffffffffu, cs, 16);
      if (lane < 4) red_w[nb * 8 + lane * 2 + e] = cs;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = row0 + 8 * h;
      if (ok[h] && v0 < p.vp)
        *reinterpret_cast<__nv_bfloat162*>(p.d + (size_t)rl * p.vp + v0) =
            __floats2bfloat162_rn(d[h][0], d[h][1]);
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumer warps only
  const int ct = threadIdx.x;
  if (p.dbpart != nullptr && ct < GN && n0 + ct < p.V) {
    float sum = 0.f;
    for (int w = 0; w < 8; ++w) sum += red[w * GN + ct];
    p.dbpart[(size_t)blockIdx.y * p.V + n0 + ct] = sum;
  }
}

// F's last step over the chunk's rows: the lse from the TC_LSE partials,
// the V tiles folded in order, and the log-probs from the picks. A label
// outside [0, V) (the padding -1) picked nothing, so its logit counts as
// 0 (lp_emit = -lse), as in the JAX kernel; u = U1 - 1 has no emit column.
__global__ void joint_lp_fold(const float* mpart, const float* spart, int vtiles,
                              int rows_c, const float* lb, const float* le,
                              const int* labels, int r0, int T, int U1, int V,
                              float* lse, float* lpb, float* lpe) {
  const int U = U1 - 1;
  for (int rl = blockIdx.x * blockDim.x + threadIdx.x; rl < rows_c;
       rl += gridDim.x * blockDim.x) {
    float top = -INFINITY;
    for (int k = 0; k < vtiles; ++k) top = fmaxf(top, mpart[(size_t)k * rows_c + rl]);
    float sum = 0.f;
    for (int k = 0; k < vtiles; ++k)
      sum += spart[(size_t)k * rows_c + rl] * expf(mpart[(size_t)k * rows_c + rl] - top);
    const float x = top + logf(sum);
    const int r = r0 + rl, f = r / U1, u = r - f * U1;  // f = n T + t
    lse[r] = x;
    lpb[r] = lb[rl] - x;
    if (u < U) {
      const int lab = labels[(f / T) * U + u];
      lpe[(size_t)f * U + u] = (lab >= 0 && lab < V ? le[rl] : 0.f) - x;
    }
  }
}

// dW (+)= sum over groups of the partials, db (+)= sum over row tiles of
// the column sums; first: the chunk is the first, nothing to add to
__global__ void joint_dw_fold(const float* part, int groups, const float* dbpart,
                              int mtiles, float* dw, float* db, int J, int V, int first) {
  const size_t n_w = (size_t)J * V;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n_w + V;
       idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < n_w) {
      float sum = first ? 0.f : dw[idx];
      for (int g = 0; g < groups; ++g) sum += part[g * n_w + idx];
      dw[idx] = sum;
    } else {
      const size_t v = idx - n_w;
      float sum = first ? 0.f : db[v];
      for (int m = 0; m < mtiles; ++m) sum += dbpart[(size_t)m * V + v];
      db[v] = sum;
    }
  }
}

Shape make_shape(int N, int T, int U1, int J, int V, int blank) {
  Shape s;
  s.N = N; s.T = T; s.U1 = U1; s.J = J; s.V = V; s.blank = blank;
  s.Jp = (J + 15) / 16 * 16;
  s.nTB = (T + BT - 1) / BT;
  s.nUB = (U1 + BU - 1) / BU;
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

// F with float32 W_out (bf16 W_out takes lp_tc below)
int fwd_f32(const float* enc, const float* pred, const float* w, const float* b,
            const int* labels, float* lpb, float* lpe, float* lse, int N, int T, int U1,
            int J, int V, int blank, cudaStream_t st) {
  const Shape s = make_shape(N, T, U1, J, V, blank);
  const Smem L(s.Jp, 0);
  cudaError_t err = prepare(joint_fwd_kernel, L.total);
  if (err != cudaSuccess) return (int)err;
  joint_fwd_kernel<<<N * s.nTB * s.nUB, THREADS, L.total, st>>>(enc, pred, w, b, labels,
                                                                lpb, lpe, lse, s);
  return (int)cudaGetLastError();
}

// G with float32 W_out (bf16 W_out takes dx_tc below)
int dx_f32(const float* enc, const float* pred, const float* w, const float* b,
           const int* labels, const float* glpb, const float* glpe, const float* lse,
           float* d_enc, float* d_pred, float* part_enc, float* part_pred, int N, int T,
           int U1, int J, int V, int blank, cudaStream_t st) {
  const Shape s = make_shape(N, T, U1, J, V, blank);
  const Smem L(s.Jp, 1);
  cudaError_t err = prepare(joint_dx_kernel, L.total);
  if (err != cudaSuccess) return (int)err;
  joint_dx_kernel<<<N * s.nTB * s.nUB, THREADS, L.total, st>>>(
      enc, pred, w, b, labels, glpb, glpe, lse, part_enc, part_pred, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  joint_dx_reduce<<<grid_1d((size_t)N * (T + U1) * J), THREADS, 0, st>>>(
      part_enc, part_pred, d_enc, d_pred, s);
  return (int)cudaGetLastError();
}

// H with float32 W_out (bf16 W_out takes dw_tc below)
int dw_f32(const float* enc, const float* pred, const float* w, const float* b,
           const int* labels, const float* glpb, const float* glpe, const float* lse,
           float* dwo, float* dbo, float* part_w, float* part_b, int groups, int N,
           int T, int U1, int J, int V, int blank, cudaStream_t st) {
  const Shape s = make_shape(N, T, U1, J, V, blank);
  const Smem L(s.Jp, 2);
  const int n_tiles = N * s.nTB * s.nUB;
  const int per = (n_tiles + groups - 1) / groups;
  dim3 grid((V + BNH - 1) / BNH, groups);
  cudaError_t err;
  err = prepare(joint_dw_kernel, L.total);
  if (err != cudaSuccess) return (int)err;
  joint_dw_kernel<<<grid, THREADS, L.total, st>>>(enc, pred, w, b, labels, glpb, glpe,
                                                  lse, part_w, part_b, per, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  joint_dw_reduce<<<grid_1d((size_t)J * V + V), THREADS, 0, st>>>(part_w, part_b, dwo,
                                                                   dbo, groups, s);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime so that the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// a row-major bf16 [outer, inner] tensor with rows of row_bytes, read in
// {64, 64} boxes with the 128-byte swizzle wgmma's descriptors describe
bool tensor_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
                uint64_t row_bytes) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major bf16 [outer, mid, inner] tensor, read in {64, box_mid,
// box_outer} boxes with the 128-byte swizzle (box_mid x box_outer rows of
// 128 bytes, laid out as a 2-D box of that many rows)
bool tensor_map3(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t mid,
                 uint64_t outer, uint32_t box_mid, uint32_t box_outer) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {inner, mid, outer};
  const cuuint64_t strides[2] = {inner * 2, inner * mid * 2};
  const cuuint32_t box[3] = {64, box_mid, box_outer};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// H with bf16 W_out (vw: W_out's row length, V rounded up to 8) over the
// lattice rows in chunks of chunk_rows (a multiple of GM): per chunk, w(h)
// into hs, the logits product into d and dbpart, the dW product into
// `groups` partials, and their fold into dW and db: four launches.
int dw_tc(const float* enc, const float* pred, const bf16* w, int vw, const float* b,
          const int* labels, const float* glpb, const float* glpe, const float* lse,
          float* dwo, float* dbo, bf16* hs, bf16* d, float* dbpart, float* part, int N,
          int T, int U1, int J, int V, int blank, int jp, int vp, int chunk_rows,
          int groups, cudaStream_t st) {
  if (jp % GK || jp < J || vp % 8 || vp < V || vw % 8 || vw < V || chunk_rows <= 0 ||
      chunk_rows % GM || groups <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(joint_dw_tc<TC_DLOGITS>, Ring<TC_DLOGITS>::SMEM);
  if (err == cudaSuccess) err = prepare(joint_dw_tc<TC_DW>, Ring<TC_DW>::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tw;
  if (!tensor_map(&tw, w, vw, J, (uint64_t)vw * 2)) return ERR_TENSOR_MAP;
  const int rows = N * T * U1;
  for (int r0 = 0; r0 < rows; r0 += chunk_rows) {
    const int rc = min(chunk_rows, rows - r0);
    const size_t frames = (size_t)((r0 + rc - 1) / U1 - r0 / U1 + 1);
    joint_dw_fill<<<grid_1d(frames * jp / 8), THREADS, 0, st>>>(enc, pred, hs, r0, rc, N,
                                                                T, U1, J, jp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    CUtensorMap th, td;
    if (!tensor_map(&th, hs, jp, rc, (uint64_t)jp * 2) ||
        !tensor_map(&td, d, vp, rc, (uint64_t)vp * 2))
      return ERR_TENSOR_MAP;
    DwChunk p{};
    p.bias = b;
    p.labels = labels;
    p.glpb = glpb;
    p.glpe = glpe;
    p.lse = lse;
    p.d = d;
    p.dbpart = dbpart;
    p.part = part;
    p.r0 = r0;
    p.rows_c = rc;
    p.T = T;
    p.U1 = U1;
    p.J = J;
    p.V = V;
    p.vp = vp;
    p.blank = blank;
    p.k_iters = jp / GK;
    p.k_total = 0;
    const int mtiles = (rc + GM - 1) / GM;
    joint_dw_tc<TC_DLOGITS><<<dim3((V + GN - 1) / GN, mtiles), GTHREADS,
                              Ring<TC_DLOGITS>::SMEM, st>>>(th, tw, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    p.k_total = (rc + GK - 1) / GK;
    p.k_iters = (p.k_total + groups - 1) / groups;
    joint_dw_tc<TC_DW><<<dim3((V + GN - 1) / GN, (J + GM - 1) / GM, groups), GTHREADS,
                         Ring<TC_DW>::SMEM, st>>>(th, td, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    joint_dw_fold<<<grid_1d((size_t)J * V + V), THREADS, 0, st>>>(
        part, groups, dbpart, mtiles, dwo, dbo, J, V, r0 == 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// F with bf16 W_out (vw as for H) over the lattice rows in chunks of
// chunk_rows (a multiple of GM; ops/kernels/joint_lp.py:lp_plan): per
// chunk, w(h) into hs, the logits product with its (max, sum) partials
// into ms ([2][ceil(V / GN)][rows_c]) and its picks into picks ([2][rows_c]),
// then the fold into lse, lp_blank and lp_emit: 3 launches a chunk.
int lp_tc(const float* enc, const float* pred, const bf16* w, int vw, const float* b,
          const int* labels, float* lpb, float* lpe, float* lse, bf16* hs, float* ms,
          float* picks, int N, int T, int U1, int J, int V, int blank, int jp,
          int chunk_rows, cudaStream_t st) {
  if (jp % GK || jp < J || vw % 8 || vw < V || chunk_rows <= 0 || chunk_rows % GM ||
      blank < 0 || blank >= V)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(joint_dw_tc<TC_LSE>, Ring<TC_LSE>::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tw;
  if (!tensor_map(&tw, w, vw, J, (uint64_t)vw * 2)) return ERR_TENSOR_MAP;
  const int rows = N * T * U1, vtiles = (V + GN - 1) / GN;
  for (int r0 = 0; r0 < rows; r0 += chunk_rows) {
    const int rc = min(chunk_rows, rows - r0);
    const size_t frames = (size_t)((r0 + rc - 1) / U1 - r0 / U1 + 1);
    joint_dw_fill<<<grid_1d(frames * jp / 8), THREADS, 0, st>>>(enc, pred, hs, r0, rc, N,
                                                                T, U1, J, jp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    CUtensorMap th;
    if (!tensor_map(&th, hs, jp, rc, (uint64_t)jp * 2)) return ERR_TENSOR_MAP;
    DwChunk p{};
    p.bias = b;
    p.labels = labels;
    p.mpart = ms;
    p.spart = ms + (size_t)vtiles * rc;
    p.lb = picks;
    p.le = picks + rc;
    p.r0 = r0;
    p.rows_c = rc;
    p.T = T;
    p.U1 = U1;
    p.J = J;
    p.V = V;
    p.blank = blank;
    p.k_iters = jp / GK;
    joint_dw_tc<TC_LSE><<<dim3(vtiles, (rc + GM - 1) / GM), GTHREADS, Ring<TC_LSE>::SMEM,
                          st>>>(th, tw, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    joint_lp_fold<<<grid_1d(rc), THREADS, 0, st>>>(p.mpart, p.spart, vtiles, rc, p.lb, p.le,
                                                   labels, r0, T, U1, V, lse, lpb, lpe);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// G with bf16 W_out (vw as for H) over the lattice in chunks of
// groups_per_chunk frame groups ((n, tb): DX_FRAMES frames of one
// utterance; ops/kernels/joint_lp.py:dx_plan), with F's lse. Per chunk:
// w(h) into hs; the logits with the dlogits epilogue into d; dh =
// w(dlogits) W_out^T with its label and frame sums into enc_part
// [N, T, nub, J] and pred_part [N, ntb, U1, J]. Then one fold into d_enc
// and d_pred: 3 launches a chunk and one more. Every sum in a fixed order.
int dx_tc(const float* enc, const float* pred, const bf16* w, int vw, const float* b,
          const int* labels, const float* glpb, const float* glpe, const float* lse,
          float* d_enc, float* d_pred, bf16* hs, bf16* d, float* enc_part,
          float* pred_part, int N, int T, int U1, int J, int V, int blank, int jp, int vp,
          int groups_per_chunk, cudaStream_t st) {
  if (jp % GK || jp < J || vp % 8 || vp < V || vw % 8 || vw < V || groups_per_chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(joint_dw_tc<TC_DLOGITS>, Ring<TC_DLOGITS>::SMEM);
  if (err == cudaSuccess) err = prepare(joint_dw_tc<TC_DH>, Ring<TC_DH>::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tw;
  if (!tensor_map(&tw, w, vw, J, (uint64_t)vw * 2)) return ERR_TENSOR_MAP;
  const int ntb = (T + DX_FRAMES - 1) / DX_FRAMES, nub = (U1 + DX_LABELS - 1) / DX_LABELS;
  const int groups = N * ntb;
  for (int g0 = 0; g0 < groups; g0 += groups_per_chunk) {
    const int g1 = min(groups, g0 + groups_per_chunk);
    const int f0 = (g0 / ntb) * T + (g0 % ntb) * DX_FRAMES;
    const int f1 = ((g1 - 1) / ntb) * T + min(T, ((g1 - 1) % ntb + 1) * DX_FRAMES);
    const int r0 = f0 * U1, rc = (f1 - f0) * U1;
    joint_dw_fill<<<grid_1d((size_t)(f1 - f0) * jp / 8), THREADS, 0, st>>>(
        enc, pred, hs, r0, rc, N, T, U1, J, jp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    CUtensorMap th, td;
    if (!tensor_map(&th, hs, jp, rc, (uint64_t)jp * 2) ||
        !tensor_map3(&td, d, vp, U1, f1 - f0, DX_LABELS, DX_FRAMES))
      return ERR_TENSOR_MAP;
    DwChunk p{};
    p.bias = b;
    p.labels = labels;
    p.glpb = glpb;
    p.glpe = glpe;
    p.lse = lse;
    p.d = d;
    p.dbpart = nullptr;
    p.enc = enc;
    p.pred = pred;
    p.enc_part = enc_part;
    p.pred_part = pred_part;
    p.r0 = r0;
    p.rows_c = rc;
    p.T = T;
    p.U1 = U1;
    p.J = J;
    p.V = V;
    p.vp = vp;
    p.blank = blank;
    p.k_iters = jp / GK;
    p.g0 = g0;
    p.f0 = f0;
    p.ntb = ntb;
    p.nub = nub;
    joint_dw_tc<TC_DLOGITS><<<dim3((V + GN - 1) / GN, (rc + GM - 1) / GM), GTHREADS,
                              Ring<TC_DLOGITS>::SMEM, st>>>(th, tw, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    p.k_iters = (vp + GK - 1) / GK;
    joint_dw_tc<TC_DH><<<dim3((J + GN - 1) / GN, (g1 - g0) * nub), GTHREADS,
                         Ring<TC_DH>::SMEM, st>>>(td, tw, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  Shape s = make_shape(N, T, U1, J, V, blank);
  s.nTB = ntb;
  s.nUB = nub;
  joint_dx_reduce<<<grid_1d((size_t)N * (T + U1) * J), THREADS, 0, st>>>(
      enc_part, pred_part, d_enc, d_pred, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch sizes, in float32 elements, that the wrapper allocates for G
// and H with float32 W_out: out[0] G's enc partial, out[1] G's pred
// partial, out[2] H's row groups, out[3] H's dW partial, out[4] H's db
// partial.
int joint_lp_scratch(int N, int T, int U1, int J, int V, long long* out) {
  const Shape s = make_shape(N, T, U1, J, V, 0);
  const int g = n_groups(s);
  out[0] = (long long)N * T * s.nUB * J;
  out[1] = (long long)N * s.nTB * U1 * J;
  out[2] = g;
  out[3] = (long long)g * J * V;
  out[4] = (long long)g * V;
  return 0;
}

// F with float32 W_out (bf16 W_out: joint_lp_fwd_tc). Outputs lpb
// [N, T, U1], lpe [N, T, U1 - 1], lse [N, T, U1] float32.
int joint_lp_fwd(const void* enc, const void* pred, const void* w, const void* b,
                 const void* labels, void* lpb, void* lpe, void* lse, int N, int T,
                 int U1, int J, int V, int blank, void* stream) {
  return fwd_f32((const float*)enc, (const float*)pred, (const float*)w, (const float*)b,
                 (const int*)labels, (float*)lpb, (float*)lpe, (float*)lse, N, T, U1, J,
                 V, blank, (cudaStream_t)stream);
}

// F with bf16 W_out on the tensor cores. w [J, vw] bf16 (vw = V rounded
// up to 8, zero past V); scratch from the wrapper's plan
// (ops/kernels/joint_lp.py:lp_plan): hs [chunk_rows, jp] bf16, ms
// [2, ceil(V / 128), chunk_rows] and picks [2, chunk_rows] float32.
// Outputs as joint_lp_fwd.
int joint_lp_fwd_tc(const void* enc, const void* pred, const void* w, int vw,
                    const void* b, const void* labels, void* lpb, void* lpe, void* lse,
                    void* hs, void* ms, void* picks, int N, int T, int U1, int J, int V,
                    int blank, int jp, int chunk_rows, void* stream) {
  return lp_tc((const float*)enc, (const float*)pred, (const bf16*)w, vw, (const float*)b,
               (const int*)labels, (float*)lpb, (float*)lpe, (float*)lse, (bf16*)hs,
               (float*)ms, (float*)picks, N, T, U1, J, V, blank, jp, chunk_rows,
               (cudaStream_t)stream);
}

// G with float32 W_out (bf16 W_out: joint_lp_dx_tc), with F's lse
// [N, T, U1]
int joint_lp_dx(const void* enc, const void* pred, const void* w, const void* b,
                const void* labels, const void* glpb, const void* glpe, const void* lse,
                void* d_enc, void* d_pred, void* part_enc, void* part_pred, int N, int T,
                int U1, int J, int V, int blank, void* stream) {
  return dx_f32((const float*)enc, (const float*)pred, (const float*)w, (const float*)b,
                (const int*)labels, (const float*)glpb, (const float*)glpe,
                (const float*)lse, (float*)d_enc, (float*)d_pred, (float*)part_enc,
                (float*)part_pred, N, T, U1, J, V, blank, (cudaStream_t)stream);
}

// G with bf16 W_out on the tensor cores, with F's lse [N, T, U1]. w
// [J, vw] bf16 (vw = V rounded up to 8, zero past V); scratch from the
// wrapper's plan (ops/kernels/joint_lp.py:dx_plan): hs [chunk_rows, jp]
// and d [chunk_rows, vp] bf16, enc_part [N, T, nub, J] and pred_part
// [N, ntb, U1, J] float32. Outputs d_enc [N, T, J], d_pred [N, U1, J].
int joint_lp_dx_tc(const void* enc, const void* pred, const void* w, int vw,
                   const void* b, const void* labels, const void* glpb,
                   const void* glpe, const void* lse, void* d_enc, void* d_pred, void* hs,
                   void* d, void* enc_part, void* pred_part, int N, int T, int U1, int J,
                   int V, int blank, int jp, int vp, int groups_per_chunk, void* stream) {
  return dx_tc((const float*)enc, (const float*)pred, (const bf16*)w, vw, (const float*)b,
               (const int*)labels, (const float*)glpb, (const float*)glpe,
               (const float*)lse, (float*)d_enc, (float*)d_pred, (bf16*)hs, (bf16*)d,
               (float*)enc_part, (float*)pred_part, N, T, U1, J, V, blank, jp, vp,
               groups_per_chunk, (cudaStream_t)stream);
}

// H with float32 W_out (bf16 W_out: joint_lp_dw_tc)
int joint_lp_dw(const void* enc, const void* pred, const void* w,
                const void* b, const void* labels, const void* glpb,
                const void* glpe, const void* lse, void* dwo, void* dbo,
                void* part_w, void* part_b, int groups, int N, int T, int U1,
                int J, int V, int blank, void* stream) {
  return dw_f32((const float*)enc, (const float*)pred, (const float*)w, (const float*)b,
                (const int*)labels, (const float*)glpb, (const float*)glpe,
                (const float*)lse, (float*)dwo, (float*)dbo, (float*)part_w,
                (float*)part_b, groups, N, T, U1, J, V, blank, (cudaStream_t)stream);
}

// H with bf16 W_out on the tensor cores. w [J, vw] bf16 (vw = V rounded
// up to 8, zero past V); scratch from the wrapper's plan
// (ops/kernels/joint_lp.py:dw_plan): hs [chunk_rows, jp] and d
// [chunk_rows, vp] bf16, dbpart [chunk_rows / 128, V] and part
// [groups, J, V] float32. Outputs dwo [J, V], dbo [V] float32.
int joint_lp_dw_tc(const void* enc, const void* pred, const void* w, int vw,
                   const void* b, const void* labels, const void* glpb,
                   const void* glpe, const void* lse, void* dwo, void* dbo, void* hs,
                   void* d, void* dbpart, void* part, int N, int T, int U1, int J, int V,
                   int blank, int jp, int vp, int chunk_rows, int groups, void* stream) {
  return dw_tc((const float*)enc, (const float*)pred, (const bf16*)w, vw, (const float*)b,
               (const int*)labels, (const float*)glpb, (const float*)glpe,
               (const float*)lse, (float*)dwo, (float*)dbo, (bf16*)hs, (bf16*)d,
               (float*)dbpart, (float*)part, N, T, U1, J, V, blank, jp, vp, chunk_rows,
               groups, (cudaStream_t)stream);
}

const char* joint_lp_error_string(int code) {
  if (code == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map (or the driver lacks it)";
  if (code == (int)cudaErrorInvalidValue)
    return "invalid value (J too large: shared memory above the per-block "
           "limit; blank outside [0, V); or the scratch plan of F, G or H "
           "(lp_plan, dx_plan, dw_plan) out of shape)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
