// Training LSTM kernels for Hopper (sm_90a): the recurrence forward (D)
// and its reverse-time backward (E).
//
// Replaces the JAX package's Pallas TPU kernels
// ops/pallas/lstm.py:_lstm_train_fwd_kernel (called by _train_fwd_call) and
// ops/pallas/lstm.py:_lstm_train_bwd_kernel (called by _train_bwd_call),
// the custom-VJP core of lstm_pack_train_pallas. R [H, 4H] comes in the
// training compute type: bf16 under a bf16 policy, float32 without one.
// Gates are in the order i, g, f, o.
//
// D, per step t, from wx = x @ W + b [N, T, 4H] (float32):
//   v_t = r(h_{t-1}) @ R + wx[:, t]       (float32 sums; r() rounds to R's
//                                           type, the identity for float32)
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g);  h_t = sigmoid(o) * tanh(c_t)
// and writes y[:, t] = h_t, c_seq[:, t] = c_t and v[:, t] = v_t: the
// backward recomputes the gates from v instead of re-running the product.
//
// E, in reverse time, from dy and dc_in (the cotangents of y and c_seq),
// v, c_seq and c_prev (c_seq shifted by one step, c0 first):
//   dh_t = dy[:, t] + r(dv_{t+1}) @ R^T     (zero at t = T - 1)
//   dc_t = dc_in[:, t] + dc_f + dh_t * o * (1 - tanh(c_t)^2)
//   dv_t = [dc*g*i*(1-i), dc*i*(1-g^2), dc*c_prev*f*(1-f), dh*tanh(c)*o*(1-o)]
//   dc_f = dc_t * f                          (carried to step t - 1)
// and after step 0, dh0 = r(dv_0) @ R^T and dc0 = dc_f. dR = h_prev^T dv
// is one large product outside the kernel, as in JAX.
//
// What bounds them on an H100: each step reads all of R (8 MB in bf16 at
// H = 1024; it stays in the 50 MB L2 across steps) and does 2 * N * H * 4H
// flops, far below the tensor-core rate at training batch sizes, so a step
// is bound by streaming R out of L2 and by the launch itself. The TPU
// kernels held R in VMEM for the whole grid; R does not fit one SM's
// 227 KB of shared memory, so this first design launches one fused step
// kernel per timestep on the caller's stream and spreads R over the grid:
//   - D is the step kernel of csrc/lstm_seq.cu with a third output, v, and
//     a float32-R variant: grid.x over tiles of BJ hidden units, grid.y
//     over tiles of BN batch rows; a block owns the 4 * BJ gate columns of
//     its units, splits the H-long reduction over KS k-slices and reads
//     h_{t-1} from y[:, t-1] (or h0);
//   - E mirrors it: a block owns BJ units j and BN rows. Its product
//     dh[b, j] = sum_k r(dv_{t+1}[b, k]) R[j, k] runs along row j of R,
//     which is contiguous, so the contraction over 4H needs no transposed
//     copy; r(dv_{t+1}) for its BN rows is staged in shared memory, the
//     4H-long reduction is split over BKS k-slices. The launch for step t
//     reads dv[:, t+1], which the previous launch wrote in full, and writes
//     dv[:, t]: no block reads what a block of its own launch writes. The
//     carried dc_f of a unit is read and written by the one thread that
//     owns it, in place in dc0. A last launch of the same kernel, product
//     only, gives dh0.
// A persistent single-launch design (R split across CTAs for the whole
// sequence, h or dv exchanged through L2 under a grid-wide barrier) and
// tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 8;                 // batch rows per block
constexpr int BJ = 16;                // hidden units per block
constexpr int CG = 4 * BJ / 8;        // D: 8-column groups per block (8)
constexpr int KS = 32;                // D: k-slices of the reduction
constexpr int THREADS = CG * KS;      // 256
constexpr int COLS = 4 * BJ;          // D: R columns per block (64)
constexpr int BKS = THREADS / BJ;     // E: k-slices of the 4H reduction (16)
constexpr int MAX_SMEM = 227 * 1024;  // per-block limit on sm_90

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// x rounded to R's type and widened back (exact for the product in float32)
template <typename RT>
__device__ __forceinline__ float round_r(float x);
template <>
__device__ __forceinline__ float round_r<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <>
__device__ __forceinline__ float round_r<float>(float x) {
  return x;
}

// 8 consecutive elements of R from p as float32; `valid` of them in range.
// VEC: all 8 valid and p 16-byte aligned.
template <typename RT, bool VEC>
__device__ __forceinline__ void load8(const RT* p, int valid, float (&v)[8]);

template <>
__device__ __forceinline__ void load8<__nv_bfloat16, true>(
    const __nv_bfloat16* p, int, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p2[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load8<float, true>(const float* p, int,
                                                   float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <>
__device__ __forceinline__ void load8<__nv_bfloat16, false>(
    const __nv_bfloat16* p, int valid, float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? __bfloat162float(p[e]) : 0.0f;
}

template <>
__device__ __forceinline__ void load8<float, false>(const float* p, int valid,
                                                    float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? p[e] : 0.0f;
}

// ---------------------------------------------------------------------------
// D: one forward step
// ---------------------------------------------------------------------------

template <typename RT, bool VEC>
__global__ void __launch_bounds__(THREADS) train_fwd_step(
    const float* __restrict__ wx, long long wx_stride,
    const RT* __restrict__ r,
    const float* __restrict__ h_prev, long long h_stride,
    const float* __restrict__ c_prev, long long c_stride,
    float* __restrict__ y, float* __restrict__ c_out, long long seq_stride,
    float* __restrict__ v_out, int n, int hdim) {
  extern __shared__ float smem[];
  float* hs = smem;                // [BN][hdim]   r(h_{t-1})
  float* red = smem + BN * hdim;   // [KS][BN][COLS] partial sums

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BJ;
  const int b0 = blockIdx.y * BN;

  for (int idx = tid; idx < BN * hdim; idx += THREADS) {
    const int b = idx / hdim;
    const int k = idx - b * hdim;
    hs[idx] = b0 + b < n
                  ? round_r<RT>(h_prev[(long long)(b0 + b) * h_stride + k])
                  : 0.0f;
  }
  __syncthreads();

  const int cg = tid % CG;
  const int ks = tid / CG;
  const int gate = cg / (BJ / 8);
  const int jb = j0 + (cg % (BJ / 8)) * 8;  // hidden unit of element 0
  const long long col = (long long)gate * hdim + jb;
  const long long ld = 4LL * hdim;
  const int valid = hdim - jb < 8 ? hdim - jb : 8;

  float acc[BN][8];
#pragma unroll
  for (int b = 0; b < BN; ++b) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0.0f;
  }

  if (valid > 0) {
    for (int k = ks; k < hdim; k += KS) {
      float rv[8];
      load8<RT, VEC>(r + (long long)k * ld + col, valid, rv);
#pragma unroll
      for (int b = 0; b < BN; ++b) {
        const float hv = hs[b * hdim + k];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[b][e] = fmaf(hv, rv[e], acc[b][e]);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < BN; ++b) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[(ks * BN + b) * COLS + cg * 8 + e] = acc[b][e];
    }
  }
  __syncthreads();

  if (tid < BN * BJ) {
    const int b = tid / BJ;
    const int jj = tid % BJ;
    const int row = b0 + b;
    const int j = j0 + jj;
    if (row < n && j < hdim) {
      float v[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = 0.0f;
        for (int q = 0; q < KS; ++q) s += red[(q * BN + b) * COLS + g * BJ + jj];
        v[g] = s + wx[(long long)row * wx_stride + (long long)g * hdim + j];
        v_out[(long long)row * wx_stride + (long long)g * hdim + j] = v[g];
      }
      const float ig = sigmoid_f(v[0]);
      const float gg = tanhf(v[1]);
      const float fg = sigmoid_f(v[2]);
      const float og = sigmoid_f(v[3]);
      const float c = fg * c_prev[(long long)row * c_stride + j] + ig * gg;
      y[(long long)row * seq_stride + j] = og * tanhf(c);
      c_out[(long long)row * seq_stride + j] = c;
    }
  }
}

size_t fwd_smem_bytes(int hdim) {
  return sizeof(float) * ((size_t)BN * hdim + (size_t)KS * BN * COLS);
}

template <typename RT, bool VEC>
cudaError_t run_fwd(const float* wx, const RT* r, const float* h0,
                    const float* c0, float* y, float* c_seq, float* v, int n,
                    int t_steps, int hdim, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(hdim);
  cudaError_t err = cudaFuncSetAttribute(
      train_fwd_step<RT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((hdim + BJ - 1) / BJ, (n + BN - 1) / BN);
  const long long seq = (long long)t_steps * hdim;    // row stride of y, c
  const long long gseq = 4 * seq;                     // row stride of wx, v
  for (int t = 0; t < t_steps; ++t) {
    const float* hp = t == 0 ? h0 : y + (long long)(t - 1) * hdim;
    const float* cp = t == 0 ? c0 : c_seq + (long long)(t - 1) * hdim;
    const long long ps = t == 0 ? hdim : seq;
    train_fwd_step<RT, VEC><<<grid, THREADS, smem, stream>>>(
        wx + (long long)t * 4 * hdim, gseq, r, hp, ps, cp, ps,
        y + (long long)t * hdim, c_seq + (long long)t * hdim, seq,
        v + (long long)t * 4 * hdim, n, hdim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// E: one reverse step (PRODUCT: dh from dv_{t+1}; EPILOGUE: dv_t and dc_f,
// else dh goes to dh_out, the dh0 launch)
// ---------------------------------------------------------------------------

template <typename RT, bool VEC, bool PRODUCT, bool EPILOGUE>
__global__ void __launch_bounds__(THREADS) train_bwd_step(
    const float* __restrict__ dv_next, const RT* __restrict__ r,
    const float* __restrict__ dy, const float* __restrict__ dc_in,
    const float* __restrict__ c, const float* __restrict__ cprev,
    long long seq_stride, const float* __restrict__ v, long long g_stride,
    float* __restrict__ dv_out, float* __restrict__ dc_carry,
    float* __restrict__ dh_out, int n, int hdim) {
  extern __shared__ float smem[];
  const int g4 = 4 * hdim;
  float* dvs = smem;               // [BN][4H]  r(dv_{t+1})
  float* red = smem + BN * g4;     // [BKS][BN][BJ] partial sums

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BJ;
  const int b0 = blockIdx.y * BN;

  if (PRODUCT) {
    // 4H is a multiple of 4 and every row starts 16-byte aligned
    const int q4 = g4 / 4;
    for (int idx = tid; idx < BN * q4; idx += THREADS) {
      const int b = idx / q4;
      const int k = (idx - b * q4) * 4;
      float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (b0 + b < n) {
        d = *reinterpret_cast<const float4*>(
            dv_next + (long long)(b0 + b) * g_stride + k);
      }
      float* s = dvs + b * g4 + k;
      s[0] = round_r<RT>(d.x);
      s[1] = round_r<RT>(d.y);
      s[2] = round_r<RT>(d.z);
      s[3] = round_r<RT>(d.w);
    }
    __syncthreads();

    const int jj = tid / BKS;
    const int ks = tid % BKS;
    const int j = j0 + jj;
    float acc[BN];
#pragma unroll
    for (int b = 0; b < BN; ++b) acc[b] = 0.0f;
    if (j < hdim) {
      const RT* rrow = r + (long long)j * g4;
      for (int k = ks * 8; k < g4; k += BKS * 8) {
        float rv[8];
        const int valid = VEC ? 8 : (g4 - k < 8 ? g4 - k : 8);
        load8<RT, VEC>(rrow + k, valid, rv);
#pragma unroll
        for (int b = 0; b < BN; ++b) {
          const float* d = dvs + b * g4 + k;
          float dd[8];
          if (VEC) {  // k % 8 == 0 and 4H % 32 == 0: 16-byte aligned
            const float4 lo = *reinterpret_cast<const float4*>(d);
            const float4 hi = *reinterpret_cast<const float4*>(d + 4);
            dd[0] = lo.x; dd[1] = lo.y; dd[2] = lo.z; dd[3] = lo.w;
            dd[4] = hi.x; dd[5] = hi.y; dd[6] = hi.z; dd[7] = hi.w;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) dd[e] = e < valid ? d[e] : 0.0f;
          }
          float s = acc[b];
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(dd[e], rv[e], s);
          acc[b] = s;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BN; ++b) red[(ks * BN + b) * BJ + jj] = acc[b];
    __syncthreads();
  }

  if (tid < BN * BJ) {
    const int b = tid / BJ;
    const int jj = tid % BJ;
    const int row = b0 + b;
    const int j = j0 + jj;
    if (row < n && j < hdim) {
      float dh_carry = 0.0f;
      if (PRODUCT) {
        for (int q = 0; q < BKS; ++q) dh_carry += red[(q * BN + b) * BJ + jj];
      }
      if (EPILOGUE) {
        const long long hi = (long long)row * seq_stride + j;
        const long long gi = (long long)row * g_stride + j;
        const float ig = sigmoid_f(v[gi]);
        const float gg = tanhf(v[gi + hdim]);
        const float fg = sigmoid_f(v[gi + 2LL * hdim]);
        const float og = sigmoid_f(v[gi + 3LL * hdim]);
        const float tc = tanhf(c[hi]);
        const long long ci = (long long)row * hdim + j;
        const float dh = dy[hi] + dh_carry;
        const float dc = dc_in[hi] + dc_carry[ci] + dh * og * (1.0f - tc * tc);
        dv_out[gi] = dc * gg * ig * (1.0f - ig);
        dv_out[gi + hdim] = dc * ig * (1.0f - gg * gg);
        dv_out[gi + 2LL * hdim] = dc * cprev[hi] * fg * (1.0f - fg);
        dv_out[gi + 3LL * hdim] = dh * tc * og * (1.0f - og);
        dc_carry[ci] = dc * fg;
      } else {
        dh_out[(long long)row * hdim + j] = dh_carry;
      }
    }
  }
}

size_t bwd_smem_bytes(int hdim) {
  return sizeof(float) * ((size_t)BN * 4 * hdim + (size_t)BKS * BN * BJ);
}

template <typename RT, bool VEC, bool PRODUCT, bool EPILOGUE>
cudaError_t set_bwd_smem(size_t smem) {
  return cudaFuncSetAttribute(
      train_bwd_step<RT, VEC, PRODUCT, EPILOGUE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename RT, bool VEC>
cudaError_t run_bwd(const float* dy, const float* dc_in, const float* v,
                    const float* c_seq, const float* cprev, const RT* r,
                    float* dv, float* dh0, float* dc0, int n, int t_steps,
                    int hdim, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(hdim);
  cudaError_t err = set_bwd_smem<RT, VEC, true, true>(smem);
  if (err == cudaSuccess) err = set_bwd_smem<RT, VEC, true, false>(smem);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(dc0, 0, sizeof(float) * (size_t)n * hdim, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((hdim + BJ - 1) / BJ, (n + BN - 1) / BN);
  const long long seq = (long long)t_steps * hdim;  // row stride of dy, c
  const long long gseq = 4 * seq;                   // row stride of v, dv
  for (int t = t_steps - 1; t >= 0; --t) {
    const long long o = (long long)t * hdim;
    const long long go = 4 * o;
    if (t == t_steps - 1) {
      train_bwd_step<RT, VEC, false, true><<<grid, THREADS, 0, stream>>>(
          nullptr, r, dy + o, dc_in + o, c_seq + o, cprev + o, seq, v + go,
          gseq, dv + go, dc0, nullptr, n, hdim);
    } else {
      train_bwd_step<RT, VEC, true, true><<<grid, THREADS, smem, stream>>>(
          dv + go + 4LL * hdim, r, dy + o, dc_in + o, c_seq + o, cprev + o,
          seq, v + go, gseq, dv + go, dc0, nullptr, n, hdim);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // dh0 = r(dv_0) @ R^T
  train_bwd_step<RT, VEC, true, false><<<grid, THREADS, smem, stream>>>(
      dv, r, nullptr, nullptr, nullptr, nullptr, seq, nullptr, gseq, nullptr,
      nullptr, dh0, n, hdim);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest hidden size the shared-memory layouts of both kernels take.
int lstm_train_max_hidden() {
  const int fwd = (int)((MAX_SMEM - sizeof(float) * KS * BN * COLS) /
                        (sizeof(float) * BN));
  const int bwd = (int)((MAX_SMEM - sizeof(float) * BKS * BN * BJ) /
                        (sizeof(float) * BN * 4));
  return fwd < bwd ? fwd : bwd;
}

// D: t_steps step kernels on `stream`. Device pointers:
//   wx [n, t_steps, 4h] f32; r [h, 4h] bf16 (r_bf16 != 0) or f32;
//   h0, c0 [n, h] f32; outputs y, c_seq [n, t_steps, h] f32 and
//   v [n, t_steps, 4h] f32.
// Returns 0, or the cudaError_t of the first call that failed.
int lstm_train_forward(const void* wx, const void* r, int r_bf16,
                       const void* h0, const void* c0, void* y, void* c_seq,
                       void* v, int n, int t_steps, int hdim, void* stream) {
  if (n <= 0 || t_steps <= 0 || hdim <= 0 || hdim > lstm_train_max_hidden()) {
    return (int)cudaErrorInvalidValue;
  }
  const float* wx_f = static_cast<const float*>(wx);
  const float* h0_f = static_cast<const float*>(h0);
  const float* c0_f = static_cast<const float*>(c0);
  float* y_f = static_cast<float*>(y);
  float* c_f = static_cast<float*>(c_seq);
  float* v_f = static_cast<float*>(v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte vector loads of R need each 8-column group inside one row
  const bool vec = hdim % 8 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  cudaError_t err;
  if (r_bf16) {
    const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(r);
    err = vec ? run_fwd<__nv_bfloat16, true>(wx_f, rb, h0_f, c0_f, y_f, c_f,
                                              v_f, n, t_steps, hdim, s)
              : run_fwd<__nv_bfloat16, false>(wx_f, rb, h0_f, c0_f, y_f, c_f,
                                               v_f, n, t_steps, hdim, s);
  } else {
    const float* rf = static_cast<const float*>(r);
    err = vec ? run_fwd<float, true>(wx_f, rf, h0_f, c0_f, y_f, c_f, v_f, n,
                                     t_steps, hdim, s)
              : run_fwd<float, false>(wx_f, rf, h0_f, c0_f, y_f, c_f, v_f, n,
                                      t_steps, hdim, s);
  }
  return (int)err;
}

// E: t_steps reverse step kernels and the dh0 product on `stream`.
// Device pointers: dy, dc_in, c_seq, cprev [n, t_steps, h] f32;
//   v [n, t_steps, 4h] f32; r as for the forward; outputs
//   dv [n, t_steps, 4h] f32, dh0 and dc0 [n, h] f32.
// Returns 0, or the cudaError_t of the first call that failed.
int lstm_train_backward(const void* dy, const void* dc_in, const void* v,
                        const void* c_seq, const void* cprev, const void* r,
                        int r_bf16, void* dv, void* dh0, void* dc0, int n,
                        int t_steps, int hdim, void* stream) {
  if (n <= 0 || t_steps <= 0 || hdim <= 0 || hdim > lstm_train_max_hidden()) {
    return (int)cudaErrorInvalidValue;
  }
  const float* dy_f = static_cast<const float*>(dy);
  const float* dci_f = static_cast<const float*>(dc_in);
  const float* v_f = static_cast<const float*>(v);
  const float* c_f = static_cast<const float*>(c_seq);
  const float* cp_f = static_cast<const float*>(cprev);
  float* dv_f = static_cast<float*>(dv);
  float* dh0_f = static_cast<float*>(dh0);
  float* dc0_f = static_cast<float*>(dc0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = hdim % 8 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  cudaError_t err;
  if (r_bf16) {
    const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(r);
    err = vec ? run_bwd<__nv_bfloat16, true>(dy_f, dci_f, v_f, c_f, cp_f, rb,
                                              dv_f, dh0_f, dc0_f, n, t_steps,
                                              hdim, s)
              : run_bwd<__nv_bfloat16, false>(dy_f, dci_f, v_f, c_f, cp_f, rb,
                                               dv_f, dh0_f, dc0_f, n, t_steps,
                                               hdim, s);
  } else {
    const float* rf = static_cast<const float*>(r);
    err = vec ? run_bwd<float, true>(dy_f, dci_f, v_f, c_f, cp_f, rf, dv_f,
                                     dh0_f, dc0_f, n, t_steps, hdim, s)
              : run_bwd<float, false>(dy_f, dci_f, v_f, c_f, cp_f, rf, dv_f,
                                      dh0_f, dc0_f, n, t_steps, hdim, s);
  }
  return (int)err;
}

const char* lstm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
