// Eval-mode LSTM sequence kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
// ops/pallas/lstm.py:_lstm_step_kernel (lstm_seq_pallas, no lengths) and
// ops/pallas/lstm.py:_lstm_step_kernel_cseq (_lstm_seq_pallas_cseq,
// which also streams the cell state per step for pack semantics). One
// kernel serves both: `c_out` points either into the streamed [N, T, H]
// cell sequence or into a ping-pong buffer.
//
// What it computes, per step t, from the precomputed input projections
// wx = x @ W + b [N, T, 4H] (float32) and the recurrent matrix R [H, 4H]
// (bf16), gates in the order i, g, f, o:
//   v  = bf16(h_{t-1}) @ R + wx[:, t]          (float32 accumulation)
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
// y[:, t] = h_t, and c_t goes to c_out. bf16 x bf16 products are exact in
// float32, so the result differs from the plain PyTorch twin
// (ops/kernels/lstm.py:lstm_seq_reference) only in summation order.
//
// What bounds it on an H100: each step reads all of R (8 MB in bf16 at
// H = 1024; it stays resident in the 50 MB L2 across steps) and does
// 2 * N * H * 4H flops, a few hundred MFLOP at serving batch sizes: far
// below the tensor-core rate, so a step is bound by streaming R out of L2
// and by the launch itself. The TPU kernel kept R in VMEM for the whole
// grid; on Hopper R does not fit one SM's 227 KB of shared memory, so this
// first design launches one fused step kernel per timestep on the
// caller's stream and spreads R over the grid instead:
//   - grid.x runs over tiles of BJ hidden units, grid.y over tiles of BN
//     batch rows; a block owns the 4 * BJ gate columns {g * H + j} of its
//     units, so the gate math fuses into the product's epilogue;
//   - inside a block the H-long reduction is split over KS k-slices
//     (interleaved, k = ks + KS * it, so one warp's shared-memory reads
//     of h fall in distinct banks); each thread loads 8 consecutive bf16
//     columns of a row of R as one 16-byte vector and keeps BN x 8 float32
//     sums in registers; the KS partial sums meet in shared memory;
//   - h_{t-1} is staged in shared memory, rounded to bf16, once per block;
//   - the step reads h_{t-1} from y[:, t-1] (or h0) and writes y[:, t],
//     so no block ever reads what another block of the same step writes.
// A persistent single-launch design (R split across CTAs for the whole
// sequence, h exchanged through L2 under a grid-wide barrier) would save
// the per-step launch and R traffic; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 8;                 // batch rows per block
constexpr int BJ = 16;                // hidden units per block
constexpr int CG = 4 * BJ / 8;        // 8-column groups per block (8)
constexpr int KS = 32;                // k-slices of the reduction
constexpr int THREADS = CG * KS;      // 256
constexpr int COLS = 4 * BJ;          // R columns per block (64)
constexpr int MAX_SMEM = 227 * 1024;  // per-block limit on sm_90

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) lstm_step_kernel(
    const float* __restrict__ wx, long long wx_stride,
    const __nv_bfloat16* __restrict__ r,
    const float* __restrict__ h_prev, long long h_stride,
    const float* __restrict__ c_prev, long long c_stride,
    float* __restrict__ y, long long y_stride,
    float* __restrict__ c_out, long long co_stride,
    int n, int hdim) {
  extern __shared__ float smem[];
  float* hs = smem;                // [BN][hdim]   bf16-rounded h_{t-1}
  float* red = smem + BN * hdim;   // [KS][BN][COLS] partial sums

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BJ;
  const int b0 = blockIdx.y * BN;

  for (int idx = tid; idx < BN * hdim; idx += THREADS) {
    const int b = idx / hdim;
    const int k = idx - b * hdim;
    float v = 0.0f;
    if (b0 + b < n) {
      v = __bfloat162float(
          __float2bfloat16(h_prev[(long long)(b0 + b) * h_stride + k]));
    }
    hs[idx] = v;
  }
  __syncthreads();

  const int cg = tid % CG;
  const int ks = tid / CG;
  const int gate = cg / (BJ / 8);
  const int jb = j0 + (cg % (BJ / 8)) * 8;  // hidden unit of element 0
  const long long col = (long long)gate * hdim + jb;
  const long long ld = 4LL * hdim;

  float acc[BN][8];
#pragma unroll
  for (int b = 0; b < BN; ++b) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0.0f;
  }

  for (int k = ks; k < hdim; k += KS) {
    float rv[8];
    const __nv_bfloat16* rp = r + (long long)k * ld + col;
    if (VEC) {
      // hdim % 8 == 0: a group of 8 is wholly inside or outside the row
      if (jb < hdim) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(rp));
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p2[e]);
          rv[2 * e] = f.x;
          rv[2 * e + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) rv[e] = 0.0f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        rv[e] = (jb + e < hdim) ? __bfloat162float(rp[e]) : 0.0f;
      }
    }
#pragma unroll
    for (int b = 0; b < BN; ++b) {
      const float hv = hs[b * hdim + k];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[b][e] = fmaf(hv, rv[e], acc[b][e]);
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
      }
      const float ig = sigmoid_f(v[0]);
      const float gg = tanhf(v[1]);
      const float fg = sigmoid_f(v[2]);
      const float og = sigmoid_f(v[3]);
      const float c = fg * c_prev[(long long)row * c_stride + j] + ig * gg;
      y[(long long)row * y_stride + j] = og * tanhf(c);
      c_out[(long long)row * co_stride + j] = c;
    }
  }
}

size_t smem_bytes(int hdim) {
  return sizeof(float) * ((size_t)BN * hdim + (size_t)KS * BN * COLS);
}

template <bool VEC>
cudaError_t run(const float* wx, const __nv_bfloat16* r, const float* h0,
                const float* c0, float* y, float* yc, float* cbuf, float* c_t,
                int n, int t_steps, int hdim, cudaStream_t stream) {
  const size_t smem = smem_bytes(hdim);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_step_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((hdim + BJ - 1) / BJ, (n + BN - 1) / BN);
  const long long hn = (long long)n * hdim;
  const long long seq = (long long)t_steps * hdim;  // row stride of y, yc
  for (int t = 0; t < t_steps; ++t) {
    const float* hp = t == 0 ? h0 : y + (long long)(t - 1) * hdim;
    const long long hps = t == 0 ? hdim : seq;
    const float* cp;
    long long cps;
    float* co;
    long long co_stride;
    if (yc != nullptr) {
      cp = t == 0 ? c0 : yc + (long long)(t - 1) * hdim;
      cps = t == 0 ? hdim : seq;
      co = yc + (long long)t * hdim;
      co_stride = seq;
    } else {
      cp = t == 0 ? c0 : cbuf + (long long)((t - 1) % 2) * hn;
      cps = hdim;
      co = t == t_steps - 1 ? c_t : cbuf + (long long)(t % 2) * hn;
      co_stride = hdim;
    }
    lstm_step_kernel<VEC><<<grid, THREADS, smem, stream>>>(
        wx + (long long)t * 4 * hdim, (long long)t_steps * 4 * hdim, r, hp,
        hps, cp, cps, y + (long long)t * hdim, seq, co, co_stride, n, hdim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Largest hidden size the shared-memory layout takes.
int lstm_seq_max_hidden() {
  return (int)((MAX_SMEM - sizeof(float) * KS * BN * COLS) /
               (sizeof(float) * BN));
}

// Runs t_steps step kernels on `stream`. All pointers are device memory:
//   wx [n, t_steps, 4h] f32, r [h, 4h] bf16, h0/c0 [n, h] f32,
//   y [n, t_steps, h] f32;
//   yc [n, t_steps, h] f32 streams every c_t (then cbuf and c_t are
//   unused), or is null: then cbuf [2, n, h] f32 holds the running cell
//   state and c_t [n, h] f32 receives the last one.
// Returns 0, or the cudaError_t of the first launch that failed.
int lstm_seq_forward(const void* wx, const void* r, const void* h0,
                     const void* c0, void* y, void* yc, void* cbuf, void* c_t,
                     int n, int t_steps, int hdim, void* stream) {
  if (n <= 0 || t_steps <= 0 || hdim <= 0 || hdim > lstm_seq_max_hidden()) {
    return (int)cudaErrorInvalidValue;
  }
  const float* wx_f = static_cast<const float*>(wx);
  const __nv_bfloat16* r_b = static_cast<const __nv_bfloat16*>(r);
  const float* h0_f = static_cast<const float*>(h0);
  const float* c0_f = static_cast<const float*>(c0);
  float* y_f = static_cast<float*>(y);
  float* yc_f = static_cast<float*>(yc);
  float* cbuf_f = static_cast<float*>(cbuf);
  float* ct_f = static_cast<float*>(c_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte vector loads of R need each row segment 8-element aligned
  const bool vec = hdim % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(r) % 16 == 0;
  const cudaError_t err =
      vec ? run<true>(wx_f, r_b, h0_f, c0_f, y_f, yc_f, cbuf_f, ct_f, n,
                      t_steps, hdim, s)
          : run<false>(wx_f, r_b, h0_f, c0_f, y_f, yc_f, cbuf_f, ct_f, n,
                       t_steps, hdim, s);
  return (int)err;
}

const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
