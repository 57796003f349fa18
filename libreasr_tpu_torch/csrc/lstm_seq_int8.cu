// Eval-mode int8 LSTM sequence kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas/lstm.py:_lstm_step_kernel_int8 (_lstm_seq_pallas_int8), which
// serves int8-quantized bundles: R is int8 with one float32 scale per
// column, and h is quantized per row at every step (dynamic int8, the
// numerics of ops/quant.py:int8_matmul).
//
// What it computes, per step t, from the precomputed input projections
// wx [N, T, 4H] (float32), the quantized recurrent matrix rq int8 [H, 4H]
// and its scales rscale float32 [4H], gates in the order i, g, f, o:
//   amax   = max_k |h_{t-1}[k]|                      (per row)
//   hscale = max(amax / 127, 1e-12)
//   hq     = clip(round_half_even(h_{t-1} / hscale), -127, 127)
//   acc    = hq @ rq                                 (int32, exact)
//   v      = (float(acc) * hscale) * rscale + wx[:, t]
//   c_t    = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t    = sigmoid(o) * tanh(c_t)
// y[:, t] = h_t and yc[:, t] = c_t, both [N, T, H] float32.
//
// Exactness against the plain twin (ops/kernels/lstm.py:
// lstm_seq_int8_reference): the scale uses IEEE division (never
// -use_fast_math), rounding is rintf (half to even, as torch.round), the
// int32 sum is exact in any order, and the epilogue is written with
// __fmul_rn/__fadd_rn so that nvcc does not contract it into FMAs. The
// pre-activation v therefore equals the twin's bit for bit on the same
// h_{t-1}; what remains are expf/tanhf against PyTorch's own versions and
// the rounding flips at .5 boundaries of h/hscale that a last-bit
// difference in h can seed at the next step.
//
// What bounds it on an H100: each step reads all of rq (4 MB at H = 1024,
// resident in the 50 MB L2 across steps) and does 2 * N * H * 4H int8
// operations, a few hundred MOP at serving batch sizes against 1,979
// TOP/s: the kernel is bound by the per-step launch and by latency, not by
// bytes or operations. Design, kept simple (tensor-core int8 mma/wgmma
// and a persistent single launch are later work):
//   - one launch per step on the caller's stream, as in lstm_seq.cu:
//     grid.x over tiles of BJ hidden units, grid.y over tiles of BN rows;
//     a block owns the 4 * BJ gate columns {g * H + j} of its units, so
//     the gate math fuses into the product's epilogue;
//   - the per-row scale needs the whole row of h, and every block stages
//     its BN rows of h_{t-1} in shared memory anyway: each block reduces
//     amax (one warp per row) and quantizes into k-packed int8 words in
//     shared memory. Redundant across blocks, but exact, and no state is
//     shared between blocks;
//   - rq is re-laid once per cell, when the weights are bound (never per
//     call), into k-packed 32-bit words rw [ceil(H/4), 4H]: word (kk, col)
//     holds rq[4kk + i, col] in byte i, k padded with zeros. A thread loads
//     4 consecutive columns' words as one 16-byte vector and runs __dp4a
//     against the packed h words: 4 multiply-adds per instruction;
//   - the H/4-long reduction is split over KS interleaved k-slices whose
//     int32 partial sums meet in shared memory;
//   - step t reads h_{t-1} from y[:, t-1] (or h0) and c_{t-1} from
//     yc[:, t-1] (or c0), so no block reads what another block of the
//     same step writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 8;                 // batch rows per block
constexpr int BJ = 16;                // hidden units per block
constexpr int COLS = 4 * BJ;          // R columns per block (64)
constexpr int CW = 4;                 // columns per thread (one 16-byte load)
constexpr int CG = COLS / CW;         // column groups per block (16)
constexpr int KS = 16;                // k-word slices of the reduction
constexpr int THREADS = CG * KS;      // 256
constexpr int WARPS = THREADS / 32;   // 8: one warp per row for amax
constexpr int MAX_SMEM = 227 * 1024;  // per-block limit on sm_90
static_assert(WARPS == BN, "the amax pass gives each row one warp");

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) lstm_step_int8_kernel(
    const float* __restrict__ wx, long long wx_stride,
    const int* __restrict__ rw, const float* __restrict__ rscale,
    const float* __restrict__ h_prev, long long h_stride,
    const float* __restrict__ c_prev, long long c_stride,
    float* __restrict__ y, float* __restrict__ c_out, long long out_stride,
    int n, int hdim) {
  extern __shared__ float smem[];
  const int kw = (hdim + 3) / 4;
  float* hs = smem;                                   // [BN][hdim]
  float* hscale = hs + BN * hdim;                     // [BN]
  int* hq = reinterpret_cast<int*>(hscale + BN);      // [BN][kw]
  int* red = hq + BN * kw;                            // [KS][BN][COLS]

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BJ;
  const int b0 = blockIdx.y * BN;

  // 1. stage h_{t-1} and reduce each row's amax (warp w takes row w)
  {
    const int b = tid / 32;
    const int lane = tid % 32;
    const int row = b0 + b;
    float m = 0.0f;
    for (int k = lane; k < hdim; k += 32) {
      const float v = row < n ? h_prev[(long long)row * h_stride + k] : 0.0f;
      hs[b * hdim + k] = v;
      m = fmaxf(m, fabsf(v));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) hscale[b] = fmaxf(__fdiv_rn(m, 127.0f), 1e-12f);
  }
  __syncthreads();

  // 2. quantize into k-packed words: byte i of word kk is hq[4kk + i]
  for (int idx = tid; idx < BN * kw; idx += THREADS) {
    const int b = idx / kw;
    const int kk = idx - b * kw;
    const float s = hscale[b];
    unsigned int word = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * kk + i;
      if (k < hdim) {
        float q = rintf(__fdiv_rn(hs[b * hdim + k], s));
        q = fminf(fmaxf(q, -127.0f), 127.0f);
        word |= (static_cast<unsigned int>(static_cast<int>(q)) & 0xffu)
                << (8 * i);
      }
    }
    hq[idx] = static_cast<int>(word);
  }
  __syncthreads();

  // 3. int8 x int8 -> int32 over this thread's k-slice and 4 columns
  const int cg = tid % CG;
  const int ks = tid / CG;
  const int gate = cg / (BJ / CW);
  const int jb = j0 + (cg % (BJ / CW)) * CW;  // hidden unit of column 0
  const long long col = (long long)gate * hdim + jb;
  const long long ld = 4LL * hdim;

  int acc[BN][CW];
#pragma unroll
  for (int b = 0; b < BN; ++b) {
#pragma unroll
    for (int e = 0; e < CW; ++e) acc[b][e] = 0;
  }

  for (int kk = ks; kk < kw; kk += KS) {
    int rv[CW];
    const int* rp = rw + (long long)kk * ld + col;
    if (VEC) {
      // hdim % 4 == 0: a group of 4 columns is wholly inside or outside
      if (jb < hdim) {
        const int4 u = __ldg(reinterpret_cast<const int4*>(rp));
        rv[0] = u.x;
        rv[1] = u.y;
        rv[2] = u.z;
        rv[3] = u.w;
      } else {
#pragma unroll
        for (int e = 0; e < CW; ++e) rv[e] = 0;
      }
    } else {
#pragma unroll
      for (int e = 0; e < CW; ++e) rv[e] = (jb + e < hdim) ? __ldg(rp + e) : 0;
    }
#pragma unroll
    for (int b = 0; b < BN; ++b) {
      const int hv = hq[b * kw + kk];
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[b][e] = __dp4a(hv, rv[e], acc[b][e]);
    }
  }

#pragma unroll
  for (int b = 0; b < BN; ++b) {
#pragma unroll
    for (int e = 0; e < CW; ++e) {
      red[(ks * BN + b) * COLS + cg * CW + e] = acc[b][e];
    }
  }
  __syncthreads();

  // 4. epilogue: rescale, add wx, gates, state update
  if (tid < BN * BJ) {
    const int b = tid / BJ;
    const int jj = tid % BJ;
    const int row = b0 + b;
    const int j = j0 + jj;
    if (row < n && j < hdim) {
      const float s = hscale[b];
      float v[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        int sum = 0;
        for (int q = 0; q < KS; ++q) sum += red[(q * BN + b) * COLS + g * BJ + jj];
        const long long gc = (long long)g * hdim + j;
        v[g] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(sum), s), rscale[gc]),
                         wx[(long long)row * wx_stride + gc]);
      }
      const float ig = sigmoid_f(v[0]);
      const float gg = tanhf(v[1]);
      const float fg = sigmoid_f(v[2]);
      const float og = sigmoid_f(v[3]);
      const float c = __fadd_rn(
          __fmul_rn(fg, c_prev[(long long)row * c_stride + j]),
          __fmul_rn(ig, gg));
      y[(long long)row * out_stride + j] = __fmul_rn(og, tanhf(c));
      c_out[(long long)row * out_stride + j] = c;
    }
  }
}

size_t smem_bytes(int hdim) {
  const size_t kw = (size_t)(hdim + 3) / 4;
  return sizeof(float) * ((size_t)BN * hdim + BN) + sizeof(int) * BN * kw +
         sizeof(int) * (size_t)KS * BN * COLS;
}

template <bool VEC>
cudaError_t run(const float* wx, const int* rw, const float* rscale,
                const float* h0, const float* c0, float* y, float* yc, int n,
                int t_steps, int hdim, cudaStream_t stream) {
  const size_t smem = smem_bytes(hdim);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_step_int8_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((hdim + BJ - 1) / BJ, (n + BN - 1) / BN);
  const long long seq = (long long)t_steps * hdim;  // row stride of y, yc
  for (int t = 0; t < t_steps; ++t) {
    const float* hp = t == 0 ? h0 : y + (long long)(t - 1) * hdim;
    const float* cp = t == 0 ? c0 : yc + (long long)(t - 1) * hdim;
    const long long ps = t == 0 ? hdim : seq;
    lstm_step_int8_kernel<VEC><<<grid, THREADS, smem, stream>>>(
        wx + (long long)t * 4 * hdim, (long long)t_steps * 4 * hdim, rw,
        rscale, hp, ps, cp, ps, y + (long long)t * hdim,
        yc + (long long)t * hdim, seq, n, hdim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Largest hidden size the shared-memory layout takes.
int lstm_seq_int8_max_hidden() {
  // per row: hdim floats of h and ceil(hdim/4) packed words <= 5 bytes/k
  const size_t fixed = sizeof(int) * (size_t)KS * BN * COLS +
                       sizeof(float) * BN + sizeof(int) * BN;
  return (int)((MAX_SMEM - fixed) / (5 * BN));
}

// Runs t_steps step kernels on `stream`. All pointers are device memory:
//   wx [n, t_steps, 4h] f32; rw [ceil(h/4), 4h] int32, the k-packed int8
//   recurrent matrix; rscale [4h] f32; h0, c0 [n, h] f32;
//   y, yc [n, t_steps, h] f32 receive every h_t and c_t.
// Returns 0, or the cudaError_t of the first launch that failed.
int lstm_seq_int8_forward(const void* wx, const void* rw, const void* rscale,
                          const void* h0, const void* c0, void* y, void* yc,
                          int n, int t_steps, int hdim, void* stream) {
  if (n <= 0 || t_steps <= 0 || hdim <= 0 ||
      hdim > lstm_seq_int8_max_hidden()) {
    return (int)cudaErrorInvalidValue;
  }
  const float* wx_f = static_cast<const float*>(wx);
  const int* rw_i = static_cast<const int*>(rw);
  const float* rs_f = static_cast<const float*>(rscale);
  const float* h0_f = static_cast<const float*>(h0);
  const float* c0_f = static_cast<const float*>(c0);
  float* y_f = static_cast<float*>(y);
  float* yc_f = static_cast<float*>(yc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte vector loads of rw need each row segment 4-word aligned
  const bool vec = hdim % 4 == 0 && reinterpret_cast<uintptr_t>(rw) % 16 == 0;
  const cudaError_t err =
      vec ? run<true>(wx_f, rw_i, rs_f, h0_f, c0_f, y_f, yc_f, n, t_steps,
                      hdim, s)
          : run<false>(wx_f, rw_i, rs_f, h0_f, c0_f, y_f, yc_f, n, t_steps,
                       hdim, s);
  return (int)err;
}

const char* lstm_seq_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
