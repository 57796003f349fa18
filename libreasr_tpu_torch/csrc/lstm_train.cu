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
// What bounds them on an H100: each step needs all of R (8 MB in bf16 at
// H = 1024) for 2 * N * H * 4H flops, far below the tensor-core rate at
// training batch sizes, and step t + 1 must finish before step t starts,
// so a step is bound by latency: moving R or the exchanged state, and
// synchronising the card. The TPU kernels held R in VMEM for the whole
// grid.
//   - D launches one fused step kernel per timestep on the caller's
//     stream and spreads R over the grid (the step kernel of
//     csrc/lstm_seq.cu with a third output, v, and a float32-R variant:
//     grid.x over tiles of BJ hidden units, grid.y over tiles of BN batch
//     rows, KS k-slices of the H-long reduction; R streams out of L2).
//   - E is one persistent cooperative launch for the whole sequence. The
//     grid is no larger than the blocks that can be resident at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs; the launch is
//     refused otherwise, never split). Block b owns the hidden units
//     [b * bj, (b + 1) * bj) and keeps rows j of R, the contiguous runs
//     dh[:, j] contracts with, in shared memory for all T steps (8 rows x
//     4H x 2 B = 64 KB at H 1024 in bf16), so R is read from memory once
//     per call instead of once per step. A step: the product
//     dh[:, j] += sum_k r(dv_{t+1})[:, k] R[j, k] reads r(dv_{t+1}) from an
//     exchange buffer in global memory (L2-resident, bf16, [2][Np][Kp],
//     double-buffered by step parity) and runs on mma.sync.m16n8k16 in
//     bf16 with float32 sums (M: 16 batch rows, padded; N: 8 units; the B
//     fragment is a row of R, contiguous; the k order inside each 32-wide
//     slab is permuted alike for A and B so that every thread loads 16
//     contiguous bytes); 16 warps split K and meet in shared memory in a
//     fixed order; the epilogue owner of (row, unit) keeps the dc carry in
//     registers, writes dv_t in float32 and its rounded copy to the
//     exchange buffer; then a grid barrier. After step 0 the same launch
//     forms dh0 and dc0: one launch per call, where the per-step design
//     took T + 1. With float32 R nothing is rounded: the exchange is dv
//     itself and the product a float32 FMA loop.
//   Traps: the exchange buffer (and dv on the float32 route) is written
//   and read by different blocks within the launch, so it is read with
//   ld.global.cg (L2, coherent) after the barrier, never through __ldg,
//   const __restrict__ or ld.global.nc, which could return the previous
//   step's values; writes are released by __threadfence() before the
//   barrier's atomic and the barrier's read is ld.acquire.gpu. The
//   barrier is a counter of its own (zeroed per launch by a memset on the
//   stream), so the source builds without -rdc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 8;                 // D: batch rows per block
constexpr int BJ = 16;                // D: hidden units per block
constexpr int CG = 4 * BJ / 8;        // D: 8-column groups per block (8)
constexpr int KS = 32;                // D: k-slices of the reduction
constexpr int THREADS = CG * KS;      // 256
constexpr int COLS = 4 * BJ;          // D: R columns per block (64)
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
// E: the reverse-time recurrence in one cooperative launch
// ---------------------------------------------------------------------------

constexpr int E_THREADS = 512;
constexpr int E_WARPS = E_THREADS / 32;
constexpr int E_MAXC = 4;    // (row, unit) pairs an epilogue thread owns
constexpr int E_BATCH = 8;   // k-slabs a warp has in flight per batch

struct BwdArgs {
  const float* dy;
  const float* dc_in;
  const float* c;
  const float* cprev;
  const float* v;
  const void* r;          // [H, 4H], bf16 or float32
  float* dv;              // [N, T, 4H]; the exchange on the float32 route
  float* dh0;
  float* dc0;
  __nv_bfloat16* xbuf;    // bf16 route: [2][np][kp] r(dv) by step parity, zeroed
  unsigned int* bar;      // grid barrier counter, zeroed on the stream
  int n, t_steps, hdim, np, kp, bj;
};

// row stride of the staged R slice in elements: +64 B (bf16) or +16 B
// (float32) so that neighbouring rows start in other banks
__host__ __device__ inline int rs_stride(int kp, int rbytes) {
  return rbytes == 2 ? kp + 32 : kp + 4;
}

// (ops/kernels/lstm_train.py:bwd_smem_bytes mirrors it for the plan)
__host__ __device__ inline size_t bwd_smem_bytes(int n, int kp, int bj, int rbytes) {
  const size_t rs = (size_t)bj * rs_stride(kp, rbytes) * rbytes;
  const size_t red = rbytes == 2
      ? (size_t)E_WARPS * ((n + 15) / 16) * (bj / 8) * 128 * sizeof(float)
      : (size_t)E_WARPS * n * bj * sizeof(float);
  return rs + red;
}

template <typename RT> __device__ __forceinline__ RT zero_r();
template <> __device__ __forceinline__ __nv_bfloat16 zero_r<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}
template <> __device__ __forceinline__ float zero_r<float>() { return 0.0f; }

// all blocks of the grid arrive; the `target`-th arrival releases them.
// A wait that outlasts ~2^35 cycles (~20 s) traps: a launch error, never
// a hung card (the cooperative launch makes it unreachable).
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned int seen = 0;
    const long long t0 = clock64();
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(bar) : "memory");
      if (clock64() - t0 > (1ll << 35)) asm volatile("trap;");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Partial products of r(dv) [np, kp] (bf16, the exchange buffer) with the
// staged rows of R [bj, kp], K split over the warps: warp w takes the
// 32-wide slabs w, w + E_WARPS, ... Thread (g = lane / 4, c = lane % 4)
// loads 16 contiguous bytes at slab offset 8c of rows g and g + 8 of A and
// of row g of the R slice, and feeds them to two m16n8k16 products as the
// logical k {2c, 2c+1, 2c+8, 2c+9} of each: A and B take the same
// permutation of the slab's 32 k, so the sum is unchanged. Partials go to
// red[warp][mt][nt][lane * 4 + i] in the accumulator layout.
template <int NT>
__device__ void product_bf16(const __nv_bfloat16* x, const __nv_bfloat16* rs,
                             int rstride, float* red, int mtiles, int kp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int slabs = kp / 32;
  for (int mt = 0; mt < mtiles; ++mt) {
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
    const __nv_bfloat16* xlo = x + (size_t)(mt * 16 + g) * kp + 8 * c;
    const __nv_bfloat16* xhi = xlo + (size_t)8 * kp;
    for (int s0 = warp; s0 < slabs; s0 += E_WARPS * E_BATCH) {
      uint4 lo[E_BATCH], hi[E_BATCH];
#pragma unroll
      for (int q = 0; q < E_BATCH; ++q) {
        const int s = s0 + q * E_WARPS;
        if (s < slabs) {
          lo[q] = __ldcg(reinterpret_cast<const uint4*>(xlo + s * 32));
          hi[q] = __ldcg(reinterpret_cast<const uint4*>(xhi + s * 32));
        }
      }
#pragma unroll
      for (int q = 0; q < E_BATCH; ++q) {
        const int s = s0 + q * E_WARPS;
        if (s < slabs) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint4 b = *reinterpret_cast<const uint4*>(
                rs + (nt * 8 + g) * rstride + s * 32 + 8 * c);
            mma_bf16(acc[nt], lo[q].x, hi[q].x, lo[q].y, hi[q].y, b.x, b.y);
            mma_bf16(acc[nt], lo[q].z, hi[q].z, lo[q].w, hi[q].w, b.z, b.w);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[((warp * mtiles + mt) * NT + nt) * 128 + lane * 4 + i] = acc[nt][i];
  }
}

// Partial products of dv_src (float32 rows of stride xrow, 4H long) with
// the staged float32 rows of R, K split in contiguous quarters-of-float4
// ranges over the warps; red[warp][b * bj + jj].
__device__ void product_f32(const float* x, size_t xrow, const float* rs,
                            int rstride, float* red, int n, int bj, int g4) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quads = g4 / 4, per = (quads + E_WARPS - 1) / E_WARPS;
  const int q0 = warp * per, q1 = min(quads, q0 + per);
  for (int p = lane; p < n * bj; p += 32) {
    const int b = p / bj, jj = p - (p / bj) * bj;
    const float* xr = x + (size_t)b * xrow;
    const float* rr = rs + (size_t)jj * rstride;
    float s = 0.0f;
    for (int q = q0; q < q1; ++q) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(xr + 4 * q));
      const float4 w = *reinterpret_cast<const float4*>(rr + 4 * q);
      s = fmaf(a.x, w.x, s);
      s = fmaf(a.y, w.y, s);
      s = fmaf(a.z, w.z, s);
      s = fmaf(a.w, w.w, s);
    }
    red[(size_t)warp * n * bj + p] = s;
  }
}

template <typename RT, int NT>
__global__ void __launch_bounds__(E_THREADS, 1) train_bwd_seq(BwdArgs a) {
  constexpr bool BF16 = sizeof(RT) == 2;
  extern __shared__ __align__(16) unsigned char esmem[];
  const int n = a.n, kp = a.kp, bj = a.bj, H = a.hdim, T = a.t_steps;
  const int g4 = 4 * H, j0 = blockIdx.x * bj, mtiles = a.np / 16;
  const int rstride = rs_stride(kp, sizeof(RT));
  RT* rs = reinterpret_cast<RT*>(esmem);
  float* red = reinterpret_cast<float*>(esmem + (size_t)bj * rstride * sizeof(RT));

  // rows j0 .. j0 + bj - 1 of R, zero past H and 4H, for the whole call
  const RT* r = static_cast<const RT*>(a.r);
  for (int idx = threadIdx.x; idx < bj * rstride; idx += E_THREADS) {
    const int jj = idx / rstride, k = idx - (idx / rstride) * rstride;
    const int j = j0 + jj;
    rs[idx] = (j < H && k < g4) ? r[(size_t)j * g4 + k] : zero_r<RT>();
  }
  __syncthreads();

  const size_t seq = (size_t)T * H, gseq = (size_t)T * g4;
  float carry[E_MAXC];
#pragma unroll
  for (int q = 0; q < E_MAXC; ++q) carry[q] = 0.0f;
  unsigned int target = 0;

  // t = T - 1 .. 0 are the reverse steps; t = -1 forms dh0 and dc0
  for (int t = T - 1; t >= -1; --t) {
    // this step's epilogue inputs, loaded ahead of the product
    float in[E_MAXC][8];
#pragma unroll
    for (int q = 0; q < E_MAXC; ++q) {
      const int e = threadIdx.x + q * E_THREADS;
      const int b = e / bj, j = j0 + e - (e / bj) * bj;
      if (t >= 0 && b < n && j < H) {
        const size_t hi = b * seq + (size_t)t * H + j;
        const size_t gi = b * gseq + (size_t)t * g4 + j;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) in[q][gate] = a.v[gi + (size_t)gate * H];
        in[q][4] = a.c[hi];
        in[q][5] = a.cprev[hi];
        in[q][6] = a.dy[hi];
        in[q][7] = a.dc_in[hi];
      }
    }
    const bool product = t < T - 1;
    const int src = t < 0 ? 0 : t + 1;  // the step whose dv this one reads
    if (product) {
      if constexpr (BF16) {
        product_bf16<NT>(a.xbuf + (size_t)(src & 1) * a.np * kp,
                         reinterpret_cast<const __nv_bfloat16*>(rs), rstride,
                         red, mtiles, kp);
      } else {
        product_f32(a.dv + (size_t)src * g4, gseq,
                    reinterpret_cast<const float*>(rs), rstride, red, n, bj, g4);
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < E_MAXC; ++q) {
      const int e = threadIdx.x + q * E_THREADS;
      const int b = e / bj, jj = e - (e / bj) * bj, j = j0 + jj;
      if (b >= n || j >= H) continue;
      float dh_carry = 0.0f;
      if (product) {
        if constexpr (BF16) {
          const int mt = b / 16, rr = b % 16, nt = jj / 8, cc = jj % 8;
          const int slot = ((rr % 8) * 4 + cc / 2) * 4 + (rr / 8) * 2 + cc % 2;
          for (int w = 0; w < E_WARPS; ++w)
            dh_carry += red[((w * mtiles + mt) * NT + nt) * 128 + slot];
        } else {
          for (int w = 0; w < E_WARPS; ++w)
            dh_carry += red[(size_t)w * n * bj + b * bj + jj];
        }
      }
      if (t < 0) {
        a.dh0[(size_t)b * H + j] = dh_carry;
        a.dc0[(size_t)b * H + j] = carry[q];
        continue;
      }
      const float ig = sigmoid_f(in[q][0]);
      const float gg = tanhf(in[q][1]);
      const float fg = sigmoid_f(in[q][2]);
      const float og = sigmoid_f(in[q][3]);
      const float tc = tanhf(in[q][4]);
      const float dh = in[q][6] + dh_carry;
      const float dc = in[q][7] + carry[q] + dh * og * (1.0f - tc * tc);
      float d[4];
      d[0] = dc * gg * ig * (1.0f - ig);
      d[1] = dc * ig * (1.0f - gg * gg);
      d[2] = dc * in[q][5] * fg * (1.0f - fg);
      d[3] = dh * tc * og * (1.0f - og);
      const size_t gi = b * gseq + (size_t)t * g4 + j;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) a.dv[gi + (size_t)gate * H] = d[gate];
      if constexpr (BF16) {
        __nv_bfloat16* xo = a.xbuf + (size_t)(t & 1) * a.np * kp + (size_t)b * kp + j;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) xo[(size_t)gate * H] = __float2bfloat16(d[gate]);
      }
      carry[q] = dc * fg;
    }
    if (t >= 0) {
      target += gridDim.x;
      grid_sync(a.bar, target);
    }
  }
}

template <typename RT, int NT>
cudaError_t launch_bwd(const BwdArgs& args, int grid, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(args.n, args.kp, args.bj, sizeof(RT));
  if (smem > (size_t)MAX_SMEM || args.bj != 8 * NT ||
      (size_t)args.n * args.bj > (size_t)E_MAXC * E_THREADS ||
      (long long)grid * args.bj < args.hdim) {
    return cudaErrorInvalidValue;
  }
  auto kernel = train_bwd_seq<RT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, E_THREADS,
                                                           smem)) != cudaSuccess)
    return err;
  if (grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(args.bar, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  BwdArgs a = args;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(E_THREADS), params, smem, stream);
}

}  // namespace

extern "C" {

// Largest hidden size D's shared-memory layout takes.
int lstm_train_max_hidden() {
  return (int)((MAX_SMEM - sizeof(float) * KS * BN * COLS) / (sizeof(float) * BN));
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

// E: one cooperative launch of `grid` blocks of `bj` units (a multiple
// of 8, grid * bj >= h) on `stream`. Device pointers: dy, dc_in, c_seq,
// cprev [n, t_steps, h] f32; v [n, t_steps, 4h] f32; r as for the
// forward; xbuf [2, np, kp] bf16, zeroed (bf16 R only; np = n rounded up
// to 16, kp = 4h rounded up to 32); bar one zeroed-on-the-stream counter;
// outputs dv [n, t_steps, 4h] f32, dh0 and dc0 [n, h] f32.
// Returns 0, or the cudaError_t of the call that failed
// (cudaErrorCooperativeLaunchTooLarge: the grid cannot be co-resident).
int lstm_train_backward(const void* dy, const void* dc_in, const void* v,
                        const void* c_seq, const void* cprev, const void* r,
                        int r_bf16, void* dv, void* dh0, void* dc0, void* xbuf,
                        void* bar, int n, int t_steps, int hdim, int grid,
                        int bj, void* stream) {
  if (n <= 0 || t_steps <= 0 || hdim <= 0 || grid <= 0 || bj <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  BwdArgs a;
  a.dy = static_cast<const float*>(dy);
  a.dc_in = static_cast<const float*>(dc_in);
  a.c = static_cast<const float*>(c_seq);
  a.cprev = static_cast<const float*>(cprev);
  a.v = static_cast<const float*>(v);
  a.r = r;
  a.dv = static_cast<float*>(dv);
  a.dh0 = static_cast<float*>(dh0);
  a.dc0 = static_cast<float*>(dc0);
  a.xbuf = static_cast<__nv_bfloat16*>(xbuf);
  a.bar = static_cast<unsigned int*>(bar);
  a.n = n;
  a.t_steps = t_steps;
  a.hdim = hdim;
  a.np = (n + 15) / 16 * 16;
  a.kp = (4 * hdim + 31) / 32 * 32;
  a.bj = bj;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (r_bf16) {
    err = bj == 8 ? launch_bwd<__nv_bfloat16, 1>(a, grid, s)
        : bj == 16 ? launch_bwd<__nv_bfloat16, 2>(a, grid, s)
                   : cudaErrorInvalidValue;
  } else {
    err = bj == 8 ? launch_bwd<float, 1>(a, grid, s)
        : bj == 16 ? launch_bwd<float, 2>(a, grid, s)
                   : cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* lstm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
