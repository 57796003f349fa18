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
// grid. Both are one persistent cooperative launch per call (per slice
// of the batch), so R is read from memory once per call, not once a
// step.
//   - D is kernel B's persistent forward (csrc/lstm_persistent.cuh:
//     lstm_fwd_persistent) with v streamed out, planned by
//     ops/kernels/lstm.py:fwd_plan: block b owns u hidden units and keeps
//     their 4u gate columns of R in shared memory (or, past that, in a
//     global scratch read from L2). bf16 R: r(h) = bf16(h) is exchanged
//     through L2 by step parity and the product runs on mma.sync.m16n8k16,
//     as B's. float32 R: the exchange holds h itself, R's slice is float32
//     (4u x H x 4 B, 96 KB at H 768, u 8), and the product is a float32 FMA
//     loop with K split over the warps in a fixed order (no TF32), so the
//     result differs from the twin in summation order only.
//   - E: the grid is no larger than the blocks that can be resident at once
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
//     forms dh0 and dc0. With float32 R nothing is rounded: the exchange
//     is dv itself and the product a float32 FMA loop.
//   Traps: the exchange buffers (and dv on E's float32 route) are written
//   and read by different blocks within the launch, so they are read with
//   ld.global.cg (L2, coherent) after the barrier, never through __ldg,
//   const __restrict__ or ld.global.nc, which could return the previous
//   step's values; writes are released by __threadfence() before the
//   barrier's atomic and the barrier's read is ld.acquire.gpu. The
//   barrier is a counter of its own (zeroed per launch by a memset on the
//   stream), so the source builds without -rdc.

#include "lstm_persistent.cuh"

namespace {

// ---------------------------------------------------------------------------
// E: the reverse-time recurrence in one cooperative launch
// ---------------------------------------------------------------------------

constexpr int E_THREADS = THREADS;  // the shared cooperative launch's block
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
    rs[idx] = (j < H && k < g4) ? r[(size_t)j * g4 + k] : zero_of<RT>();
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
  if (args.bj != 8 * NT || (size_t)args.n * args.bj > (size_t)E_MAXC * E_THREADS ||
      (long long)grid * args.bj < args.hdim) {
    return cudaErrorInvalidValue;
  }
  return launch_cooperative(train_bwd_seq<RT, NT>, args, args.bar, grid, smem, stream);
}

}  // namespace

extern "C" {

// D: one cooperative launch of `grid` blocks of `units` hidden units
// each (a multiple of 8, grid * units >= h) on `stream`, K split `kw`
// ways (1, 2, 4, 8 or 16), R's slice in shared memory (resident != 0) or
// in rslice. Device pointers: wx [n, t_steps, 4h] f32; r [h, 4h] bf16
// (r_bf16 != 0) or f32; h0, c0 [n, h] f32; outputs y, c_seq
// [n, t_steps, h] f32 and v [n, t_steps, 4h] f32; xbuf [2, np, kp] of R's
// type, zeroed (np = n rounded up to 16, kp = h rounded up to 32); rslice
// [grid, 4 units, rstride] of R's type when not resident (else null); bar
// one counter, zeroed on the stream here.
// Returns 0, or the cudaError_t of the call that failed
// (cudaErrorCooperativeLaunchTooLarge: the grid cannot be co-resident).
int lstm_train_forward(const void* wx, const void* r, int r_bf16, const void* h0,
                       const void* c0, void* y, void* c_seq, void* v, void* xbuf,
                       void* rslice, void* bar, int n, int t_steps, int hdim, int grid,
                       int units, int kw, int resident, void* stream) {
  if (!fwd_args_ok(n, t_steps, hdim, grid, units, kw, resident, rslice)) {
    return (int)cudaErrorInvalidValue;
  }
  FwdArgs a;
  a.wx = static_cast<const float*>(wx);
  a.r = r;
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.y = static_cast<float*>(y);
  a.yc = static_cast<float*>(c_seq);
  a.c_t = nullptr;
  a.v = static_cast<float*>(v);
  a.xbuf = xbuf;
  a.rslice = rslice;
  a.bar = static_cast<unsigned int*>(bar);
  a.n = n;
  a.t_steps = t_steps;
  a.hdim = hdim;
  a.units = units;
  a.kw = kw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = r_bf16 ? launch_fwd<bf16>(a, grid, resident != 0, s)
                                 : launch_fwd<float>(a, grid, resident != 0, s);
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
