// Eval-mode LSTM sequence kernel for Hopper (sm_90a): kernels A and B.
//
// Replaces the JAX package's Pallas TPU kernels
// ops/pallas/lstm.py:_lstm_step_kernel (lstm_seq_pallas, no lengths) and
// ops/pallas/lstm.py:_lstm_step_kernel_cseq (_lstm_seq_pallas_cseq,
// which also streams the cell state per step for pack semantics). One
// kernel serves both: `yc` is either the streamed [N, T, H] cell
// sequence or null, and then only the last cell state is written.
//
// What it computes, per step t, from the precomputed input projections
// wx = x @ W + b [N, T, 4H] (float32) and the recurrent matrix R [H, 4H]
// (bf16), gates in the order i, g, f, o:
//   v  = bf16(h_{t-1}) @ R + wx[:, t]          (float32 accumulation)
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
// y[:, t] = h_t. bf16 x bf16 products are exact in float32, so the result
// differs from the plain PyTorch twin (ops/kernels/lstm.py:
// lstm_seq_reference) only in summation order.
//
// What bounds it on an H100: each step needs all of R (8 MB in bf16 at
// H 1024) for 2 N H 4H flops, far below the tensor-core rate at serving
// batch sizes, and step t + 1 cannot start before step t ends, so a step
// is bound by latency: moving R or h, and synchronising the card. The
// TPU kernel kept R in VMEM for the whole grid. The first design here
// launched one step kernel per timestep and streamed all of R out of L2
// every step (1.27 ms per 74-step call, 113-127x the bound).
//
// This design is kernel E's (csrc/lstm_train.cu) in the forward
// direction: one persistent cooperative launch per call (per slice of the
// batch, see ops/kernels/lstm.py:fwd_plan and batch_slices). The grid is
// no larger than the blocks that can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs; the launch is
// refused otherwise, never split).
//   - Block b owns hidden units [b u, (b + 1) u) and stages the 4u gate
//     columns {g H + j} of R, transposed so that k runs along a row, once
//     per call: in shared memory (RES: 4u x H x 2 B, 64 KB at H 1024,
//     u 8), or, where no partition fits that, in a global scratch of its
//     own that the steps read from L2.
//   - A step reads bf16(h_{t-1}) from an exchange buffer in global memory
//     ([2][Np][Kp] bf16 by step parity, L2-resident) and runs the product
//     on mma.sync.m16n8k16 (M: batch rows padded to 16; N: 8 gate
//     columns; K: H; the k order inside each 32-wide slab permuted alike
//     for A and B so that every thread loads 16 contiguous bytes). The
//     warps split K kw ways and the batch tiles 16 / kw ways; the kw
//     partial sums meet in shared memory in a fixed order, so the result
//     is the same bits from run to run.
//   - The thread that owns a (row, unit) pair adds wx, forms the gates,
//     keeps c in registers, writes y[:, t] (and c to yc[:, t] for B) and
//     bf16(h_t) to the exchange buffer; then a grid barrier.
//   Traps (E's): the exchange buffer is written and read by different
//   blocks within the launch, so it is read with ld.global.cg (L2,
//   coherent) after the barrier, never through __ldg, const __restrict__
//   or ld.global.nc; writes are released by __threadfence() before the
//   barrier's atomic, and the barrier's read is ld.acquire.gpu. The
//   barrier is a counter of its own, zeroed per launch by a memset on the
//   stream, so the source builds without -rdc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAXC = 8;             // (row, unit) pairs an epilogue thread owns
constexpr int PRE = 2;              // of them, whose projections load before the product
constexpr int BATCH = 4;            // k-slabs a warp has in flight
constexpr int MAX_SMEM = 227 * 1024;  // per-block limit on sm_90
constexpr int MAX_HIDDEN = 8192;  // ops/kernels/lstm.py:SEQ_MAX_HIDDEN

struct SeqArgs {
  const float* wx;    // [n, T, 4H]
  const bf16* r;      // [H, 4H]
  const float* h0;    // [n, H]
  const float* c0;    // [n, H]
  float* y;           // [n, T, H]
  float* yc;          // [n, T, H], or null
  float* c_t;         // [n, H] when yc is null
  bf16* xbuf;         // [2][np][kp] bf16(h) by step parity, zeroed
  bf16* rslice;       // !RES: [grid][4 units][rstride]
  unsigned int* bar;  // grid barrier counter, zeroed on the stream
  int n, t_steps, hdim, np, kp, units, kw, rstride;
};

// row stride of a staged column of R: kp rounded up to 64 elements, plus
// 32, so that 2 * stride = 64 mod 128 bytes and the eight rows a quarter
// warp reads start in distinct 16-byte bank groups
__host__ __device__ inline int seq_rstride(int kp) { return (kp + 63) / 64 * 64 + 32; }

// (ops/kernels/lstm.py:fwd_smem_bytes mirrors it for the plan)
__host__ __device__ inline size_t seq_smem_bytes(int n, int kp, int units, int kw,
                                                 bool resident) {
  const size_t rs = resident ? (size_t)4 * units * seq_rstride(kp) * sizeof(bf16) : 0;
  const size_t red = (size_t)kw * ((n + 15) / 16) * (units / 2) * 128 * sizeof(float);
  return rs + red;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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

// 16 bytes of the staged R slice: shared memory, or (the L2 variant) the
// block's own global scratch, written earlier in this launch
template <bool RES>
__device__ __forceinline__ uint4 load_r(const bf16* p) {
  if constexpr (RES) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    return __ldcg(reinterpret_cast<const uint4*>(p));
  }
}

// Partial products of bf16(h) [np, kp] (the exchange buffer) with the
// block's staged columns rs [4 units][rstride]. Warp w takes the K slabs
// w % kw, w % kw + kw, ... of the batch tiles w / kw, w / kw + 16 / kw, ...
// Thread (g = lane / 4, c = lane % 4) loads 16 contiguous bytes at slab
// offset 8c of rows g and g + 8 of A and of column g of the R slice, and
// feeds them to two m16n8k16 products as the logical k {2c, 2c+1, 2c+8,
// 2c+9} of each: A and B take the same permutation of the slab's 32 k,
// so the sum is unchanged. Partials go to
// red[kslice][mt][nt][lane * 4 + i] in the accumulator layout.
template <bool RES>
__device__ void product(const bf16* x, const bf16* rs, int rstride, float* red,
                        int mtiles, int ntiles, int kp, int kw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int slabs = kp / 32, ks = warp % kw, mlanes = WARPS / kw;
  for (int mt = warp / kw; mt < mtiles; mt += mlanes) {
    const bf16* xlo = x + (size_t)(mt * 16 + g) * kp + 8 * c;
    const bf16* xhi = xlo + (size_t)8 * kp;
    for (int nt0 = 0; nt0 < ntiles; nt0 += 4) {
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
      for (int s0 = ks; s0 < slabs; s0 += kw * BATCH) {
        uint4 lo[BATCH], hi[BATCH];
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int s = s0 + q * kw;
          if (s < slabs) {
            lo[q] = __ldcg(reinterpret_cast<const uint4*>(xlo + s * 32));
            hi[q] = __ldcg(reinterpret_cast<const uint4*>(xhi + s * 32));
          }
        }
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int s = s0 + q * kw;
          if (s < slabs) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const uint4 b = load_r<RES>(rs + (size_t)((nt0 + nt) * 8 + g) * rstride +
                                          s * 32 + 8 * c);
              mma_bf16(acc[nt], lo[q].x, hi[q].x, lo[q].y, hi[q].y, b.x, b.y);
              mma_bf16(acc[nt], lo[q].z, hi[q].z, lo[q].w, hi[q].w, b.z, b.w);
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[((size_t)(ks * mtiles + mt) * ntiles + nt0 + nt) * 128 + lane * 4 + i] =
              acc[nt][i];
    }
  }
}

template <bool RES>
__global__ void __launch_bounds__(THREADS, 1) lstm_seq_persistent(SeqArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, H = a.hdim, T = a.t_steps, u = a.units, kp = a.kp;
  const int rstride = a.rstride, g4 = 4 * H, j0 = blockIdx.x * u;
  const int mtiles = a.np / 16, ntiles = u / 2, cols = 4 * u;
  bf16* rs = RES ? reinterpret_cast<bf16*>(smem)
                 : a.rslice + (size_t)blockIdx.x * cols * rstride;
  float* red = reinterpret_cast<float*>(
      smem + (RES ? (size_t)cols * rstride * sizeof(bf16) : 0));

  // the block's gate columns of R, k along a row, zero past H: read row by
  // row of R (consecutive threads on consecutive columns), once per call
  for (int idx = threadIdx.x; idx < kp * cols; idx += THREADS) {
    const int k = idx / cols, cc = idx - (idx / cols) * cols;
    const int gate = cc / u, j = j0 + cc - (cc / u) * u;
    rs[(size_t)cc * rstride + k] =
        (k < H && j < H) ? a.r[(size_t)k * g4 + (size_t)gate * H + j]
                         : __float2bfloat16(0.0f);
  }

  // the pairs this thread owns: c in registers; bf16(h0) to parity 1
  float carry[MAXC];
#pragma unroll
  for (int q = 0; q < MAXC; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int b = e / u, j = j0 + e - (e / u) * u;
    carry[q] = 0.0f;
    if (b < n && j < H) {
      carry[q] = a.c0[(size_t)b * H + j];
      a.xbuf[(size_t)a.np * kp + (size_t)b * kp + j] =
          __float2bfloat16(a.h0[(size_t)b * H + j]);
    }
  }
  unsigned int target = gridDim.x;
  grid_sync(a.bar, target);

  const size_t seq = (size_t)T * H, gseq = (size_t)T * g4;
  for (int t = 0; t < T; ++t) {
    // this step's projections of the first PRE pairs, loaded ahead of the
    // product (all MAXC would hold 32 registers across it and spill)
    float in[PRE][4];
#pragma unroll
    for (int q = 0; q < PRE; ++q) {
      const int e = threadIdx.x + q * THREADS;
      const int b = e / u, j = j0 + e - (e / u) * u;
      if (b < n && j < H) {
        const float* w = a.wx + b * gseq + (size_t)t * g4 + j;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) in[q][gate] = w[(size_t)gate * H];
      }
    }
    product<RES>(a.xbuf + (size_t)((t + 1) & 1) * a.np * kp, rs, rstride, red, mtiles,
                 ntiles, kp, a.kw);
    __syncthreads();
    bf16* xo = a.xbuf + (size_t)(t & 1) * a.np * kp;
#pragma unroll
    for (int q = 0; q < MAXC; ++q) {
      const int e = threadIdx.x + q * THREADS;
      const int b = e / u, jj = e - (e / u) * u, j = j0 + jj;
      if (b >= n || j >= H) continue;
      const int mt = b / 16, rr = b % 16;
      const float* w = a.wx + b * gseq + (size_t)t * g4 + j;
      float v[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const int cc = gate * u + jj, nt = cc / 8, c8 = cc % 8;
        const int slot = ((rr % 8) * 4 + c8 / 2) * 4 + (rr / 8) * 2 + c8 % 2;
        float s = 0.0f;
        for (int k = 0; k < a.kw; ++k)
          s += red[((size_t)(k * mtiles + mt) * ntiles + nt) * 128 + slot];
        v[gate] = s + (q < PRE ? in[q < PRE ? q : 0][gate] : w[(size_t)gate * H]);
      }
      const float ig = sigmoid_f(v[0]);
      const float gg = tanhf(v[1]);
      const float fg = sigmoid_f(v[2]);
      const float og = sigmoid_f(v[3]);
      const float cn = fg * carry[q] + ig * gg;
      const float hn = og * tanhf(cn);
      carry[q] = cn;
      const size_t hi = b * seq + (size_t)t * H + j;
      a.y[hi] = hn;
      if (a.yc != nullptr) a.yc[hi] = cn;
      xo[(size_t)b * kp + j] = __float2bfloat16(hn);
    }
    if (t + 1 < T) {
      target += gridDim.x;
      grid_sync(a.bar, target);
    }
  }
  if (a.yc == nullptr) {
#pragma unroll
    for (int q = 0; q < MAXC; ++q) {
      const int e = threadIdx.x + q * THREADS;
      const int b = e / u, j = j0 + e - (e / u) * u;
      if (b < n && j < H) a.c_t[(size_t)b * H + j] = carry[q];
    }
  }
}

template <bool RES>
cudaError_t launch(const SeqArgs& args, int grid, cudaStream_t stream) {
  const size_t smem = seq_smem_bytes(args.n, args.kp, args.units, args.kw, RES);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = lstm_seq_persistent<RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                           smem)) != cudaSuccess)
    return err;
  if (grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(args.bar, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  SeqArgs a = args;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(THREADS), params, smem, stream);
}

}  // namespace

extern "C" {

// One cooperative launch of `grid` blocks of `units` hidden units each (a
// multiple of 8, grid * units >= h) on `stream`, K split `kw` ways (1, 2,
// 4, 8 or 16), R's slice in shared memory (resident != 0) or in rslice.
// Device pointers: wx [n, t_steps, 4h] f32, r [h, 4h] bf16, h0/c0 [n, h]
// f32, y [n, t_steps, h] f32; yc [n, t_steps, h] f32 streams every c_t
// (then c_t is unused), or is null: then c_t [n, h] receives the last;
// xbuf [2, np, kp] bf16, zeroed (np = n rounded up to 16, kp = h rounded
// up to 32); rslice [grid, 4 units, rstride] bf16 when not resident (else
// null); bar one counter, zeroed on the stream here.
// Returns 0, or the cudaError_t of the call that failed
// (cudaErrorCooperativeLaunchTooLarge: the grid cannot be co-resident).
int lstm_seq_forward(const void* wx, const void* r, const void* h0, const void* c0,
                     void* y, void* yc, void* c_t, void* xbuf, void* rslice, void* bar,
                     int n, int t_steps, int hdim, int grid, int units, int kw,
                     int resident, void* stream) {
  if (n <= 0 || t_steps <= 0 || hdim <= 0 || hdim > MAX_HIDDEN || grid <= 0 ||
      units <= 0 || units % 8 || (long long)grid * units < hdim ||
      (long long)n * units > (long long)MAXC * THREADS ||
      !(kw == 1 || kw == 2 || kw == 4 || kw == 8 || kw == 16) ||
      (yc == nullptr && c_t == nullptr) || (!resident && rslice == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  SeqArgs a;
  a.wx = static_cast<const float*>(wx);
  a.r = static_cast<const bf16*>(r);
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.y = static_cast<float*>(y);
  a.yc = static_cast<float*>(yc);
  a.c_t = static_cast<float*>(c_t);
  a.xbuf = static_cast<bf16*>(xbuf);
  a.rslice = static_cast<bf16*>(rslice);
  a.bar = static_cast<unsigned int*>(bar);
  a.n = n;
  a.t_steps = t_steps;
  a.hdim = hdim;
  a.np = (n + 15) / 16 * 16;
  a.kp = (hdim + 31) / 32 * 32;
  a.units = units;
  a.kw = kw;
  a.rstride = seq_rstride(a.kp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = resident ? launch<true>(a, grid, s) : launch<false>(a, grid, s);
  return (int)err;
}

const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
