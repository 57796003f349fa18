// The persistent LSTM forward recurrence for Hopper (sm_90a), shared by
// kernels B (csrc/lstm_seq.cu, eval), C (csrc/lstm_seq_int8.cu, eval with
// int8 R) and D (csrc/lstm_train.cu, training), and the grid barrier and
// bf16 mma that E (csrc/lstm_train.cu) uses too.
//
// One cooperative launch runs all T steps of a call (of a slice of its
// batch: ops/kernels/lstm.py:fwd_plan and batch_slices). The grid is no
// larger than the blocks that can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs; the launch is
// refused otherwise, never split).
//   - Block b owns hidden units [b u, (b + 1) u), u a multiple of 8, and
//     stages the 4u gate columns {g H + j} of R, transposed so that k
//     runs along a row, once per call: in shared memory (RES), or, where
//     no partition fits that, in a global scratch of its own that the
//     steps read from L2.
//   - A step reads r(h_{t-1}) from an exchange buffer in global memory
//     ([2][np][kp] by step parity, L2-resident) and forms its partial
//     products: bf16 R on mma.sync.m16n8k16 (M: batch rows padded to 16;
//     N: 8 gate columns; K: H, the k order inside each 32-wide slab
//     permuted alike for A and B so that every thread loads 16 contiguous
//     bytes), float32 R as a float32 FMA loop (no TF32). The warps split
//     K kw ways; the kw partial sums meet in shared memory in a fixed
//     order, so a rerun gives the same bits.
//   - The thread that owns a (row, unit) pair adds wx, forms the gates,
//     keeps c in registers, writes y[:, t] (c to yc[:, t] for B and D, the
//     four pre-activations to v[:, t] for D) and r(h_t) to the exchange
//     buffer; then a grid barrier.
// Traps: the exchange buffer is written and read by different blocks
// within the launch, so it is read with ld.global.cg (L2, coherent)
// after the barrier, never through __ldg, const __restrict__ or
// ld.global.nc; writes are released by __threadfence() before the
// barrier's atomic, and the barrier's read is ld.acquire.gpu. The barrier
// is a counter of its own, zeroed per launch by a memset on the stream,
// so the sources build without -rdc.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAXC = 8;               // (row, unit) pairs an epilogue thread owns
constexpr int PRE = 2;                // of them, whose projections load before the product
constexpr int BATCH = 4;              // k-slabs a warp has in flight
constexpr int MAX_SMEM = 227 * 1024;  // per-block limit on sm_90
constexpr int MAX_HIDDEN = 8192;      // ops/kernels/lstm.py:SEQ_MAX_HIDDEN

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

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.0f); }
template <> __device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <> __device__ __forceinline__ int zero_of<int>() { return 0; }

// h as the exchange buffer holds it: rounded to bf16 for bf16 R, itself
// for float32 R
template <typename T> __device__ __forceinline__ T to_exchange(float x);
template <> __device__ __forceinline__ bf16 to_exchange<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ float to_exchange<float>(float x) { return x; }

// The R-slice layout of each kind, by `rbytes`, the size of one entry of
// R as the caller holds it: 2 (bf16), 4 (float32) or 1 (int8, held as
// the k-packed words of ops/kernels/lstm.py:pack_k4, 4 k a word).
// kp: H padded to the product's k granule; rstride: the staged columns'
// row stride in entries of the staged type (bf16, float, int32 word),
// chosen so that the rows a quarter warp reads with 16-byte loads start
// in distinct bank groups. (ops/kernels/lstm.py mirrors all three.)
__host__ __device__ inline int fwd_kpad(int hdim, int rbytes) {
  return rbytes == 1 ? (hdim + 63) / 64 * 64 : (hdim + 31) / 32 * 32;
}
__host__ __device__ inline int fwd_rstride(int kp, int rbytes) {
  if (rbytes == 2) return (kp + 63) / 64 * 64 + 32;  // 2 * stride = 64 mod 128 B
  if (rbytes == 4) return kp + 4;                    // 4 * stride = 16 mod 128 B
  return (kp / 4 + 31) / 32 * 32 + 16;               // 4 * stride = 64 mod 128 B
}
__host__ __device__ inline size_t fwd_smem_bytes(int n, int kp, int units, int kw,
                                                 bool resident, int rbytes) {
  const int cols = 4 * units, np = (n + 15) / 16 * 16;
  const size_t entry = rbytes == 2 ? 2 : 4;
  const size_t rs = resident ? (size_t)cols * fwd_rstride(kp, rbytes) * entry : 0;
  const size_t red = rbytes == 4 ? (size_t)kw * n * cols * sizeof(float)
                                 : (size_t)kw * (np / 16) * (units / 2) * 128 * 4;
  const size_t scales = rbytes == 1 ? (size_t)3 * np * 4 : 0;  // C: hscale, 1 / hscale, amax
  return rs + red + scales;
}

// The checks every forward launch shares (the plan makes the same).
inline bool fwd_args_ok(int n, int t_steps, int hdim, int grid, int units, int kw,
                        bool resident, const void* rslice) {
  return n > 0 && t_steps > 0 && hdim > 0 && hdim <= MAX_HIDDEN && grid > 0 &&
         units > 0 && units % 8 == 0 && (long long)grid * units >= hdim &&
         (long long)n * units <= (long long)MAXC * THREADS &&
         (kw == 1 || kw == 2 || kw == 4 || kw == 8 || kw == 16) &&
         (resident || rslice != nullptr);
}

// The block's 4u gate columns of a [rows, 4H] matrix, k along a row of
// stride `rstride`, zero past `rows` (up to kpad) and past H: read row
// by row of the source (consecutive threads on consecutive columns),
// once per call.
template <typename T>
__device__ void stage_columns(T* rs, const T* src, int rows, int kpad, int rstride,
                              int hdim, int units, int j0) {
  const int cols = 4 * units, g4 = 4 * hdim;
  for (int idx = threadIdx.x; idx < kpad * cols; idx += THREADS) {
    const int k = idx / cols, cc = idx - (idx / cols) * cols;
    const int gate = cc / units, j = j0 + cc - (cc / units) * units;
    rs[(size_t)cc * rstride + k] =
        (k < rows && j < hdim) ? src[(size_t)k * g4 + (size_t)gate * hdim + j]
                               : zero_of<T>();
  }
}

// The q-th (row, unit) pair of this thread: row b, unit j0 + jj. Owners
// of consecutive units of a row are consecutive threads.
__device__ __forceinline__ void owner(int q, int units, int& b, int& jj) {
  const int e = threadIdx.x + q * THREADS;
  b = e / units;
  jj = e - b * units;
}

// Where the accumulator of (row b, column cc) of the block's tiled
// partials lies: red[(ks * mtiles + mt) * ntiles + nt) * 128 + slot].
__device__ __forceinline__ int tile_slot(int b, int cc, int& mt, int& nt) {
  const int rr = b % 16, c8 = cc % 8;
  mt = b / 16;
  nt = cc / 8;
  return ((rr % 8) * 4 + c8 / 2) * 4 + (rr / 8) * 2 + c8 % 2;
}

// 16 bytes of the staged R slice: shared memory, or (the L2 variant) the
// block's own global scratch, written earlier in this launch
template <bool RES, typename V>
__device__ __forceinline__ V load_r(const void* p) {
  if constexpr (RES) {
    return *reinterpret_cast<const V*>(p);
  } else {
    return __ldcg(reinterpret_cast<const V*>(p));
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
__device__ void fwd_product_bf16(const bf16* x, const bf16* rs, int rstride, float* red,
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
              const uint4 b = load_r<RES, uint4>(
                  rs + (size_t)((nt0 + nt) * 8 + g) * rstride + s * 32 + 8 * c);
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

// Partial products of float32 h [np, kp] (the exchange buffer) with the
// block's staged float32 columns rs [4 units][rstride]: warp w takes the
// contiguous float4 range w % kw of K for the (row b, column group cq)
// items w / kw, w / kw + 16 / kw, ... (32 a warp); an item is the four
// columns cq + u c (c = 0 .. 3) of row b, so that one load of h feeds
// four columns and the lanes of a quarter warp read consecutive rows of
// the slice. red[ks][b * cols + cc].
template <bool RES>
__device__ void fwd_product_f32(const float* x, const float* rs, int rstride, float* red,
                                int n, int cols, int kp, int kw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ks = warp % kw, stride = WARPS / kw * 32, u = cols / 4, items = n * u;
  const int quads = kp / 4, per = (quads + kw - 1) / kw;
  const int q0 = ks * per, q1 = min(quads, q0 + per);
  for (int p = warp / kw * 32 + lane; p < items; p += stride) {
    const int b = p / u, cq = p - (p / u) * u;
    const float* xr = x + (size_t)b * kp;
    const float* rr = rs + (size_t)cq * rstride;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = q0; q < q1; ++q) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(xr + 4 * q));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 w = load_r<RES, float4>(rr + (size_t)c * u * rstride + 4 * q);
        s[c] = fmaf(a.x, w.x, s[c]);
        s[c] = fmaf(a.y, w.y, s[c]);
        s[c] = fmaf(a.z, w.z, s[c]);
        s[c] = fmaf(a.w, w.w, s[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(size_t)ks * n * cols + b * cols + cq + c * u] = s[c];
  }
}

struct FwdArgs {
  const float* wx;    // [n, T, 4H]
  const void* r;      // [H, 4H], bf16 or float32 (RT)
  const float* h0;    // [n, H]
  const float* c0;    // [n, H]
  float* y;           // [n, T, H]
  float* yc;          // [n, T, H], or null
  float* c_t;         // [n, H] when yc is null
  float* v;           // [n, T, 4H] pre-activations (D), or null
  void* xbuf;         // [2][np][kp] r(h) by step parity, zeroed
  void* rslice;       // !RES: [grid][4 units][rstride]
  unsigned int* bar;  // grid barrier counter, zeroed on the stream
  int n, t_steps, hdim, np, kp, units, kw, rstride;
};

// The forward recurrence, R of type RT (bf16 or float), R's slice in
// shared memory (RES) or in rslice. B is <bf16, RES> without v; D is
// <bf16 or float, RES> with v.
template <typename RT, bool RES>
__global__ void __launch_bounds__(THREADS, 1) lstm_fwd_persistent(FwdArgs a) {
  constexpr bool BF16 = sizeof(RT) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, H = a.hdim, T = a.t_steps, u = a.units, kp = a.kp;
  const int rstride = a.rstride, g4 = 4 * H, j0 = blockIdx.x * u;
  const int mtiles = a.np / 16, ntiles = u / 2, cols = 4 * u;
  RT* rs = RES ? reinterpret_cast<RT*>(smem)
               : static_cast<RT*>(a.rslice) + (size_t)blockIdx.x * cols * rstride;
  float* red = reinterpret_cast<float*>(
      smem + (RES ? (size_t)cols * rstride * sizeof(RT) : 0));
  RT* xbuf = static_cast<RT*>(a.xbuf);
  const size_t half = (size_t)a.np * kp;

  stage_columns<RT>(rs, static_cast<const RT*>(a.r), H, kp, rstride, H, u, j0);

  // the pairs this thread owns: c in registers; r(h0) to parity 1
  float carry[MAXC];
#pragma unroll
  for (int q = 0; q < MAXC; ++q) {
    int b, jj;
    owner(q, u, b, jj);
    const int j = j0 + jj;
    carry[q] = 0.0f;
    if (b < n && j < H) {
      carry[q] = a.c0[(size_t)b * H + j];
      xbuf[half + (size_t)b * kp + j] = to_exchange<RT>(a.h0[(size_t)b * H + j]);
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
      int b, jj;
      owner(q, u, b, jj);
      if (b < n && j0 + jj < H) {
        const float* w = a.wx + b * gseq + (size_t)t * g4 + j0 + jj;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) in[q][gate] = w[(size_t)gate * H];
      }
    }
    const RT* xi = xbuf + (size_t)((t + 1) & 1) * half;
    if constexpr (BF16) {
      fwd_product_bf16<RES>(xi, rs, rstride, red, mtiles, ntiles, kp, a.kw);
    } else {
      fwd_product_f32<RES>(xi, rs, rstride, red, n, cols, kp, a.kw);
    }
    __syncthreads();
    RT* xo = xbuf + (size_t)(t & 1) * half;
#pragma unroll
    for (int q = 0; q < MAXC; ++q) {
      int b, jj;
      owner(q, u, b, jj);
      const int j = j0 + jj;
      if (b >= n || j >= H) continue;
      const float* w = a.wx + b * gseq + (size_t)t * g4 + j;
      float v[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const int cc = gate * u + jj;
        float s = 0.0f;
        if constexpr (BF16) {
          int mt, nt;
          const int slot = tile_slot(b, cc, mt, nt);
          for (int k = 0; k < a.kw; ++k)
            s += red[((size_t)(k * mtiles + mt) * ntiles + nt) * 128 + slot];
        } else {
          for (int k = 0; k < a.kw; ++k) s += red[((size_t)k * n + b) * cols + cc];
        }
        v[gate] = s + (q < PRE ? in[q < PRE ? q : 0][gate] : w[(size_t)gate * H]);
      }
      if (a.v != nullptr) {
        float* vo = a.v + b * gseq + (size_t)t * g4 + j;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) vo[(size_t)gate * H] = v[gate];
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
      xo[(size_t)b * kp + j] = to_exchange<RT>(hn);
    }
    if (t + 1 < T) {
      target += gridDim.x;
      grid_sync(a.bar, target);
    }
  }
  if (a.yc == nullptr) {
#pragma unroll
    for (int q = 0; q < MAXC; ++q) {
      int b, jj;
      owner(q, u, b, jj);
      if (b < n && j0 + jj < H) a.c_t[(size_t)b * H + j0 + jj] = carry[q];
    }
  }
}

// A cooperative launch of `kernel` on `grid` blocks with `smem` bytes of
// dynamic shared memory, refused (cudaErrorCooperativeLaunchTooLarge)
// where the grid cannot be co-resident; zeroes the barrier counter first.
template <typename Args>
cudaError_t launch_cooperative(void (*kernel)(Args), const Args& args,
                               unsigned int* bar, int grid, size_t smem,
                               cudaStream_t stream) {
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
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
  err = cudaMemsetAsync(bar, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  Args a = args;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(THREADS), params, smem, stream);
}

// The forward recurrence on `grid` blocks: RT bf16 or float; the R slice
// resident or not. Returns the cudaError_t of the call that failed.
template <typename RT>
cudaError_t launch_fwd(FwdArgs a, int grid, bool resident, cudaStream_t stream) {
  const int rbytes = (int)sizeof(RT);
  a.np = (a.n + 15) / 16 * 16;
  a.kp = fwd_kpad(a.hdim, rbytes);
  a.rstride = fwd_rstride(a.kp, rbytes);
  const size_t smem = fwd_smem_bytes(a.n, a.kp, a.units, a.kw, resident, rbytes);
  return resident ? launch_cooperative(lstm_fwd_persistent<RT, true>, a, a.bar, grid,
                                       smem, stream)
                  : launch_cooperative(lstm_fwd_persistent<RT, false>, a, a.bar, grid,
                                       smem, stream);
}

}  // namespace
