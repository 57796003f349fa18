// Eval-mode int8 LSTM sequence kernel for Hopper (sm_90a): kernel C.
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
// -use_fast_math), hq is the rint of the IEEE quotient h / hscale (see
// quantize1), rounding is rintf (half to even, as torch.round), the
// int32 sum is exact in any order (|acc| <= 127^2 H < 2^31 up to the
// widest H), the row amax is a max (order-free), and the epilogue is
// written with __fmul_rn/__fadd_rn so that nvcc does not contract it into
// FMAs. The pre-activation v therefore equals the twin's bit for bit on
// the same h_{t-1}, whatever the grid.
//
// What bounds it on an H100: each step needs all of rq (4 MB at H 1024)
// for 2 N H 4H int8 operations, far below the tensor-core rate at serving
// batch sizes, and step t + 1 cannot start before step t ends: a step is
// bound by latency: moving h, and synchronising the card.
//
// This design is the int8 sibling of the persistent forward of kernels B
// and D (csrc/lstm_persistent.cuh): one cooperative launch per call and
// slice of the batch (ops/kernels/lstm.py:fwd_plan with r_itemsize 1).
//   - Block b owns u hidden units and stages their 4u gate columns of the
//     k-packed words of rq (ops/kernels/lstm.py:pack_k4: word (kk, col)
//     holds rq[4kk + i, col] in byte i, which is how the m16n8k32 B
//     fragment holds 4 consecutive k of a column) once per call: in
//     shared memory (4u x H bytes, 32 KB at H 1024, u 8), or, where no
//     partition fits that, in a global scratch read from L2 (RES).
//   - The owners write h_t in float32 to an exchange buffer ([2][np][kp]
//     by step parity: quantization needs the exact h), and each block's
//     per-row max of |h_t| over its units to a partial-amax buffer
//     ([2][np][grid]) beside it; then a grid barrier.
//   - After the barrier every block folds the grid's partial maxima into
//     the row's hscale (exact: max is order-free) and quantizes h_{t-1}
//     itself as it loads the A fragments (the IEEE quotient's rint, from
//     a reciprocal and one exact correction: quantize1; clip): no second
//     barrier. Padding rows (past N) have h 0 and hscale 1e-12:
//     hq 0.
//   - The product runs on mma.sync.m16n8k32.s8.s8.s32 (M: batch rows
//     padded to 16; N: 8 gate columns; K: H in slabs of 64, split kw ways
//     over the warps). Thread (g = lane / 4, c = lane % 4) loads 16 bytes
//     of column g's words at slab word 4c (k 16c .. 16c + 15) and quantizes
//     the same 16 k of rows g and g + 8; each 4-k word feeds two
//     m16n8k32 products as the logical k {4c..4c+3, 16+4c..16+4c+3}: A and
//     B take the same permutation of the slab's 64 k, so the int32 sum is
//     unchanged. The kw partial sums meet in shared memory.
//   - The owner of each (row, unit) keeps c in registers and runs the
//     epilogue with the exact operation order of the twin.
// Traps (those of lstm_persistent.cuh): the exchange buffer and the
// partial maxima are written and read by different blocks within the
// launch, so both are read with ld.global.cg after the barrier, ordered by
// the same fence and barrier.

#include "lstm_persistent.cuh"

namespace {

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x / s from rc = __frcp_rn(s): q = RN(x rc), corrected once by the
// exact remainder, q' = RN(q + RN(x - q s) rc) (Markstein). Three
// instructions where the IEEE quotient (__fdiv_rn) takes ~15, 16 k of
// them per block and step; q' is within an ulp of the IEEE quotient, and
// almost always equal to it (lstm_seq_int8_quotient_check counts both).
__device__ __forceinline__ float quotient(float x, float s, float rc) {
  const float q = __fmul_rn(x, rc);
  return __fmaf_rn(__fmaf_rn(-q, s, x), rc, q);
}

// Whether q, with rq = rint(q), lies within 2^-13 of a half-integer:
// |x / s| <= 127 (1 + 2^-24) here, where an ulp is at most 2^-17, so
// that is 16 ulps or more.
__device__ __forceinline__ bool near_tie(float q, float rq) {
  return fabsf(q - rq) >= 0.5f - 0x1p-13f;
}

// clip(rint(x / s), +-127) with x / s the IEEE quotient: rint of two
// values an ulp apart differs only where they straddle or touch a
// half-integer, so there the IEEE quotient is taken (the rare case).
__device__ __forceinline__ float quantize1(float x, float s, float rc) {
  const float q = quotient(x, s, rc);
  float rq = rintf(q);
  if (near_tie(q, rq)) rq = rintf(__fdiv_rn(x, s));
  return fminf(fmaxf(rq, -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t mix64(uint64_t v) {
  v ^= v >> 33;
  v *= 0xff51afd7ed558ccdull;
  v ^= v >> 33;
  v *= 0xc4ceb9fe1a85ec53ull;
  v ^= v >> 33;
  return (uint32_t)v;
}

// quantize1 against the IEEE quotient's clip(rint(.)) on `pairs` (x, s)
// drawn as the kernel meets them: a row max m (mantissa and exponent
// 2^-30 .. 2^10 at random), s = max(m / 127, 1e-12), x in [-m, m] (m
// itself at times). counts: [0] quotients that differ from the IEEE one,
// [1] of them by more than 4 ulps, [2] quantized values that differ,
// [3] pairs that took the IEEE quotient.
__global__ void quotient_check(unsigned long long* counts, unsigned long long pairs) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long c[4] = {0, 0, 0, 0};
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < pairs; i += stride) {
    const uint32_t u1 = mix64(3 * i), u2 = mix64(3 * i + 1), u3 = mix64(3 * i + 2);
    const float m = ldexpf(1.0f + (u2 >> 9) * 0x1p-23f, (int)(u1 % 40) - 30);
    const float s = fmaxf(__fdiv_rn(m, 127.0f), 1e-12f), rc = __frcp_rn(s);
    float x = (u3 & 0xff) == 2 ? m : m * ((u3 >> 8) * 0x1p-24f);
    if (u3 & 1) x = -x;
    const float ieee = __fdiv_rn(x, s), q = quotient(x, s, rc);
    const int ulps = ieee == q ? 0 : abs(__float_as_int(ieee) - __float_as_int(q));
    c[0] += ulps != 0;
    c[1] += ulps > 4;
    c[2] += quantize1(x, s, rc) != fminf(fmaxf(rintf(ieee), -127.0f), 127.0f);
    c[3] += near_tie(q, rintf(q));
  }
  for (int k = 0; k < 4; ++k)
    if (c[k]) atomicAdd(counts + k, c[k]);
}

// 16 consecutive float32 h at p (from the exchange buffer, 16-byte
// aligned) quantized with scale s (reciprocal rc) into 4 words, byte i
// of word w holding hq[4w + i]
__device__ __forceinline__ void quantize16(const float* p, float s, float rc,
                                           uint32_t (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p) + i);
    const float e[4] = {x.x, x.y, x.z, x.w};
    uint32_t word = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float q = quantize1(e[k], s, rc);
      word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * k);
    }
    w[i] = word;
  }
}

struct Int8Args {
  const float* wx;      // [n, T, 4H]
  const int* rw;        // [ceil(H/4), 4H] k-packed int8 words of rq
  const float* rscale;  // [4H]
  const float* h0;      // [n, H]
  const float* c0;      // [n, H]
  float* y;             // [n, T, H]
  float* yc;            // [n, T, H]
  float* xbuf;          // [2][np][kp] h by step parity, zeroed
  float* amax;          // [2][np][grid] each block's per-row max |h|
  int* rslice;          // !RES: [grid][4 units][rstride] words
  unsigned int* bar;    // grid barrier counter, zeroed on the stream
  int n, t_steps, hdim, np, kp, units, kw, rstride;
};

// Partial int32 products of hq [np, kp] (quantized here from the float32
// exchange buffer x with the rows' scales hsc and their reciprocals
// hsc[np ..]) with the block's staged words rs [4 units][rstride]: warp
// w takes the 64-k slabs w % kw, w % kw + kw, ... of the batch tiles
// w / kw, w / kw + 16 / kw, ...; red[kslice][mt][nt][lane * 4 + i].
template <bool RES>
__device__ void product_int8(const float* x, const float* hsc, const int* rs,
                             int rstride, int* red, int mtiles, int ntiles, int kp,
                             int kw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int slabs = kp / 64, ks = warp % kw, mlanes = WARPS / kw;
  for (int mt = warp / kw; mt < mtiles; mt += mlanes) {
    const float* xlo = x + (size_t)(mt * 16 + g) * kp + 16 * c;
    const float* xhi = xlo + (size_t)8 * kp;
    const float slo = hsc[mt * 16 + g], shi = hsc[mt * 16 + g + 8];
    const float rlo = hsc[mtiles * 16 + mt * 16 + g];
    const float rhi = hsc[mtiles * 16 + mt * 16 + g + 8];
    for (int nt0 = 0; nt0 < ntiles; nt0 += 4) {
      int acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
      for (int s = ks; s < slabs; s += kw) {
        uint32_t lo[4], hi[4];
        quantize16(xlo + s * 64, slo, rlo, lo);
        quantize16(xhi + s * 64, shi, rhi, hi);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint4 b = load_r<RES, uint4>(
              rs + (size_t)((nt0 + nt) * 8 + g) * rstride + s * 16 + 4 * c);
          mma_s8(acc[nt], lo[0], hi[0], lo[1], hi[1], b.x, b.y);
          mma_s8(acc[nt], lo[2], hi[2], lo[3], hi[3], b.z, b.w);
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
__global__ void __launch_bounds__(THREADS, 1) lstm_seq_int8_persistent(Int8Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, H = a.hdim, T = a.t_steps, u = a.units, kp = a.kp, np = a.np;
  const int rstride = a.rstride, g4 = 4 * H, j0 = blockIdx.x * u, grid = gridDim.x;
  const int mtiles = np / 16, ntiles = u / 2, cols = 4 * u;
  int* rs = RES ? reinterpret_cast<int*>(smem)
                : a.rslice + (size_t)blockIdx.x * cols * rstride;
  int* red = reinterpret_cast<int*>(smem + (RES ? (size_t)cols * rstride * 4 : 0));
  // the rows' scales, then their reciprocals; the block's maxima of |h|
  // (as int bits: ordered as the nonnegative floats)
  float* hsc = reinterpret_cast<float*>(red + (size_t)a.kw * mtiles * ntiles * 128);
  int* bmax = reinterpret_cast<int*>(hsc + 2 * np);
  const size_t half = (size_t)np * kp, ahalf = (size_t)np * grid;

  stage_columns<int>(rs, a.rw, (H + 3) / 4, kp / 4, rstride, H, u, j0);
  for (int r = threadIdx.x; r < np; r += THREADS) bmax[r] = 0;
  __syncthreads();

  // the pairs this thread owns: c in registers; h0 to parity 1
  float carry[MAXC];
#pragma unroll
  for (int q = 0; q < MAXC; ++q) {
    int b, jj;
    owner(q, u, b, jj);
    const int j = j0 + jj;
    carry[q] = 0.0f;
    if (b < n && j < H) {
      carry[q] = a.c0[(size_t)b * H + j];
      const float h = a.h0[(size_t)b * H + j];
      a.xbuf[half + (size_t)b * kp + j] = h;
      atomicMax(&bmax[b], __float_as_int(fabsf(h)));
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += THREADS)
    a.amax[ahalf + (size_t)r * grid + blockIdx.x] = __int_as_float(bmax[r]);
  unsigned int target = grid;
  grid_sync(a.bar, target);

  // the column scales of the first PRE pairs, for the whole call
  float csc[PRE][4];
#pragma unroll
  for (int q = 0; q < PRE; ++q) {
    int b, jj;
    owner(q, u, b, jj);
    if (b < n && j0 + jj < H) {
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) csc[q][gate] = a.rscale[gate * H + j0 + jj];
    }
  }

  const size_t seq = (size_t)T * H, gseq = (size_t)T * g4;
  for (int t = 0; t < T; ++t) {
    const int src = (t + 1) & 1;
    // this step's projections of the first PRE pairs, loaded ahead of the
    // fold and the product
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
    // each row's scale from the grid's partial maxima (warp w: rows w,
    // w + 16, ...); padding rows get 1 (their h is 0); the block's maxima
    // restart for this step
    {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int r = warp; r < np; r += WARPS) {
        float m = 0.0f;
        if (r < n) {
          const float* p = a.amax + src * ahalf + (size_t)r * grid;
          for (int k = lane; k < grid; k += 32) m = fmaxf(m, __ldcg(p + k));
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        }
        if (lane == 0) {
          const float sc = r < n ? fmaxf(__fdiv_rn(m, 127.0f), 1e-12f) : 1.0f;
          hsc[r] = sc;
          hsc[np + r] = __frcp_rn(sc);
          bmax[r] = 0;
        }
      }
    }
    __syncthreads();
    product_int8<RES>(a.xbuf + (size_t)src * half, hsc, rs, rstride, red, mtiles, ntiles,
                      kp, a.kw);
    __syncthreads();
    float* xo = a.xbuf + (size_t)(t & 1) * half;
#pragma unroll
    for (int q = 0; q < MAXC; ++q) {
      int b, jj;
      owner(q, u, b, jj);
      const int j = j0 + jj;
      if (b >= n || j >= H) continue;
      const float s = hsc[b];
      const float* w = a.wx + b * gseq + (size_t)t * g4 + j;
      float v[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        int mt, nt;
        const int slot = tile_slot(b, gate * u + jj, mt, nt);
        int sum = 0;
        for (int k = 0; k < a.kw; ++k)
          sum += red[((size_t)(k * mtiles + mt) * ntiles + nt) * 128 + slot];
        const float cs = q < PRE ? csc[q < PRE ? q : 0][gate] : a.rscale[gate * H + j];
        const float wv = q < PRE ? in[q < PRE ? q : 0][gate] : w[(size_t)gate * H];
        v[gate] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(sum), s), cs), wv);
      }
      const float ig = sigmoid_rn(v[0]);
      const float gg = tanhf(v[1]);
      const float fg = sigmoid_rn(v[2]);
      const float og = sigmoid_rn(v[3]);
      const float cn = __fadd_rn(__fmul_rn(fg, carry[q]), __fmul_rn(ig, gg));
      const float hn = __fmul_rn(og, tanhf(cn));
      carry[q] = cn;
      const size_t hi = b * seq + (size_t)t * H + j;
      a.y[hi] = hn;
      a.yc[hi] = cn;
      xo[(size_t)b * kp + j] = hn;
      atomicMax(&bmax[b], __float_as_int(fabsf(hn)));
    }
    if (t + 1 < T) {
      __syncthreads();
      for (int r = threadIdx.x; r < n; r += THREADS)
        a.amax[(size_t)(t & 1) * ahalf + (size_t)r * grid + blockIdx.x] =
            __int_as_float(bmax[r]);
      target += grid;
      grid_sync(a.bar, target);
    }
  }
}

}  // namespace

extern "C" {

// One cooperative launch of `grid` blocks of `units` hidden units each (a
// multiple of 8, grid * units >= h) on `stream`, K split `kw` ways (1, 2,
// 4, 8 or 16), the slice of rw in shared memory (resident != 0) or in
// rslice. Device pointers: wx [n, t_steps, 4h] f32; rw [ceil(h/4), 4h]
// int32, the k-packed int8 recurrent matrix; rscale [4h] f32; h0, c0
// [n, h] f32; y, yc [n, t_steps, h] f32 receive every h_t and c_t;
// xbuf [2, np, kp] f32, zeroed (np = n rounded up to 16, kp = h rounded
// up to 64); amax [2, np, grid] f32; rslice [grid, 4 units, rstride]
// int32 when not resident (else null); bar one counter, zeroed on the
// stream here.
// Returns 0, or the cudaError_t of the call that failed
// (cudaErrorCooperativeLaunchTooLarge: the grid cannot be co-resident).
int lstm_seq_int8_forward(const void* wx, const void* rw, const void* rscale,
                          const void* h0, const void* c0, void* y, void* yc, void* xbuf,
                          void* amax, void* rslice, void* bar, int n, int t_steps,
                          int hdim, int grid, int units, int kw, int resident,
                          void* stream) {
  if (!fwd_args_ok(n, t_steps, hdim, grid, units, kw, resident, rslice)) {
    return (int)cudaErrorInvalidValue;
  }
  Int8Args a;
  a.wx = static_cast<const float*>(wx);
  a.rw = static_cast<const int*>(rw);
  a.rscale = static_cast<const float*>(rscale);
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.y = static_cast<float*>(y);
  a.yc = static_cast<float*>(yc);
  a.xbuf = static_cast<float*>(xbuf);
  a.amax = static_cast<float*>(amax);
  a.rslice = static_cast<int*>(rslice);
  a.bar = static_cast<unsigned int*>(bar);
  a.n = n;
  a.t_steps = t_steps;
  a.hdim = hdim;
  a.np = (n + 15) / 16 * 16;
  a.kp = fwd_kpad(hdim, 1);
  a.units = units;
  a.kw = kw;
  a.rstride = fwd_rstride(a.kp, 1);
  const size_t smem = fwd_smem_bytes(n, a.kp, units, kw, resident != 0, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      resident ? launch_cooperative(lstm_seq_int8_persistent<true>, a, a.bar, grid, smem, s)
               : launch_cooperative(lstm_seq_int8_persistent<false>, a, a.bar, grid, smem,
                                    s);
  return (int)err;
}

// Runs quotient_check on `pairs` pairs into counts [4] (device memory,
// zeroed by the caller) on `stream`. Returns 0 or the launch's error.
int lstm_seq_int8_quotient_check(void* counts, long long pairs, void* stream) {
  quotient_check<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts), (unsigned long long)pairs);
  return (int)cudaGetLastError();
}

const char* lstm_seq_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
