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
// direction: the persistent forward of csrc/lstm_persistent.cuh, which
// kernel D shares (with v streamed) and kernel C follows with int8 R.
// One cooperative launch per call and slice of the batch; block b owns
// 8 (or more) hidden units and keeps their 4u gate columns of R in shared
// memory (4u x H x 2 B, 64 KB at H 1024, u 8) or, past that, in a global
// scratch read from L2; bf16(h) is exchanged through L2 by step parity
// under a grid barrier; the product runs on mma.sync.m16n8k16.

#include "lstm_persistent.cuh"

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
  if (!fwd_args_ok(n, t_steps, hdim, grid, units, kw, resident, rslice) ||
      (yc == nullptr && c_t == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  FwdArgs a;
  a.wx = static_cast<const float*>(wx);
  a.r = r;
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.y = static_cast<float*>(y);
  a.yc = static_cast<float*>(yc);
  a.c_t = static_cast<float*>(c_t);
  a.v = nullptr;
  a.xbuf = xbuf;
  a.rslice = rslice;
  a.bar = static_cast<unsigned int*>(bar);
  a.n = n;
  a.t_steps = t_steps;
  a.hdim = hdim;
  a.units = units;
  a.kw = kw;
  return (int)launch_fwd<bf16>(a, grid, resident != 0,
                               static_cast<cudaStream_t>(stream));
}

const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
