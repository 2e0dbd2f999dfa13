// GPTQ's in-block column sweep (quant/gptq.py): one launch quantizes a
// block of bs <= 128 columns of an (N, K) weight with in-block error
// feedback, for every row at once.
//
// Replaces no TPU kernel: the JAX package compiles this sweep into one XLA
// program (chatglm_q_tpu/quant/gptq.py:_sweep_int8 / _sweep_int4, a
// lax.fori_loop over the block's columns inside a jit), with no pallas_call.
// Run column by column from PyTorch it costs about a dozen launches a column
// (ops/gptq_sweep.py::gptq_sweep_block_plain), some 11.6M for ChatGLM2-6B,
// so the host, not the card, would bound the quantizer.  Here it is one
// launch a block.
//
// The sweep is independent per output row: column j's quantization error
// err = (w_j - qd_j) / Hinv[j, j] updates w_k -= err * Hinv[j, k] for k >= j
// of the same row only.  So a warp owns a row: lane l holds columns l,
// l + 32, l + 64, l + 96 in registers, column j's value reaches every lane
// by one shuffle, and the (bs x bs) block of the upper Cholesky factor of
// H^-1 sits in shared memory (64 KB at bs = 128), read a row at a time
// without bank conflicts.  Blocks of 12 warps walk the rows (grid-stride),
// as many as fit on the card at once (3 an SM: 4,752 rows, N = 4096 in one
// wave), so each block loads the factor once.  Bound: a chain of dependent
// operations per column (a shuffle, two divides, the update), not bytes:
// the block is read once and three (N, bs) f32 outputs written once.  The
// losses are formed after the sweep, off that chain.
//
// The arithmetic is that of the plain version operation for operation, each
// rounded as PyTorch rounds it: __fdiv_rn / __fmul_rn / __fsub_rn keep nvcc
// from contracting a multiply and a subtract into an FMA (PyTorch runs them
// as two kernels), every divide is correctly rounded (the plain version
// divides by 7 through ops/quant.div_exact, not by a reciprocal), and rintf
// rounds half to even as torch.round does.  So the kernel is bit-equal to
// the plain version, on the card and on the CPU.
//
// int8: a fixed per-row scale (the naive pass's).  int4: the scale starts
// at 1 and, at every column j with j % groupsize == 0, becomes
// max(max |w| over the row's current columns j .. j + groupsize - 1 / 7,
// 1e-10); groupsize is a multiple of 32 dividing bs, so a group is whole
// slots of the row's registers, reduced across the warp by shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int SWEEP_MAX_BS = 128;
constexpr int SWEEP_SLOTS = SWEEP_MAX_BS / 32;  // columns a lane holds
constexpr int SWEEP_WARPS = 12;                 // rows a block sweeps at once
constexpr unsigned FULL = 0xffffffffu;

template <bool INT4>
__global__ void __launch_bounds__(SWEEP_WARPS * 32)
    gptq_sweep_kernel(const float* __restrict__ w, int ld_w, const float* __restrict__ hinv,
                      int ld_h, const float* __restrict__ scale_n, float* __restrict__ q_out,
                      float* __restrict__ err_out, float* __restrict__ loss_out,
                      float* __restrict__ scales_out, int N, int bs, int groupsize) {
  extern __shared__ float h_s[];  // bs x bs, row-major
  for (int i = threadIdx.x; i < bs * bs; i += blockDim.x)
    h_s[i] = hinv[(size_t)(i / bs) * ld_h + i % bs];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const float qmax = INT4 ? 7.f : 127.f;
  for (int n = blockIdx.x * SWEEP_WARPS + (threadIdx.x >> 5); n < N;
       n += gridDim.x * SWEEP_WARPS) {
    const float* wr = w + (size_t)n * ld_w;
    // v: the row's current values; at column j, lane j % 32 keeps the value
    // it quantized (wq), the grid value (q) and the error (e) in its slot
    float v[SWEEP_SLOTS], wq[SWEEP_SLOTS], q[SWEEP_SLOTS], e[SWEEP_SLOTS];
#pragma unroll
    for (int s = 0; s < SWEEP_SLOTS; ++s) {
      const int k = s * 32 + lane;
      v[s] = k < bs ? wr[k] : 0.f;
      wq[s] = q[s] = e[s] = 0.f;
    }
    float sc = INT4 ? 1.f : scale_n[n];
#pragma unroll
    for (int s = 0; s < SWEEP_SLOTS; ++s) {
      if (s * 32 >= bs) break;
      if (INT4 && (s * 32) % groupsize == 0) {
        // the group's current columns: slots s .. s + groupsize / 32 - 1
        float m = 0.f;
#pragma unroll
        for (int s2 = s; s2 < SWEEP_SLOTS; ++s2)
          if (s2 * 32 < s * 32 + groupsize) m = fmaxf(m, fabsf(v[s2]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
        sc = fmaxf(__fdiv_rn(m, 7.f), 1e-10f);
        if (lane == 0) scales_out[(size_t)(s * 32 / groupsize) * N + n] = sc;
      }
      const int t_end = min(32, bs - s * 32);
      for (int t = 0; t < t_end; ++t) {
        const int j = s * 32 + t;
        const float wj = __shfl_sync(FULL, v[s], t);
        const float qv = fminf(fmaxf(rintf(__fdiv_rn(wj, sc)), -qmax), qmax);
        const float qd = __fmul_rn(sc, qv);
        const float err = __fdiv_rn(__fsub_rn(wj, qd), h_s[j * bs + j]);
        if (lane == t) {
          wq[s] = wj;
          q[s] = qd;
          e[s] = err;
        }
        const float* hrow = h_s + j * bs;
#pragma unroll
        for (int s2 = s; s2 < SWEEP_SLOTS; ++s2) {
          const int k = s2 * 32 + lane;
          if (k >= j && k < bs) v[s2] = __fsub_rn(v[s2], __fmul_rn(err, hrow[k]));
        }
      }
    }
    // the losses, off the column chain: (w_j - qd_j)^2 / Hinv[j, j]^2
#pragma unroll
    for (int s = 0; s < SWEEP_SLOTS; ++s) {
      const int k = s * 32 + lane;
      if (k < bs) {
        const size_t o = (size_t)n * bs + k;
        const float d = h_s[k * bs + k];
        const float diff = __fsub_rn(wq[s], q[s]);
        q_out[o] = q[s];
        err_out[o] = e[s];
        loss_out[o] = __fdiv_rn(__fmul_rn(diff, diff), __fmul_rn(d, d));
      }
    }
  }
}

template <bool INT4>
int launch_sweep(const float* w, int ld_w, const float* hinv, int ld_h, const float* scale_n,
                 float* q_out, float* err_out, float* loss_out, float* scales_out, int N, int bs,
                 int groupsize, cudaStream_t stream) {
  const int smem = bs * bs * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gptq_sweep_kernel<INT4>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gptq_sweep_kernel<INT4>,
                                                         SWEEP_WARPS * 32, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = min((N + SWEEP_WARPS - 1) / SWEEP_WARPS, per_sm * sms);
  gptq_sweep_kernel<INT4><<<blocks, SWEEP_WARPS * 32, smem, stream>>>(
      w, ld_w, hinv, ld_h, scale_n, q_out, err_out, loss_out, scales_out, N, bs, groupsize);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One block of GPTQ's column sweep.  w: N rows of bs f32 at row stride ld_w
// (a column slice of the (N, K) weight); hinv: the (bs, bs) diagonal block of
// the upper Cholesky factor of H^-1 at row stride ld_h; q_out, err_out,
// loss_out: (N, bs) f32 contiguous (the dequantized grid, the scaled errors,
// the unhalved losses).  int8 (scale_n non-null, (N,) f32): a fixed scale;
// int4 (scale_n null): the group rescale, scales_out (bs / groupsize, N)
// f32.  1 <= bs <= 128; int4: groupsize % 32 == 0 and bs % groupsize == 0
// (checked by the wrapper, ops/gptq_sweep.py).
int chatglm_gptq_sweep(const void* w, int ld_w, const void* hinv, int ld_h, const void* scale_n,
                       void* q_out, void* err_out, void* loss_out, void* scales_out, int N, int bs,
                       int groupsize, void* stream) {
  if (N < 1 || bs < 1 || bs > SWEEP_MAX_BS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(hinv);
  float* qo = static_cast<float*>(q_out);
  float* eo = static_cast<float*>(err_out);
  float* lo = static_cast<float*>(loss_out);
  if (scale_n != nullptr)
    return launch_sweep<false>(wf, ld_w, hf, ld_h, static_cast<const float*>(scale_n), qo, eo, lo,
                               nullptr, N, bs, groupsize, s);
  if (groupsize < 32 || groupsize % 32 || bs % groupsize) return (int)cudaErrorInvalidValue;
  return launch_sweep<true>(wf, ld_w, hf, ld_h, nullptr, qo, eo, lo,
                            static_cast<float*>(scales_out), N, bs, groupsize, s);
}

}  // extern "C"
