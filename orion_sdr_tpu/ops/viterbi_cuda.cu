// Soft-decision Viterbi ACS + traceback for the rate-1/2 shift-register
// convolutional codes (K <= 7), one warp per trellis lane, called from JAX
// through the XLA FFI (orion_sdr_tpu/ops/viterbi.py builds and registers it).
//
// Semantics are those of the plain scan in orion_sdr_tpu/fec/conv.py,
// operation for operation, so the bits agree exactly:
//   cand[ns][z] = (pm[prev(ns, z)] + s0[ns][z] * l0[t]) + s1[ns][z] * l1[t]
//   dec[ns]     = cand[ns][1] > cand[ns][0]        (first max wins ties)
//   pm'[ns]     = max(cand[ns][0], cand[ns][1])
//   chunked:    pm' -= max_ns pm'                  (every step)
// with prev(ns, z) = ((ns & (H - 1)) << 1) | z and H = S / 2. The traceback
// starts at state 0 (terminated trellis) or at the lowest-index argmax of
// the final metrics (chunked fixed-lag decode) and emits the state's top bit.
//
// Layout: thread j of the warp holds the metrics of states j and j + H. Both
// are reached from predecessors 2j and 2j + 1 (a radix-2 butterfly), which
// the warp exchanges with shuffles. Each step's decisions pack into two
// 32-bit ballots kept in shared memory (8 bytes per step and lane), and the
// traceback runs in the same kernel. LLRs are read 32 steps at a time,
// one step per thread, and broadcast with shuffles.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;      // opt-in shared memory per block
constexpr int kSmemDefault = 48 * 1024; // without the opt-in attribute
constexpr int kMaxWarps = 8;

__device__ __forceinline__ float sgn(unsigned window, unsigned g) {
  return 1.0f - 2.0f * static_cast<float>(__popc(window & g) & 1);
}

__global__ void viterbi_kernel(const float* __restrict__ l0,
                               const float* __restrict__ l1,
                               const float* __restrict__ pm0,
                               uint8_t* __restrict__ bits, int64_t n_lanes,
                               int n_steps, int K, unsigned g0, unsigned g1,
                               int terminated) {
  extern __shared__ uint2 dec_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= n_lanes) return;  // uniform across the warp
  uint2* dec = dec_all + static_cast<size_t>(warp) * n_steps;

  const int top = K - 2;
  const int H = 1 << top;          // half the state count
  const int j = lane & (H - 1);    // lanes >= H mirror lane j
  const int S = 2 * H;

  // branch signs of the four branches into states j (b = 0) and j + H (b = 1)
  float s0[2][2], s1[2][2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const unsigned w = (static_cast<unsigned>(b) << (K - 1)) |
                         (static_cast<unsigned>(j) << 1) | z;
      s0[b][z] = sgn(w, g0);
      s1[b][z] = sgn(w, g1);
    }
  }
  // predecessor 2j (and 2j + 1) lives in lane (2j) & (H - 1), in its
  // upper half when 2j >= H
  const int src = (2 * j) & (H - 1);
  const bool from_hi = 2 * j >= H;

  float lo = pm0[row * S + j];
  float hi = pm0[row * S + j + H];

  const float* r0 = l0 + row * n_steps;
  const float* r1 = l1 + row * n_steps;
  float cur_a = lane < n_steps ? r0[lane] : 0.0f;
  float cur_b = lane < n_steps ? r1[lane] : 0.0f;

  for (int t0 = 0; t0 < n_steps; t0 += 32) {
    const int nxt = t0 + 32 + lane;
    const float nxt_a = nxt < n_steps ? r0[nxt] : 0.0f;
    const float nxt_b = nxt < n_steps ? r1[nxt] : 0.0f;
    const int n = min(32, n_steps - t0);
    for (int k = 0; k < n; ++k) {
      const float la = __shfl_sync(kFull, cur_a, k);
      const float lb = __shfl_sync(kFull, cur_b, k);
      const float e_lo = __shfl_sync(kFull, lo, src);
      const float e_hi = __shfl_sync(kFull, hi, src);
      const float o_lo = __shfl_sync(kFull, lo, src + 1);
      const float o_hi = __shfl_sync(kFull, hi, src + 1);
      const float pe = from_hi ? e_hi : e_lo;   // pm[2j]
      const float po = from_hi ? o_hi : o_lo;   // pm[2j + 1]

      const float a0 = __fadd_rn(__fadd_rn(pe, s0[0][0] * la), s1[0][0] * lb);
      const float a1 = __fadd_rn(__fadd_rn(po, s0[0][1] * la), s1[0][1] * lb);
      const float b0 = __fadd_rn(__fadd_rn(pe, s0[1][0] * la), s1[1][0] * lb);
      const float b1 = __fadd_rn(__fadd_rn(po, s0[1][1] * la), s1[1][1] * lb);
      const bool d_lo = a1 > a0;
      const bool d_hi = b1 > b0;
      lo = d_lo ? a1 : a0;
      hi = d_hi ? b1 : b0;
      const unsigned w_lo = __ballot_sync(kFull, d_lo);
      const unsigned w_hi = __ballot_sync(kFull, d_hi);
      if (!terminated) {
        float m = fmaxf(lo, hi);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        lo = __fsub_rn(lo, m);
        hi = __fsub_rn(hi, m);
      }
      if (lane == 0) dec[t0 + k] = make_uint2(w_lo, w_hi);
    }
    cur_a = nxt_a;
    cur_b = nxt_b;
  }

  // traceback start: state 0, or the lowest-index argmax of the metrics
  int state = 0;
  if (!terminated) {
    float v = lo;
    int idx = j;
    if (hi > lo) {
      v = hi;
      idx = j + H;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(kFull, v, off);
      const int i2 = __shfl_xor_sync(kFull, idx, off);
      if (v2 > v || (v2 == v && i2 < idx)) {
        v = v2;
        idx = i2;
      }
    }
    state = idx;
  }
  __syncwarp();
  if (lane != 0) return;
  uint8_t* out = bits + row * n_steps;
  for (int t = n_steps - 1; t >= 0; --t) {
    out[t] = static_cast<uint8_t>((state >> top) & 1);
    const uint2 w = dec[t];
    const unsigned word = state >= H ? w.y : w.x;
    const int z = (word >> (state & (H - 1))) & 1;
    state = ((state & (H - 1)) << 1) | z;
  }
}

ffi::Error ViterbiImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> l0,
                       ffi::Buffer<ffi::F32> l1, ffi::Buffer<ffi::F32> pm0,
                       ffi::ResultBuffer<ffi::U8> bits, int32_t K, int32_t g0,
                       int32_t g1, int32_t terminated) {
  const auto d = l0.dimensions();
  if (d.size() != 2 || !(l1.dimensions() == d))
    return ffi::Error::InvalidArgument("l0 and l1 must both be (L, T)");
  if (K < 3 || K > 7)
    return ffi::Error::InvalidArgument("constraint length must be 3..7");
  const int64_t n_lanes = d[0];
  const int64_t n_steps = d[1];
  const auto dp = pm0.dimensions();
  if (dp.size() != 2 || dp[0] != n_lanes ||
      dp[1] != (int64_t{1} << (K - 1)))
    return ffi::Error::InvalidArgument("pm0 must be (L, 2^(K-1))");
  if (n_lanes == 0 || n_steps == 0) return ffi::Error::Success();
  const int64_t per_warp = n_steps * static_cast<int64_t>(sizeof(uint2));
  if (per_warp > kSmemLimit)
    return ffi::Error::InvalidArgument("trellis longer than shared memory");
  int warps = static_cast<int>(kSmemDefault / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = static_cast<size_t>(warps * per_warp);
  if (smem > static_cast<size_t>(kSmemDefault)) {
    cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  }
  const int64_t blocks = (n_lanes + warps - 1) / warps;
  viterbi_kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem, stream>>>(
      l0.typed_data(), l1.typed_data(), pm0.typed_data(),
      bits->typed_data(), n_lanes, static_cast<int>(n_steps), K,
      static_cast<unsigned>(g0), static_cast<unsigned>(g1), terminated);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(OrionViterbi, ViterbiImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("K")
                                  .Attr<int32_t>("g0")
                                  .Attr<int32_t>("g1")
                                  .Attr<int32_t>("terminated"));
