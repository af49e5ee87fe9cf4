// The gated FFN's activations on the gate half, f32 in and out, in the
// order of operations of the TPU kernels (ggml_hexagon_tpu/ops/qmm_qp8.py
// `_apply_act_f32`, qmm_fast.py `_apply_act`, ffn_fused.py `_act`):
//   silu  g * sigmoid(g)
//   gelu  0.5 * g * (1 + tanh(0.7978845608028654 * (g + 0.044715 * g * g * g)))
//   relu  max(g, 0)
// Each is a template instance: a kernel picks one by a uniform choice (a
// launch's, or a prologue task's of eight values), never in its weight loop.  gelu's
// products and sums are rounded one at a time (no fused multiply-add, as
// XLA and PyTorch compute them), and tanhf / expf are the accurate library
// functions (the build has no --use_fast_math).  Included by qp8_gemv.cu
// (K1), il_gemv.cuh (K6, K9) and fast_il_gemm.cu (K6 above 8 rows).
#pragma once

// the C entries' `act` ids (kernels.ACT_IDS)
constexpr int ACT_SILU = 0, ACT_GELU = 1, ACT_RELU = 2;

template <int ACT>
__device__ __forceinline__ float act_f(float g) {
  if constexpr (ACT == ACT_GELU) {
    const float g3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, g), g), g);
    const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(g, g3)));
    return __fmul_rn(__fmul_rn(0.5f, g), __fadd_rn(1.f, t));
  } else if constexpr (ACT == ACT_RELU) {
    return fmaxf(g, 0.f);
  } else {
    return g * (1.f / (1.f + expf(-g)));
  }
}

// act(g) * u
template <int ACT>
__device__ __forceinline__ float act_mul(float g, float u) {
  return act_f<ACT>(g) * u;
}

// v[i] = act(v[i]) * u[i], eight values of a task (K1's prologue, K6's
// activation build)
template <int ACT>
__device__ __forceinline__ void act_mul8(float v[8], const float u[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = act_mul<ACT>(v[i], u[i]);
}
