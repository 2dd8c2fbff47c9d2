// The per-point rules of B2, the backward of the fused fields (fp32), shared
// by its forms: csrc/fused_fields_bwd.cu (resident) and
// csrc/fused_fields_bwd_layered.cu (layered).  With SECOND they are the JAX
// kernel's rules, hpvpinns_tpu/ops/pallas_fields.py:246-253 and its forward
// replay.  Without it (firsts only: the fields u, u_k) they are the same chain
// with the second-order streams removed (z_kk, h_kk and gz_kk are zero), the
// VJP that the JAX package leaves to XLA (pallas_fields.py:190-196).
//
// A hidden layer's stash holds, per neuron and point, (t or z, z_k[, z_kk]):
// t = tanh(z) for tanh (every derivative is a polynomial of t, so tanhf runs
// once per hidden neuron and point) and z itself for sin (which needs sincosf
// anyway).  streams(ND, SECOND) values a point: 1 + 2 ND, or 1 + ND.
#pragma once

namespace {

// Field columns (streams) of a mode: u, u_k and, with second, u_kk.
__host__ __device__ constexpr int streams(int nd, bool second) { return 1 + nd * (second ? 2 : 1); }

template <int ACT>
__device__ __forceinline__ float stash_value(float z) {
  return ACT == 0 ? tanhf(z) : z;
}

// act(z) and its first two derivatives from the stashed value v.
template <int ACT>
__device__ __forceinline__ void act_derivs(float v, float& a, float& d1, float& d2) {
  if (ACT == 0) {  // tanh: v = t
    a = v;
    d1 = 1.0f - v * v;
    d2 = -2.0f * v * d1;
  } else {  // sin: v = z
    float s, c;
    sincosf(v, &s, &c);
    a = s;
    d1 = c;
    d2 = -s;
  }
}

// The first three derivatives of act from the stashed value v.
template <int ACT>
__device__ __forceinline__ void act_derivs3(float v, float& d1, float& d2, float& d3) {
  if (ACT == 0) {  // tanh: v = t
    d1 = 1.0f - v * v;
    d2 = -2.0f * v * d1;
    d3 = -2.0f * d1 * (1.0f - 3.0f * v * v);
  } else {  // sin: v = z
    float s, c;
    sincosf(v, &s, &c);
    d1 = c;
    d2 = -s;
    d3 = -c;
  }
}

// A hidden layer's output streams at one point from its stashed values v
// (t or z, z_k[, z_kk]): h = act(z), h_k = d1 z_k[, h_kk = d2 z_k^2 + d1 z_kk].
template <int ND, int ACT, bool SECOND>
__device__ __forceinline__ void outputs(const float (&v)[streams(ND, SECOND)], float (&h)[streams(ND, SECOND)]) {
  float a, d1, d2;
  act_derivs<ACT>(v[0], a, d1, d2);
  h[0] = a;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const float zk = v[1 + k];
    h[1 + k] = d1 * zk;
    if constexpr (SECOND) {
      const float zkk = v[1 + ND + k];
      h[1 + ND + k] = d2 * zk * zk + d1 * zkk;
    }
  }
}

// gz of a hidden layer at one point from the cotangents g of its outputs and
// its stashed values v.  With SECOND: gz = d1 gh + sum_k d2 z_k gh_k + (d3
// z_k^2 + d2 z_kk) gh_kk, gz_k = d1 gh_k + 2 d2 z_k gh_kk, gz_kk = d1 gh_kk.
// Firsts only: gz = d1 gh + sum_k d2 z_k gh_k, gz_k = d1 gh_k.
template <int ND, int ACT, bool SECOND>
__device__ __forceinline__ void gz_point(const float (&v)[streams(ND, SECOND)], const float (&g)[streams(ND, SECOND)],
                                         float (&out)[streams(ND, SECOND)]) {
  if constexpr (SECOND) {
    float d1, d2, d3;
    act_derivs3<ACT>(v[0], d1, d2, d3);
    float g0 = d1 * g[0];
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      const float zk = v[1 + k];
      const float zkk = v[1 + ND + k];
      const float ghk = g[1 + k];
      const float ghkk = g[1 + ND + k];
      g0 += d2 * zk * ghk + (d3 * zk * zk + d2 * zkk) * ghkk;
      out[1 + k] = d1 * ghk + 2.0f * d2 * zk * ghkk;
      out[1 + ND + k] = d1 * ghkk;
    }
    out[0] = g0;
  } else {
    float a, d1, d2;
    act_derivs<ACT>(v[0], a, d1, d2);
    float g0 = d1 * g[0];
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      g0 += d2 * v[1 + k] * g[1 + k];
      out[1 + k] = d1 * g[1 + k];
    }
    out[0] = g0;
  }
}

}  // namespace
