// Fused MLP + derivative-field propagation (Taylor mode), fp32, for sm_90a.
//
// Replaces hpvpinns_tpu/ops/pallas_fields.py::_fields_kernel (launched by
// _pallas_fields_flat).  For every point it computes the network value u and,
// per input axis k < n_dirs, u_k (and u_kk when SECOND) by propagating the
// streams (h, h_k[, h_kk]) through the layers:
//   z = h W + b, z_k = h_k W, z_kk = h_kk W,
//   h' = act(z), h_k' = act'(z) z_k, h_kk' = act''(z) z_k^2 + act'(z) z_kk,
// with a linear last layer.  Output: [P, F] row-major, F = 1 + n_dirs * (1 or
// 2), columns u, u_1..u_n, then u_11..u_nn.
//
// Design.  One block takes kBlockPoints points and holds the whole network
// (every W [in, out] and b, packed back to back) in shared memory, plus two
// ping-pong buffers of the streams laid out [stream][neuron][point] so a
// warp (32 points, one neuron) reads and writes 32 consecutive words.  The
// block's threads are kBlockPoints x kGroups: thread (p, g) computes the
// output neurons j = g, g + kGroups, ... of point p, one j at a time, with
// one fp32 FMA chain per stream; the weight W[i, j] it reads is the same
// word for the whole warp (a broadcast).  No TPU layout is carried over: no
// 128-lane padding and no one-tile output packing.
//
// What bounds it on the card.  The slice's networks are tiny (widths 20 and
// 48, d = 2): a step is about 0.1 GFLOP, so the card's FMA rate is not the
// limit.  Inside the inner loop each FMA reads its input from shared memory
// (S + 1 loads for S FMAs), so the kernel is bound by shared-memory
// bandwidth and by latency at these small point counts (16,384 and 4,096
// points give 512 and 128 blocks for 132 SMs).  What the design does about
// it: every intermediate stays on chip (device memory sees X once and the
// [P, F] output once), and one launch replaces the plain version's ~10
// launches per layer.  Register tiling over several neurons per thread is
// the next step when the kernel shows up in a profile.
//
// Precision: IEEE fp32 throughout; build without --use_fast_math, so tanhf,
// sincosf are the accurate library functions.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxWidth = 64;
constexpr int kBlockPoints = 32;
constexpr int kGroups = 8;

struct Widths {
  int n_layers;
  int w[kMaxLayers + 1];
};

template <int ACT>
__device__ __forceinline__ void act_derivs(float z, float& a, float& d1, float& d2) {
  if (ACT == 0) {  // tanh
    const float t = tanhf(z);
    a = t;
    d1 = 1.0f - t * t;
    d2 = -2.0f * t * d1;
  } else {  // sin
    float s, c;
    sincosf(z, &s, &c);
    a = s;
    d1 = c;
    d2 = -s;
  }
}

template <int ND, bool SECOND, int ACT>
__global__ void __launch_bounds__(kBlockPoints * kGroups)
fused_fields_kernel(const float* __restrict__ X, const float* __restrict__ params,
                    const Widths wd, const int n_params, const int max_w, const int P,
                    float* __restrict__ out) {
  constexpr int S = 1 + ND * (SECOND ? 2 : 1);  // streams = output columns
  extern __shared__ float smem[];
  float* wsm = smem;
  float* hin = smem + n_params;
  float* hout = hin + S * max_w * kBlockPoints;

  const int tx = threadIdx.x;  // point within the block
  const int ty = threadIdx.y;  // output-neuron group
  const int tid = ty * kBlockPoints + tx;
  constexpr int kThreads = kBlockPoints * kGroups;
  const int p0 = blockIdx.x * kBlockPoints;
  const int d = wd.w[0];

  for (int i = tid; i < n_params; i += kThreads) wsm[i] = params[i];

  // Seed the streams: h = x, h_k = e_k, h_kk = 0.
  for (int idx = tid; idx < S * d * kBlockPoints; idx += kThreads) {
    const int p = idx % kBlockPoints;
    const int i = (idx / kBlockPoints) % d;
    const int s = idx / (kBlockPoints * d);
    float v = 0.0f;
    if (s == 0) {
      const int gp = p0 + p;
      v = gp < P ? X[(size_t)gp * d + i] : 0.0f;
    } else if (s <= ND) {
      v = (i == s - 1) ? 1.0f : 0.0f;
    }
    hin[(s * max_w + i) * kBlockPoints + p] = v;
  }
  __syncthreads();

  const float* Wl = wsm;
  for (int l = 0; l < wd.n_layers; ++l) {
    const int din = wd.w[l];
    const int dout = wd.w[l + 1];
    const float* bl = Wl + din * dout;
    const bool last = l == wd.n_layers - 1;
    for (int j = ty; j < dout; j += kGroups) {
      float acc[S];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < din; ++i) {
        const float w = Wl[i * dout + j];
#pragma unroll
        for (int s = 0; s < S; ++s)
          acc[s] = fmaf(hin[(s * max_w + i) * kBlockPoints + tx], w, acc[s]);
      }
      const float z = acc[0] + bl[j];
      if (last) {  // linear output layer; dout == 1, so j == 0
        const int gp = p0 + tx;
        if (gp < P) {
          float* o = out + (size_t)gp * S;
          o[0] = z;
#pragma unroll
          for (int s = 1; s < S; ++s) o[s] = acc[s];
        }
      } else {
        float a, d1, d2;
        act_derivs<ACT>(z, a, d1, d2);
        hout[j * kBlockPoints + tx] = a;
#pragma unroll
        for (int k = 0; k < ND; ++k) {
          const float zk = acc[1 + k];
          hout[((1 + k) * max_w + j) * kBlockPoints + tx] = d1 * zk;
          if (SECOND) {
            const float zkk = acc[1 + ND + k];
            hout[((1 + ND + k) * max_w + j) * kBlockPoints + tx] = d2 * zk * zk + d1 * zkk;
          }
        }
      }
    }
    __syncthreads();
    float* t = hin;
    hin = hout;
    hout = t;
    Wl = bl + dout;
  }
}

template <int ND, bool SECOND, int ACT>
cudaError_t launch(const float* X, const float* params, const Widths& wd, int n_params,
                   int max_w, int P, float* out, size_t smem, cudaStream_t stream) {
  auto kernel = fused_fields_kernel<ND, SECOND, ACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kBlockPoints, kGroups);
  const dim3 grid((P + kBlockPoints - 1) / kBlockPoints);
  kernel<<<grid, block, smem, stream>>>(X, params, wd, n_params, max_w, P, out);
  return cudaGetLastError();
}

template <int ND, bool SECOND>
cudaError_t launch_act(int act, const float* X, const float* params, const Widths& wd,
                       int n_params, int max_w, int P, float* out, size_t smem,
                       cudaStream_t stream) {
  return act == 0 ? launch<ND, SECOND, 0>(X, params, wd, n_params, max_w, P, out, smem, stream)
                  : launch<ND, SECOND, 1>(X, params, wd, n_params, max_w, P, out, smem, stream);
}

}  // namespace

extern "C" {

int hp_fused_fields_max_width() { return kMaxWidth; }
int hp_fused_fields_max_layers() { return kMaxLayers; }

// Shared memory (bytes) one block needs: the packed network plus two stream
// buffers.  The wrapper checks it against the card's limit before launching.
long long hp_fused_fields_smem_bytes(int n_params, int max_w, int n_dirs, int second) {
  const int S = 1 + n_dirs * (second ? 2 : 1);
  return (long long)sizeof(float) * (n_params + 2LL * S * max_w * kBlockPoints);
}

// The most shared memory one block may opt in to on `device` (-1 on error).
int hp_fused_fields_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// X [P, widths[0]] and out [P, 1 + n_dirs * (second ? 2 : 1)] are row-major
// fp32 on device `device`; params packs W_0 [in, out], b_0, W_1, b_1, ...
// back to back; widths (host memory) has n_layers + 1 entries and ends in 1.
// activation: 0 = tanh, 1 = sin.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 on success).
int hp_fused_fields_f32(const float* X, const float* params, const int* widths, int n_layers,
                        int P, int n_dirs, int second, int activation, float* out, int device,
                        void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_dirs < 1 || n_dirs > 3 || P < 1 ||
      activation < 0 || activation > 1 || widths[n_layers] != 1 || n_dirs > widths[0])
    return (int)cudaErrorInvalidValue;
  Widths wd;
  wd.n_layers = n_layers;
  int n_params = 0;
  int max_w = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || widths[l] > kMaxWidth) return (int)cudaErrorInvalidValue;
    wd.w[l] = widths[l];
    if (l < n_layers) {
      n_params += widths[l] * widths[l + 1] + widths[l + 1];
      if (widths[l] > max_w) max_w = widths[l];
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)hp_fused_fields_smem_bytes(n_params, max_w, n_dirs, second);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_dirs * 2 + (second ? 1 : 0)) {
    case 2: return (int)launch_act<1, false>(activation, X, params, wd, n_params, max_w, P, out, smem, s);
    case 3: return (int)launch_act<1, true>(activation, X, params, wd, n_params, max_w, P, out, smem, s);
    case 4: return (int)launch_act<2, false>(activation, X, params, wd, n_params, max_w, P, out, smem, s);
    case 5: return (int)launch_act<2, true>(activation, X, params, wd, n_params, max_w, P, out, smem, s);
    case 6: return (int)launch_act<3, false>(activation, X, params, wd, n_params, max_w, P, out, smem, s);
    default: return (int)launch_act<3, true>(activation, X, params, wd, n_params, max_w, P, out, smem, s);
  }
}

}  // extern "C"
