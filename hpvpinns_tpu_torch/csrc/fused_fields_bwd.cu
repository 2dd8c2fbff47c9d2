// Backward of the fused MLP + derivative-field propagation (B2), fp32, sm_90a.
//
// Replaces hpvpinns_tpu/ops/pallas_fields.py::_fields_bwd_kernel (launched by
// _pallas_fields_bwd, the custom VJP of fields_flat for second=True).  Given
// the cotangent g [P, S] of every field column (S = 1 + 2 n_dirs: u, u_k,
// u_kk), it returns the gradient of sum(g * fields) with respect to every
// W_l, b_l and (optionally) X.
//
// Per point block: replay the forward (z = h W + b, z_k = h_k W,
// z_kk = h_kk W; h' = act(z), h_k' = act'(z) z_k,
// h_kk' = act''(z) z_k^2 + act'(z) z_kk), stashing z, z_k, z_kk of every
// hidden layer, then run the reverse chain (pallas_fields.py:246-253):
//   gz     = d1 gh + sum_k d2 z_k gh_k + (d3 z_k^2 + d2 z_kk) gh_kk
//   gz_k   = d1 gh_k + 2 d2 z_k gh_kk
//   gz_kk  = d1 gh_kk
//   gW    += h^T gz + sum_k (h_k^T gz_k + h_kk^T gz_kk);  gb += colsum gz
//   gh     = gz W^T,  gh_k = gz_k W^T,  gh_kk = gz_kk W^T
// with d_i = act^(i)(z) and a linear last layer whose gz is g itself.  Each
// layer's input streams are recomputed from the stashed z of the layer below
// (as the TPU kernel does, :358-365), so the stash holds S floats per hidden
// neuron and point; gX = gh of the input layer (the tangent seeds are
// constants).
//
// Design.  One block takes kBlockPoints = 16 points and holds the packed
// network, the stash [Lh][S][width][point] and three stream buffers in shared
// memory.  Sixteen points, not B1's 32: at poisson2d_quality widths
// (2,48,48,48,48,1) with n_dirs 2 the stash alone is 5 * 4 * 48 = 960 floats a
// point, so 32 points would need ~245 KB of the card's 227 KB per block; 16
// need ~143 KB.  The stash is kept on chip rather than in device memory
// because every stashed value is read back once per layer by the same block;
// the wrapper raises when a network does not fit.  Within a buffer the
// neuron stride is kPointStride = 17 words (odd), so the gW phase, whose
// lanes walk neurons, hits 32 distinct banks; the point-parallel phases read
// 16 consecutive words per neuron.  Threads are 16 points x 16 neuron groups.
//
// Determinism.  The TPU sums dW/db over points by read-modify-write across a
// sequential grid (:241-244, :328-335).  CUDA blocks run concurrently, so each
// block writes its partial sums to partials[block][param] (summed over its 16
// points in a fixed order) and a second kernel, block_sum_kernel, adds the
// blocks in a fixed order.  No float atomics: the same inputs give
// bit-identical gradients on every run.
//
// What bounds it on the card.  At the slice's shapes the work is ~3x B1's
// FMAs (replay, gW, gh) on the same tiny widths; every FMA takes its operands
// from shared memory, so like B1 it is bound by shared-memory bandwidth and
// latency, not by the fp32 FMA rate or by device memory (X, g, the network
// and gX are read or written once; the partials are n_blocks x n_params
// floats).  Register tiling and tensor cores are later work.
//
// Precision: IEEE fp32 throughout; build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxWidth = 64;
constexpr int kBlockPoints = 16;
constexpr int kPointStride = 17;
constexpr int kGroups = 16;
constexpr int kThreads = kBlockPoints * kGroups;
constexpr int kSumCols = 32;   // block_sum_kernel: parameters per block
constexpr int kSumChunks = 8;  // block_sum_kernel: interleaved chunks of partial rows

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

template <int ACT>
__device__ __forceinline__ void act_derivs3(float z, float& d1, float& d2, float& d3) {
  if (ACT == 0) {  // tanh
    const float t = tanhf(z);
    d1 = 1.0f - t * t;
    d2 = -2.0f * t * d1;
    d3 = -2.0f * d1 * (1.0f - 3.0f * t * t);
  } else {  // sin
    float s, c;
    sincosf(z, &s, &c);
    d1 = c;
    d2 = -s;
    d3 = -c;
  }
}

// Word offset of neuron j of stream s in a stream buffer; point p adds p.
__device__ __forceinline__ int at(int s, int j, int max_w) {
  return (s * max_w + j) * kPointStride;
}

// Input streams of layer 0: h = x, h_k = e_k, h_kk = 0.
template <int ND>
__device__ void seed_inputs(const float* __restrict__ X, int d, int p0, int P, int max_w,
                            float* h, int tid) {
  constexpr int S = 1 + 2 * ND;
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
    h[at(s, i, max_w) + p] = v;
  }
}

// Output streams of a hidden layer from its stashed pre-activations:
// h = act(z), h_k = d1 z_k, h_kk = d2 z_k^2 + d1 z_kk.  Thread (tx, ty) takes
// point tx and neurons ty, ty + kGroups, ...
template <int ND, int ACT>
__device__ __forceinline__ void activate(const float* st, int width, int max_w, float* h, int tx,
                                         int ty) {
  for (int j = ty; j < width; j += kGroups) {
    float a, d1, d2;
    act_derivs<ACT>(st[at(0, j, max_w) + tx], a, d1, d2);
    h[at(0, j, max_w) + tx] = a;
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      const float zk = st[at(1 + k, j, max_w) + tx];
      const float zkk = st[at(1 + ND + k, j, max_w) + tx];
      h[at(1 + k, j, max_w) + tx] = d1 * zk;
      h[at(1 + ND + k, j, max_w) + tx] = d2 * zk * zk + d1 * zkk;
    }
  }
}

template <int ND, int ACT>
__global__ void __launch_bounds__(kThreads)
fused_fields_bwd_kernel(const float* __restrict__ X, const float* __restrict__ G,
                        const float* __restrict__ params, const Widths wd, const int n_params,
                        const int max_w, const int P, float* __restrict__ partials,
                        float* __restrict__ gX) {
  constexpr int S = 1 + 2 * ND;  // streams = field columns
  extern __shared__ float smem[];
  const int L = wd.n_layers;
  const int buf = S * max_w * kPointStride;  // floats in one stream buffer
  float* wsm = smem;
  float* stash = wsm + n_params;  // [L - 1][S][max_w][kPointStride]
  float* hin = stash + (L - 1) * buf;
  float* hout = hin + buf;
  float* gh = hout + buf;

  const int tx = threadIdx.x;  // point within the block
  const int ty = threadIdx.y;  // neuron group
  const int tid = ty * kBlockPoints + tx;
  const int p0 = blockIdx.x * kBlockPoints;
  const int d = wd.w[0];

  for (int i = tid; i < n_params; i += kThreads) wsm[i] = params[i];
  seed_inputs<ND>(X, d, p0, P, max_w, hin, tid);
  __syncthreads();

  // ---- forward replay through the hidden layers, stashing z, z_k, z_kk ----
  const float* Wl = wsm;
  for (int l = 0; l < L - 1; ++l) {
    const int din = wd.w[l];
    const int dout = wd.w[l + 1];
    const float* bl = Wl + din * dout;
    float* st = stash + l * buf;
    for (int j = ty; j < dout; j += kGroups) {
      float acc[S];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < din; ++i) {
        const float w = Wl[i * dout + j];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = fmaf(hin[at(s, i, max_w) + tx], w, acc[s]);
      }
      acc[0] += bl[j];
#pragma unroll
      for (int s = 0; s < S; ++s) st[at(s, j, max_w) + tx] = acc[s];
    }
    // Reads only the stash entries this thread has just written.
    activate<ND, ACT>(st, dout, max_w, hout, tx, ty);
    __syncthreads();
    float* t = hin;
    hin = hout;
    hout = t;
    Wl = bl + dout;
  }

  // ---- reverse: hin holds the last layer's input streams; gz <- g ----
  float* gz = hout;
  for (int idx = tid; idx < kBlockPoints * S; idx += kThreads) {
    const int p = idx / S;
    const int s = idx - p * S;
    const int gp = p0 + p;
    gz[at(s, 0, max_w) + p] = gp < P ? G[(size_t)gp * S + s] : 0.0f;
  }
  __syncthreads();

  float* part = partials + (size_t)blockIdx.x * n_params;
  int off = n_params - (wd.w[L - 1] + 1);  // packed offset of W_{L-1}
  for (int l = L - 1; l >= 0; --l) {
    const int din = wd.w[l];
    const int dout = wd.w[l + 1];
    const float* W = wsm + off;
    // gW[i, j] = sum_{s, p} h_s[i, p] gz_s[j, p]; the h_kk streams of the
    // input layer are zero.
    const int s_in = l == 0 ? 1 + ND : S;
    for (int q = tid; q < din * dout; q += kThreads) {
      const int i = q / dout;
      const int j = q - i * dout;
      float acc = 0.0f;
      for (int s = 0; s < s_in; ++s) {
        const float* hs = hin + at(s, i, max_w);
        const float* gs = gz + at(s, j, max_w);
#pragma unroll
        for (int p = 0; p < kBlockPoints; ++p) acc = fmaf(hs[p], gs[p], acc);
      }
      part[off + q] = acc;
    }
    for (int j = tid; j < dout; j += kThreads) {
      const float* gs = gz + at(0, j, max_w);
      float acc = 0.0f;
#pragma unroll
      for (int p = 0; p < kBlockPoints; ++p) acc += gs[p];
      part[off + din * dout + j] = acc;
    }
    if (l == 0) {
      // gX = gz W^T on the value stream only.
      const int gp = p0 + tx;
      if (gX != nullptr && gp < P) {
        for (int i = ty; i < din; i += kGroups) {
          float acc = 0.0f;
          for (int j = 0; j < dout; ++j) acc = fmaf(gz[at(0, j, max_w) + tx], W[i * dout + j], acc);
          gX[(size_t)gp * d + i] = acc;
        }
      }
      break;
    }
    // gh_s = gz_s W^T: cotangents of the streams below.
    for (int i = ty; i < din; i += kGroups) {
      float acc[S];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] = 0.0f;
      for (int j = 0; j < dout; ++j) {
        const float w = W[i * dout + j];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = fmaf(gz[at(s, j, max_w) + tx], w, acc[s]);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) gh[at(s, i, max_w) + tx] = acc[s];
    }
    __syncthreads();

    // Hidden layer l - 1 (output width din): its gz from gh and the stash,
    // and its input streams, recomputed from the layer below.
    const float* st = stash + (l - 1) * buf;
    for (int j = ty; j < din; j += kGroups) {
      float d1, d2, d3;
      act_derivs3<ACT>(st[at(0, j, max_w) + tx], d1, d2, d3);
      float g0 = d1 * gh[at(0, j, max_w) + tx];
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        const float zk = st[at(1 + k, j, max_w) + tx];
        const float zkk = st[at(1 + ND + k, j, max_w) + tx];
        const float ghk = gh[at(1 + k, j, max_w) + tx];
        const float ghkk = gh[at(1 + ND + k, j, max_w) + tx];
        g0 += d2 * zk * ghk + (d3 * zk * zk + d2 * zkk) * ghkk;
        gz[at(1 + k, j, max_w) + tx] = d1 * ghk + 2.0f * d2 * zk * ghkk;
        gz[at(1 + ND + k, j, max_w) + tx] = d1 * ghkk;
      }
      gz[at(0, j, max_w) + tx] = g0;
    }
    if (l == 1) {
      seed_inputs<ND>(X, d, p0, P, max_w, hin, tid);
    } else {
      activate<ND, ACT>(stash + (l - 2) * buf, wd.w[l - 1], max_w, hin, tx, ty);
    }
    __syncthreads();
    off -= wd.w[l - 1] * din + din;
  }
}

// out[k] = sum_b partials[b, k], b in a fixed order: thread (c, k) sums rows
// c, c + kSumChunks, ... and the chunk sums are added in order c = 0, 1, ...
__global__ void __launch_bounds__(kSumCols * kSumChunks)
block_sum_kernel(const float* __restrict__ partials, const int n_rows, const int n,
                 float* __restrict__ out) {
  __shared__ float chunk[kSumChunks][kSumCols];
  const int k = blockIdx.x * kSumCols + threadIdx.x;
  float acc = 0.0f;
  if (k < n)
    for (int b = threadIdx.y; b < n_rows; b += kSumChunks) acc += partials[(size_t)b * n + k];
  chunk[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && k < n) {
    float s = chunk[0][threadIdx.x];
#pragma unroll
    for (int c = 1; c < kSumChunks; ++c) s += chunk[c][threadIdx.x];
    out[k] = s;
  }
}

template <int ND, int ACT>
cudaError_t launch(const float* X, const float* G, const float* params, const Widths& wd,
                   int n_params, int max_w, int P, float* partials, float* gX, size_t smem,
                   cudaStream_t stream) {
  auto kernel = fused_fields_bwd_kernel<ND, ACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kBlockPoints, kGroups);
  const dim3 grid((P + kBlockPoints - 1) / kBlockPoints);
  kernel<<<grid, block, smem, stream>>>(X, G, params, wd, n_params, max_w, P, partials, gX);
  return cudaGetLastError();
}

template <int ND>
cudaError_t launch_act(int act, const float* X, const float* G, const float* params,
                       const Widths& wd, int n_params, int max_w, int P, float* partials,
                       float* gX, size_t smem, cudaStream_t stream) {
  return act == 0
             ? launch<ND, 0>(X, G, params, wd, n_params, max_w, P, partials, gX, smem, stream)
             : launch<ND, 1>(X, G, params, wd, n_params, max_w, P, partials, gX, smem, stream);
}

}  // namespace

extern "C" {

int hp_fused_fields_bwd_max_width() { return kMaxWidth; }
int hp_fused_fields_bwd_max_layers() { return kMaxLayers; }
int hp_fused_fields_bwd_block_points() { return kBlockPoints; }

// Shared memory (bytes) one block needs: the packed network, the stash of the
// n_layers - 1 hidden layers and three stream buffers.  The wrapper checks it
// against the card's limit before launching.
long long hp_fused_fields_bwd_smem_bytes(int n_params, int max_w, int n_layers, int n_dirs) {
  const long long S = 1 + 2 * n_dirs;
  return (long long)sizeof(float) *
         (n_params + (n_layers + 2LL) * S * max_w * kPointStride);
}

// The most shared memory one block may opt in to on `device` (-1 on error).
int hp_fused_fields_bwd_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// X [P, widths[0]] and G [P, 1 + 2 n_dirs] row-major fp32 on device `device`;
// params packs W_0 [in, out], b_0, W_1, b_1, ... back to back (n_params
// floats); widths (host memory) has n_layers + 1 entries and ends in 1.
// Writes partials [ceil(P / 16), n_params] (per-block sums, in the packed
// layout) and, unless gX is null, gX [P, widths[0]].  activation: 0 = tanh,
// 1 = sin.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
int hp_fused_fields_bwd_f32(const float* X, const float* G, const float* params,
                            const int* widths, int n_layers, int P, int n_dirs, int activation,
                            float* partials, float* gX, int device, void* stream) {
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
  const size_t smem = (size_t)hp_fused_fields_bwd_smem_bytes(n_params, max_w, n_layers, n_dirs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_dirs) {
    case 1: return (int)launch_act<1>(activation, X, G, params, wd, n_params, max_w, P, partials, gX, smem, s);
    case 2: return (int)launch_act<2>(activation, X, G, params, wd, n_params, max_w, P, partials, gX, smem, s);
    default: return (int)launch_act<3>(activation, X, G, params, wd, n_params, max_w, P, partials, gX, smem, s);
  }
}

// out [n] = the sum over rows of partials [n_rows, n] (fp32, row-major), in a
// fixed order.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
int hp_block_sum_f32(const float* partials, int n_rows, int n, float* out, int device,
                     void* stream) {
  if (n_rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kSumCols, kSumChunks);
  const dim3 grid((n + kSumCols - 1) / kSumCols);
  block_sum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(partials, n_rows, n,
                                                                          out);
  return cudaGetLastError();
}

}  // extern "C"
