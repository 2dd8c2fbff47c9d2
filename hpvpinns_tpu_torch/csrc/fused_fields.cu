// Fused MLP + derivative-field propagation (Taylor mode), B1, fp32, sm_90a.
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
// What bounds it on the H100.  Device memory sees X, the network and the
// [P, F] output once, a few hundred KB: bytes are never the limit.  The work
// is S = F chains of small matrix products per point, in IEEE fp32 FMAs
// outside the tensor cores.  At widths up to 64 a launch is 0.1-0.4 GFLOP
// spread over at most a few hundred blocks, so the time is the instructions
// each warp issues per FMA (shared-memory loads, the accurate tanhf/sincosf)
// and each block's latency through its layers and barriers, not the FMA
// rate.  At widths up to 256 the FMA rate itself and the network's trips
// from L2 to every block bound it.
//
// Design.
// - Register tiles.  A thread owns kJT = 4 consecutive output neurons of one
//   point and keeps their 4 S sums in registers.  Per input i it loads the
//   four weights W[i, j..j+3] as one 16-byte word (a row of W is padded to a
//   multiple of 4 in shared memory) and S stream words, so a loaded word
//   feeds 4 or S FMAs.  Every sum runs over i = 0..din-1 into a zero
//   accumulator, then + b.
// - Layout.  The streams lie [neuron][stream][point] with the points per
//   block a template parameter: the lanes of a neuron tile read and write
//   consecutive words, the lanes of different tiles read the same words (a
//   broadcast), and every stream word of an unrolled step is at a constant
//   offset from one pointer.
// - A launch plan made by the wrapper (ops/fused_fields.py::fwd_plan) from
//   the shapes alone: points per block (enough blocks to fill the card where
//   P allows), neuron-tile groups per block (so that no warp idles at the
//   network's widths), the form and the shared memory.  The C function
//   checks the plan against its own arithmetic.
// - The scalar output layer gives each stream of a point to another thread,
//   so S warps work there instead of one.
// - No packing on the host: the kernel takes a table of the layers' W and b
//   pointers and copies them with 16-byte requests where a layer allows (4
//   bytes otherwise).  Every layer's copy is queued at once (cp.async), so a
//   block waits one trip to device memory, not one per layer: at these sizes
//   a block's latency is the kernel's time.
// - Two forms.  Resident: the whole network and two ping-pong stream buffers
//   in shared memory (the slice's networks, widths up to 64).  Staged, widths
//   up to 256: 16 points a block, one stream buffer, each layer's W streamed
//   through two shared-memory tiles of k_tile input rows by cp.async (the
//   next tile in flight while this one is used), the sums of the whole layer
//   (up to 4 neuron tiles a thread) in registers across the tiles, and the
//   activations written back over the same stream buffer after a barrier.
//   Both forms add in the same order, so they agree bit for bit.
//
// Precision: IEEE fp32 throughout; build without --use_fast_math, so tanhf,
// sincosf are the accurate library functions.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxWidth = 256;
constexpr int kMaxThreads = 256;
constexpr int kJT = 4;  // consecutive output neurons per thread tile
constexpr int kStagedPoints = 16;
constexpr int kStagedGroups = kMaxThreads / kStagedPoints;
constexpr int kStagedRounds = kMaxWidth / (kJT * kStagedGroups);  // neuron tiles per thread
constexpr int kMaxDevices = 64;
static_assert(kStagedRounds * kJT * kStagedGroups == kMaxWidth, "a staged block covers the widest layer");

struct Widths {
  int n_layers;
  int w[kMaxLayers + 1];
};

// Where the layers lie in device memory: W_l [in, out] row-major and b_l.
struct LayerPtrs {
  const float* W[kMaxLayers];
  const float* b[kMaxLayers];
};

// n rounded up to a multiple of kJT floats: the pitch of a row of W in shared
// memory, so that a neuron tile's weights are one aligned 16-byte word.
__host__ __device__ __forceinline__ int padded(int n) { return (n + kJT - 1) / kJT * kJT; }

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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Seed the streams of a block's NP points from p0: h = x, h_k = e_k, h_kk = 0.
template <int ND, int S, int NP>
__device__ __forceinline__ void seed_streams(const float* __restrict__ X, int d, int p0, int P, float* h,
                                             int tid, int nthreads) {
  for (int idx = tid; idx < S * d * NP; idx += nthreads) {
    const int p = idx % NP;
    const int i = (idx / NP) % d;
    const int s = idx / (NP * d);
    float v = 0.0f;
    if (s == 0) {
      const int gp = p0 + p;
      v = gp < P ? X[(size_t)gp * d + i] : 0.0f;
    } else if (s <= ND) {
      v = (i == s - 1) ? 1.0f : 0.0f;
    }
    h[(i * S + s) * NP + p] = v;
  }
}

// One input's step of a neuron tile: four weights, S stream words, 4 S FMAs.
template <int S>
__device__ __forceinline__ void fma_tile(float (&acc)[kJT][S], const float4 w, const float (&h)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    acc[0][s] = fmaf(h[s], w.x, acc[0][s]);
    acc[1][s] = fmaf(h[s], w.y, acc[1][s]);
    acc[2][s] = fmaf(h[s], w.z, acc[2][s]);
    acc[3][s] = fmaf(h[s], w.w, acc[3][s]);
  }
}

// A hidden neuron's output streams at one point from its sums: hj points at
// the value stream's word, the other streams follow at NP words each.
template <int ND, bool SECOND, int ACT, int S, int NP>
__device__ __forceinline__ void store_hidden(const float (&acc)[S], float bj, float* hj) {
  const float z = acc[0] + bj;
  float a, d1, d2;
  act_derivs<ACT>(z, a, d1, d2);
  hj[0] = a;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const float zk = acc[1 + k];
    hj[(1 + k) * NP] = d1 * zk;
    if (SECOND) {
      const float zkk = acc[1 + ND + k];
      hj[(1 + ND + k) * NP] = d2 * zk * zk + d1 * zkk;
    }
  }
}

// The four neurons of tile t: activations and stores, for the neurons below
// dout (a padded tile's last neurons are dropped).
template <int ND, bool SECOND, int ACT, int S, int NP>
__device__ __forceinline__ void store_tile(const float (&acc)[kJT][S], const float* b, int t, int dout,
                                           float* hp) {
  const float4 bv = *reinterpret_cast<const float4*>(b + kJT * t);
  const float bj[kJT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int jj = 0; jj < kJT; ++jj) {
    const int j = kJT * t + jj;
    if (j < dout) store_hidden<ND, SECOND, ACT, S, NP>(acc[jj], bj[jj], hp + j * S * NP);
  }
}

// The linear scalar output layer: thread (p, g) takes the streams s = g,
// g + groups, ... of point p, each one FMA chain over the inputs.
template <int S, int NP>
__device__ __forceinline__ void output_layer(const float* h, int din, const float* w, int wstride, float b,
                                             int p, int g, int groups, int gp, int P,
                                             float* __restrict__ out) {
  for (int s = g; s < S; s += groups) {
    const float* hs = h + s * NP + p;
    float acc = 0.0f;
#pragma unroll 4
    for (int i = 0; i < din; ++i) acc = fmaf(hs[i * S * NP], w[i * wstride], acc);
    if (gp < P) out[(size_t)gp * S + s] = s == 0 ? acc + b : acc;
  }
}

// Queue the copy of rows [k0, k0 + rows) of W [din, dout] into a tile at the
// row pitch padded(dout): 16 bytes a request where the layer allows, else 4.
__device__ __forceinline__ void fetch_rows(const float* __restrict__ W, int dout, int k0, int rows,
                                           float* tile, int tid, int nthreads) {
  const float* src = W + (size_t)k0 * dout;
  if (dout % kJT == 0 && aligned16(W)) {
    for (int e = tid; e < rows * dout / 4; e += nthreads)
      __pipeline_memcpy_async(tile + 4 * e, src + 4 * e, 16);
  } else {
    const int pitch = padded(dout);
    for (int e = tid; e < rows * dout; e += nthreads) {
      const int r = e / dout;
      __pipeline_memcpy_async(tile + r * pitch + (e - r * dout), src + e, 4);
    }
  }
}

// ---------------------------------------------------------------------------
// The resident form: the whole network in shared memory, W_l at a row pitch of
// padded(dout) followed by b_l, then two stream buffers.  A block is NP points
// x groups; thread (p, g) takes the neuron tiles g, g + groups, ... of point p.

template <int ND, bool SECOND, int ACT, int NP>
__global__ void __launch_bounds__(kMaxThreads)
fused_fields_kernel(const float* __restrict__ X, const LayerPtrs net, const Widths wd, const int max_w,
                    const int n_net, const int P, float* __restrict__ out) {
  constexpr int S = 1 + ND * (SECOND ? 2 : 1);  // streams = output columns
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  float* hin = wsm + n_net;
  float* hout = hin + S * max_w * NP;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int p = tid % NP;
  const int g = tid / NP;
  const int groups = nthreads / NP;
  const int p0 = blockIdx.x * NP;

  {  // The network, where it lies, into shared memory: every layer's copy is
     // queued at once (cp.async), so the block waits one trip to device memory
     // and not one per layer, and seeds its streams meanwhile.
    float* dst = wsm;
    for (int l = 0; l < wd.n_layers; ++l) {
      const int din = wd.w[l];
      const int dout = wd.w[l + 1];
      fetch_rows(net.W[l], dout, 0, din, dst, tid, nthreads);
      dst += din * padded(dout);
      fetch_rows(net.b[l], dout, 0, 1, dst, tid, nthreads);
      dst += padded(dout);
    }
    __pipeline_commit();
  }
  seed_streams<ND, S, NP>(X, wd.w[0], p0, P, hin, tid, nthreads);
  __pipeline_wait_prior(0);
  __syncthreads();

  const float* Wl = wsm;
  for (int l = 0; l < wd.n_layers; ++l) {
    const int din = wd.w[l];
    const int dout = wd.w[l + 1];
    const int pitch = padded(dout);
    const float* bl = Wl + din * pitch;
    if (l == wd.n_layers - 1) {
      output_layer<S, NP>(hin, din, Wl, pitch, bl[0], p, g, groups, p0 + p, P, out);
      break;
    }
    for (int t = g; t < pitch / kJT; t += groups) {
      float acc[kJT][S];
#pragma unroll
      for (int jj = 0; jj < kJT; ++jj)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[jj][s] = 0.0f;
      const float* w = Wl + kJT * t;
      const float* hp = hin + p;
#pragma unroll 4
      for (int i = 0; i < din; ++i) {
        const float4 wv = *reinterpret_cast<const float4*>(w + i * pitch);
        float hv[S];
#pragma unroll
        for (int s = 0; s < S; ++s) hv[s] = hp[(i * S + s) * NP];
        fma_tile<S>(acc, wv, hv);
      }
      store_tile<ND, SECOND, ACT, S, NP>(acc, bl, t, dout, hout + p);
    }
    __syncthreads();
    float* tmp = hin;
    hin = hout;
    hout = tmp;
    Wl = bl + pitch;
  }
}

// ---------------------------------------------------------------------------
// The staged form, for networks that do not fit the resident form (widths up
// to kMaxWidth).  Shared memory: one stream buffer, two W tiles of kt rows x
// pitch_max, every bias (padded) and the output layer's weights.  A block is
// kStagedPoints points x kStagedGroups groups; thread (p, g) takes the neuron
// tiles g, g + 16, g + 32, g + 48 of point p, all in registers at once.

// Queue the next tile of the hidden layers, rows from fk of layer fl, and step
// (fl, fk) on.  Every call commits one group of requests (an empty one after
// the last tile), so "all but the newest group" is always the tile about to
// be used.
__device__ __forceinline__ void fetch_next(const LayerPtrs& net, const Widths& wd, int kt, int& fl, int& fk,
                                           float* tile, int tid) {
  if (fl < wd.n_layers - 1) {
    const int din = wd.w[fl];
    const int rows = min(kt, din - fk);
    fetch_rows(net.W[fl], wd.w[fl + 1], fk, rows, tile, tid, kMaxThreads);
    fk += rows;
    if (fk >= din) {
      ++fl;
      fk = 0;
    }
  }
  __pipeline_commit();
}

template <int ND, bool SECOND, int ACT>
__global__ void __launch_bounds__(kMaxThreads)
fused_fields_staged_kernel(const float* __restrict__ X, const LayerPtrs net, const Widths wd, const int max_w,
                           const int kt, const int pitch_max, const int P, float* __restrict__ out) {
  constexpr int S = 1 + ND * (SECOND ? 2 : 1);
  constexpr int NP = kStagedPoints;
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);
  float* tiles = h + S * max_w * NP;
  float* bias = tiles + 2 * kt * pitch_max;

  const int tid = threadIdx.x;
  const int p = tid % NP;
  const int g = tid / NP;
  const int p0 = blockIdx.x * NP;
  const int n_hidden = wd.n_layers - 1;

  // The biases and the output layer's weights ride in the first tile's group
  // of requests, so they have landed before the first layer's sums end.
  float* wlast = bias;
  for (int l = 0; l < wd.n_layers; ++l) {
    fetch_rows(net.b[l], wd.w[l + 1], 0, 1, wlast, tid, kMaxThreads);
    wlast += padded(wd.w[l + 1]);
  }
  fetch_rows(net.W[n_hidden], wd.w[n_hidden], 0, 1, wlast, tid, kMaxThreads);
  int fl = 0, fk = 0;  // the tile to fetch next: rows from fk of layer fl
  fetch_next(net, wd, kt, fl, fk, tiles, tid);
  seed_streams<ND, S, NP>(X, wd.w[0], p0, P, h, tid, kMaxThreads);
  if (n_hidden == 0) __pipeline_wait_prior(0);
  __syncthreads();

  int buf = 0;
  const float* bl = bias;
  for (int l = 0; l < n_hidden; ++l) {
    const int din = wd.w[l];
    const int dout = wd.w[l + 1];
    const int pitch = padded(dout);
    const int n_tiles = pitch / kJT;
    float acc[kStagedRounds][kJT][S];
#pragma unroll
    for (int r = 0; r < kStagedRounds; ++r)
#pragma unroll
      for (int jj = 0; jj < kJT; ++jj)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[r][jj][s] = 0.0f;

    for (int k0 = 0; k0 < din; k0 += kt) {
      fetch_next(net, wd, kt, fl, fk, tiles + (buf ^ 1) * kt * pitch_max, tid);
      __pipeline_wait_prior(1);
      __syncthreads();  // this tile has landed for every thread
      const float* w = tiles + buf * kt * pitch_max + kJT * g;
      const float* hp = h + k0 * S * NP + p;
      const int rows = min(kt, din - k0);
#pragma unroll 4
      for (int i = 0; i < rows; ++i) {
        float hv[S];
#pragma unroll
        for (int s = 0; s < S; ++s) hv[s] = hp[(i * S + s) * NP];
#pragma unroll
        for (int r = 0; r < kStagedRounds; ++r) {
          if (g + r * kStagedGroups < n_tiles) {
            const float4 wv = *reinterpret_cast<const float4*>(w + i * pitch + r * kJT * kStagedGroups);
            fma_tile<S>(acc[r], wv, hv);
          }
        }
      }
      __syncthreads();  // every thread is done with this tile (and, after the last, with h)
      buf ^= 1;
    }
#pragma unroll
    for (int r = 0; r < kStagedRounds; ++r) {
      const int t = g + r * kStagedGroups;
      if (t < n_tiles) store_tile<ND, SECOND, ACT, S, NP>(acc[r], bl, t, dout, h + p);
    }
    bl += pitch;
  }
  __syncthreads();
  output_layer<S, NP>(h, wd.w[n_hidden], wlast, 1, bl[0], p, g, kStagedGroups, p0 + p, P, out);
}

// ---------------------------------------------------------------------------

struct Launch {
  const float* X;
  const LayerPtrs* net;
  Widths wd;
  int max_w, n_net, pitch_max;  // widest input, floats of the resident network, widest padded output
  int P, staged, block_points, groups, k_tile;
  float* out;
  size_t smem;
  int device;
  cudaStream_t stream;
};

// Make `device` current unless it is already: a launch then makes no device
// call it does not need (also while a CUDA graph is being captured).
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// Opt in to more dynamic shared memory only when a launch needs more than
// any before it (per kernel and device): the call costs host time.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int (&allowed)[kMaxDevices], const Launch& a) {
  const int dev = a.device;
  if (dev >= 0 && dev < kMaxDevices && (int)a.smem <= allowed[dev]) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) allowed[dev] = (int)a.smem;
  return err;
}

template <int ND, bool SECOND, int ACT, int NP>
cudaError_t launch_resident(const Launch& a) {
  static int allowed[kMaxDevices] = {};
  auto kernel = fused_fields_kernel<ND, SECOND, ACT, NP>;
  cudaError_t err = allow_smem(kernel, allowed, a);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.P + NP - 1) / NP), dim3(NP * a.groups), a.smem, a.stream>>>(a.X, *a.net, a.wd, a.max_w,
                                                                                 a.n_net, a.P, a.out);
  return cudaGetLastError();
}

template <int ND, bool SECOND, int ACT>
cudaError_t launch(const Launch& a) {
  if (a.staged) {
    static int allowed[kMaxDevices] = {};
    auto kernel = fused_fields_staged_kernel<ND, SECOND, ACT>;
    cudaError_t err = allow_smem(kernel, allowed, a);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.P + kStagedPoints - 1) / kStagedPoints), dim3(kMaxThreads), a.smem, a.stream>>>(
        a.X, *a.net, a.wd, a.max_w, a.k_tile, a.pitch_max, a.P, a.out);
    return cudaGetLastError();
  }
  switch (a.block_points) {
    case 8: return launch_resident<ND, SECOND, ACT, 8>(a);
    case 16: return launch_resident<ND, SECOND, ACT, 16>(a);
    default: return launch_resident<ND, SECOND, ACT, 32>(a);
  }
}

template <int ND, bool SECOND>
cudaError_t launch_act(int act, const Launch& a) {
  return act == 0 ? launch<ND, SECOND, 0>(a) : launch<ND, SECOND, 1>(a);
}

// The shape arithmetic of both forms, from the widths: false if a width or
// the layer count is outside what the kernels take.
bool measure(const int* widths, int n_layers, Launch& a) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  a.wd.n_layers = n_layers;
  a.max_w = a.n_net = a.pitch_max = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || widths[l] > kMaxWidth) return false;
    a.wd.w[l] = widths[l];
    if (l < n_layers) {
      const int pitch = padded(widths[l + 1]);
      a.n_net += (widths[l] + 1) * pitch;
      if (widths[l] > a.max_w) a.max_w = widths[l];
      if (pitch > a.pitch_max) a.pitch_max = pitch;
    }
  }
  return widths[n_layers] == 1;
}

long long smem_bytes(const Launch& a, int n_dirs, int second) {
  const long long S = 1 + n_dirs * (second ? 2 : 1);
  if (!a.staged) return 4 * (a.n_net + 2 * S * a.max_w * a.block_points);
  long long small = padded(a.wd.w[a.wd.n_layers - 1]);  // the output layer's weights
  for (int l = 1; l <= a.wd.n_layers; ++l) small += padded(a.wd.w[l]);
  return 4 * (S * a.max_w * kStagedPoints + 2LL * a.k_tile * a.pitch_max + small);
}

}  // namespace

extern "C" {

int hp_fused_fields_max_width() { return kMaxWidth; }
int hp_fused_fields_max_layers() { return kMaxLayers; }
int hp_fused_fields_staged_points() { return kStagedPoints; }
int hp_fused_fields_staged_groups() { return kStagedGroups; }

// Shared memory (bytes) one block needs under a plan, -1 for widths the
// kernels do not take.  Resident (staged = 0): the network at padded row
// pitches plus two stream buffers of block_points points.  Staged: one stream
// buffer of 16 points, two W tiles of k_tile rows, the biases and the output
// layer's weights.
long long hp_fused_fields_smem_bytes(const int* widths, int n_layers, int n_dirs, int second, int staged,
                                     int block_points, int k_tile) {
  Launch a;
  if (!measure(widths, n_layers, a)) return -1;
  a.staged = staged;
  a.block_points = block_points;
  a.k_tile = k_tile;
  return smem_bytes(a, n_dirs, second);
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
// fp32 on device `device`; layers (host memory) is a LayerPtrs, the device
// pointers of every W_l [in, out] (row-major) and b_l; widths (host memory) has
// n_layers + 1 entries and ends in 1.  activation: 0 = tanh, 1 = sin.  The
// plan (staged, block_points, groups, k_tile, smem) is the wrapper's; it is
// checked here.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
int hp_fused_fields_f32(const float* X, const void* layers, const int* widths, int n_layers, int P,
                        int n_dirs, int second, int activation, int staged, int block_points, int groups,
                        int k_tile, long long smem, float* out, int device, void* stream) {
  Launch a;
  if (!measure(widths, n_layers, a) || n_dirs < 1 || n_dirs > 3 || P < 1 || activation < 0 ||
      activation > 1 || n_dirs > widths[0])
    return (int)cudaErrorInvalidValue;
  a.X = X;
  a.net = static_cast<const LayerPtrs*>(layers);  // void* in the signature: LayerPtrs has internal linkage
  a.P = P;
  a.staged = staged ? 1 : 0;
  a.block_points = block_points;
  a.groups = groups;
  a.k_tile = k_tile;
  a.out = out;
  a.device = device;
  a.stream = static_cast<cudaStream_t>(stream);
  if (a.staged ? (block_points != kStagedPoints || groups != kStagedGroups || k_tile < 1 || k_tile > kMaxWidth)
               : ((block_points != 8 && block_points != 16 && block_points != 32) || groups < 1 ||
                  block_points * groups > kMaxThreads))
    return (int)cudaErrorInvalidValue;
  if (smem != smem_bytes(a, n_dirs, second)) return (int)cudaErrorInvalidValue;
  a.smem = (size_t)smem;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  switch (n_dirs * 2 + (second ? 1 : 0)) {
    case 2: return (int)launch_act<1, false>(activation, a);
    case 3: return (int)launch_act<1, true>(activation, a);
    case 4: return (int)launch_act<2, false>(activation, a);
    case 5: return (int)launch_act<2, true>(activation, a);
    case 6: return (int)launch_act<3, false>(activation, a);
    default: return (int)launch_act<3, true>(activation, a);
  }
}

}  // extern "C"
