// B2's firsts-only resident form, fp32, sm_90a: the VJP of the fused fields
// for second=False (g [P, 1 + n_dirs]: u, u_k), for networks no wider than
// 64 whose blocks fit in shared memory.  Built into B2's library beside
// csrc/fused_fields_bwd.cu (the second-derivative resident form and the block
// sum) and csrc/fused_fields_bwd_layered.cu (every other network);
// ops/fused_fields.py::bwd_plan picks the form and this kernel's launch shape.
//
// Replaces the firsts-only instantiation of fused_fields_bwd_kernel
// (SECOND false), the counterpart of the VJP that the JAX package leaves to
// XLA (hpvpinns_tpu/ops/pallas_fields.py:190-196); the per-point rules are
// those of its _fields_bwd_kernel (:246-253) without the second-order
// streams, shared in fused_fields_bwd_rules.cuh.  Given g, it returns the
// gradient of sum(g * fields) with respect to every W_l, b_l and
// (optionally) X: replay the forward (z = h W + b, z_k = h_k W; h' = act(z),
// h_k' = act'(z) z_k), stashing (t = tanh(z) or z, z_k) of every hidden
// layer, then the reverse chain
//   gz = d1 gh + sum_k d2 z_k gh_k,   gz_k = d1 gh_k,
//   gW += h^T gz + sum_k h_k^T gz_k,   gb += colsum gz,   gh_s = gz_s W^T.
//
// What bounds it on the H100.  The widths are 2-64, so every multiply-add
// takes its operands from shared memory, and the work is ~7,600
// multiply-adds a point at poisson2d_scaled: 3.7 us of fp32 issue for all
// 16,384 points.  The kernel it replaces (one block of 256 threads walking
// 16-point tiles through ~16 phases, the second-derivative kernel without
// the kk streams) took 37.98 us: a stream value it loaded fed two
// multiply-adds and a weight six; at width 20, 96 of its threads had no
// neuron and 156 no gW tile; clock64() stamps of one block
// (tools/b2_firsts_probe.py, NVIDIA H100 80GB HBM3, 700 W) put 73% of its
// cycles in the reverse phases.  Here one block's cycles are spread over
// its phases (replay 25%, gh 25%, gW 25%, set-up 10%, the input layer
// 10%): latency and issue, not any one phase, bound it.
//
// Design, and what each choice measured (C function, CUDA events; the
// probe's sweeps and variants, NVIDIA H100 80GB HBM3, 700 W):
// - Groups of PB points a block, one partial row a block, no barrier shared
//   with other groups: blocks of 1-4 warps, as many as fit an SM (8 at
//   poisson2d_scaled).  At poisson2d_scaled one warp a block ran 26.6 us,
//   two 27.9, four 43.4; two groups a block 43.0 (the groups run in turn).
// - Register tiles.  In the point-parallel phases (replay, gh = gz W^T) a
//   thread takes kTP = 2 points by kTN = 3 neurons and all S streams: per
//   input it loads S 8-byte words of h (a warp's threads that share points
//   read one address) and kTN weights, for S kTP kTN multiply-adds.  Four
//   points a thread (kTP = 4) ran 1.2x slower at poisson2d_quality and
//   ragged.
// - Fused epilogues.  The replay's epilogue stashes (t, z_k) and writes the
//   next layer's input streams; gh's computes gz of the layer below
//   (gz_point) and overwrites its stash with its output streams h in place
//   (the stash is not read again), which gW then reads: two barriers a
//   layer on the way down and one on the way up.
// - gW in TI x 4 register tiles over 16-byte runs of four points, dealt in
//   order where a layer has at most 8 column tiles (dout <= 32), else in
//   8 x 4 warp tiles whose loads fall on 8 and 4 rows (bank-conflict free):
//   in order everywhere ran 46.4 us at poisson2d_quality, warp tiles
//   everywhere 34.9 at poisson2d_scaled, the mix 38.5 and 26.6.
// - The network copied with kLoadDepth 16-byte loads of each thread in
//   flight, and a first group's sums stored without reading the row: the
//   set-up fell from 13,505 to 4,186 cycles at poisson2d_scaled and from
//   48,799 to 4,180 at ragged, where the same launch shape went from 57.4
//   to 33.5 us.
//
// Determinism.  Each gW/gb entry of a block's partial row is summed by one
// fixed thread in a fixed order (over streams, then points in order,
// fmaf into its register; then the group's sum stored, or added to the row
// for groups after the first), and block_sum_kernel adds the rows in a fixed
// order.  No float atomics: two runs give the same bits on any card.
//
// Precision: IEEE fp32 throughout; build without --use_fast_math.

#include <cuda_runtime.h>

#include "fused_fields_bwd_rules.cuh"  // streams, stash_value, outputs, gz_point

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxWidth = 64;
constexpr int kTP = 2;  // points a thread in the point-parallel phases (2 or 4)
constexpr int kTN = 3;  // neurons a thread a pass in the point-parallel phases
constexpr int kMaxWarps = 4;
constexpr int kLoadDepth = 8;  // loads of the network each thread has in flight
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

// Floats between neighbouring neurons of a stream buffer (a neuron's PB
// points are contiguous): PB rounded up to four times an odd number.
__host__ __device__ __forceinline__ int point_stride(int pb) { return (pb / 4) % 2 ? pb : pb + 4; }

struct Net {
  int n_layers;
  int w[kMaxLayers + 1];
  int off[kMaxLayers];   // offset of W_l in the packed params, in shared memory and in a partial row
  int tile[kMaxLayers];    // rows of a gW tile of layer l: 4, 2 or 1
  bool in_order[kMaxLayers];  // layer l's gW tiles dealt to the threads in order (else in 8 x 4 warp tiles)
};

// kTP consecutive points of one row as one 8- or 16-byte access.
template <int TP>
struct Vec;
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ void load_pts(const float* p, float (&v)[kTP]) {
  const typename Vec<kTP>::T x = *reinterpret_cast<const typename Vec<kTP>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&x);
#pragma unroll
  for (int e = 0; e < kTP; ++e) v[e] = f[e];
}

__device__ __forceinline__ void store_pts(float* p, const float (&v)[kTP]) {
  typename Vec<kTP>::T x;
  float* f = reinterpret_cast<float*>(&x);
#pragma unroll
  for (int e = 0; e < kTP; ++e) f[e] = v[e];
  *reinterpret_cast<typename Vec<kTP>::T*>(p) = x;
}

template <int ND>
struct Shape {
  static constexpr int S = streams(ND, false);
  int ss;      // floats between streams of a buffer
  int stride;  // floats between neurons of a stream
  int rp;      // this thread's first point (kTP points from it)
  int rn;      // this thread's first neuron of a pass
  int RN;      // threads across neurons
};

// Layer l's replay: z_s = h_s W (+ b on the value stream) at this thread's
// kTP points and neurons rn + RN b (b < kTN) a pass; stashes (t or z, z_k) in
// st and writes the next layer's input streams to hout.  Each sum takes i in
// order, as the second-derivative kernel does.
template <int ND, int ACT>
__device__ __forceinline__ void replay_layer(const Shape<ND>& sh, const float* hin, const float* W, const float* b,
                                             int din, int dout, float* st, float* hout) {
  constexpr int S = Shape<ND>::S;
  for (int j0 = 0; j0 < dout; j0 += sh.RN * kTN) {
    int j[kTN];
    bool any = false;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      j[c] = j0 + sh.rn + sh.RN * c;
      any |= j[c] < dout;
    }
    if (!any) break;
    float acc[S][kTP][kTN];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int t = 0; t < kTP; ++t)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[s][t][c] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < din; ++i) {
      float w[kTN];
#pragma unroll
      for (int c = 0; c < kTN; ++c) w[c] = j[c] < dout ? W[i * dout + j[c]] : 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float h[kTP];
        load_pts(hin + s * sh.ss + i * sh.stride + sh.rp, h);
#pragma unroll
        for (int t = 0; t < kTP; ++t)
#pragma unroll
          for (int c = 0; c < kTN; ++c) acc[s][t][c] = fmaf(h[t], w[c], acc[s][t][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      if (j[c] >= dout) continue;
      const float bj = b[j[c]];
      float v[kTP][S], h[kTP][S];
#pragma unroll
      for (int t = 0; t < kTP; ++t) {
        v[t][0] = stash_value<ACT>(acc[0][t][c] + bj);
#pragma unroll
        for (int s = 1; s < S; ++s) v[t][s] = acc[s][t][c];
        outputs<ND, ACT, false>(v[t], h[t]);
      }
      const int at = j[c] * sh.stride + sh.rp;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float vs[kTP], hs[kTP];
#pragma unroll
        for (int t = 0; t < kTP; ++t) {
          vs[t] = v[t][s];
          hs[t] = h[t][s];
        }
        store_pts(st + s * sh.ss + at, vs);
        store_pts(hout + s * sh.ss + at, hs);
      }
    }
  }
}

// Layer l's gh_s = gz_s W^T at this thread's points and input neurons, fused
// with the layer below: gz of hidden layer l - 1 (gz_point on its stash st)
// into gzn, and its output streams h written over st in place (each (i, p)
// belongs to one thread, and the stash is not read again).  Each sum takes j
// in order, four outputs a step; past dout the weights are zero.
template <int ND, int ACT>
__device__ __forceinline__ void gh_layer(const Shape<ND>& sh, const float* gz, const float* W, int din, int dout,
                                         float* st, float* gzn) {
  constexpr int S = Shape<ND>::S;
  for (int i0 = 0; i0 < din; i0 += sh.RN * kTN) {
    int ii[kTN];
    bool any = false;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      ii[c] = i0 + sh.rn + sh.RN * c;
      any |= ii[c] < din;
    }
    if (!any) break;
    float acc[S][kTP][kTN];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int t = 0; t < kTP; ++t)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[s][t][c] = 0.0f;
    for (int jq = 0; jq < dout; jq += 4) {
      float w[4][kTN];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < kTN; ++c) w[q][c] = ii[c] < din && jq + q < dout ? W[ii[c] * dout + jq + q] : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float g[kTP];
          load_pts(gz + s * sh.ss + (jq + q) * sh.stride + sh.rp, g);
#pragma unroll
          for (int t = 0; t < kTP; ++t)
#pragma unroll
            for (int c = 0; c < kTN; ++c) acc[s][t][c] = fmaf(g[t], w[q][c], acc[s][t][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      if (ii[c] >= din) continue;
      const int at = ii[c] * sh.stride + sh.rp;
      float v[kTP][S], g[kTP][S], o[kTP][S], h[kTP][S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float x[kTP];
        load_pts(st + s * sh.ss + at, x);
#pragma unroll
        for (int t = 0; t < kTP; ++t) {
          v[t][s] = x[t];
          g[t][s] = acc[s][t][c];
        }
      }
#pragma unroll
      for (int t = 0; t < kTP; ++t) {
        gz_point<ND, ACT, false>(v[t], g[t], o[t]);
        outputs<ND, ACT, false>(v[t], h[t]);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float os[kTP], hs[kTP];
#pragma unroll
        for (int t = 0; t < kTP; ++t) {
          os[t] = o[t][s];
          hs[t] = h[t][s];
        }
        store_pts(gzn + s * sh.ss + at, os);
        store_pts(st + s * sh.ss + at, hs);
      }
    }
  }
}

// gW of one layer, out[i * dout + j] = sum_{s, p} h_s[i, p] gz_s[j, p], in
// tiles of TI rows (i0, i0 + ni, ...) by four columns (j0, j0 + nj, ...),
// ni = ceil(din / TI), nj = ceil(dout / 4).  in_order: thread t takes tiles
// t, t + threads, ... (i0 = t / nj, j0 = t % nj: a warp's 16-byte loads of gz
// fall on at most nj rows, one wavefront where nj <= 8).  Else warp w takes
// the warp tiles w, w + warps, ... of 8 x 4 tiles, lane (l % 8, l / 8) the
// tile (i0, j0) at that offset: its loads of h fall on 8 consecutive rows
// and of gz on 4 (one wavefront each), whatever nj.  Each entry sums over s,
// then p in order, and is stored (a block's first group: no read of the
// row) or added to the row (ADD).  Rows and columns past din and dout (they
// read pad rows of the buffers) are computed and dropped.
template <int ND, int TI, bool ADD>
__device__ __forceinline__ void gw_tiles(const Shape<ND>& sh, const float* H, const float* gz, int din, int dout,
                                         int pb, bool in_order, float* out, int tid, int threads) {
  constexpr int S = Shape<ND>::S;
  const int ni = (din + TI - 1) / TI;
  const int nj = (dout + 3) / 4;
  const int nwi = (ni + 7) / 8;
  const int n = in_order ? ni * nj : nwi * ((nj + 3) / 4) * 32;
  for (int t = tid; t < n; t += threads) {
    int i0, j0;
    if (in_order) {
      i0 = t / nj;
      j0 = t - i0 * nj;
    } else {
      const int q = t >> 5;  // threads is a multiple of 32: warp tiles w, w + warps, ...
      const int qj = q / nwi;
      i0 = (q - qj * nwi) * 8 + (t & 7);
      j0 = qj * 4 + ((t & 31) >> 3);
      if (i0 >= ni || j0 >= nj) continue;
    }
    float acc[TI][4];
#pragma unroll
    for (int a = 0; a < TI; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
    for (int s = 0; s < S; ++s) {
#pragma unroll 4
      for (int p = 0; p < pb; p += 4) {
        float4 h[TI], g[4];
#pragma unroll
        for (int a = 0; a < TI; ++a)
          h[a] = *reinterpret_cast<const float4*>(H + s * sh.ss + (i0 + ni * a) * sh.stride + p);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          g[c] = *reinterpret_cast<const float4*>(gz + s * sh.ss + (j0 + nj * c) * sh.stride + p);
#pragma unroll
        for (int a = 0; a < TI; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[a][c] = fmaf(h[a].x, g[c].x, acc[a][c]);
            acc[a][c] = fmaf(h[a].y, g[c].y, acc[a][c]);
            acc[a][c] = fmaf(h[a].z, g[c].z, acc[a][c]);
            acc[a][c] = fmaf(h[a].w, g[c].w, acc[a][c]);
          }
      }
    }
#pragma unroll
    for (int a = 0; a < TI; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + ni * a;
        const int j = j0 + nj * c;
        if (i < din && j < dout) {
          float* e = out + i * dout + j;
          *e = ADD ? *e + acc[a][c] : acc[a][c];
        }
      }
  }
}

// gW of layer l (tile rows net.tile[l], dealt as net.in_order[l]) and gb:
// gb[j] = sum_p gz_0[j, p] in point order.
template <int ND, bool ADD>
__device__ __forceinline__ void gw_layer(const Shape<ND>& sh, const Net& net, int l, const float* H, const float* gz,
                                         int pb, float* row, int tid, int threads) {
  const int din = net.w[l];
  const int dout = net.w[l + 1];
  float* out = row + net.off[l];
  switch (net.tile[l]) {
    case 4: gw_tiles<ND, 4, ADD>(sh, H, gz, din, dout, pb, net.in_order[l], out, tid, threads); break;
    case 2: gw_tiles<ND, 2, ADD>(sh, H, gz, din, dout, pb, net.in_order[l], out, tid, threads); break;
    default: gw_tiles<ND, 1, ADD>(sh, H, gz, din, dout, pb, net.in_order[l], out, tid, threads); break;
  }
  for (int j = tid; j < dout; j += threads) {
    const float* gs = gz + j * sh.stride;
    float sum = 0.0f;
#pragma unroll 4
    for (int p = 0; p < pb; p += 4) {
      const float4 g = *reinterpret_cast<const float4*>(gs + p);
      sum += g.x;
      sum += g.y;
      sum += g.z;
      sum += g.w;
    }
    float* e = out + din * dout + j;
    *e = ADD ? *e + sum : sum;
  }
}

template <int ND>
__device__ __forceinline__ void gw_layer(const Shape<ND>& sh, const Net& net, int l, const float* H, const float* gz,
                                         int pb, bool add, float* row, int tid, int threads) {
  if (add)
    gw_layer<ND, true>(sh, net, l, H, gz, pb, row, tid, threads);
  else
    gw_layer<ND, false>(sh, net, l, H, gz, pb, row, tid, threads);
}

// Input streams of layer 0 into buf: h = x, h_k = e_k (point p of a group,
// past P zero).  Thread tid < PB d takes x[p0 + tid % PB, tid / PB] from
// x_own; further values of x (d > threads / PB) come from X.
template <int ND>
__device__ __forceinline__ void seed_inputs(const Shape<ND>& sh, const float* __restrict__ X, int d, int p0, int P,
                                            int pb, float* buf, int tid, int threads, float x_own) {
  constexpr int S = Shape<ND>::S;
  for (int e = tid; e < S * d * pb; e += threads) {
    const int p = e % pb;
    const int i = (e / pb) % d;
    const int s = e / (pb * d);
    float v = 0.0f;
    if (s == 0) {
      const int gp = p0 + p;
      v = e == tid ? x_own : gp < P ? X[(size_t)gp * d + i] : 0.0f;
    } else {
      v = i == s - 1 ? 1.0f : 0.0f;
    }
    buf[s * sh.ss + i * sh.stride + p] = v;
  }
}

// The packed network into shared memory, kLoadDepth loads of each thread in
// flight at once (16-byte loads where params is 16-byte aligned).
__device__ __forceinline__ void load_network(const float* __restrict__ params, int n_params, float* wsm, int tid,
                                             int threads) {
  if ((reinterpret_cast<size_t>(params) & 15) == 0) {
    const int n4 = n_params / 4;
    for (int base = tid; base < n4; base += kLoadDepth * threads) {
      float4 v[kLoadDepth];
#pragma unroll
      for (int m = 0; m < kLoadDepth; ++m)
        if (base + m * threads < n4) v[m] = __ldg(reinterpret_cast<const float4*>(params) + base + m * threads);
#pragma unroll
      for (int m = 0; m < kLoadDepth; ++m)
        if (base + m * threads < n4) reinterpret_cast<float4*>(wsm)[base + m * threads] = v[m];
    }
    for (int e = 4 * n4 + tid; e < n_params; e += threads) wsm[e] = __ldg(params + e);
  } else {
    for (int base = tid; base < n_params; base += kLoadDepth * threads) {
      float v[kLoadDepth];
#pragma unroll
      for (int m = 0; m < kLoadDepth; ++m)
        if (base + m * threads < n_params) v[m] = __ldg(params + base + m * threads);
#pragma unroll
      for (int m = 0; m < kLoadDepth; ++m)
        if (base + m * threads < n_params) wsm[base + m * threads] = v[m];
    }
  }
}

// gh reads a layer's gz up to its width rounded up to 4, past the width
// times zero weights: those rows of the two stream buffers (buf_b follows
// buf_a) start at zero; later they hold other layers' finite values.
template <int ND>
__device__ __forceinline__ void zero_pad_rows(const Shape<ND>& sh, const Net& net, float* buf_a, int tid,
                                              int threads) {
  constexpr int S = Shape<ND>::S;
  const int quads = sh.stride / 4;
  for (int l = 1; l <= net.n_layers; ++l) {
    const int w = net.w[l];
    const int n = (round4(w) - w) * 2 * S * quads;
    for (int e = tid; e < n; e += threads) {
      const int rest = e / quads;
      const int r = w + rest % (round4(w) - w);
      const int bs = rest / (round4(w) - w);  // buffer and stream
      reinterpret_cast<float4*>(buf_a + bs * sh.ss + r * sh.stride)[e - rest * quads] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// A block of `blockDim.x` threads (32 WB) takes `groups` consecutive groups
// of PB points and writes one partial row: its sums of gW and gb in the
// packed layout, pad columns zero.
template <int ND, int ACT>
__global__ void __launch_bounds__(32 * kMaxWarps)
fused_fields_bwd_firsts_kernel(const float* __restrict__ X, const float* __restrict__ G,
                               const float* __restrict__ params, const Net net, const int n_params,
                               const int row_pitch, const int P, const int pb, const int groups,
                               float* __restrict__ partials, float* __restrict__ gX) {
  constexpr int S = streams(ND, false);
  extern __shared__ __align__(16) float smem[];
  const int L = net.n_layers;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int d = net.w[0];
  int max_w = 0;
  for (int l = 0; l < L; ++l) max_w = max(max_w, net.w[l]);
  Shape<ND> sh;
  sh.stride = point_stride(pb);
  sh.ss = round4(max_w) * sh.stride;
  const int rp_n = pb / kTP;  // threads across points
  sh.rp = (tid % rp_n) * kTP;
  sh.rn = tid / rp_n;
  sh.RN = threads / rp_n;
  const int buf = S * sh.ss;
  float* wsm = smem;                         // the packed network
  float* stash = smem + round4(n_params);    // [L - 1] buffers
  float* buf_a = stash + (L - 1) * buf;
  float* buf_b = buf_a + buf;

  float* row = partials + (size_t)blockIdx.x * row_pitch;
  for (int c = n_params + tid; c < row_pitch; c += threads) row[c] = 0.0f;

  for (int k = 0; k < groups; ++k) {
    const int p0 = (blockIdx.x * groups + k) * pb;
    if (p0 >= P) break;
    const bool add = k > 0;
    // This thread's values of x (seed_inputs) and g (the reverse), loaded
    // here: g's loads are in flight through the replay.
    const float x_own = tid < pb * d && p0 + tid % pb < P ? X[(size_t)(p0 + tid % pb) * d + tid / pb] : 0.0f;
    float g_own[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int e = tid + m * threads;
      g_own[m] = e < S * pb && p0 + e / S < P ? G[(size_t)p0 * S + e] : 0.0f;
    }
    if (k == 0) {  // with the first group's x and g in flight
      load_network(params, n_params, wsm, tid, threads);
      zero_pad_rows<ND>(sh, net, buf_a, tid, threads);
    }
    __syncthreads();  // the previous group's last reads are done
    seed_inputs<ND>(sh, X, d, p0, P, pb, buf_a, tid, threads, x_own);
    __syncthreads();

    // ---- forward replay through the hidden layers ----
    float* hin = buf_a;
    float* hout = buf_b;
    for (int l = 0; l < L - 1; ++l) {
      const float* W = wsm + net.off[l];
      replay_layer<ND, ACT>(sh, hin, W, W + net.w[l] * net.w[l + 1], net.w[l], net.w[l + 1], stash + l * buf, hout);
      __syncthreads();
      float* t = hin;
      hin = hout;
      hout = t;
    }

    // ---- reverse: gz of the last layer is g ----
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int e = tid + m * threads;
      if (e < S * pb) buf_a[(e % S) * sh.ss + e / S] = g_own[m];
    }
    __syncthreads();
    float* gz = buf_a;
    float* gzn = buf_b;
    for (int l = L - 1; l >= 1; --l) {
      float* st = stash + (l - 1) * buf;
      gh_layer<ND, ACT>(sh, gz, wsm + net.off[l], net.w[l], net.w[l + 1], st, gzn);
      __syncthreads();
      gw_layer<ND>(sh, net, l, st, gz, pb, add, row, tid, threads);  // st now holds h of layer l's inputs
      __syncthreads();
      float* t = gz;
      gz = gzn;
      gzn = t;
    }
    seed_inputs<ND>(sh, X, d, p0, P, pb, gzn, tid, threads, x_own);
    __syncthreads();
    gw_layer<ND>(sh, net, 0, gzn, gz, pb, add, row, tid, threads);
    if (gX != nullptr) {
      // gX = gz W_0^T on the value stream, j in order.
      for (int e = tid; e < pb * d; e += threads) {
        const int p = e / d;
        const int i = e - p * d;
        if (p0 + p >= P) continue;
        float sum = 0.0f;
#pragma unroll 4
        for (int j = 0; j < net.w[1]; ++j) sum = fmaf(gz[j * sh.stride + p], wsm[i * net.w[1] + j], sum);
        gX[(size_t)(p0 + p) * d + i] = sum;
      }
    }
  }
}

struct FirstsArgs {
  const float* X;
  const float* G;
  const float* params;
  Net net;
  int n_params, row_pitch, P, pb, warps, groups, act;
  float* partials;
  float* gX;
  size_t smem;
  int device;
  cudaStream_t stream;
};

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

template <int ND, int ACT>
cudaError_t launch(const FirstsArgs& a) {
  // Opt in to more dynamic shared memory only when a launch needs more than
  // any before it (per instantiation and device).
  static int allowed[kMaxDevices] = {};
  auto kernel = fused_fields_bwd_firsts_kernel<ND, ACT>;
  const bool known = a.device >= 0 && a.device < kMaxDevices;
  if (!known || (int)a.smem > allowed[a.device]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return err;
    if (known) allowed[a.device] = (int)a.smem;
  }
  const int n_groups = (a.P + a.pb - 1) / a.pb;
  const dim3 grid((n_groups + a.groups - 1) / a.groups);
  kernel<<<grid, dim3(32 * a.warps), a.smem, a.stream>>>(a.X, a.G, a.params, a.net, a.n_params, a.row_pitch, a.P,
                                                          a.pb, a.groups, a.partials, a.gX);
  return cudaGetLastError();
}

template <int ND>
cudaError_t launch_act(const FirstsArgs& a) {
  return a.act == 0 ? launch<ND, 0>(a) : launch<ND, 1>(a);
}

// The network's layout (or an error code): each layer's packed offset and
// how its gW tiles are cut and dealt to `threads` threads.
cudaError_t make_net(const int* widths, int n_layers, int n_dirs, int threads, Net& net, int& n_params) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_dirs < 1 || n_dirs > 3 || widths[n_layers] != 1 ||
      n_dirs > widths[0] || threads < 32)
    return cudaErrorInvalidValue;
  net = Net{};
  net.n_layers = n_layers;
  n_params = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || widths[l] > kMaxWidth) return cudaErrorInvalidValue;
    net.w[l] = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    const int din = widths[l];
    const int dout = widths[l + 1];
    net.off[l] = n_params;
    n_params += din * dout + dout;
    // Up to 8 column tiles (dout <= 32) the tiles go in order, with the TI
    // whose rounds over the threads take the fewest loads and multiply-adds,
    // (17 TI + 4) a quad of points and tile (ties to the larger TI); wider,
    // in 8 x 4 warp tiles of two rows (bank conflicts, not instructions,
    // bound those: tools/b2_firsts_probe.py's variants).
    net.in_order[l] = (dout + 3) / 4 <= 8;
    net.tile[l] = 2;
    for (int ti = 4, best_cost = 0; net.in_order[l] && ti >= 1; ti /= 2) {
      const int tiles = (din + ti - 1) / ti * ((dout + 3) / 4);
      const int cost = (tiles + threads - 1) / threads * (17 * ti + 4);
      if (ti == 4 || cost < best_cost) {
        net.tile[l] = ti;
        best_cost = cost;
      }
    }
  }
  return cudaSuccess;
}

long long smem_bytes(const Net& net, int n_params, int n_dirs, int pb) {
  int max_w = 0;
  for (int l = 0; l < net.n_layers; ++l) max_w = max_w > net.w[l] ? max_w : net.w[l];
  return (long long)sizeof(float) *
         (round4(n_params) +
          (long long)(net.n_layers + 1) * streams(n_dirs, false) * round4(max_w) * point_stride(pb));
}

bool valid_points(int pb) { return pb == 4 || pb == 8 || pb == 16; }

}  // namespace

extern "C" {

// Shared memory (bytes) of one block for a network (widths, host memory, up
// to 64 wide), n_dirs and groups of `group_points` points: the packed network
// (n_params rounded up to 4) and (n_layers + 1) stream buffers (the hidden
// layers' stash and two), each (1 + n_dirs) x round4(widest input) x point
// stride floats; -1 for arguments the kernel does not take.
// ops/fused_fields.py::bwd_smem_bytes repeats it.
long long hp_fused_fields_bwd_firsts_smem_bytes(const int* widths, int n_layers, int n_dirs, int group_points) {
  Net net;
  int n_params = 0;
  if (!valid_points(group_points) || make_net(widths, n_layers, n_dirs, 32, net, n_params) != cudaSuccess) return -1;
  return smem_bytes(net, n_params, n_dirs, group_points);
}

// X [P, widths[0]] and G [P, 1 + n_dirs] row-major fp32 on device `device`;
// params packs W_0 [in, out], b_0, W_1, b_1, ... back to back; widths (host
// memory) has n_layers + 1 entries, each at most 64, and ends in 1.  second
// must be 0: this is the firsts-only mode (the fields u, u_k); the
// second-derivative resident form is hp_fused_fields_bwd_f32.  Each block of
// 32 warps_per_block threads takes groups_per_block consecutive groups of
// group_points (4, 8 or 16) points and writes one row of partials
// [ceil(ceil(P / group_points) / groups_per_block), 4 ceil(n_params / 4)]:
// its sums of gW and gb in the packed layout, pad columns zero.  Unless gX is
// null it writes gX [P, widths[0]].  activation: 0 = tanh, 1 = sin.  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() (0 on
// success).
int hp_fused_fields_bwd_firsts_f32(const float* X, const float* G, const float* params, const int* widths,
                                   int n_layers, int P, int n_dirs, int second, int activation, int group_points,
                                   int warps_per_block, int groups_per_block, float* partials, float* gX, int device,
                                   void* stream) {
  if (second != 0 || P < 1 || activation < 0 || activation > 1 || !valid_points(group_points) ||
      warps_per_block < 1 || warps_per_block > kMaxWarps || groups_per_block < 1)
    return (int)cudaErrorInvalidValue;
  FirstsArgs a{X, G, params, Net{}, 0, 0, P, group_points, warps_per_block, groups_per_block, activation,
               partials, gX, 0, device, static_cast<cudaStream_t>(stream)};
  cudaError_t err = make_net(widths, n_layers, n_dirs, 32 * warps_per_block, a.net, a.n_params);
  if (err != cudaSuccess) return (int)err;
  a.row_pitch = round4(a.n_params);
  a.smem = (size_t)smem_bytes(a.net, a.n_params, n_dirs, group_points);
  err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  switch (n_dirs) {
    case 1: return (int)launch_act<1>(a);
    case 2: return (int)launch_act<2>(a);
    default: return (int)launch_act<3>(a);
  }
}

}  // extern "C"
