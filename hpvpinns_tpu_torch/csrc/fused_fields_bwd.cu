// Backward of the fused MLP + derivative-field propagation (B2), fp32, sm_90a:
// its resident form with second derivatives, for networks no wider than 64
// whose shared memory fits a block, and the block sum of B2's partial rows.
// Every other network takes the layered form, csrc/fused_fields_bwd_layered.cu,
// and the firsts-only mode's resident form is a kernel of its own,
// csrc/fused_fields_bwd_firsts.cu (all three built into one library;
// ops/fused_fields.py::bwd_plan picks the form from the shapes).
//
// Replaces hpvpinns_tpu/ops/pallas_fields.py::_fields_bwd_kernel (launched by
// _pallas_fields_bwd, the custom VJP of fields_flat for second=True).  Given
// the cotangent g [P, S] of every field column (S = 1 + 2 n_dirs: u, u_k,
// u_kk), it returns the gradient of sum(g * fields) with respect to every
// W_l, b_l and (optionally) X.  The kernel keeps the rules' SECOND flag but
// is instantiated with it true only: its firsts-only instantiation (the
// var_form-1 backward before) was replaced by
// csrc/fused_fields_bwd_firsts.cu.
//
// Per tile of 16 points: replay the forward (z = h W + b, z_k = h_k W,
// z_kk = h_kk W; h' = act(z), h_k' = act'(z) z_k,
// h_kk' = act''(z) z_k^2 + act'(z) z_kk), stashing (t = tanh(z) or z), z_k,
// z_kk of every hidden layer, then run the reverse chain
// (pallas_fields.py:246-253):
//   gz     = d1 gh + sum_k d2 z_k gh_k + (d3 z_k^2 + d2 z_kk) gh_kk
//   gz_k   = d1 gh_k + 2 d2 z_k gh_kk
//   gz_kk  = d1 gh_kk
//   gW    += h^T gz + sum_k (h_k^T gz_k + h_kk^T gz_kk);  gb += colsum gz
//   gh     = gz W^T,  gh_k = gz_k W^T,  gh_kk = gz_kk W^T
// with d_i = act^(i)(z) and a linear last layer whose gz is g itself.  Each
// layer's input streams are recomputed from the stash of the layer below (as
// the TPU kernel does, :358-365), so the stash holds S floats per hidden
// neuron and point; gX = gh of the input layer (the tangent seeds are
// constants).
//
// What bounds it on the H100.  The widths are tiny (2-64), so every FMA
// takes an operand from shared memory and a block runs a chain of ~10
// phases split by __syncthreads; the fp32 FMA rate and device memory (X, g,
// the network and gX once, one partial row per block) are far from the
// limit.  At poisson2d_scaled shapes the time goes to shared-memory traffic
// and to each block's latency with four blocks an SM (shared memory, ~55 KB
// a block, and the 64-register cap both allow four); at poisson2d_quality
// (~188 KB a block) one block has each SM, so latency alone bounds it.
//
// Design.
// - A block of 256 threads holds the packed network, its own gW/gb sums, the
//   stash [Lh][S][width][point] and three stream buffers in shared memory,
//   and walks T consecutive tiles of 16 points (T from P alone, set by the
//   wrapper, ops/fused_fields.py::bwd_plan): the network is loaded once per
//   block and each block writes one partial row.  The stash stays on chip
//   because the same block reads every stashed value back once per layer;
//   the wrapper raises when a network does not fit.
// - Register tiles.  The point-parallel phases (replay, gh = gz W^T, the
//   elementwise gz and activations) give a thread one neuron and PT = 2
//   points (widths up to 32) or 4, loaded as one 8- or 16-byte word, so each
//   stream word feeds PT FMAs and each weight S PT.  The gW phase gives a
//   thread a 2 x 2 tile of (i, j) and loads four points at a time, so each
//   loaded word feeds two FMAs.  gW tiles go to consecutive threads: spreading
//   them over all warps was slower on the card.
// - Layout.  In a stream buffer the neuron stride is kPointStride = 20 words
//   (4 x odd): rows are 16-byte aligned, and eight lanes reading one 16-byte
//   word each from eight consecutive rows hit 32 distinct banks.
// - tanh is evaluated once per hidden neuron and point: the stash keeps t,
//   and every derivative is a polynomial of t.
// - Each tile's values of x and g are loaded into registers at the tile's
//   start, so g's load overlaps the replay and x is not read twice.
// - Registers: four blocks an SM where their shared memory allows it (64
//   registers, shallow unrolling), else one (deep unrolling for latency).
//
// Determinism.  The TPU sums dW/db over points by read-modify-write across a
// sequential grid (:241-244, :328-335).  Here each thread owns fixed entries
// of its block's sums and adds each tile's value in tile order; each block
// writes one row partials[block][param], and block_sum_kernel adds the rows
// in a fixed order.  No float atomics: the same inputs give bit-identical
// gradients on every run, on any card.
//
// Precision: IEEE fp32 throughout; build without --use_fast_math.

#include <cuda_runtime.h>

#include "fused_fields_bwd_rules.cuh"  // stash_value, outputs, gz_point

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxWidth = 256;         // the library's limit (B1's; the layered form's)
constexpr int kResidentMaxWidth = 64;  // the resident form
constexpr int kBlockPoints = 16;
constexpr int kPointStride = 20;
constexpr int kThreads = 256;
static_assert(kBlockPoints * 7 <= kThreads, "one thread per value of g in a tile");
constexpr int kSumThreads = 256;    // block_sum_kernel: lanes x row groups
constexpr int kMaxSumTiles = 4096;  // block_sum_kernel: column tiles with a ticket
constexpr int kMaxDevices = 64;

// n rounded up to a multiple of 4 floats: keeps the stream buffers that
// follow n floats of shared memory 16-byte aligned.
__host__ __device__ __forceinline__ int padded(int n) { return (n + 3) / 4 * 4; }

struct Widths {
  int n_layers;
  int w[kMaxLayers + 1];
};

// Word offset of neuron j of stream s in a stream buffer; point p adds p.
__device__ __forceinline__ int at(int s, int j, int max_w) {
  return (s * max_w + j) * kPointStride;
}

// PT consecutive points of one row as one 8- or 16-byte shared-memory access.
template <int PT>
struct Vec;
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int PT>
__device__ __forceinline__ void load_pts(const float* p, float (&v)[PT]) {
  const typename Vec<PT>::T x = *reinterpret_cast<const typename Vec<PT>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&x);
#pragma unroll
  for (int e = 0; e < PT; ++e) v[e] = f[e];
}

template <int PT>
__device__ __forceinline__ void store_pts(float* p, const float (&v)[PT]) {
  typename Vec<PT>::T x;
  float* f = reinterpret_cast<float*>(&x);
#pragma unroll
  for (int e = 0; e < PT; ++e) f[e] = v[e];
  *reinterpret_cast<typename Vec<PT>::T*>(p) = x;
}

// The point-parallel phases give thread tid neuron j = tid / (16 / PT) and
// the PT points from (tid % (16 / PT)) * PT: PT = 2 for widths up to 32 (32
// neurons x 8 point pairs; width 20 keeps five warps whole), else 4 (64
// neurons x 4 point quads).  Each stream word loaded then feeds PT FMAs, and
// the warp's lanes of one neuron read consecutive words.
__device__ __forceinline__ bool narrow(int width) { return width <= 32; }

// Input streams of layer 0: h = x, h_k = e_k[, h_kk = 0].  Thread tid < 16 d
// takes x[p0 + tid % 16, tid / 16] from x_own (loaded by load_tile); any
// further values of x (d > 16) come from X.
template <int ND, bool SECOND>
__device__ void seed_inputs(const float* __restrict__ X, int d, int p0, int P, int max_w,
                            float* h, int tid, float x_own) {
  constexpr int S = streams(ND, SECOND);
  for (int idx = tid; idx < S * d * kBlockPoints; idx += kThreads) {
    const int p = idx % kBlockPoints;
    const int i = (idx / kBlockPoints) % d;
    const int s = idx / (kBlockPoints * d);
    float v = 0.0f;
    if (s == 0) {
      const int gp = p0 + p;
      v = idx == tid ? x_own : gp < P ? X[(size_t)gp * d + i] : 0.0f;
    } else if (s <= ND) {
      v = (i == s - 1) ? 1.0f : 0.0f;
    }
    h[at(s, i, max_w) + p] = v;
  }
}

// Forward replay of hidden layer (W [din, dout], b): z_s = h_s W (+ b on the
// value stream) for every stream s; stashes (t or z, z_k[, z_kk]) in st and
// writes the layer's output streams to hout.
template <int ND, int ACT, int PT, int UNR, bool SECOND>
__device__ __forceinline__ void replay_layer(const float* hin, const float* W, const float* b, int din,
                                             int dout, int max_w, float* st, float* hout, int tid) {
  constexpr int S = streams(ND, SECOND);
  const int j = tid / (kBlockPoints / PT);
  const int p = (tid % (kBlockPoints / PT)) * PT;
  if (j >= dout) return;
  float acc[S][PT];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < PT; ++e) acc[s][e] = 0.0f;
#pragma unroll(UNR * 2 / PT)
  for (int i = 0; i < din; ++i) {
    const float w = W[i * dout + j];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float v[PT];
      load_pts<PT>(hin + at(s, i, max_w) + p, v);
#pragma unroll
      for (int e = 0; e < PT; ++e) acc[s][e] = fmaf(v[e], w, acc[s][e]);
    }
  }
#pragma unroll
  for (int e = 0; e < PT; ++e) acc[0][e] = stash_value<ACT>(acc[0][e] + b[j]);
#pragma unroll
  for (int s = 0; s < S; ++s) store_pts<PT>(st + at(s, j, max_w) + p, acc[s]);
  // The output streams one point at a time (fewer live registers).
#pragma unroll
  for (int e = 0; e < PT; ++e) {
    float v[S], h[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = acc[s][e];
    outputs<ND, ACT, SECOND>(v, h);
#pragma unroll
    for (int s = 0; s < S; ++s) hout[at(s, j, max_w) + p + e] = h[s];
  }
}

// A hidden layer's output streams, recomputed from its stash.
template <int ND, int ACT, int PT, bool SECOND>
__device__ __forceinline__ void activate_layer(const float* st, int width, int max_w, float* h,
                                               int tid) {
  constexpr int S = streams(ND, SECOND);
  const int j = tid / (kBlockPoints / PT);
  const int p = (tid % (kBlockPoints / PT)) * PT;
  if (j >= width) return;
#pragma unroll 1
  for (int e = 0; e < PT; ++e) {
    float v[S], out[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = st[at(s, j, max_w) + p + e];
    outputs<ND, ACT, SECOND>(v, out);
#pragma unroll
    for (int s = 0; s < S; ++s) h[at(s, j, max_w) + p + e] = out[s];
  }
}

// gh_s = gz_s W^T for every stream: the cotangents of the layer's inputs.
template <int S, int PT, int UNR>
__device__ __forceinline__ void gh_layer(const float* gz, const float* W, int din, int dout, int max_w,
                                         float* gh, int tid) {
  const int i = tid / (kBlockPoints / PT);
  const int p = (tid % (kBlockPoints / PT)) * PT;
  if (i >= din) return;
  float acc[S][PT];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < PT; ++e) acc[s][e] = 0.0f;
#pragma unroll(UNR * 2 / PT)
  for (int j = 0; j < dout; ++j) {
    const float w = W[i * dout + j];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float v[PT];
      load_pts<PT>(gz + at(s, j, max_w) + p, v);
#pragma unroll
      for (int e = 0; e < PT; ++e) acc[s][e] = fmaf(v[e], w, acc[s][e]);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) store_pts<PT>(gh + at(s, i, max_w) + p, acc[s]);
}

// gz of a hidden layer from gh and its stash (gz_point at every point).
template <int ND, int ACT, int PT, bool SECOND>
__device__ __forceinline__ void gz_layer(const float* st, const float* gh, int width, int max_w, float* gz,
                                         int tid) {
  constexpr int S = streams(ND, SECOND);
  const int j = tid / (kBlockPoints / PT);
  const int p = (tid % (kBlockPoints / PT)) * PT;
  if (j >= width) return;
#pragma unroll 1
  for (int e = 0; e < PT; ++e) {
    float v[S], g[S], out[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      v[s] = st[at(s, j, max_w) + p + e];
      g[s] = gh[at(s, j, max_w) + p + e];
    }
    gz_point<ND, ACT, SECOND>(v, g, out);
#pragma unroll
    for (int s = 0; s < S; ++s) gz[at(s, j, max_w) + p + e] = out[s];
  }
}

// gW of one layer, out[i * dout + j] = sum_{s < s_in, p} h_s[i, p] gz_s[j, p],
// added to out, in register tiles of two rows (i0, i0 + hi) by two columns
// (j0, j0 + hj), hi = ceil(din / 2), hj = ceil(dout / 2), four points a
// load: each word loaded feeds two FMAs.  Thread t takes tile t (and t + 256,
// ...), so each thread owns the same entries on every tile.  Each entry sums
// over s, then p, in order.
template <int S, int UNR>
__device__ __forceinline__ void gw_tiles(const float* h, const float* gz, int din, int dout, int s_in,
                                         int max_w, float* out, int tid) {
  const int hi = (din + 1) / 2;
  const int hj = (dout + 1) / 2;
  for (int t = tid; t < hi * hj; t += kThreads) {
    const int i0 = t / hj;
    const int j0 = t - i0 * hj;
    const bool i1_ok = i0 + hi < din;
    const bool j1_ok = j0 + hj < dout;
    const int i1 = i1_ok ? i0 + hi : i0;
    const int j1 = j1_ok ? j0 + hj : j0;
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
    for (int s = 0; s < s_in; ++s) {
#pragma unroll(UNR == 4 ? 4 : 1)
      for (int p = 0; p < kBlockPoints; p += 4) {
        float h0[4], h1[4], g0[4], g1[4];
        load_pts<4>(h + at(s, i0, max_w) + p, h0);
        load_pts<4>(h + at(s, i1, max_w) + p, h1);
        load_pts<4>(gz + at(s, j0, max_w) + p, g0);
        load_pts<4>(gz + at(s, j1, max_w) + p, g1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a00 = fmaf(h0[e], g0[e], a00);
          a01 = fmaf(h0[e], g1[e], a01);
          a10 = fmaf(h1[e], g0[e], a10);
          a11 = fmaf(h1[e], g1[e], a11);
        }
      }
    }
    out[i0 * dout + j0] += a00;
    if (j1_ok) out[i0 * dout + j1] += a01;
    if (i1_ok) out[i1 * dout + j0] += a10;
    if (i1_ok && j1_ok) out[i1 * dout + j1] += a11;
  }
}

// MINB: the blocks per SM the register budget is set for (launch picks 4
// where four blocks' shared memory fits an SM, else 1).  SECOND: the fields
// u, u_k, u_kk (else u, u_k).
template <int ND, int ACT, int MINB, bool SECOND>
__global__ void __launch_bounds__(kThreads, MINB)
fused_fields_bwd_kernel(const float* __restrict__ X, const float* __restrict__ G,
                        const float* __restrict__ params, const Widths wd, const int n_params,
                        const int max_w, const int P, const int tiles, float* __restrict__ partials,
                        float* __restrict__ gX) {
  constexpr int S = streams(ND, SECOND);  // streams = field columns
  // Loop unrolling: deep where one block has the SM to itself (latency
  // bound), shallow where four share its registers.
  constexpr int UNR = MINB == 1 ? 4 : 2;
  extern __shared__ __align__(16) float smem[];
  const int L = wd.n_layers;
  const int np = padded(n_params);
  const int buf = S * max_w * kPointStride;  // floats in one stream buffer
  float* wsm = smem;
  float* acc = wsm + np;    // this block's gW, gb sums, packed as params
  float* stash = acc + np;  // [L - 1][S][max_w][kPointStride]
  float* hin = stash + (L - 1) * buf;
  float* hout = hin + buf;
  float* gh = hout + buf;

  const int tid = threadIdx.x;
  const int d = wd.w[0];
  // Unrolled so that several loads of the network are in flight at once.
#pragma unroll 8
  for (int i = tid; i < np; i += kThreads) {
    wsm[i] = i < n_params ? params[i] : 0.0f;
    acc[i] = 0.0f;
  }

  for (int tile = 0; tile < tiles; ++tile) {
    const int p0 = (blockIdx.x * tiles + tile) * kBlockPoints;
    if (p0 >= P) break;
    // This thread's value of x (seed_inputs) and of g (the reverse), loaded
    // together here: g's load is in flight through the replay, and x is
    // kept for the second seeding at layer 1.
    const int gx = p0 + tid % kBlockPoints;
    const float x_own = tid < kBlockPoints * d && gx < P ? X[(size_t)gx * d + tid / kBlockPoints] : 0.0f;
    const int gg = p0 + tid / S;
    const float g_own = tid < kBlockPoints * S && gg < P ? G[(size_t)p0 * S + tid] : 0.0f;
    __syncthreads();  // the previous tile's last reads of hin and gz are done
    seed_inputs<ND, SECOND>(X, d, p0, P, max_w, hin, tid, x_own);
    __syncthreads();

    // ---- forward replay through the hidden layers, stashing (t or z), z_k[, z_kk] ----
    const float* Wl = wsm;
    for (int l = 0; l < L - 1; ++l) {
      const int din = wd.w[l];
      const int dout = wd.w[l + 1];
      const float* bl = Wl + din * dout;
      float* st = stash + l * buf;
      if (narrow(dout))
        replay_layer<ND, ACT, 2, UNR, SECOND>(hin, Wl, bl, din, dout, max_w, st, hout, tid);
      else
        replay_layer<ND, ACT, 4, UNR, SECOND>(hin, Wl, bl, din, dout, max_w, st, hout, tid);
      __syncthreads();
      float* t = hin;
      hin = hout;
      hout = t;
      Wl = bl + dout;
    }

    // ---- reverse: hin holds the last layer's input streams; gz <- g ----
    float* gz = hout;
    if (tid < kBlockPoints * S) gz[at(tid % S, 0, max_w) + tid / S] = g_own;
    __syncthreads();

    int off = n_params - (wd.w[L - 1] + 1);  // packed offset of W_{L-1}
    for (int l = L - 1; l >= 0; --l) {
      const int din = wd.w[l];
      const int dout = wd.w[l + 1];
      const float* W = wsm + off;
      // gW and gb, added to this block's sums; the h_kk streams of the input
      // layer are zero (firsts only: S is 1 + ND).
      gw_tiles<S, UNR>(hin, gz, din, dout, l == 0 ? 1 + ND : S, max_w, acc + off, tid);
      for (int j = tid; j < dout; j += kThreads) {
        const float* gs = gz + at(0, j, max_w);
        float sum = 0.0f;
#pragma unroll
        for (int p = 0; p < kBlockPoints; ++p) sum += gs[p];
        acc[off + din * dout + j] += sum;
      }
      if (l == 0) {
        // gX = gz W^T on the value stream only.
        const int p = tid % kBlockPoints;
        if (gX != nullptr && p0 + p < P) {
          for (int i = tid / kBlockPoints; i < din; i += kThreads / kBlockPoints) {
            float sum = 0.0f;
            for (int j = 0; j < dout; ++j) sum = fmaf(gz[at(0, j, max_w) + p], W[i * dout + j], sum);
            gX[(size_t)(p0 + p) * d + i] = sum;
          }
        }
        break;
      }
      if (narrow(din))
        gh_layer<S, 2, UNR>(gz, W, din, dout, max_w, gh, tid);
      else
        gh_layer<S, 4, UNR>(gz, W, din, dout, max_w, gh, tid);
      __syncthreads();

      // Hidden layer l - 1 (output width din): its gz from gh and the stash,
      // and its input streams, recomputed from the layer below.
      const float* st = stash + (l - 1) * buf;
      if (narrow(din))
        gz_layer<ND, ACT, 2, SECOND>(st, gh, din, max_w, gz, tid);
      else
        gz_layer<ND, ACT, 4, SECOND>(st, gh, din, max_w, gz, tid);
      if (l == 1) {
        seed_inputs<ND, SECOND>(X, d, p0, P, max_w, hin, tid, x_own);
      } else if (narrow(wd.w[l - 1])) {
        activate_layer<ND, ACT, 2, SECOND>(stash + (l - 2) * buf, wd.w[l - 1], max_w, hin, tid);
      } else {
        activate_layer<ND, ACT, 4, SECOND>(stash + (l - 2) * buf, wd.w[l - 1], max_w, hin, tid);
      }
      __syncthreads();
      off -= wd.w[l - 1] * din + din;
    }
  }

  // One partial row per block: its sums over its tiles (pad columns zero).
  __syncthreads();
  float* part = partials + (size_t)blockIdx.x * np;
  for (int i = tid; i < np; i += kThreads) part[i] = acc[i];
}

// out[k] = sum_b partials[b, k], b in a fixed order, in one launch.  A lane
// takes four consecutive columns: one 16-byte load a row where rows are
// 16-byte aligned (ALIGNED), else four 4-byte loads through the read-only
// cache, which merges them.  A block has kSumThreads threads: blockDim.x
// lanes by blockDim.y = kSumThreads / blockDim.x row groups; the grid is
// (column tiles) x (row slabs).  In block (c, r), group y sums rows y, y +
// blockDim.y, ... of slab r, and the groups' sums are added by a pairwise
// tree in a fixed order.  With one slab that sum is the result.  Otherwise
// each block writes its slab's sum to scratch[r] and takes an integer ticket
// for its column tile (atomicAdd after __threadfence); the block that draws
// the last ticket adds the slabs, again by groups and tree, and resets the
// ticket.  Only the integer ticket is atomic, so the float sums are in a
// fixed order and repeat bit for bit.  The tickets are the launch's own (one
// word per column tile, zeroed by the wrapper before the first launch and
// left at zero by each), so sums in flight at once on other streams, or in
// replayed CUDA graphs, share nothing.  The plan (lanes, slabs) comes from
// ops/fused_fields.py::block_sum_plan.

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Columns 4c .. 4c + 3 of one row of n floats (zero past n).
template <bool ALIGNED>
__device__ __forceinline__ float4 load4(const float* row, int c, int n) {
  if (ALIGNED) return __ldcg(reinterpret_cast<const float4*>(row) + c);
  const int k = 4 * c;
  return make_float4(k < n ? __ldg(row + k) : 0.0f, k + 1 < n ? __ldg(row + k + 1) : 0.0f,
                     k + 2 < n ? __ldg(row + k + 2) : 0.0f, k + 3 < n ? __ldg(row + k + 3) : 0.0f);
}

// Rows [r0, r1) (pitch floats apart) at column group c, summed by the
// block's row groups and their tree; the sum reaches the threads of group 0
// (the others get zero).
template <bool ALIGNED>
__device__ __forceinline__ float4 slab_sum(const float* rows, size_t pitch, int r0, int r1, int n, int c,
                                           float4* part) {
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int lanes = blockDim.x;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (4 * c < n) {
#pragma unroll 4
    for (int r = r0 + y; r < r1; r += blockDim.y) add_to(acc, load4<ALIGNED>(rows + r * pitch, c, n));
  }
  part[y * lanes + x] = acc;
  __syncthreads();
  for (int half = blockDim.y / 2; half > 0; half /= 2) {
    if (y < half) add_to(part[y * lanes + x], part[(y + half) * lanes + x]);
    __syncthreads();
  }
  const float4 s = y == 0 ? part[x] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();  // part is free again
  return s;
}

template <bool ALIGNED>
__device__ __forceinline__ void store4(float* out, int c, int n, const float4& v) {
  if (ALIGNED) {
    reinterpret_cast<float4*>(out)[c] = v;
  } else {
    const int k = 4 * c;
    if (k < n) out[k] = v.x;
    if (k + 1 < n) out[k + 1] = v.y;
    if (k + 2 < n) out[k + 2] = v.z;
    if (k + 3 < n) out[k + 3] = v.w;
  }
}

// scratch: [slabs, ceil(n / 4)] float4s (any n).
template <bool ALIGNED>
__global__ void __launch_bounds__(kSumThreads)
block_sum_kernel(const float* __restrict__ partials, const int n_rows, const int n,
                 const int rows_per_slab, float4* __restrict__ scratch, unsigned int* __restrict__ tickets,
                 float* __restrict__ out) {
  __shared__ float4 part[kSumThreads];
  __shared__ bool last;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int n4 = (n + 3) / 4;
  const int r0 = blockIdx.y * rows_per_slab;
  const int r1 = min(n_rows, r0 + rows_per_slab);
  const float4 s = slab_sum<ALIGNED>(partials, n, r0, r1, n, c, part);
  if (gridDim.y == 1) {
    if (threadIdx.y == 0 && c < n4) store4<ALIGNED>(out, c, n, s);
    return;
  }
  if (threadIdx.y == 0 && c < n4) scratch[(size_t)blockIdx.y * n4 + c] = s;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float4 t = slab_sum<true>(reinterpret_cast<const float*>(scratch), 4 * (size_t)n4, 0, gridDim.y,
                                  4 * n4, c, part);
  if (threadIdx.y == 0 && c < n4) store4<ALIGNED>(out, c, n, t);
  if (threadIdx.x == 0 && threadIdx.y == 0) tickets[blockIdx.x] = 0;
}

struct BwdArgs {
  const float* X;
  const float* G;
  const float* params;
  Widths wd;
  int n_params, max_w, P, tiles;
  bool second;
  float* partials;
  float* gX;
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

template <int ND, int ACT, int MINB, bool SECOND>
cudaError_t launch(const BwdArgs& a) {
  // Opt in to more dynamic shared memory only when a launch needs more than
  // any before it (per instantiation and device), as B1 does.
  static int allowed[kMaxDevices] = {};
  auto kernel = fused_fields_bwd_kernel<ND, ACT, MINB, SECOND>;
  const bool known = a.device >= 0 && a.device < kMaxDevices;
  if (!known || (int)a.smem > allowed[a.device]) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return err;
    if (known) allowed[a.device] = (int)a.smem;
  }
  const int n_tiles = (a.P + kBlockPoints - 1) / kBlockPoints;
  const dim3 grid((n_tiles + a.tiles - 1) / a.tiles);
  kernel<<<grid, dim3(kThreads), a.smem, a.stream>>>(a.X, a.G, a.params, a.wd, a.n_params, a.max_w, a.P,
                                                     a.tiles, a.partials, a.gX);
  return cudaGetLastError();
}

// Four blocks an SM where their shared memory fits (228 KB an SM, 1 KB of
// it reserved per block), so their registers are capped at 64; else one.
template <int ND, int ACT, bool SECOND>
cudaError_t launch_minb(const BwdArgs& a) {
  return 4 * (a.smem + 1024) <= 228 * 1024 ? launch<ND, ACT, 4, SECOND>(a) : launch<ND, ACT, 1, SECOND>(a);
}

template <int ND, bool SECOND>
cudaError_t launch_act(int act, const BwdArgs& a) {
  return act == 0 ? launch_minb<ND, 0, SECOND>(a) : launch_minb<ND, 1, SECOND>(a);
}

// Second derivatives only: the firsts-only mode is hp_fused_fields_bwd_firsts_f32.
template <int ND>
cudaError_t launch_mode(int act, const BwdArgs& a) {
  return a.second ? launch_act<ND, true>(act, a) : cudaErrorInvalidValue;
}

// The arguments, checked, into a (widths up to kResidentMaxWidth); else an
// error code.
cudaError_t bwd_args(const float* X, const float* G, const float* params, const int* widths, int n_layers, int P,
                     int n_dirs, int second, int activation, int tiles, float* partials, float* gX, int device,
                     void* stream, BwdArgs& a) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_dirs < 1 || n_dirs > 3 || P < 1 || tiles < 1 ||
      second < 0 || second > 1 || activation < 0 || activation > 1 || widths[n_layers] != 1 || n_dirs > widths[0])
    return cudaErrorInvalidValue;
  a = BwdArgs{X,  G,  params, Widths{}, 0, 0, P, tiles, second == 1, partials, gX, 0, device,
              static_cast<cudaStream_t>(stream)};
  a.wd.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || widths[l] > kResidentMaxWidth) return cudaErrorInvalidValue;
    a.wd.w[l] = widths[l];
    if (l < n_layers) {
      a.n_params += widths[l] * widths[l + 1] + widths[l + 1];
      if (widths[l] > a.max_w) a.max_w = widths[l];
    }
  }
  return use_device(device);
}

}  // namespace

extern "C" {

int hp_fused_fields_bwd_max_width() { return kMaxWidth; }
int hp_fused_fields_bwd_resident_max_width() { return kResidentMaxWidth; }
int hp_fused_fields_bwd_max_layers() { return kMaxLayers; }
int hp_fused_fields_bwd_block_points() { return kBlockPoints; }
int hp_fused_fields_bwd_point_stride() { return kPointStride; }

// Shared memory (bytes) one block needs: the packed network, the block's
// gW/gb sums (each n_params rounded up to a multiple of 4), the stash of the
// n_layers - 1 hidden layers and three stream buffers, each of
// streams(n_dirs, second) streams.  The wrapper checks it against the card's
// limit before launching; ops/fused_fields.py::bwd_plan repeats it.
long long hp_fused_fields_bwd_smem_bytes(int n_params, int max_w, int n_layers, int n_dirs, int second) {
  const long long S = streams(n_dirs, second != 0);
  return (long long)sizeof(float) *
         (2LL * padded(n_params) + (n_layers + 2LL) * S * max_w * kPointStride);
}

// The most shared memory one block may opt in to on `device` (-1 on error).
int hp_fused_fields_bwd_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// X [P, widths[0]] and G [P, 1 + 2 n_dirs] row-major fp32 on device
// `device`; second must be 1 (the firsts-only mode, g [P, 1 + n_dirs], is
// csrc/fused_fields_bwd_firsts.cu's hp_fused_fields_bwd_firsts_f32);
// params packs W_0 [in, out], b_0, W_1, b_1, ... back to back (n_params
// floats); widths (host memory) has n_layers + 1 entries and ends in 1.  Each
// block takes `tiles` consecutive tiles of 16 points and writes one row of
// partials [ceil(ceil(P / 16) / tiles), padded(n_params)]: its sums of gW and
// gb in the packed layout, pad columns zero.  Unless gX is null it writes gX
// [P, widths[0]].  activation: 0 = tanh, 1 = sin.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success).
int hp_fused_fields_bwd_f32(const float* X, const float* G, const float* params, const int* widths,
                            int n_layers, int P, int n_dirs, int second, int activation, int tiles,
                            float* partials, float* gX, int device, void* stream) {
  BwdArgs a;
  cudaError_t err = bwd_args(X, G, params, widths, n_layers, P, n_dirs, second, activation, tiles, partials, gX,
                             device, stream, a);
  if (err != cudaSuccess) return (int)err;
  a.smem = (size_t)hp_fused_fields_bwd_smem_bytes(a.n_params, a.max_w, n_layers, n_dirs, second);
  switch (n_dirs) {
    case 1: return (int)launch_mode<1>(activation, a);
    case 2: return (int)launch_mode<2>(activation, a);
    default: return (int)launch_mode<3>(activation, a);
  }
}

// out [n] = the sum over rows of partials [n_rows, n] (fp32, row-major), in a
// fixed order set by the plan (ops/fused_fields.py::block_sum_plan):
// `aligned` (n % 4 == 0 and partials and out 16-byte aligned: 16-byte loads
// and stores) or not; `lanes` (a power of two from 1 to 256) lanes of four
// columns a block; slabs of rows_per_slab rows.  scratch, 16-byte aligned,
// holds [slabs, 4 ceil(n / 4)] floats when there is more than one slab (else
// it may be null), and tickets [ceil(ceil(n / 4) / lanes)] zeroed words (may be
// null with one slab).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
int hp_block_sum_f32(const float* partials, int n_rows, int n, int aligned, int lanes, int rows_per_slab,
                     float* scratch, unsigned int* tickets, float* out, int device, void* stream) {
  if (n_rows < 1 || n < 1 || rows_per_slab < 1 || (aligned && n % 4 != 0) || lanes < 1 ||
      lanes > kSumThreads || (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int n4 = (n + 3) / 4;
  const dim3 block(lanes, kSumThreads / lanes);
  const dim3 grid((n4 + lanes - 1) / lanes, (n_rows + rows_per_slab - 1) / rows_per_slab);
  if ((grid.y > 1 && (scratch == nullptr || tickets == nullptr || grid.x > (unsigned)kMaxSumTiles)) ||
      grid.y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* sc = reinterpret_cast<float4*>(scratch);
  if (aligned)
    block_sum_kernel<true><<<grid, block, 0, s>>>(partials, n_rows, n, rows_per_slab, sc, tickets, out);
  else
    block_sum_kernel<false><<<grid, block, 0, s>>>(partials, n_rows, n, rows_per_slab, sc, tickets, out);
  return cudaGetLastError();
}

}  // extern "C"
