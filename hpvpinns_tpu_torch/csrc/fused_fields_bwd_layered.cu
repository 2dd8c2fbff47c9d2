// B2's layered form: the second-derivative backward as per-layer fp32 GEMMs
// over many points, the per-point rules in their epilogues (sm_90a).  Built
// into the fused_fields_bwd library beside the resident form of
// csrc/fused_fields_bwd.cu, whose per-point rules it shares
// (csrc/fused_fields_bwd_rules.cuh), and whose block sum adds its partials.
//
// Replaces hpvpinns_tpu/ops/pallas_fields.py::_fields_bwd_kernel (:259-381,
// launched by _pallas_fields_bwd :385-448), the VJP of fields_flat for
// second=True: from the cotangent g [P, S] of every field column (S = 1 +
// 2 n_dirs: u, u_k, u_kk) it gives gW, gb of every layer and gX.  Compiled
// without the second-order streams (SECOND false: S = 1 + n_dirs, the stash
// (t or z, z_k), no z_kk, h_kk or gz_kk) it is the VJP of fields_flat for
// second=False, which the JAX package leaves to XLA (pallas_fields.py:
// 190-196); a firsts-only chunk holds (1 + 2 n_dirs) / (1 + n_dirs) times
// the points of a second-derivative one under the same cap.  The TPU
// kernel walks tiles of points through every layer at once; here each layer
// is one launch over a chunk of points:
//   seed     stash_0 from X (layer 0: z = x W + b, z_k = W[k], z_kk = 0)
//   replay   Z_s = H_s W_l over the chunk, H = outputs(stash_{l-1}) built as
//            the A tile is loaded; epilogue: + b and stash_value on the value
//            stream; writes stash_l (t or z, z_k, z_kk)
//   head     the linear last layer: gh_s = g_s W_last and gz_point with the
//            stash below (in place: the stash becomes gz), gW_last and gb_last
//            split over the point slices
//   gw       gW_l = sum_s H_s^T GZ_s, split-K over the point slices, and gb_l
//            (the value stream's column sums) in the same launch
//   gh       GH_s = GZ_s W_l^T over the chunk; epilogue: gz_point with the
//            stash of the layer below, written in place over that stash
//   input    gW_0, gb_0 from X, the e_k seeds and gz_0, split over the slices,
//            a group of up to 8 inputs a block (any input count)
//   gx       gX = gz_0 W_0^T on the value stream
// in that order on one stream (gw_l before gh_l, which overwrites the stash
// gw_l reads).  Each slice of slice_points consecutive points writes one row
// of partials in pack_params' packed order (every parameter, pad columns
// zero); block_sum_kernel (fused_fields_bwd.cu) adds the rows in a fixed
// order.  No float atomics, and the plan (ops/fused_fields.py::bwd_plan) comes
// from the shapes alone: two runs give the same bits on any card.  The form is
// not bit-identical to the resident form (another order of sums).  bwd_plan
// takes it for every network above the resident form's limits; its times on
// the card are in PERF.md §6.
//
// Up to three inputs (x, y, z) every entry of gW_0, gb_0 and gX is summed
// over the same points, in the same lanes and trees, as before the form took
// any input count, so its partials and gX keep their bits there; above
// three, input takes 8 inputs a block.
//
// A network without a hidden layer, (d, 1) with d above the resident form's
// width: u = x W + b, u_k = W[k], u_kk = 0, so gW[i] = sum_p x_i g_0 + (i <
// n_dirs) sum_p g_{1+i}, gb = sum_p g_0 and gX = g_0 W^T.  That is the input
// and gx launches with g itself as gz_0 (its rows S floats apart, its seed
// streams one float apart), and nothing else: no stash, no scratch.  The
// resident form was the other way (it is linear there too), but its shared
// memory grows with the input width (432 KB at (256, 1), n_dirs 3), and the
// resident kernel stays as it is.
//
// What bounds it at (2,256,256,256,1), P 16,384, n_dirs 2 (S = 5): 1,973,248
// multiply-adds a point, 64.66 GFLOP, about a third each in the replay, gW and
// gh, all GEMM-shaped: 965.1 us at the fp32 SIMT peak (67 TFLOP/s; IEEE fp32
// FFMA, no tensor cores, no --use_fast_math).  The GEMMs do 64 FMAs per value
// they bring from device memory (A tiles are reused by every neuron tile), so
// they are bound by operations, not by the 3.35 TB/s of HBM.
//
// What its tiling does about what held back the form it retired (the wide
// form: one kernel walking tiles of 16 points, each block's stash in device
// memory):
// - Tiles of 16 points, W re-read P/16 times: a replay or gh block tile is 64
//   points x 64 neurons x all S streams, and gW's is 128 x 128 entries over a
//   slice of points, so each W value in shared memory feeds 64 S FMAs.
// - Few FMAs per shared load: a thread holds acc[S][4 points][4 neurons] (gW:
//   8 x 8 entries); per k step one 16-byte load of W and S of the streams feed
//   16 S FMAs (gW: four loads, 64 FMAs).
// - A barrier every chunk of k, no overlap: chunks of 8 k (gW: 2 points x S,
//   4 at S <= 3) are double-buffered in shared memory, the next chunk's
//   cp.async copies in flight during this chunk's FMAs, one barrier a chunk.
//   The A operand (H from the stash) lands in a staging buffer and each
//   thread applies outputs() to its own words on their way to the chunk's
//   buffer, so no prefetch registers are held: two blocks an SM at S <= 5.
// - Small gW bands with short sums: each gW block sums slice_points x S
//   terms into 64 registers a thread and writes its entries once.
// - Large partials: one row per slice, at most 128 rows (68 MB at 3 x 256).
// - Spills and occupancy: 256 threads, two blocks an SM (one at S = 7) and
//   no spill stores in the GEMMs and gW (ptxas's report, chip_smoke.py phase
//   2).  Chunks of 16 k with dynamic shared memory were 1% faster at 3 x 256
//   and 2% slower at n_dirs 3; copies spread evenly over all 256 threads were
//   4% slower in the GEMMs (5% faster in gW, which keeps them).
//
// Bytes and chunks of points: the scratch holds the stash of every hidden
// layer for one chunk of chunk_points consecutive points, (n_layers - 1) x S
// x chunk_points x pitch floats, pitch = the widest hidden layer rounded up
// to 4; gz replaces the stash in place on the way down, so nothing else is
// stored.  bwd_plan picks chunk_points from the shapes alone: the most
// 2,048-point groups (a power of two) whose stash stays within 2^28 bytes,
// or P where that covers P (then the launches are those of one call over all
// points).  The C function loops over the chunks on its stream; each chunk
// is cut into the same slices, and slice r of every chunk writes partial row
// r: the first chunk stores it, each later chunk adds into it, in chunk
// order.  So the partials stay at most 128 rows, no float atomic is added
// and the sum order still comes from the shapes alone.  Only points are
// chunked: a chunk keeps up to 128 slices, so gW's grid (dout/128, din/128,
// slices) still fills the card.  Every stash is written once and read by the
// next replay, by gw and by gh; a layer's stash (84 MB at 3 x 256 and 16,384
// points) does not fit the 50 MB L2: the GEMMs' FMAs, not their reads, set
// the time.
//
// Precision: IEEE fp32 throughout; build without --use_fast_math.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "fused_fields_bwd_rules.cuh"  // stash_value, outputs, gz_point

namespace {

constexpr int kLayeredMaxLayers = 16;
constexpr int kLayeredMaxWidth = 256;  // every width, the input layer's too
constexpr int kThreadsL = 256;
constexpr int kSlicePoints = 16;  // a slice is a multiple of this many points
constexpr int kGemmM = 64;        // replay, gh: points per block tile
constexpr int kGemmN = 64;        // replay, gh: neurons per block tile
constexpr int kGemmK = 8;         // replay, gh: k per shared-memory chunk
constexpr int kGemmPitch = kGemmM + 4;
constexpr int kGwTile = 128;      // gw: entries per block tile side
constexpr int kLaneRows = 32;     // head, input: neurons per block (8 point lanes)
constexpr int kPointLanes = kThreadsL / kLaneRows;
constexpr int kGxPoints = kThreadsL / 32;  // gx: points per block, 32 lanes each
constexpr int kFewInputs = 3;              // x, y, z: one group of the input kernel
constexpr int kInputGroup = 8;             // input: inputs a block above kFewInputs

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Four consecutive floats of a row at column c (a multiple of 4, 16-byte
// aligned), zero past column n.
__device__ __forceinline__ float4 load_row4(const float* row, int c, int n) {
  if (c >= n) return zero4();
  float4 v = *reinterpret_cast<const float4*>(row + c);
  if (c + 1 >= n) v.y = 0.0f;
  if (c + 2 >= n) v.z = 0.0f;
  if (c + 3 >= n) v.w = 0.0f;
  return v;
}

// A partial-row entry: the first chunk of points stores it, each later chunk
// adds into it (ACCUM; in chunk order: the chunks run one after another on
// one stream).
template <bool ACCUM>
__device__ __forceinline__ void put(float* at, float v) {
  if (ACCUM)
    *at += v;
  else
    *at = v;
}

// ---------------------------------------------------------------------------
// seed: the stash of hidden layer 0 from X [P, d]: z = sum_i x_i W0[i, j] +
// b0[j] (summed from i = 0, as the resident form's replay), z_k = W0[k, j]
// [, z_kk = 0]; columns j in [w1, pitch) zero.
template <int ND, int ACT, bool SECOND>
__global__ void __launch_bounds__(kThreadsL)
bwd_layered_seed(const float* __restrict__ X, const float* __restrict__ W0, const float* __restrict__ b0, int d,
                 int w1, int P, int pitch, long long sstride, float* __restrict__ st0) {
  constexpr int S = streams(ND, SECOND);
  const long long n = (long long)P * pitch;
  for (long long idx = blockIdx.x * (long long)kThreadsL + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * kThreadsL) {
    const int p = (int)(idx / pitch);
    const int j = (int)(idx % pitch);
    float v[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = 0.0f;
    if (j < w1) {
      float z = 0.0f;
      for (int i = 0; i < d; ++i) z = fmaf(X[(long long)p * d + i], W0[i * w1 + j], z);
      v[0] = stash_value<ACT>(z + b0[j]);
#pragma unroll
      for (int k = 0; k < ND; ++k) v[1 + k] = W0[k * w1 + j];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) st0[s * sstride + idx] = v[s];
  }
}

// ---------------------------------------------------------------------------
// replay (REPLAY) and gh: one GEMM over all points, M = points, every stream.
//   replay: out_s[p, n] = sum_k outputs(A)_s[p, k] W[k, n], K = din, N = dout;
//           epilogue: + b and stash_value on s = 0, stored to out (stash_l)
//   gh:     acc_s[p, n] = sum_k A_s[p, k] W[n, k], K = dout, N = din (A = gz_l);
//           epilogue: gz_point(out[p, n], acc[p, n]) stored over out (stash_{l-1})
// A and out are [S][P][pitch] (sstride = P pitch floats apart).  Block tile
// kGemmM points x kGemmN neurons; thread (ty, tx) of 16 x 16 holds points
// ty*4.. and neurons tx*4.. of every stream.  Threads 0-127 copy the A chunk
// (point t / 2, k 4 (t % 2).. of every stream: 16 bytes a stream, two threads
// a 32-byte row segment) with cp.async into `raw` and, once it has landed,
// read their own words back, apply outputs() (replay) and store them to the
// chunk's buffer; threads 128-255 copy the W chunk with cp.async straight
// into its buffer.  No prefetch registers: at S = 5 the accumulators and two
// blocks an SM fit the 128 registers.
template <int S>
struct GemmSmem {
  float a[2][S][kGemmK][kGemmPitch];
  float b[2][kGemmK][kGemmPitch];
  float raw[S][kGemmM][kGemmK];  // the next A chunk as it lands, [s][point][k]
};

template <int ND, int ACT, bool REPLAY, bool SECOND>
__global__ void __launch_bounds__(kThreadsL, streams(ND, SECOND) <= 5 ? 2 : 1)
bwd_layered_gemm(const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias, int K,
                 int N, int P, int pitch, long long sstride, float* __restrict__ out) {
  constexpr int S = streams(ND, SECOND);
  __shared__ __align__(16) GemmSmem<S> sm;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kGemmM;
  const int n0 = blockIdx.y * kGemmN;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool loads_a = tid < 128;  // warp-uniform
  const int t = tid & 127;
  // A loader: point am, k column 4 aq..
  const int am = t / 2;
  const int aq = t % 2;
  const int ap = m0 + am;
  // W loader.  replay: row k = t / 16 of W, columns 4 (t % 16)..;  gh: W^T,
  // rows n = t / 8 + 16 e of W, column k = t % 8 (a warp reads four 32-byte
  // row segments an instruction)
  const int bk = REPLAY ? t / 16 : t % 8;
  const int bn = REPLAY ? 4 * (t % 16) : t / 8;

  // Start the copies of chunk k0 (A into raw, W into buffer buf).  Words past
  // P, K or N are zero: stored directly (only at the edges).
  auto fetch = [&](int k0, int buf) {
    if (loads_a) {
      const int k = k0 + 4 * aq;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float* dst = &sm.raw[s][am][4 * aq];
        if (ap < P && k < K)  // k + 3 < pitch: the words past K are pads, zeroed in stage()
          __pipeline_memcpy_async(dst, A + s * sstride + (long long)ap * pitch + k, 16);
        else
          *reinterpret_cast<float4*>(dst) = zero4();
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + bk;
        const int n = REPLAY ? n0 + bn + e : n0 + bn + 16 * e;
        float* dst = REPLAY ? &sm.b[buf][bk][bn + e] : &sm.b[buf][bk][bn + 16 * e];
        if (k < K && n < N)
          __pipeline_memcpy_async(dst, W + (REPLAY ? (long long)k * N + n : (long long)n * K + k), 4);
        else
          *dst = 0.0f;
      }
    }
    __pipeline_commit();
  };
  // Once this thread's copies have landed: its A words from raw, through
  // outputs() (replay), into buffer buf.
  auto stage = [&](int k0, int buf) {
    __pipeline_wait_prior(0);
    if (!loads_a) return;
    float4 ra[S];
#pragma unroll
    for (int s = 0; s < S; ++s) ra[s] = *reinterpret_cast<const float4*>(&sm.raw[s][am][4 * aq]);
    const int k = k0 + 4 * aq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[S], h[S];
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = k + e < K ? get(ra[s], e) : 0.0f;
      if (REPLAY) {
        outputs<ND, ACT, SECOND>(v, h);  // zeros (past P or K) give zeros
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) h[s] = v[s];
      }
#pragma unroll
      for (int s = 0; s < S; ++s) sm.a[buf][s][4 * aq + e][am] = h[s];
    }
  };

  float acc[S][4][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.0f;

  const int nk = (K + kGemmK - 1) / kGemmK;
  fetch(0, 0);
  stage(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kGemmK, buf ^ 1);  // in flight during this chunk's FMAs
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[buf][kk][4 * tx]);
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 av = *reinterpret_cast<const float4*>(&sm.a[buf][s][kk][4 * ty]);
        const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[s][i][j] = fmaf(a[i], b[j], acc[s][i][j]);
      }
    }
    if (kt + 1 < nk) stage((kt + 1) * kGemmK, buf ^ 1);  // its last reads ended at the previous barrier
    __syncthreads();
  }

  const int n = n0 + 4 * tx;
  if (n >= N) return;  // after the last barrier
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + 4 * ty + i;
    if (p >= P) break;
    float* row = out + (long long)p * pitch + n;  // n + 3 < pitch: pitch = round4(widest hidden layer)
    if (REPLAY) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)  // pad columns: W and b are zero there, so zero
          v[j] = s == 0 ? stash_value<ACT>(acc[0][i][j] + (n + j < N ? bias[n + j] : 0.0f)) : acc[s][i][j];
        *reinterpret_cast<float4*>(row + s * sstride) = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      float4 st[S];
#pragma unroll
      for (int s = 0; s < S; ++s) st[s] = *reinterpret_cast<const float4*>(row + s * sstride);
      float4 gz[S];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // pad columns: stash and acc zero, so zero
        float v[S], g[S], o[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          v[s] = get(st[s], j);
          g[s] = acc[s][i][j];
        }
        gz_point<ND, ACT, SECOND>(v, g, o);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (j == 0) gz[s].x = o[s];
          if (j == 1) gz[s].y = o[s];
          if (j == 2) gz[s].z = o[s];
          if (j == 3) gz[s].w = o[s];
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) *reinterpret_cast<float4*>(row + s * sstride) = gz[s];
    }
  }
}

// ---------------------------------------------------------------------------
// gw: gW_l[i, j] = sum_s sum_{p in slice} H_s[p, i] GZ_s[p, j], H =
// outputs(stash_{l-1}) (din wide), GZ = gz_l (dout wide), for the block's
// 128 x 128 tile (i0, j0) and slice blockIdx.z; row `slice` of partials gets
// W_l's entries at `off` (row-major [din, dout]) and, from the blocks of the
// first row of tiles, gb_l = the column sums of the value stream of GZ at off
// + din dout (stored, or added with ACCUM).  Chunks of BKP points x S streams, double-buffered as in the
// GEMM above: threads 0-127 copy H (8 bytes a stream at point it / 64,
// columns 2 (it % 64)..) with cp.async into `raw` and apply outputs() on
// the way to their buffer, threads 128-255 copy GZ the same way straight
// into its buffer.  Thread (ty, tx) owns
// rows ty*4.., 64 + ty*4.. and columns tx*4.., 64 + tx*4..; each entry sums
// over chunks, then streams, then points, in order.
template <int S>
struct GwSmem {
  static constexpr int BKP = S <= 3 ? 4 : 2;
  float h[2][S][BKP][kGwTile];
  float g[2][S][BKP][kGwTile];
  float raw[S][BKP][kGwTile];  // the next H chunk as it lands
};

template <int ND, int ACT, bool ACCUM, bool SECOND>
__global__ void __launch_bounds__(kThreadsL, streams(ND, SECOND) <= 5 ? 2 : 1)
bwd_layered_gw(const float* __restrict__ H, const float* __restrict__ GZ, int din, int dout, int P, int pitch,
               long long sstride, int slice_points, float* __restrict__ partials, long long row_pitch, long long off) {
  constexpr int S = streams(ND, SECOND);
  constexpr int BKP = GwSmem<S>::BKP;
  __shared__ __align__(16) GwSmem<S> sm;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kGwTile;
  const int i0 = blockIdx.y * kGwTile;
  const int slice = blockIdx.z;
  const int pb = slice * slice_points;
  const int pe = min(P, pb + slice_points);
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool loads_h = tid < 128;  // warp-uniform: H (0-127) or GZ (128-255)
  const int t = tid & 127;
  constexpr int NIT = BKP * 64 / 128;  // pairs of columns a thread copies a chunk: point it / 64, columns 2 (it % 64)..
  const float* src = loads_h ? H : GZ;
  const int width = loads_h ? din : dout;
  const int c0 = loads_h ? i0 : j0;
  const bool gb_owner = blockIdx.y == 0 && tid < kGwTile;

  // Start the copies of the chunk from point p0 (H into raw, GZ into buffer
  // buf); rows past the slice and columns past the width are zero (col + 1 <
  // pitch: the words past the width are the stash's zero pads).
  auto fetch = [&](int p0, int buf) {
#pragma unroll
    for (int n = 0; n < NIT; ++n) {
      const int it = t + 128 * n;
      const int lp = it / 64, lc = 2 * (it % 64);
      const int p = p0 + lp, col = c0 + lc;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float* dst = loads_h ? &sm.raw[s][lp][lc] : &sm.g[buf][s][lp][lc];
        if (p < pe && col < width)
          __pipeline_memcpy_async(dst, src + s * sstride + (long long)p * pitch + col, 8);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(0.0f, 0.0f);
      }
    }
    __pipeline_commit();
  };
  auto stage = [&](int buf) {
    __pipeline_wait_prior(0);
    if (!loads_h) return;
#pragma unroll
    for (int n = 0; n < NIT; ++n) {
      const int it = t + 128 * n;
      const int lp = it / 64, lc = 2 * (it % 64);
      float2 r[S], o[S];
#pragma unroll
      for (int s = 0; s < S; ++s) r[s] = *reinterpret_cast<const float2*>(&sm.raw[s][lp][lc]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v[S], h[S];
#pragma unroll
        for (int s = 0; s < S; ++s) v[s] = c0 + lc + e < width ? (e == 0 ? r[s].x : r[s].y) : 0.0f;
        outputs<ND, ACT, SECOND>(v, h);  // zeros (past the slice or din) give zeros
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (e == 0) o[s].x = h[s];
          if (e == 1) o[s].y = h[s];
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) *reinterpret_cast<float2*>(&sm.h[buf][s][lp][lc]) = o[s];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.0f;
  float gb = 0.0f;

  const int nc = (pe - pb + BKP - 1) / BKP;
  fetch(pb, 0);
  stage(0);
  __syncthreads();
  for (int ct = 0; ct < nc; ++ct) {
    const int buf = ct & 1;
    if (ct + 1 < nc) fetch(pb + (ct + 1) * BKP, buf ^ 1);
    if (gb_owner) {
#pragma unroll
      for (int q = 0; q < BKP; ++q) gb += sm.g[buf][0][q][tid];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int q = 0; q < BKP; ++q) {
        const float4 h0 = *reinterpret_cast<const float4*>(&sm.h[buf][s][q][4 * ty]);
        const float4 h1 = *reinterpret_cast<const float4*>(&sm.h[buf][s][q][64 + 4 * ty]);
        const float4 g0 = *reinterpret_cast<const float4*>(&sm.g[buf][s][q][4 * tx]);
        const float4 g1 = *reinterpret_cast<const float4*>(&sm.g[buf][s][q][64 + 4 * tx]);
        const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(hv[a], gv[c], acc[a][c]);
      }
    }
    if (ct + 1 < nc) stage(buf ^ 1);
    __syncthreads();
  }

  float* row = partials + slice * row_pitch + off;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? 4 * ty + a : 64 + 4 * ty + a - 4);
    if (i >= din) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + (c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4);
      if (j < dout) put<ACCUM>(row + (long long)i * dout + j, acc[a][c]);
    }
  }
  if (gb_owner && j0 + tid < dout) put<ACCUM>(row + (long long)din * dout + j0 + tid, gb);
}

// The sums of the kPointLanes point lanes of a block, added by a fixed
// pairwise tree: red is [kPointLanes][count][kLaneRows]; lane 0 gets them.
__device__ __forceinline__ void lane_tree(float* red, int count, int lane, int q) {
  for (int half = kPointLanes / 2; half > 0; half /= 2) {
    __syncthreads();
    if (q < half)
      for (int c = 0; c < count; ++c)
        red[(q * count + c) * kLaneRows + lane] += red[((q + half) * count + c) * kLaneRows + lane];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// head: the linear last layer (W [din, 1], b).  For every point of the slice
// and neuron i: h = outputs(stash), gh_s = g_s W[i], gz = gz_point(stash, gh),
// written over the stash (it is gz_{L-2} from here on); gW[i] += sum_s h_s g_s
// and gb += g_0.  A block has kLaneRows neurons x kPointLanes point lanes
// (lane q takes points q, q + 8, ...); the lanes' sums meet in lane_tree.
// Row `slice` of partials gets W_last's entries at off, b_last at off + din
// (stored, or added with ACCUM), and zero pad columns from n_params to
// row_pitch.
template <int ND, int ACT, bool ACCUM, bool SECOND>
__global__ void __launch_bounds__(kThreadsL)
bwd_layered_head(const float* __restrict__ G, const float* __restrict__ W, int din, int P, int pitch,
                 long long sstride, int slice_points, float* __restrict__ st, float* __restrict__ partials,
                 long long row_pitch, long long off, int n_params) {
  constexpr int S = streams(ND, SECOND);
  __shared__ float red[kPointLanes * 2 * kLaneRows];
  const int lane = threadIdx.x % kLaneRows;
  const int q = threadIdx.x / kLaneRows;
  const int i = blockIdx.y * kLaneRows + lane;
  const int slice = blockIdx.x;
  const int pb = slice * slice_points;
  const int pe = min(P, pb + slice_points);
  const float w = i < din ? W[i] : 0.0f;
  float gw = 0.0f, gb = 0.0f;
#pragma unroll 2
  for (int p = pb + q; p < pe; p += kPointLanes) {
    float g[S], v[S], h[S], gh[S], o[S];
#pragma unroll
    for (int s = 0; s < S; ++s) g[s] = G[(long long)p * S + s];
    gb += g[0];
    if (i < din) {
      float* at = st + (long long)p * pitch + i;
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = at[s * sstride];
      outputs<ND, ACT, SECOND>(v, h);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        gw = fmaf(h[s], g[s], gw);
        gh[s] = g[s] * w;
      }
      gz_point<ND, ACT, SECOND>(v, gh, o);
#pragma unroll
      for (int s = 0; s < S; ++s) at[s * sstride] = o[s];
    }
  }
  red[(q * 2 + 0) * kLaneRows + lane] = gw;
  red[(q * 2 + 1) * kLaneRows + lane] = gb;
  lane_tree(red, 2, lane, q);
  if (q != 0) return;
  float* row = partials + slice * row_pitch;
  if (i < din) put<ACCUM>(row + off + i, red[lane]);
  if (blockIdx.y == 0 && lane == 0) {
    put<ACCUM>(row + off + din, red[kLaneRows]);
    for (long long k = n_params; k < row_pitch; ++k) row[k] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// input: layer 0 (W0 [d, w1]).  Its input streams are x, the seeds e_k and
// (with second derivatives) zero, so gW0[i, j] = sum_p x_i gz_0[p, j] + (i < n_dirs) sum_p gz_{1+i}[p, j]
// and gb0[j] = sum_p gz_0[p, j], over the slice's points; laid out as head.
// Block (slice, neuron tile, group) takes inputs KX blockIdx.z ..; group 0
// also the seed terms and gb (n_dirs <= 3 <= KX).  Each entry's sum runs
// over the same points in the same lanes and tree whatever KX is.  gz_0's
// value stream is gz[p pitch + j], its seed streams sstride floats apart (a
// network without a hidden layer passes g itself: pitch S, sstride 1).  Pad
// columns [pad_from, row_pitch) are zeroed here (head zeroes them where there
// is a hidden layer: pad_from = row_pitch).
template <int ND, int KX, bool ACCUM>
__global__ void __launch_bounds__(kThreadsL)
bwd_layered_input(const float* __restrict__ X, const float* __restrict__ gz, int d, int w1, int P, int pitch,
                  long long sstride, int slice_points, float* __restrict__ partials, long long row_pitch,
                  long long pad_from) {
  constexpr int C = KX + ND + 1;  // x terms, seed terms, gb
  __shared__ float red[kPointLanes * C * kLaneRows];
  const int lane = threadIdx.x % kLaneRows;
  const int q = threadIdx.x / kLaneRows;
  const int j = blockIdx.y * kLaneRows + lane;
  const int slice = blockIdx.x;
  const int i0 = blockIdx.z * KX;
  const bool first = blockIdx.z == 0;  // block-uniform
  const int pb = slice * slice_points;
  const int pe = min(P, pb + slice_points);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  if (j < w1) {
#pragma unroll 2
    for (int p = pb + q; p < pe; p += kPointLanes) {
      const float* at = gz + (long long)p * pitch + j;
      const float g0 = at[0];
#pragma unroll
      for (int c = 0; c < KX; ++c)
        if (i0 + c < d) acc[c] = fmaf(X[(long long)p * d + i0 + c], g0, acc[c]);
      if (first) {
#pragma unroll
        for (int k = 0; k < ND; ++k) acc[KX + k] += at[(1 + k) * sstride];
        acc[KX + ND] += g0;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) red[(q * C + c) * kLaneRows + lane] = acc[c];
  lane_tree(red, C, lane, q);
  if (q != 0 || j >= w1) return;
  float* row = partials + slice * row_pitch;
  for (int c = 0; c < KX && i0 + c < d; ++c) {
    const int i = i0 + c;
    put<ACCUM>(row + (long long)i * w1 + j,
               i < ND ? red[c * kLaneRows + lane] + red[(KX + i) * kLaneRows + lane] : red[c * kLaneRows + lane]);
  }
  if (!first) return;
  put<ACCUM>(row + (long long)d * w1 + j, red[(KX + ND) * kLaneRows + lane]);
  if (blockIdx.y == 0 && lane == 0)
    for (long long k = pad_from; k < row_pitch; ++k) row[k] = 0.0f;
}

// ---------------------------------------------------------------------------
// gx: gX[p, i] = sum_j gz_0[p, j] W0[i, j] (the value stream; the seeds are
// constants), 32 lanes a point.  Each lane holds its values of gz_0 (j =
// lane, lane + 32, ...) in registers and, input by input, sums them against
// W0's row in that order; the lanes' sums meet in a fixed tree of warp
// shuffles (lane l adds lane l + 16, then l + 8, ...: the pairs, and so the
// bits, of a tree in shared memory).  Above kFewInputs inputs with a first
// layer at most 32 wide (a network without a hidden layer: 1), a lane takes
// inputs i = lane, lane + 32, ... instead and sums over j in order: 32
// shuffle trees an input cost more there than the sums.
__global__ void __launch_bounds__(kThreadsL)
bwd_layered_gx(const float* __restrict__ gz, const float* __restrict__ W0, int d, int w1, int P, int pitch,
               float* __restrict__ gX) {
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * kGxPoints + threadIdx.x / 32;
  if (d > kFewInputs && w1 <= 32) {  // block-uniform; no shuffle below
    if (p >= P) return;
    const float* g = gz + (long long)p * pitch;
    for (int i = lane; i < d; i += 32) {
      float sum = 0.0f;
      for (int j = 0; j < w1; ++j) sum = fmaf(g[j], W0[(long long)i * w1 + j], sum);
      gX[(long long)p * d + i] = sum;
    }
    return;
  }
  constexpr int J = kLayeredMaxWidth / 32;
  float g[J];
#pragma unroll
  for (int t = 0; t < J; ++t) {
    const int j = lane + 32 * t;
    g[t] = p < P && j < w1 ? gz[(long long)p * pitch + j] : 0.0f;
  }
  for (int i = 0; i < d; ++i) {  // every lane of the warp, p < P or not: the shuffles need all 32
    const float* w = W0 + (long long)i * w1;
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < J; ++t)
      if (lane + 32 * t < w1) sum = fmaf(g[t], w[lane + 32 * t], sum);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0 && p < P) gX[(long long)p * d + i] = sum;
  }
}

// ---------------------------------------------------------------------------

struct LayeredArgs {
  const float* X;
  const float* G;
  const float* params;
  int n_layers, P, n_dirs, act, slice_points, chunk_points, pitch;
  bool second;
  int streams;  // streams(n_dirs, second): u, u_k[, u_kk]
  int w[kLayeredMaxLayers + 1];
  long long off[kLayeredMaxLayers];  // packed offset of W_l (b_l follows it)
  long long n_params, row_pitch, sstride;
  float* scratch;
  float* partials;
  float* gX;
  cudaStream_t stream;
};

float* stash(const LayeredArgs& a, int l) { return a.scratch + (long long)l * a.streams * a.sstride; }

int blocks_for(long long n, int per) { return (int)((n + per - 1) / per); }

// The seed and the replay GEMMs over a's points (one chunk).
template <int ND, int ACT, bool SECOND>
cudaError_t run_replay(const LayeredArgs& a) {
  const int cells = blocks_for((long long)a.P * a.pitch, kThreadsL);
  const int seed_blocks = cells < 4096 ? cells : 4096;  // then grid-stride
  bwd_layered_seed<ND, ACT, SECOND><<<seed_blocks, kThreadsL, 0, a.stream>>>(a.X, a.params, a.params + a.w[0] * a.w[1], a.w[0], a.w[1], a.P, a.pitch, a.sstride, stash(a, 0));
  cudaError_t err = cudaGetLastError();
  for (int l = 1; l + 1 < a.n_layers && err == cudaSuccess; ++l) {
    const float* W = a.params + a.off[l];
    const dim3 grid(blocks_for(a.P, kGemmM), blocks_for(a.w[l + 1], kGemmN));
    bwd_layered_gemm<ND, ACT, true, SECOND><<<grid, kThreadsL, 0, a.stream>>>(stash(a, l - 1), W, W + a.w[l] * a.w[l + 1], a.w[l], a.w[l + 1], a.P, a.pitch, a.sstride, stash(a, l));
    err = cudaGetLastError();
  }
  return err;
}

// The input and gx launches with gz_0 at gz (value stream gz[p pitch + j],
// seed streams sstride floats apart), over a's points (one chunk).
template <int ND, bool ACCUM>
cudaError_t run_input(const LayeredArgs& a, const float* gz, int pitch, long long sstride, long long pad_from) {
  const int slices = blocks_for(a.P, a.slice_points);
  const bool few = a.w[0] <= kFewInputs;
  const dim3 in_grid(slices, blocks_for(a.w[1], kLaneRows), few ? 1 : blocks_for(a.w[0], kInputGroup));
  if (few)
    bwd_layered_input<ND, kFewInputs, ACCUM><<<in_grid, kThreadsL, 0, a.stream>>>(a.X, gz, a.w[0], a.w[1], a.P, pitch, sstride, a.slice_points, a.partials, a.row_pitch, pad_from);
  else
    bwd_layered_input<ND, kInputGroup, ACCUM><<<in_grid, kThreadsL, 0, a.stream>>>(a.X, gz, a.w[0], a.w[1], a.P, pitch, sstride, a.slice_points, a.partials, a.row_pitch, pad_from);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.gX == nullptr) return err;
  bwd_layered_gx<<<blocks_for(a.P, kGxPoints), kThreadsL, 0, a.stream>>>(gz, a.params, a.w[0], a.w[1], a.P, pitch, a.gX);
  return cudaGetLastError();
}

// Every launch of one chunk (a: its points, X, G and gX); ACCUM: add into the
// partial rows instead of storing them (every chunk but the first).
template <int ND, int ACT, bool ACCUM, bool SECOND>
cudaError_t run_chunk(const LayeredArgs& a) {
  const int L = a.n_layers;
  if (L == 1) return run_input<ND, ACCUM>(a, a.G, streams(ND, SECOND), 1, a.n_params);  // no hidden layer: gz_0 = g
  cudaError_t err = run_replay<ND, ACT, SECOND>(a);
  if (err != cudaSuccess) return err;
  const int slices = blocks_for(a.P, a.slice_points);
  const dim3 head_grid(slices, blocks_for(a.w[L - 1], kLaneRows));
  bwd_layered_head<ND, ACT, ACCUM, SECOND><<<head_grid, kThreadsL, 0, a.stream>>>(a.G, a.params + a.off[L - 1], a.w[L - 1], a.P, a.pitch, a.sstride, a.slice_points, stash(a, L - 2), a.partials, a.row_pitch, a.off[L - 1], (int)a.n_params);
  err = cudaGetLastError();
  for (int l = L - 2; l >= 1 && err == cudaSuccess; --l) {
    const int din = a.w[l], dout = a.w[l + 1];
    const dim3 gw_grid(blocks_for(dout, kGwTile), blocks_for(din, kGwTile), slices);
    bwd_layered_gw<ND, ACT, ACCUM, SECOND><<<gw_grid, kThreadsL, 0, a.stream>>>(stash(a, l - 1), stash(a, l), din, dout, a.P, a.pitch, a.sstride, a.slice_points, a.partials, a.row_pitch, a.off[l]);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    const dim3 gh_grid(blocks_for(a.P, kGemmM), blocks_for(din, kGemmN));
    bwd_layered_gemm<ND, ACT, false, SECOND><<<gh_grid, kThreadsL, 0, a.stream>>>(stash(a, l), a.params + a.off[l], nullptr, dout, din, a.P, a.pitch, a.sstride, stash(a, l - 1));
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return run_input<ND, ACCUM>(a, stash(a, 0), a.pitch, a.sstride, a.row_pitch);
}

// The chunks in order on a's stream: chunk c is points [c chunk_points, (c +
// 1) chunk_points) of X, G and gX, its stash in the one scratch.
template <int ND, int ACT, bool SECOND>
cudaError_t run(const LayeredArgs& a) {
  cudaError_t err = cudaSuccess;
  for (int p0 = 0; p0 < a.P && err == cudaSuccess; p0 += a.chunk_points) {
    LayeredArgs c = a;
    c.P = a.P - p0 < a.chunk_points ? a.P - p0 : a.chunk_points;
    c.X = a.X + (long long)p0 * a.w[0];
    c.G = a.G + (long long)p0 * streams(ND, SECOND);
    c.gX = a.gX == nullptr ? nullptr : a.gX + (long long)p0 * a.w[0];
    err = p0 == 0 ? run_chunk<ND, ACT, false, SECOND>(c) : run_chunk<ND, ACT, true, SECOND>(c);
  }
  return err;
}

template <int ND, bool SECOND>
cudaError_t run_act(const LayeredArgs& a, bool replay_only) {
  if (a.act == 0) return replay_only ? run_replay<ND, 0, SECOND>(a) : run<ND, 0, SECOND>(a);
  return replay_only ? run_replay<ND, 1, SECOND>(a) : run<ND, 1, SECOND>(a);
}

template <int ND>
cudaError_t run_mode(const LayeredArgs& a, bool replay_only) {
  return a.second ? run_act<ND, true>(a, replay_only) : run_act<ND, false>(a, replay_only);
}

cudaError_t run_any(const LayeredArgs& a, bool replay_only) {
  switch (a.n_dirs) {
    case 1: return run_mode<1>(a, replay_only);
    case 2: return run_mode<2>(a, replay_only);
    default: return run_mode<3>(a, replay_only);
  }
}

int widest_hidden(const int* widths, int n_layers) {
  int m = 0;
  for (int l = 1; l < n_layers; ++l) m = widths[l] > m ? widths[l] : m;
  return m;
}

// The arguments, checked, into a; else an error code.  The scratch may be
// null only without a hidden layer (no stash).
cudaError_t layered_args(const float* X, const float* G, const float* params, const int* widths, int n_layers, int P,
                         int n_dirs, int second, int activation, int tiles, int chunk_points, float* scratch,
                         float* partials, float* gX, int device, void* stream, LayeredArgs& a) {
  if (n_layers < 1 || n_layers > kLayeredMaxLayers || n_dirs < 1 || n_dirs > 3 || P < 1 || tiles < 1 ||
      chunk_points < 1 || second < 0 || second > 1 || activation < 0 || activation > 1 || widths[n_layers] != 1 ||
      n_dirs > widths[0] || (scratch == nullptr && n_layers > 1))
    return cudaErrorInvalidValue;
  a = LayeredArgs{};
  a.X = X;
  a.G = G;
  a.params = params;
  a.n_layers = n_layers;
  a.P = P;
  a.n_dirs = n_dirs;
  a.second = second == 1;
  a.streams = streams(n_dirs, a.second);
  a.act = activation;
  a.slice_points = tiles * kSlicePoints;
  a.chunk_points = chunk_points < P ? chunk_points : P;
  a.scratch = scratch;
  a.partials = partials;
  a.gX = gX;
  a.stream = static_cast<cudaStream_t>(stream);
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || widths[l] > kLayeredMaxWidth) return cudaErrorInvalidValue;
    a.w[l] = widths[l];
    if (l < n_layers) {
      a.off[l] = a.n_params;
      a.n_params += (long long)widths[l] * widths[l + 1] + widths[l + 1];
    }
  }
  a.row_pitch = round4((int)a.n_params);
  a.pitch = round4(widest_hidden(widths, n_layers));
  a.sstride = (long long)a.chunk_points * a.pitch;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// Device memory (bytes) of the layered form's scratch for chunks of `points`
// points: the stash of the n_layers - 1 hidden layers, each streams(n_dirs,
// second) x points x pitch floats, pitch = the widest hidden layer rounded up
// to 4 (zero without a hidden layer).  ops/fused_fields.py::
// bwd_layered_scratch_bytes repeats it.
long long hp_fused_fields_bwd_layered_scratch_bytes(int max_hidden_w, int n_layers, int n_dirs, int second,
                                                    int points) {
  return (long long)sizeof(float) * (n_layers - 1LL) * streams(n_dirs, second != 0) * points * round4(max_hidden_w);
}

// The layered form: X [P, widths[0]] and G [P, 1 + 2 n_dirs] (second = 1) or
// [P, 1 + n_dirs] (second = 0: the fields u, u_k alone) row-major fp32;
// params packs W_0 [in, out], b_0, W_1, ... (n_params floats); widths (host
// memory) has n_layers + 1 entries (n_layers 1-16, widths up to 256) and ends
// in 1.  The points go in chunks of chunk_points consecutive points, one
// after another; a slice is `tiles` x 16 consecutive points of a chunk;
// partials [ceil(min(chunk_points, P) / slice), round4(n_params)] gets one row
// a slice, slice r of every chunk adding into row r (every entry written, pad
// columns zero); scratch holds hp_fused_fields_bwd_layered_scratch_bytes(widest
// hidden, n_layers, n_dirs, second, min(chunk_points, P)), 16-byte aligned (null
// without a hidden layer).  Unless gX is null it writes gX [P, widths[0]].
// activation: 0 = tanh, 1 = sin.  Launches its kernels on `stream` in order,
// does not synchronise, and returns the first launch error (0 on success).
int hp_fused_fields_bwd_layered_f32(const float* X, const float* G, const float* params, const int* widths,
                                    int n_layers, int P, int n_dirs, int second, int activation, int tiles,
                                    int chunk_points, float* scratch, float* partials, float* gX, int device,
                                    void* stream) {
  LayeredArgs a;
  cudaError_t err = layered_args(X, G, params, widths, n_layers, P, n_dirs, second, activation, tiles, chunk_points,
                                 scratch, partials, gX, device, stream, a);
  if (err != cudaSuccess) return (int)err;
  return (int)run_any(a, false);
}

// The replay alone (seed and the replay GEMMs) over all P points, in one
// chunk, with second derivatives: the stash of every hidden layer in
// scratch, laid out as above ([n_layers - 1][1 + 2 n_dirs][P][pitch];
// scratch_bytes(..., 1, P)).  For checks and timings of that part
// (chip_smoke.py phase 15 (e)); it needs a hidden layer.
int hp_fused_fields_bwd_layered_replay_f32(const float* X, const float* params, const int* widths, int n_layers,
                                           int P, int n_dirs, int activation, float* scratch, int device,
                                           void* stream) {
  if (n_layers < 2) return (int)cudaErrorInvalidValue;
  LayeredArgs a;
  cudaError_t err = layered_args(X, nullptr, params, widths, n_layers, P, n_dirs, 1, activation, 1, P, scratch,
                                 nullptr, nullptr, device, stream, a);
  if (err != cudaSuccess) return (int)err;
  return (int)run_any(a, true);
}

}  // extern "C"
