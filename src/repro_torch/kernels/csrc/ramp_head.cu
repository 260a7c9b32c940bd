// Streaming ramp-head record: (max logit, sum e^{l-m}, sum l*e^{l-m}, argmax)
// of h @ w without writing the (B, V) logits, plus an optional on-device exit
// bit, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ramp_head/kernel.py : ramp_head_stats and
// ramp_head_exit (Pallas, TPU). Same semantics: f32 logits, columns >=
// v_limit set to -1e30, argmax takes the first index, and the exit bit is
// (1 - 1/s) < thr in f32 with a strict compare.
//
// What bounds it on an H100: bytes. One call streams the head's live
// columns, d*v_limit weights (1536 x 151936 bf16 = 467 MB for qwen2-1.5b),
// and does 2*B flop per weight: ~8 flop per byte at B = 8, far below the ~295 flop/byte
// where the tensor cores would become the limit. The design reads each
// weight byte once for all B rows:
//   * pass 1: one CTA per 256-column vocab tile holds a chunk of up to 8
//     rows of h in shared memory (f32) and streams its tile of w in 16-byte
//     loads, one f32 multiply-add per weight and row on the CUDA cores; it
//     writes the tile's (m, s, t, argmax) partials per row;
//   * pass 2: one warp per row merges the partials IN TILE ORDER (each lane
//     a contiguous run of tiles, then an ordered shuffle tree), with a
//     strict > so the argmax keeps the first index, and applies the exit
//     compare. The TPU carried (m, s, t, idx) across a sequential vocab
//     grid axis; Hopper runs blocks in no order, hence the second pass.
// w arrives in either layout by stride, without a copy: a ramp head
// head[site] is (d, V) contiguous along V; the tied head embed^T is a
// (d, V) view contiguous along d. Each layout has its own pass-1 mapping
// so that global loads stay 16 bytes a lane on contiguous runs. A ragged last
// vocab tile is masked in the kernel, and a tile wholly at or past v_limit
// (the padded vocab) writes its known partials without reading w, so a call
// reads d * v_limit weights, not d * V. Not done yet: TMA pipelining, and
// B > 8 reads w once per chunk of 8 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TV = 256;      // vocab columns per CTA
constexpr int RB = 8;        // rows of h per CTA (grid.y covers B)
constexpr int NW = 8;        // warps per CTA
constexpr int NT = NW * 32;  // == TV: one thread per column in the tile pass
constexpr int CPL = TV / 32; // columns per lane in the V-major pass
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 8 consecutive elements of w starting at p as floats; `n` of them valid.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int n, float (&out)[8]) {
  if (n >= 8) {
    constexpr int PER = 16 / sizeof(T);  // elements per 16-byte load
#pragma unroll
    for (int c = 0; c < 8 / PER; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + c * PER);
      const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < PER; ++e) out[c * PER + e] = to_f(el[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = e < n ? to_f(p[e]) : 0.f;
  }
}

// Rows rb0.. of h into shared memory as f32, row stride hsd >= d, zero
// past d and past the last row.
template <typename T>
__device__ void stage_h(const T* __restrict__ h, long long h_sb, int rb0, int nb, int d,
                        int hsd, float* hs) {
  for (int i = threadIdx.x; i < RB * hsd; i += NT) {
    const int r = i / hsd, kk = i % hsd;
    hs[i] = (r < nb && kk < d) ? to_f(h[(rb0 + r) * h_sb + kk]) : 0.f;
  }
}

// Per-row stats of one tile's logits lg[RB][TV] (warp r handles row r).
__device__ void tile_reduce(const float* lg, int tile, int rb0, int nb, int V, int v_limit,
                            int n_tiles, float* pm, float* ps, float* pt, int* pi) {
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  if (r >= nb) return;
  float mx = -INFINITY;
  int am = INT_MAX;
  for (int j = lane; j < TV; j += 32) {  // ascending columns within a lane
    const int col = tile * TV + j;
    if (col >= V) break;
    const float x = col < v_limit ? lg[r * TV + j] : NEG;
    if (x > mx) { mx = x; am = col; }
  }
  const float tmax = warp_max(mx);
  const int targ = warp_min(mx == tmax ? am : INT_MAX);
  float se = 0.f, st = 0.f;
  for (int j = lane; j < TV; j += 32) {
    const int col = tile * TV + j;
    if (col >= V) break;
    const float x = col < v_limit ? lg[r * TV + j] : NEG;
    const float e = expf(x - tmax);
    se += e;
    st += x * e;
  }
  se = warp_sum(se);
  st = warp_sum(st);
  if (lane == 0) {
    const long long o = (long long)(rb0 + r) * n_tiles + tile;
    pm[o] = tmax;
    ps[o] = se;
    pt[o] = st;
    pi[o] = targ;
  }
}

// A tile wholly at or past v_limit: every logit is -1e30, so its partials
// (m = -1e30, s = n, t = -1e30 * n, argmax = its first column) are known
// without reading w. Returns true when the CTA has nothing more to do.
__device__ __forceinline__ bool masked_tile(int tile, int rb0, int nb, int V, int v_limit,
                                            int n_tiles, float* pm, float* ps, float* pt,
                                            int* pi) {
  const int c0 = tile * TV;
  if (c0 < v_limit) return false;
  if ((int)threadIdx.x < nb) {
    const int n = min(TV, V - c0);
    const long long o = (long long)(rb0 + threadIdx.x) * n_tiles + tile;
    pm[o] = NEG;
    ps[o] = (float)n;
    pt[o] = NEG * (float)n;
    pi[o] = c0;
  }
  return true;
}

// Pass 1 for w contiguous along V (w[k, v] at k * w_sk + v): lane -> 8
// adjacent columns, warp -> every NW-th row of the contraction.
template <typename T>
__global__ void __launch_bounds__(NT)
tiles_vmajor(const T* __restrict__ h, long long h_sb, const T* __restrict__ w, long long w_sk,
             int B, int d, int V, int v_limit, int n_tiles, float* pm, float* ps, float* pt,
             int* pi) {
  extern __shared__ __align__(16) float sm[];
  const int tile = blockIdx.x, rb0 = blockIdx.y * RB, nb = min(RB, B - rb0);
  if (masked_tile(tile, rb0, nb, V, v_limit, n_tiles, pm, ps, pt, pi)) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* hs = sm;  // [RB][d], later reused as red[NW][RB][TV]
  const int red_n = NW * RB * TV;
  float* lg = sm + (RB * d > red_n ? RB * d : red_n);  // [RB][TV]
  stage_h(h, h_sb, rb0, nb, d, d, hs);
  __syncthreads();

  const int c0 = tile * TV + lane * CPL;
  const int nvalid = V - c0;
  float acc[RB][CPL];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[r][e] = 0.f;
  auto step = [&](int kk, int n) {
    float wf[8];
    load8(w + kk * w_sk + c0, n, wf);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float hv = hs[r * d + kk];
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[r][e] += hv * wf[e];
    }
  };
  if (nvalid >= CPL) {
    // a branch-free body, unrolled so several 16-byte loads are in flight
#pragma unroll 8
    for (int kk = warp; kk < d; kk += NW) step(kk, CPL);
  } else if (nvalid > 0) {
    for (int kk = warp; kk < d; kk += NW) step(kk, nvalid);
  }
  __syncthreads();  // hs is dead: reuse it for the cross-warp reduction
  float* red = sm;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < CPL; e += 4)
      *reinterpret_cast<float4*>(red + (warp * RB + r) * TV + lane * CPL + e) =
          make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
  __syncthreads();
  {
    const int c = threadIdx.x;  // NT == TV
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float x = 0.f;
#pragma unroll
      for (int wv = 0; wv < NW; ++wv) x += red[(wv * RB + r) * TV + c];
      lg[r * TV + c] = x;
    }
  }
  __syncthreads();
  tile_reduce(lg, tile, rb0, nb, V, v_limit, n_tiles, pm, ps, pt, pi);
}

// Pass 1 for w contiguous along d (w[k, v] at v * w_sv + k, the tied
// embed^T): the tile's w is staged through shared memory KC elements of the
// contraction at a time, in coalesced 16-byte loads, with the next stage
// prefetched into registers while the current one is consumed. Thread c
// owns column c: it reads its own padded w row (the 16-byte pad puts the
// lanes' rows in distinct banks) and the rows of h as broadcasts.
template <typename T>
struct DStage {
  static constexpr int PER = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int KC = 128 / sizeof(T);  // contraction elements per stage
  static constexpr int CPR = KC / PER;        // chunks per column per stage
  static constexpr int ROW = KC + PER;        // padded shared-memory row
  static constexpr int NCH = TV * CPR / NT;   // chunks each thread loads per stage
};

template <typename T>
__device__ __forceinline__ void dstage_load(const T* __restrict__ w, long long w_sv, int tile,
                                            int V, int d, int kc,
                                            uint4 (&pre)[DStage<T>::NCH]) {
  using S = DStage<T>;
#pragma unroll
  for (int j = 0; j < S::NCH; ++j) {
    const int i = threadIdx.x + j * NT, row = i / S::CPR, cc = i % S::CPR;
    const int col = tile * TV + row, k = kc + cc * S::PER;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (col < V) {
      const T* p = w + (long long)col * w_sv + k;
      if (k + S::PER <= d) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        T* el = reinterpret_cast<T*>(&v);
        for (int e = 0; e < S::PER; ++e)
          if (k + e < d) el[e] = p[e];
      }
    }
    pre[j] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
tiles_dmajor(const T* __restrict__ h, long long h_sb, const T* __restrict__ w, long long w_sv,
             int B, int d, int V, int v_limit, int n_tiles, float* pm, float* ps, float* pt,
             int* pi) {
  using S = DStage<T>;
  extern __shared__ __align__(16) float sm[];
  const int tile = blockIdx.x, rb0 = blockIdx.y * RB, nb = min(RB, B - rb0);
  if (masked_tile(tile, rb0, nb, V, v_limit, n_tiles, pm, ps, pt, pi)) return;
  const int hsd = (d + S::KC - 1) / S::KC * S::KC;  // whole stages, zero-filled
  float* hs = sm;                                     // [RB][hsd]
  float* lg = hs + RB * hsd;                          // [RB][TV]
  T* ws = reinterpret_cast<T*>(lg + RB * TV);         // [TV][ROW]
  stage_h(h, h_sb, rb0, nb, d, hsd, hs);
  const int c = threadIdx.x;  // NT == TV
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;
  uint4 pre[S::NCH];
  dstage_load(w, w_sv, tile, V, d, 0, pre);
  for (int kc = 0; kc < d; kc += S::KC) {
    __syncthreads();  // the last stage's reads are done (and hs is staged)
#pragma unroll
    for (int j = 0; j < S::NCH; ++j) {
      const int i = threadIdx.x + j * NT;
      *reinterpret_cast<uint4*>(ws + (i / S::CPR) * S::ROW + (i % S::CPR) * S::PER) = pre[j];
    }
    __syncthreads();
    if (kc + S::KC < d) dstage_load(w, w_sv, tile, V, d, kc + S::KC, pre);
    const T* wr = ws + c * S::ROW;
#pragma unroll
    for (int cc = 0; cc < S::CPR; ++cc) {
      const uint4 raw = *reinterpret_cast<const uint4*>(wr + cc * S::PER);
      const T* el = reinterpret_cast<const T*>(&raw);
      float wf[S::PER];
#pragma unroll
      for (int e = 0; e < S::PER; ++e) wf[e] = to_f(el[e]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float* hr = hs + r * hsd + kc + cc * S::PER;
#pragma unroll
        for (int e = 0; e < S::PER; e += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(hr + e);
          acc[r] += hv.x * wf[e];
          acc[r] += hv.y * wf[e + 1];
          acc[r] += hv.z * wf[e + 2];
          acc[r] += hv.w * wf[e + 3];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) lg[r * TV + c] = acc[r];
  __syncthreads();
  tile_reduce(lg, tile, rb0, nb, V, v_limit, n_tiles, pm, ps, pt, pi);
}

struct Stat {
  float m, s, t;
  int i;
};

// Merge b (later tiles) into a (earlier tiles): the TPU kernel's merge.
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  const float nm = fmaxf(a.m, b.m);
  const float ea = expf(a.m - nm), eb = expf(b.m - nm);
  return {nm, a.s * ea + b.s * eb, a.t * ea + b.t * eb, b.m > a.m ? b.i : a.i};
}

// Pass 2: one warp per row merges the row's partials in tile order.
__global__ void __launch_bounds__(32)
merge_tiles(const float* __restrict__ pm, const float* __restrict__ ps,
            const float* __restrict__ pt, const int* __restrict__ pi, int n_tiles,
            const float* __restrict__ thr, long long thr_stride, float* m, float* s, float* t,
            int* idx, int* ex) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const int per = (n_tiles + 31) / 32, lo = lane * per, hi = min(lo + per, n_tiles);
  const long long base = (long long)b * n_tiles;
  Stat acc = {NEG, 0.f, 0.f, 0};
  int has = 0;
  for (int j = lo; j < hi; ++j) {
    const Stat x = {pm[base + j], ps[base + j], pt[base + j], pi[base + j]};
    acc = has ? merge(acc, x) : x;
    has = 1;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // lane i absorbs lanes [i+o, i+2o)
    Stat r;
    r.m = __shfl_down_sync(0xffffffffu, acc.m, o);
    r.s = __shfl_down_sync(0xffffffffu, acc.s, o);
    r.t = __shfl_down_sync(0xffffffffu, acc.t, o);
    r.i = __shfl_down_sync(0xffffffffu, acc.i, o);
    const int rh = __shfl_down_sync(0xffffffffu, has, o);
    if (lane + o < 32 && rh) {
      acc = has ? merge(acc, r) : r;
      has = 1;
    }
  }
  if (lane == 0) {
    m[b] = acc.m;
    s[b] = acc.s;
    t[b] = acc.t;
    idx[b] = acc.i;
    if (ex != nullptr) {
      const float unc = __fsub_rn(1.0f, __fdiv_rn(1.0f, acc.s));  // 1 - maxprob
      ex[b] = unc < thr[b * thr_stride] ? 1 : 0;
    }
  }
}

template <typename T>
int launch(const void* h, long long h_sb, const void* w, long long w_sk, long long w_sv,
           const float* thr, long long thr_stride, float* part_f, int* part_i, float* m,
           float* s, float* t, int* idx, int* ex, int B, int d, int V, int v_limit,
           cudaStream_t stream) {
  const int n_tiles = (V + TV - 1) / TV;
  const long long np = (long long)B * n_tiles;
  float *pm = part_f, *ps = part_f + np, *pt = part_f + 2 * np;
  const dim3 grid(n_tiles, (B + RB - 1) / RB);
  const T* hp = static_cast<const T*>(h);
  const T* wp = static_cast<const T*>(w);
  if (w_sv == 1) {
    const int red_n = NW * RB * TV;
    const size_t smem = ((RB * d > red_n ? RB * d : red_n) + RB * TV) * sizeof(float);
    cudaFuncSetAttribute(tiles_vmajor<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    tiles_vmajor<T><<<grid, NT, smem, stream>>>(hp, h_sb, wp, w_sk, B, d, V, v_limit,
                                                n_tiles, pm, ps, pt, part_i);
  } else if (w_sk == 1) {
    using S = DStage<T>;
    const int hsd = (d + S::KC - 1) / S::KC * S::KC;
    const size_t smem = (size_t)(RB * hsd + RB * TV) * sizeof(float) + TV * S::ROW * sizeof(T);
    cudaFuncSetAttribute(tiles_dmajor<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    tiles_dmajor<T><<<grid, NT, smem, stream>>>(hp, h_sb, wp, w_sv, B, d, V, v_limit,
                                                n_tiles, pm, ps, pt, part_i);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  merge_tiles<<<B, 32, 0, stream>>>(pm, ps, pt, part_i, n_tiles, thr, thr_stride, m, s, t, idx,
                                    ex);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ramp_head_tile_v() { return TV; }

// h (B, d) with row stride h_sb; w viewed as (d, V) with element strides
// (w_sk, w_sv), one of them 1; thr (B,) f32 with stride thr_stride, or null
// for stats only (then ex must be null too); part_f float[3*B*n_tiles] and
// part_i int[B*n_tiles] scratch, n_tiles = ceil(V / ramp_head_tile_v());
// outputs m, s, t f32 (B,), idx, ex int32 (B,). dtype: 0 = float32,
// 1 = bfloat16 (h and w alike). Returns the CUDA error code (0 on success).
extern "C" int ramp_head_launch(const void* h, long long h_sb, const void* w, long long w_sk,
                                long long w_sv, const void* thr, long long thr_stride,
                                void* part_f, void* part_i, void* m, void* s, void* t,
                                void* idx, void* ex, int B, int d, int V, int v_limit,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto i = [](void* p) { return static_cast<int*>(p); };
  const float* th = static_cast<const float*>(thr);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, h_sb, w, w_sk, w_sv, th, thr_stride, f(part_f), i(part_i),
                                 f(m), f(s), f(t), i(idx), i(ex), B, d, V, v_limit, st);
  if (dtype == 0)
    return launch<float>(h, h_sb, w, w_sk, w_sv, th, thr_stride, f(part_f), i(part_i), f(m),
                         f(s), f(t), i(idx), i(ex), B, d, V, v_limit, st);
  return (int)cudaErrorInvalidValue;
}
