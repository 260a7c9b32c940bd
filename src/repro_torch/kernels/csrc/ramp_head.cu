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
// and does 2*B flop per weight: ~8 flop per byte at B = 8, far below the ~295
// flop/byte where the tensor cores would become the limit. So the kernel
// must read each weight byte once, for all B rows, and keep enough bytes in
// flight on every SM for the whole call.
// w arrives in either layout by stride, without a copy: a ramp head
// head[site] is (d, V) contiguous along V; the tied head embed^T is a
// (d, V) view contiguous along d. Columns at or past v_limit (the padded
// vocab) are never read: their logits are -1e30, so their share of the
// record is known. Two passes: pass 1 writes partial records, pass 2
// (merge_tiles, one warp a row) merges them in column order, every merge
// keeping the lower column on a tie of the max, so the argmax is the first
// index, and applies the exit compare. The
// TPU carried (m, s, t, idx) across a sequential vocab grid axis; Hopper
// runs blocks in no order, hence the second pass.
//
// bf16 (every served model), pass 1 is one balanced wave that streams w:
//   * a persistent grid of min(SMs x CTAs an SM, live blocks) CTAs of 8
//     warps. The live columns are cut into 16-column blocks; CTA c takes an
//     equal contiguous run of them. Its warps take the run in rounds of one
//     warp tile each, side by side, so the eight warps read neighbouring
//     columns; the last, partial round is dealt out evenly. So every warp
//     streams the same bytes to within one block, and all of them stream
//     until the end;
//   * h is staged once per CTA (16-byte loads), all rows of a pass (up to
//     32, as shared memory allows) against every w stage, so w is read from
//     device memory once per call; a larger B loops over passes of rows;
//   * each warp streams its tiles through its own ring of three 4 KB
//     stages (16-byte cp.async copies, zeros past d and past its columns),
//     two stages in flight while it multiplies the third; the first stages
//     are started before h is staged. Where 8 rows of h are too wide for
//     that (d over ~7.6 k: Llama-3.2-Vision's and Jamba's 8192), the ring
//     has two stages, one in flight while the warp multiplies the other,
//     and a pass takes 8 rows. A stage is 32 rows of one 128-byte
//     line: 32 k rows of 64 columns of a V-major head[site], or 32 column
//     rows of 64 k of the d-major embed^T, whose copies also ask the L2 for
//     the next 128 bytes of the row (the next stage's);
//   * the products run on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
//     accumulate): w^T is the (columns x d) A operand, from ldmatrix.trans
//     on a V-major stage and ldmatrix on a d-major one; h^T is the n8 B
//     operand, one n8 per 8 rows (rows past B are zeros and write no
//     partials). Stage rows are padded by 16 bytes, so the eight row reads
//     of an ldmatrix hit distinct banks;
//   * logits stay in the accumulators: after a tile's last stage the warp
//     folds its columns into one running (m, s, t, argmax) a row (ties of
//     the max keep the lower column, so the order of the fold does not
//     matter), the CTA folds its warps' records through 4 KB of shared
//     memory, and writes ONE partial per row. The last CTA also folds the
//     known record of the columns past the live blocks;
//   * pass 2 merges the G partials of a row in CTA order: merge_tiles, as
//     for f32, one launch more rather than a ticket on the last CTA.
// float32 (the card tests' exact reference path) stays on the CUDA cores,
// unchanged: bf16 or TF32 tensor-core products would not hold its stats to
// the 1e-4 relative agreement it is tested to. Pass 1 is one CTA per
// 256-column vocab tile and chunk of up to 8 rows of h (f32 in shared
// memory), one f32 multiply-add per weight and row, each layout with its
// own mapping so that global loads stay 16 bytes a lane on contiguous runs;
// it writes each tile's partials.
// The next step (ROADMAP): TMA bulk copies with mbarriers in place of cp.async.
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
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block can use

__device__ __forceinline__ float to_f(float x) { return x; }

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

// Merge two partial records: the TPU kernel's merge, with ties of the max
// keeping the lower column, so that the argmax is the first index whatever
// the order of the merges. i == INT_MAX marks an empty record.
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  if (b.i == INT_MAX) return a;
  if (a.i == INT_MAX) return b;
  const float nm = fmaxf(a.m, b.m);
  const float ea = expf(a.m - nm), eb = expf(b.m - nm);
  const int i = a.m > b.m ? a.i : b.m > a.m ? b.i : min(a.i, b.i);
  return {nm, a.s * ea + b.s * eb, a.t * ea + b.t * eb, i};
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
  Stat acc = {0.f, 0.f, 0.f, INT_MAX};
  for (int j = lo; j < hi; ++j)
    acc = merge(acc, Stat{pm[base + j], ps[base + j], pt[base + j], pi[base + j]});
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // lane i absorbs lanes [i+o, i+2o)
    Stat r;
    r.m = __shfl_down_sync(0xffffffffu, acc.m, o);
    r.s = __shfl_down_sync(0xffffffffu, acc.s, o);
    r.t = __shfl_down_sync(0xffffffffu, acc.t, o);
    r.i = __shfl_down_sync(0xffffffffu, acc.i, o);
    if (lane + o < 32) acc = merge(acc, r);
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


// ---------------------------------------------------------------------------
// bfloat16: one balanced wave of CTAs streams w through the tensor cores

using bf16 = __nv_bfloat16;
constexpr int MBW = 16;            // columns of an m16 block: the unit of work
constexpr int NS = 3;              // stages in a warp's ring: two in flight
constexpr int NS_WIDE = 2;         // the ring where h's rows leave no room for NS
constexpr int RNW = 8;             // warps per CTA
constexpr int RNT = RNW * 32;
constexpr int MAXG = 4;            // n8 row groups a pass: up to 32 rows of h

// A warp tile streams in 4 KB stages of whole 16-byte chunks. V-major
// (w[k, v] at k * ws + v): KC k rows of VC columns (VC / 16 m16 blocks);
// d-major (w[k, v] at v * ws + k): 32 column rows of 64 k (a 128-byte line
// each, 2 m16 blocks). Stage rows are padded by 16 bytes.
template <bool VMAJ>
struct Tile {
  static constexpr int VC = VMAJ ? 64 : 32;          // columns of a warp tile
  static constexpr int MB = VC / 16;                 // m16 blocks of a warp tile
  static constexpr int KC = 2048 / VC;               // contraction elements of a stage
  static constexpr int ROWS = VMAJ ? KC : VC;        // stage rows
  static constexpr int RL = VMAJ ? VC : KC;          // elements of a stage row
  static constexpr int PITCH = RL + 8;
  static constexpr int STAGE = ROWS * PITCH;         // elements
  static_assert(KC % 16 == 0 && ROWS * RL / 8 == 256, "a 4 KB stage of 16-byte chunks");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy; the source's first `src_bytes` (0..16) are
// read and the rest of the 16 bytes written as zeros.
// L2PF: the L2 prefetch size hint (the lines a copy's sector brings along).
template <int L2PF>
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  if (L2PF == 256)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate. Fragments
// (PTX ISA, m16n8k16): with g = lane / 4 and c = 2 * (lane % 4),
// a = {A[g][c..c+1], A[g+8][c..c+1], A[g][c+8..c+9], A[g+8][c+8..c+9]},
// b = {B[c..c+1][g], B[c+8..c+9][g]}, d = {D[g][c], D[g][c+1], D[g+8][c], D[g+8][c+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage of a warp tile, global -> shared by cp.async, zeros past d and
// at or past column ce (the end of the warp's columns, or V).
template <bool VMAJ>
__device__ __forceinline__ void fetch_stage(bf16* dst, const bf16* __restrict__ w, long long ws,
                                            int col0, int ce, int kc, int d, int lane) {
  using TL = Tile<VMAJ>;
  constexpr int CPR = TL::RL / 8;  // 16-byte chunks a stage row
#pragma unroll
  for (int j = 0; j < 256 / 32; ++j) {
    const int i = lane + 32 * j, r = i / CPR, c = (i % CPR) * 8;  // row r, chunk c
    if (VMAJ) {
      const int k = kc + r, col = col0 + c;
      const int n = k < d ? min(16, max(0, 2 * (ce - col))) : 0;
      cp_async16<128>(dst + r * TL::PITCH + c, n ? w + k * ws + col : w, n);
    } else {
      const int col = col0 + r, k = kc + c;
      const int n = col < ce ? min(16, max(0, 2 * (d - k))) : 0;
      // a column row runs on along d: the next stage's line comes along
      cp_async16<256>(dst + r * TL::PITCH + c, n ? w + (long long)col * ws + k : w, n);
    }
  }
}

// Rows rb0 .. rb0 + nb of h into shared rows of hsd + 8 elements, zeros past
// nb rows and past d; 16-byte loads where h's rows allow them.
__device__ void stage_h_bf16(const bf16* __restrict__ h, long long h_sb, int rb0, int nb, int d,
                             int hsd, int rows, bf16* hs) {
  const int cpr = hsd / 8;
  const bool vec = reinterpret_cast<uintptr_t>(h) % 16 == 0 && h_sb % 8 == 0;
  for (int i = threadIdx.x; i < rows * cpr; i += RNT) {
    const int r = i / cpr, c = (i % cpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nb) {
      const bf16* p = h + (long long)(rb0 + r) * h_sb + c;
      if (vec && c + 8 <= d) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        bf16* el = reinterpret_cast<bf16*>(&v);
        for (int e = 0; e < 8; ++e)
          if (c + e < d) el[e] = p[e];
      }
    }
    *reinterpret_cast<uint4*>(hs + r * (hsd + 8) + c) = v;
  }
}

// Pass 1, bf16. The live columns are cut into m16 blocks (16 columns); CTA
// c of G takes the blocks [M c / G, M (c + 1) / G), and its warps share
// them out as below, every warp the same number to within one block. A warp
// streams its tiles (up to Tile::MB blocks each) through its own ring of NR
// stages and keeps, per row of h, the running (m, s, t, argmax) of its
// columns. Writes one partial a row a CTA: partial[row * G + c].
template <int NG, bool VMAJ, int NR>
__global__ void __launch_bounds__(RNT, 1)
ramp_tiles_bf16(const bf16* __restrict__ h, long long h_sb, const bf16* __restrict__ w,
                long long ws, int B, int d, int hsd, int V, int v_limit, int n_blk,
                float* __restrict__ pm, float* __restrict__ ps, float* __restrict__ pt,
                int* __restrict__ pi) {
  using TL = Tile<VMAJ>;
  constexpr int RP = NG * 8, MB = TL::MB, KC = TL::KC, PITCH = TL::PITCH, STAGE = TL::STAGE;
  extern __shared__ __align__(16) unsigned char smraw[];
  __shared__ Stat red[RNW][RP];
  bf16* hs = reinterpret_cast<bf16*>(smraw);                // [RP][hsd + 8]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* ring = hs + RP * (hsd + 8) + warp * NR * STAGE;      // this warp's [NR][STAGE]
  const int G = gridDim.x, cta = blockIdx.x;
  const int r0 = (int)((long long)n_blk * cta / G), r1 = (int)((long long)n_blk * (cta + 1) / G);
  // rounds of RNW x MB blocks, warp w taking the w-th tile of each (the warps
  // of a CTA read neighbouring columns); the last, partial round dealt out
  // evenly, each warp a contiguous share
  constexpr int R = RNW * MB;
  const int n = r1 - r0, F = n / R, rem = n % R;
  const int l0 = r0 + F * R + rem * warp / RNW, l1 = r0 + F * R + rem * (warp + 1) / RNW;
  const int n_tiles = F + (l1 > l0 ? 1 : 0);
  // the columns [col0, ce) of this warp's tile j
  auto tile_cols = [&](int j, int& col0, int& ce) {
    if (j < F) {
      col0 = (r0 + j * R + warp * MB) * MBW;
      ce = min(col0 + MB * MBW, V);
    } else {
      col0 = l0 * MBW;
      ce = min(l1 * MBW, V);
    }
  };
  const int nk = hsd / KC, total = n_tiles * nk;
  const int g = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;

  auto fetch = [&](int s) {
    if (s < total) {
      int col0, ce;
      tile_cols(s / nk, col0, ce);
      fetch_stage<VMAJ>(ring + (s % NR) * STAGE, w, ws, col0, ce, (s % nk) * KC, d, lane);
    }
    cp_async_commit();  // empty past the end: the group count stays uniform
  };

  for (int rb0 = 0; rb0 < B; rb0 += RP) {
    const int nb = min(RP, B - rb0);
#pragma unroll
    for (int s = 0; s < NR - 1; ++s) fetch(s);  // w streams while h is staged
    stage_h_bf16(h, h_sb, rb0, nb, d, hsd, RP, hs);
    __syncthreads();

    float acc[MB][NG][4];
    Stat run[NG][2];
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mb][gi][e] = 0.f;
      run[gi][0] = run[gi][1] = Stat{0.f, 0.f, 0.f, INT_MAX};
    }

    for (int s = 0; s < total; ++s) {
      cp_async_wait<NR - 2>();  // stage s landed (this lane's copies) ...
      __syncwarp();             // ... and every lane's; stage s - 1 is read
      fetch(s + NR - 1);
      const bf16* st = ring + (s % NR) * STAGE;
      const int kc = (s % nk) * KC;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        // h^T as the B operand: matrices (rows, k 0-7), (rows, k 8-15)
        unsigned bfr[NG][2];
#pragma unroll
        for (int gi = 0; gi < NG; ++gi)
          ldsm_x2(bfr[gi], hs + (gi * 8 + (lane & 7)) * (hsd + 8) + kc + ks * 16 + (mi & 1) * 8);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          // w^T as the A operand (columns x k): matrices (cols 0-7, k 0-7),
          // (cols 8-15, k 0-7), (cols 0-7, k 8-15), (cols 8-15, k 8-15)
          unsigned a[4];
          if (VMAJ)
            ldsm_x4_t(a, st + (ks * 16 + (mi >> 1) * 8 + (lane & 7)) * PITCH + mb * 16 +
                             (mi & 1) * 8);
          else
            ldsm_x4(a, st + (mb * 16 + (mi & 1) * 8 + (lane & 7)) * PITCH + ks * 16 +
                           (mi >> 1) * 8);
#pragma unroll
          for (int gi = 0; gi < NG; ++gi) mma_bf16(acc[mb][gi], a, bfr[gi][0], bfr[gi][1]);
        }
      }
      if (s % nk == nk - 1) {
        // the tile's logits are complete: element e of acc[mb][gi] is column
        // col0 + 16 mb + g + 8 (e >> 1) of row 8 gi + c2 + (e & 1); the
        // eight lanes with one lane % 4 share a row. Columns at or past ce
        // are not this warp's.
        int col0, ce;
        tile_cols(s / nk, col0, ce);
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            float x[2 * MB];
            float mx = -INFINITY;
#pragma unroll
            for (int q = 0; q < 2 * MB; ++q) {
              const int col = col0 + 8 * q + g;  // q = 2 mb + hi
              x[q] = col < v_limit ? acc[q >> 1][gi][2 * (q & 1) + p] : NEG;
              if (col < ce) mx = fmaxf(mx, x[q]);
            }
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            int cand = INT_MAX;  // the first column at the max
            float se = 0.f, sl = 0.f;
#pragma unroll
            for (int q = 2 * MB - 1; q >= 0; --q) {
              const int col = col0 + 8 * q + g;
              if (col < ce) {
                if (x[q] == mx) cand = col;
                const float e = expf(x[q] - mx);
                se += e;
                sl += x[q] * e;
              }
            }
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, o));
              se += __shfl_xor_sync(0xffffffffu, se, o);
              sl += __shfl_xor_sync(0xffffffffu, sl, o);
            }
            run[gi][p] = merge(run[gi][p], Stat{mx, se, sl, cand});
          }
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mb][gi][e] = 0.f;
        }
      }
    }
    cp_async_wait<0>();

    // fold the warps' records, then write this CTA's partial of each row
    if (lane < 4) {
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        red[warp][gi * 8 + c2] = run[gi][0];
        red[warp][gi * 8 + c2 + 1] = run[gi][1];
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < nb) {
      const int r = threadIdx.x;
      Stat a = {0.f, 0.f, 0.f, INT_MAX};
      for (int wv = 0; wv < RNW; ++wv) a = merge(a, red[wv][r]);
      const int dead0 = n_blk * MBW;  // columns past the live blocks: all -1e30
      if (cta == G - 1 && dead0 < V) {
        const float n = (float)(V - dead0);
        a = merge(a, Stat{NEG, n, NEG * n, dead0});
      }
      const long long o = (long long)(rb0 + r) * G + cta;
      pm[o] = a.m;
      ps[o] = a.s;
      pt[o] = a.t;
      pi[o] = a.i;
    }
    __syncthreads();  // red and hs are reused by the next pass
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 1;
  }
  return n;
}

// The bf16 launch's shape: row groups a pass, ring stages, dynamic shared
// memory, CTAs.
struct Plan {
  int ng, ns, hsd, n_blk, grid;
  size_t smem;
  const void* fn;
};

template <int NG, bool VMAJ, int NR>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&ramp_tiles_bf16<NG, VMAJ, NR>);
}

// The most row groups (up to MAXG, no more than B needs) whose rows of h
// fit beside a ring of NS stages; else one group beside a ring of NS_WIDE,
// the only shape instantiated with it (where one group fits beside NS_WIDE
// stages but not beside NS, two do not fit beside NS_WIDE).
int plan_bf16(int B, int d, int V, int v_limit, bool vmaj, Plan* p) {
  const int kc = vmaj ? Tile<true>::KC : Tile<false>::KC;
  p->hsd = (d + kc - 1) / kc * kc;
  const int vl = v_limit < V ? v_limit : V;
  p->n_blk = vl > 0 ? (vl + MBW - 1) / MBW : 0;
  const size_t stage = (size_t)(vmaj ? Tile<true>::STAGE : Tile<false>::STAGE) * sizeof(bf16);
  // the static red[][] of NG groups, and the dynamic rows of h and the rings
  auto stat = [&](int n) { return (size_t)RNW * n * 8 * sizeof(Stat); };
  auto smem = [&](int n, int ns) {
    return (size_t)n * 8 * (p->hsd + 8) * sizeof(bf16) + (size_t)RNW * ns * stage;
  };
  int ng = (B + 7) / 8 < MAXG ? (B + 7) / 8 : MAXG;
  if (ng < 1) ng = 1;
  while (ng > 1 && smem(ng, NS) + stat(ng) > MAX_SMEM) --ng;
  p->ng = ng;
  p->ns = smem(ng, NS) + stat(ng) <= MAX_SMEM ? NS : NS_WIDE;
  if (smem(ng, p->ns) + stat(ng) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  p->smem = smem(ng, p->ns);
  static const void* fns[2][MAXG + 1] = {
      {kernel_of<1, false, NS>(), kernel_of<2, false, NS>(), kernel_of<3, false, NS>(),
       kernel_of<4, false, NS>(), kernel_of<1, false, NS_WIDE>()},
      {kernel_of<1, true, NS>(), kernel_of<2, true, NS>(), kernel_of<3, true, NS>(),
       kernel_of<4, true, NS>(), kernel_of<1, true, NS_WIDE>()}};
  const int k = p->ns == NS ? ng - 1 : MAXG;
  p->fn = fns[vmaj][k];
  // occupancy, once per (kernel, shared memory size)
  static size_t seen_smem[2][MAXG + 1] = {};
  static int seen_occ[2][MAXG + 1] = {};
  if (seen_smem[vmaj][k] != p->smem) {
    cudaError_t e = cudaFuncSetAttribute(p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p->smem);
    if (e != cudaSuccess) return (int)e;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, p->fn, RNT, p->smem);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    seen_smem[vmaj][k] = p->smem;
    seen_occ[vmaj][k] = occ;
  }
  // one wave: a CTA per SM slot, but no CTA without a block
  const int slots = sm_count() * seen_occ[vmaj][k];
  p->grid = p->n_blk < slots ? (p->n_blk > 0 ? p->n_blk : 1) : slots;
  return 0;
}

int launch_bf16(const void* h, long long h_sb, const void* w, long long w_sk, long long w_sv,
                const float* thr, long long thr_stride, float* part_f, int* part_i, float* m,
                float* s, float* t, int* idx, int* ex, int B, int d, int V, int v_limit,
                cudaStream_t stream) {
  const bool vmaj = w_sv == 1;
  if (!vmaj && w_sk != 1) return (int)cudaErrorInvalidValue;
  Plan p;
  int rc = plan_bf16(B, d, V, v_limit, vmaj, &p);
  if (rc != 0) return rc;
  const long long np = (long long)B * p.grid;
  float *pm = part_f, *ps = part_f + np, *pt = part_f + 2 * np;
  const bf16* hp = static_cast<const bf16*>(h);
  const bf16* wp = static_cast<const bf16*>(w);
  const long long ws = vmaj ? w_sk : w_sv;
#define RAMP_ARGS hp, h_sb, wp, ws, B, d, p.hsd, V, v_limit, p.n_blk, pm, ps, pt, part_i
#define RAMP_CASE(NG, NR)                                                           \
  if (vmaj)                                                                         \
    ramp_tiles_bf16<NG, true, NR><<<p.grid, RNT, p.smem, stream>>>(RAMP_ARGS);      \
  else                                                                              \
    ramp_tiles_bf16<NG, false, NR><<<p.grid, RNT, p.smem, stream>>>(RAMP_ARGS);
  if (p.ns == NS_WIDE) {
    RAMP_CASE(1, NS_WIDE)
  } else {
    switch (p.ng) {
      case 1: RAMP_CASE(1, NS) break;
      case 2: RAMP_CASE(2, NS) break;
      case 3: RAMP_CASE(3, NS) break;
      case 4: RAMP_CASE(4, NS) break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef RAMP_CASE
#undef RAMP_ARGS
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  merge_tiles<<<B, 32, 0, stream>>>(pm, ps, pt, part_i, p.grid, thr, thr_stride, m, s, t, idx,
                                    ex);
  return (int)cudaGetLastError();
}
}  // namespace

// Partial records per row of h that pass 1 writes (the scratch's size):
// one per 256-column tile for float32, one per CTA for bfloat16. 0 when no
// launch shape fits (d too wide for shared memory).
extern "C" int ramp_head_parts(int B, int d, int V, int v_limit, long long w_sk, long long w_sv,
                               int dtype) {
  if (dtype == 0) return (V + TV - 1) / TV;
  Plan p;
  return plan_bf16(B, d, V, v_limit, w_sv == 1, &p) == 0 ? p.grid : 0;
}

// h (B, d) with row stride h_sb; w viewed as (d, V) with element strides
// (w_sk, w_sv), one of them 1; thr (B,) f32 with stride thr_stride, or null
// for stats only (then ex must be null too); part_f float[3*B*n_parts] and
// part_i int[B*n_parts] scratch, n_parts = ramp_head_parts(...) of the same
// arguments; outputs m, s, t f32 (B,), idx, ex int32 (B,). dtype: 0 =
// float32, 1 = bfloat16 (h and w alike). Returns the CUDA error code (0 on
// success).
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
    return launch_bf16(h, h_sb, w, w_sk, w_sv, th, thr_stride, f(part_f), i(part_i), f(m),
                       f(s), f(t), i(idx), i(ex), B, d, V, v_limit, st);
  if (dtype == 0)
    return launch<float>(h, h_sb, w, w_sk, w_sv, th, thr_stride, f(part_f), i(part_i), f(m),
                         f(s), f(t), i(idx), i(ex), B, d, V, v_limit, st);
  return (int)cudaErrorInvalidValue;
}
