// Absorbed MLA decode attention over paged latent pools, written by hand for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/paged_mla.py :
// paged_mla_decode_attention (Pallas, TPU). Same semantics: one query token
// per row, already projected into latent space (q_lat = q_nope @ w_uk), so
//   s[b, h, t] = (q_lat[b, h] . c[b, t] + q_pe[b, h] . k_pe[b, t]) * scale
// over keys kpos <= pos[b] (masked scores -1e30), online softmax in f32,
// and the context sum_t p_t c[b, t] (the latent is also the value stream,
// zeroed under the mask), divided at the end by max(l, 1e-30); output in
// q_lat's dtype. Key t of row b lives at (table[b, t / bs], t % bs) of the
// (P, bs, r) and (P, bs, dr) pools.
//
// What bounds it on an H100: bytes. At decode the latent stream is MQA-like
// (one stream serves all H heads): (r + dr) * 2 bytes a key in bf16 against
// H * (2 r + dr) * 2 flop, ~30 flop per byte at H = 16, far below the ~295
// where the tensor cores would become the limit. The design reads each
// latent byte once and keeps enough of them in flight:
//   * the key axis is split: the grid is (B, splits), and CTA (b, s) walks
//     keys [s * chunk, (s + 1) * chunk) of the row's nk = min(pos, nb*bs-1)
//     + 1 keys; chunk is a whole number of 32-key tiles, and splits (the
//     wrapper's mla_splits) depends on static shapes only. Ranges that start
//     at or past nk exit at once. A row with one live range writes its
//     output from that CTA; otherwise each live range writes its (m, l,
//     context) in f32 to scratch, and a second kernel, one CTA a (head,
//     row), merges them: every range's (m, l) read at once, then the
//     contexts in range order, so two calls give the same bits. (Merging in
//     the last range's CTA, as the flash-decode kernel does, put a row's
//     ~32 KB a range of partial contexts through one SM, and measured
//     slower on an H100);
//   * the CTA copies its range's table entries into shared memory once,
//     each clamped into [0, P), so a bad id cannot address outside the pool;
//     any block size works (a tile may span several blocks).
// bf16 (every served model): both products on the tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 out), 4 warps a CTA.
//   * Each 32-key tile of c then k_pe (a 576-wide row at DeepSeek's shapes,
//     zero-padded to a multiple of 16, rows padded by 16 bytes so that
//     ldmatrix's row reads hit distinct banks) is staged once through a
//     two-stage ring and serves all H heads. One warp stages a tile with
//     TMA bulk copies (cp.async.bulk, two a key row) completing on the
//     stage's mbarrier: issuing a tile as 16-byte cp.async copies from all
//     threads took several times longer than the tile's products on an
//     H100.
//   * S = Q.K^T: the H <= 16 heads are the rows of the A operand (rows past H
//     zero). The warps divide the contraction: warp w keeps its quarter of
//     Q in A fragments for the whole walk (Q's rows arrive by TMA too and
//     reach the fragments through ldmatrix, once) and
//     scores all 32 keys against it; the four partial scores meet in shared
//     memory, where 8 threads a head sum them in warp order and run the
//     online softmax (exp2 of pre-scaled scores), writing P as bf16.
//   * O = P.C: the latent is also the value, so the staged c tile is read a
//     second time, through ldmatrix.trans; the warps divide the r output
//     columns (64 f32 accumulators a thread at r = 512).
//   * ~105 KB of shared memory at DeepSeek's shapes: two CTAs an SM.
// float32 (the tiny configs and the card tests' exact path) stays on the
// CUDA cores (neither bf16 nor TF32 products hold 1e-5): 16 warps, warp h
// scores head h with lane j on key j of a tile, thread e owns latent dim e
// of every head's context. It shares the split planning and the merge.
// pos is read as the caller holds it (int32 or int64, one per row or one for
// all rows, or a scalar): the model's int64 positions cost no cast.
// Not done yet: TMA bulk copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;          // keys a tile; a key range is whole tiles
constexpr int MAXH = 16;          // heads: the rows of an m16 A operand
constexpr int MAXR = 512;         // latent width
constexpr int MAXD = 1024;        // r + dr
constexpr int MAX_SPLITS = 128;   // ranges a row: the merge keeps their weights in shared memory
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Where row b's position comes from: an int32 or int64 array read with
// element stride `stride` (0: one value for every row), or `scalar` when p
// is null.
struct Pos {
  const void* p;
  long long stride, scalar;
  int is64;
};

// keys row b attends to: kpos <= pos and kpos < S
__device__ __forceinline__ int keys_of(const Pos& ps, int b, int S) {
  const long long p = ps.p == nullptr ? ps.scalar
                      : ps.is64       ? static_cast<const long long*>(ps.p)[b * ps.stride]
                                      : static_cast<const int*>(ps.p)[b * ps.stride];
  return p < 0 ? 0 : (int)(p < S - 1 ? p : S - 1) + 1;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy that bypasses registers (cp.async); the
// source's first `src_bytes` (0 or 16) are read, the rest written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Row b's table entries [t_lo, t_lo + n) into shared memory, clamped into [0, P).
__device__ __forceinline__ void load_table(int* tab, const int* __restrict__ table,
                                           long long t_row, int t_lo, int n, int P) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = table[t_row + t_lo + i];
    tab[i] = t < 0 ? 0 : (t < P ? t : P - 1);
  }
}

// Floats of one range's partial state: the [H][r] context, then (m, l) per
// head; padded so that every range starts 16-byte aligned.
__host__ __device__ inline long long part_stride(int H, int r) {
  return (long long)H * r + 2 * MAXH;
}
constexpr int CNT = MAXR / 4;  // threads of a combine CTA: a float4 of the r columns each

// Grid (H, B): CTA (h, b) merges head h of row b over its live ranges, in
// range order: every range's (m, l), m in log2 units, read at once (a lane
// a range), M = max m_r, each range's weight 2^(m_r - M), L = sum l_r w_r;
// the context, a float4 of the r <= 512 columns a thread, its first CB
// ranges' loads in flight with the (m, l) loads: out = sum_r w_r acc_r /
// max(L, 1e-30). A row with one live range was written by the walk. It is
// a programmatic dependent launch: its CTAs start once every CTA of the
// walk has started, read pos, and wait for the walk's writes only then.
constexpr int CB = 16;  // ranges of context a thread loads at once
template <typename T>
__global__ void __launch_bounds__(CNT)
mla_combine_kernel(const float* __restrict__ part, T* __restrict__ out, Pos pos, int H, int r,
                   int S, int chunk, int splits) {
  __shared__ float wt[MAX_SPLITS];
  __shared__ float tot;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int nk = keys_of(pos, b, S);
  const int live = nk > chunk ? (nk + chunk - 1) / chunk : 1;
  if (live == 1) return;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the walk's partials
  const long long stride = part_stride(H, r);
  const float* p0 = part + (long long)b * splits * stride;
  const int col = 4 * tid;  // r % 8 == 0: a float4 lies in the row
  const float* pc = p0 + h * r + col;
  float4 x[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j)
    x[j] = col < r && j < live ? __ldcg(reinterpret_cast<const float4*>(pc + j * stride))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < 32) {
    constexpr int PER = MAX_SPLITS / 32;
    float m[PER], l[PER], M = NEG;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int ri = lane + 32 * j;
      m[j] = ri < live ? __ldcg(p0 + ri * stride + H * r + 2 * h) : NEG;
      l[j] = ri < live ? __ldcg(p0 + ri * stride + H * r + 2 * h + 1) : 0.f;
      M = fmaxf(M, m[j]);
    }
    M = warp_max(M);
    float L = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int ri = lane + 32 * j;
      if (ri < live) {
        const float a = exp2f(m[j] - M);
        wt[ri] = a;
        L += l[j] * a;
      }
    }
    L = warp_sum(L);
    if (lane == 0) tot = L;
  }
  __syncthreads();
  if (col >= r) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < live; r0 += CB) {
    if (r0 > 0) {
#pragma unroll
      for (int j = 0; j < CB; ++j)
        if (r0 + j < live) x[j] = __ldcg(reinterpret_cast<const float4*>(pc + (r0 + j) * stride));
    }
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      if (r0 + j < live) {
        const float w = wt[r0 + j];
        acc.x += w * x[j].x;
        acc.y += w * x[j].y;
        acc.z += w * x[j].z;
        acc.w += w * x[j].w;
      }
    }
  }
  const float inv_l = 1.f / fmaxf(tot, 1e-30f);
  T* ob = out + ((long long)b * H + h) * r + col;
  ob[0] = from_f<T>(acc.x * inv_l);
  ob[1] = from_f<T>(acc.y * inv_l);
  ob[2] = from_f<T>(acc.z * inv_l);
  ob[3] = from_f<T>(acc.w * inv_l);
}

// Everything a launch needs besides the kernel's own layout.
struct Args {
  const void *ql, *qp, *c, *kpe;
  const int* table;
  long long t_sb;
  Pos pos;
  void* out;
  float* part;
  int B, H, r, dr, P, bs, nb, splits, chunk;
  long long ql_sb, ql_sh, qp_sb, qp_sh, c_sb, c_ss, k_sb, k_ss;
  float scale;
};

// ---------------------------------------------------------------------------
// bfloat16: both products on the tensor cores (mma.sync)

using bf16 = __nv_bfloat16;
constexpr int BW = 4;                     // warps a CTA
constexpr int BNT = BW * 32;
constexpr int MAXKW = MAXD / 16 / BW;     // k-steps of Q.K^T a warp holds in A fragments
constexpr int MAXPW = MAXR / 16 / BW;     // 16-column pairs of P.C a warp owns
constexpr int STAGES = 2;                // the ring: a tile in flight while one is used
constexpr int SPITCH = TILE + 8;          // a head's partial scores, in floats
constexpr int PPITCH = TILE + 8;          // a head's P row, in bf16

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// TMA bulk copies (cp.async.bulk) completing on an mbarrier's transaction count
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// orders this thread's shared-memory accesses before the async proxy's
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Dynamic shared memory of a bf16 CTA, in bytes from its start, for a
// contraction of Dp (r + dr padded to 16) and n_tab table entries.
struct Bf16Layout {
  int pitch;     // a staged key row (c, k_pe, zeros), in elements: Dp + 8
  size_t stage;  // one stage of the ring: TILE rows
  size_t q;      // the (q_lat, q_pe) rows of MAXH heads, pitch as the ring's
  size_t sp;     // the warps' partial scores [BW][MAXH][SPITCH] f32
  size_t ps;     // P [MAXH][PPITCH] bf16
  size_t stat;   // alpha, m, l [MAXH] f32
  size_t bar;    // an mbarrier a stage, then Q's
  size_t tab;    // the range's table entries (int32)
  size_t total;
  __host__ __device__ Bf16Layout(int Dp, int n_tab) {
    pitch = Dp + 8;
    stage = (size_t)TILE * pitch * sizeof(bf16);
    q = STAGES * stage;
    sp = q + (size_t)MAXH * pitch * sizeof(bf16);
    ps = sp + (size_t)BW * MAXH * SPITCH * sizeof(float);
    stat = ps + (size_t)MAXH * PPITCH * sizeof(bf16);
    bar = stat + 3 * MAXH * sizeof(float);
    tab = bar + align16((STAGES + 1) * sizeof(uint64_t));
    total = tab + align16((size_t)n_tab * sizeof(int));
  }
};

// Grid (B, splits); keys of range s: [s * chunk, min((s + 1) * chunk, nk)).
__global__ void __launch_bounds__(BNT, 2)
mla_bf16_kernel(const bf16* __restrict__ ql, const bf16* __restrict__ qp,
                const bf16* __restrict__ c_pool, const bf16* __restrict__ kpe_pool,
                const int* __restrict__ table, long long t_sb, Pos pos, bf16* __restrict__ out,
                float* __restrict__ part, int H, int r, int dr, int P,
                int bs, int nb, int chunk, long long ql_sb, long long ql_sh, long long qp_sb,
                long long qp_sh, long long c_sb, long long c_ss, long long k_sb, long long k_ss,
                float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may start
  const int D = r + dr, Dp = (D + 15) / 16 * 16, KS = Dp / 16;
  const Bf16Layout lt(Dp, 0);  // the table slice's size matters to the launch only
  const int b = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;
  // the row's pos and the range's first table entries are read at once
  // (the entries of the whole range: the walk reads only those below nk)
  const int k0 = split * chunk, tab0 = k0 / bs;
  const int n_tab = (min(k0 + chunk, nb * bs) - 1) / bs - tab0 + 1;
  const int t_first = tid < n_tab ? table[b * t_sb + tab0 + tid] : 0;
  const int nk = keys_of(pos, b, nb * bs);
  const int live = nk > chunk ? (nk + chunk - 1) / chunk : 1;  // ranges with keys (>= 1)
  if (split >= live) return;
  const int k1 = min(k0 + chunk, nk);  // k1 <= k0 only when nk == 0

  int* tab = reinterpret_cast<int*>(smem + lt.tab);
  if (tid < n_tab) tab[tid] = t_first < 0 ? 0 : (t_first < P ? t_first : P - 1);
  load_table(tab + BNT, table, b * t_sb, tab0 + BNT, n_tab - BNT, P);  // a range past 128 blocks
  // the ring and Q start zeroed: rows past the range's keys or past H, and
  // columns past r + dr, are never copied into, so they hold zeros or an
  // earlier tile's finite values, which P (0 there) and the mask ignore
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lt.bar);  // [STAGES] then Q's
  for (int i = tid; i < (int)(lt.sp / 16); i += BNT)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid <= STAGES) mbar_init(bar + tid);
  fence_proxy_async();
  __syncthreads();  // the table slice, the zeroed ring and Q, the barriers
  bf16* qs = reinterpret_cast<bf16*>(smem + lt.q);
  if (warp == 1) {  // Q's rows: q_lat then q_pe of head `lane`, two bulk copies
    if (lane == 0) mbar_expect_tx(bar + STAGES, (unsigned)(H * (r + dr) * sizeof(bf16)));
    __syncwarp();
    if (lane < H) {
      bulk_copy(qs + lane * lt.pitch, ql + b * ql_sb + lane * ql_sh, r * sizeof(bf16), bar + STAGES);
      bulk_copy(qs + lane * lt.pitch + r, qp + b * qp_sb + lane * qp_sh, dr * sizeof(bf16),
                bar + STAGES);
    }
  }

  // warp 0 stages the tile of keys [t0, t0 + TILE) into stage st: lane j
  // copies key t0 + j's latent row and rope key (two TMA bulk copies of r
  // and dr bf16) into row j, the stage's mbarrier counting the bytes
  auto issue = [&](int t0, int st) {
    const int n = min(TILE, k1 - t0);  // rows with keys
    if (lane == 0) mbar_expect_tx(bar + st, (unsigned)(n * (r + dr) * sizeof(bf16)));
    __syncwarp();
    if (lane < n) {
      const int key = t0 + lane;
      const long long blk = tab[key / bs - tab0], slot = key % bs;
      bf16* dst = reinterpret_cast<bf16*>(smem + st * lt.stage) + lane * lt.pitch;
      bulk_copy(dst, c_pool + blk * c_sb + slot * c_ss, r * sizeof(bf16), bar + st);
      bulk_copy(dst + r, kpe_pool + blk * k_sb + slot * k_ss, dr * sizeof(bf16), bar + st);
    }
  };

  float* sp = reinterpret_cast<float*>(smem + lt.sp);
  bf16* ps = reinterpret_cast<bf16*>(smem + lt.ps);
  float* alpha_s = reinterpret_cast<float*>(smem + lt.stat);
  float* m_s = alpha_s + MAXH;
  float* l_s = m_s + MAXH;
  // the warp's output columns: 16-column pairs [pp0, pp1) (a pair's second
  // half may lie past r: it reads k_pe and is not written)
  const int NPAIR = (r + 15) / 16, ppw = (NPAIR + BW - 1) / BW;
  const int pp0 = warp * ppw, pp1 = min(pp0 + ppw, NPAIR);
  float o[MAXPW][2][4];
#pragma unroll
  for (int j = 0; j < MAXPW; ++j)
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) o[j][hb][0] = o[j][hb][1] = o[j][hb][2] = o[j][hb][3] = 0.f;
  // the online softmax of head sh over keys sq..sq+3 of each tile: 8 threads a head
  const int sh = tid >> 3, sq = (tid & 7) * 4;
  float m = NEG, l = 0.f;
  const int ntiles = k1 > k0 ? (k1 - k0 + TILE - 1) / TILE : 0;

  // the first STAGES - 1 tiles
  if (warp == 0)
    for (int i = 0; i < STAGES - 1 && i < ntiles; ++i) issue(k0 + i * TILE, i);
  // Q's A fragments for the warp's k-steps [ks0, ks1), kept for the whole
  // walk: matrices (heads 0-7 / 8-15 x d 0-7 / 8-15) through ldmatrix
  const int kpw = (KS + BW - 1) / BW, ks0 = warp * kpw, ks1 = min(ks0 + kpw, KS);
  unsigned qa[MAXKW][4];
  mbar_wait(bar + STAGES, 0);
#pragma unroll
  for (int j = 0; j < MAXKW; ++j) {
    if (ks0 + j < ks1)
      ldsm_x4(qa[j], qs + ((mi & 1) * 8 + (lane & 7)) * lt.pitch + (ks0 + j) * 16 + (mi >> 1) * 8);
    else
      qa[j][0] = qa[j][1] = qa[j][2] = qa[j][3] = 0u;
  }
  for (int it = 0; it < ntiles; ++it) {
    mbar_wait(bar + it % STAGES, (it / STAGES) & 1);
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (warp == 0 && it + STAGES - 1 < ntiles) {
      fence_proxy_async();
      issue(k0 + (it + STAGES - 1) * TILE, (it + STAGES - 1) % STAGES);
    }
    const bf16* ts = reinterpret_cast<const bf16*>(smem + (it % STAGES) * lt.stage);
    const int t0 = k0 + it * TILE;

    // partial S over the warp's k-steps: matrices (keys 0-7, d 0-7),
    // (keys 0-7, d 8-15), (keys 8-15, ..), then keys 16-31 the same
    float s[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) s[kb][0] = s[kb][1] = s[kb][2] = s[kb][3] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXKW; ++j) {
      if (ks0 + j < ks1) {
        const bf16* kr = ts + ((mi >> 1) * 8 + (lane & 7)) * lt.pitch + (ks0 + j) * 16 + (mi & 1) * 8;
        unsigned kf[4], kf2[4];
        ldsm_x4(kf, kr);
        ldsm_x4(kf2, kr + 16 * lt.pitch);
        mma_bf16(s[0], qa[j], kf[0], kf[1]);
        mma_bf16(s[1], qa[j], kf[2], kf[3]);
        mma_bf16(s[2], qa[j], kf2[0], kf2[1]);
        mma_bf16(s[3], qa[j], kf2[2], kf2[3]);
      }
    }
    float* spw = sp + warp * MAXH * SPITCH;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      *reinterpret_cast<float2*>(spw + g * SPITCH + kb * 8 + c2) = make_float2(s[kb][0], s[kb][1]);
      *reinterpret_cast<float2*>(spw + (g + 8) * SPITCH + kb * 8 + c2) =
          make_float2(s[kb][2], s[kb][3]);
    }
    __syncthreads();

    // softmax: the warps' partial scores summed in warp order
    {
      float4 a = *reinterpret_cast<const float4*>(sp + sh * SPITCH + sq);
#pragma unroll
      for (int w = 1; w < BW; ++w) {
        const float4 e = *reinterpret_cast<const float4*>(sp + (w * MAXH + sh) * SPITCH + sq);
        a.x += e.x;
        a.y += e.y;
        a.z += e.z;
        a.w += e.w;
      }
      float sv[4] = {a.x * scale_log2, a.y * scale_log2, a.z * scale_log2, a.w * scale_log2};
      const bool full = t0 + TILE <= k1;
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (full || t0 + sq + e < k1) mx = fmaxf(mx, sv[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m, mx);
      const float alpha = ex2(m - mn);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv[e] = full || t0 + sq + e < k1 ? ex2(sv[e] - mn) : 0.f;
        sum += sv[e];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l = l * alpha + sum;
      m = mn;
      *reinterpret_cast<uint2*>(ps + sh * PPITCH + sq) =
          make_uint2(pack_bf16(sv[0], sv[1]), pack_bf16(sv[2], sv[3]));
      if ((tid & 7) == 0) alpha_s[sh] = alpha;
    }
    __syncthreads();

    // O = alpha O + P C over the warp's columns: P's A fragments through
    // ldmatrix (matrices rows 0-7 / 8-15 x keys 0-7 / 8-15), C through
    // ldmatrix.trans (keys 0-7 / 8-15 x the pair's two 8-column halves)
    {
      const float a0 = alpha_s[g], a1 = alpha_s[g + 8];
      unsigned pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldsm_x4(pa[kk], ps + ((mi & 1) * 8 + (lane & 7)) * PPITCH + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int j = 0; j < MAXPW; ++j) {
        if (pp0 + j < pp1) {
#pragma unroll
          for (int hb = 0; hb < 2; ++hb) {
            o[j][hb][0] *= a0;
            o[j][hb][1] *= a0;
            o[j][hb][2] *= a1;
            o[j][hb][3] *= a1;
          }
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            unsigned vf[4];
            ldsm_x4_t(vf, ts + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * lt.pitch +
                              (2 * (pp0 + j) + (mi >> 1)) * 8);
            mma_bf16(o[j][0], pa[kk], vf[0], vf[1]);
            mma_bf16(o[j][1], pa[kk], vf[2], vf[3]);
          }
        }
      }
    }
  }

  if ((tid & 7) == 0) {
    m_s[sh] = m;
    l_s[sh] = l;
  }
  __syncthreads();
  if (live == 1) {  // the row's only range: normalise and write out
    const float L0 = fmaxf(l_s[g], 1e-30f), L1 = fmaxf(l_s[g + 8], 1e-30f);
    bf16* ob = out + (long long)b * H * r;
#pragma unroll
    for (int j = 0; j < MAXPW; ++j) {
      if (pp0 + j < pp1) {
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int col = (2 * (pp0 + j) + hb) * 8 + c2;
          if (col < r) {
            if (g < H)
              *reinterpret_cast<unsigned*>(ob + g * r + col) =
                  pack_bf16(o[j][hb][0] / L0, o[j][hb][1] / L0);
            if (g + 8 < H)
              *reinterpret_cast<unsigned*>(ob + (g + 8) * r + col) =
                  pack_bf16(o[j][hb][2] / L1, o[j][hb][3] / L1);
          }
        }
      }
    }
    return;
  }
  float* pr = part + ((long long)b * gridDim.y + split) * part_stride(H, r);
#pragma unroll
  for (int j = 0; j < MAXPW; ++j) {
    if (pp0 + j < pp1) {
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int col = (2 * (pp0 + j) + hb) * 8 + c2;
        if (col < r) {
          if (g < H)
            *reinterpret_cast<float2*>(pr + g * r + col) = make_float2(o[j][hb][0], o[j][hb][1]);
          if (g + 8 < H)
            *reinterpret_cast<float2*>(pr + (g + 8) * r + col) =
                make_float2(o[j][hb][2], o[j][hb][3]);
        }
      }
    }
  }
  if (tid < H) {
    pr[H * r + 2 * tid] = m_s[tid];
    pr[H * r + 2 * tid + 1] = l_s[tid];
  }
}

// ---------------------------------------------------------------------------
// float32: on the CUDA cores

// threads: warp h scores head h with lane j on key j; thread e owns latent dim e
constexpr int FNT = 512;

// Dynamic shared memory of an f32 CTA, in bytes from its start.
struct F32Layout {
  int kpad;     // a staged key row: r + dr, padded by 16 bytes
  size_t tile;  // one tile of TILE key rows, after q [H][D] f32
  size_t ps;    // p [TILE][MAXH] f32
  size_t stat;  // alpha, l [MAXH] f32
  size_t tab;   // the range's table entries (int32)
  size_t total;
  __host__ __device__ F32Layout(int H, int D, int n_tab) {
    kpad = D + 4;
    tile = align16((size_t)H * D * sizeof(float));
    ps = tile + (size_t)TILE * kpad * sizeof(float);
    stat = ps + TILE * MAXH * sizeof(float);
    tab = stat + 2 * MAXH * sizeof(float);
    total = tab + align16((size_t)n_tab * sizeof(int));
  }
};

__global__ void __launch_bounds__(FNT, 1)
mla_f32_kernel(const float* __restrict__ ql, const float* __restrict__ qp,
               const float* __restrict__ c_pool, const float* __restrict__ kpe_pool,
               const int* __restrict__ table, long long t_sb, Pos pos, float* __restrict__ out,
               float* __restrict__ part, int H, int r, int dr, int P,
               int bs, int nb, int chunk, long long ql_sb, long long ql_sh, long long qp_sb,
               long long qp_sh, long long c_sb, long long c_ss, long long k_sb, long long k_ss,
               float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may start
  const int D = r + dr;
  const F32Layout lt(H, D, 0);
  float* qs = reinterpret_cast<float*>(smem);                 // [H][D]
  float* ts = reinterpret_cast<float*>(smem + lt.tile);       // [TILE][kpad]
  float* ps = reinterpret_cast<float*>(smem + lt.ps);         // [TILE][MAXH]
  float* alpha_s = reinterpret_cast<float*>(smem + lt.stat);  // [MAXH]
  float* l_s = alpha_s + MAXH;                                // [MAXH]
  int* tab = reinterpret_cast<int*>(smem + lt.tab);
  const int b = blockIdx.x, split = blockIdx.y, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int nk = keys_of(pos, b, nb * bs);
  const int live = nk > chunk ? (nk + chunk - 1) / chunk : 1;
  if (split >= live) return;
  const int k0 = split * chunk, k1 = min(k0 + chunk, nk);
  const int tab0 = k0 / bs;

  for (int i = tid; i < H * D; i += FNT) {
    const int h = i / D, e = i % D;
    qs[i] = e < r ? ql[b * ql_sb + h * ql_sh + e] : qp[b * qp_sb + h * qp_sh + (e - r)];
  }
  load_table(tab, table, b * t_sb, tab0, k1 > k0 ? (k1 - 1) / bs - tab0 + 1 : 0, P);
  __syncthreads();

  const int CR = r / 4, CPR = D / 4;  // 16-byte chunks: latent, whole row
  float m = NEG, l = 0.f;  // head `warp`: running max and sum
  float acc[MAXH];         // dim `tid` of every head's context
#pragma unroll
  for (int h = 0; h < MAXH; ++h) acc[h] = 0.f;
  const float* qh = qs + warp * D;
  const int ntiles = k1 > k0 ? (k1 - k0 + TILE - 1) / TILE : 0;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = k0 + it * TILE;
    // the tile, all of its 16-byte copies in flight at once; keys past k1
    // are zero-filled, so a masked latent lane is zero
    for (int i = tid; i < TILE * CPR; i += FNT) {
      const int row = i / CPR, cc = i % CPR, key = t0 + row;
      const bool ok = key < k1;
      const float* src = c_pool;  // a valid address; nothing is read when !ok
      if (ok) {
        const long long blk = tab[key / bs - tab0], slot = key % bs;
        src = cc < CR ? c_pool + blk * c_sb + slot * c_ss + cc * 4
                      : kpe_pool + blk * k_sb + slot * k_ss + (cc - CR) * 4;
      }
      cp_async16(ts + row * lt.kpad + cc * 4, src, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    if (warp < H) {  // scores of head `warp` against key t0 + lane
      const float* krow = ts + lane * lt.kpad;
      float s = 0.f;
#pragma unroll 4
      for (int cc = 0; cc < CPR; ++cc) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + cc * 4);
        const float4 qv = *reinterpret_cast<const float4*>(qh + cc * 4);
        s += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
      const bool valid = t0 + lane < k1;
      const float sg = valid ? s * scale : NEG;
      const float mnew = fmaxf(m, warp_max(sg));
      const float pg = valid ? expf(sg - mnew) : 0.f;
      const float alpha = expf(m - mnew);
      l = l * alpha + warp_sum(pg);
      m = mnew;
      ps[lane * MAXH + warp] = pg;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    if (tid < r) {  // context: latent dim tid of every head
#pragma unroll
      for (int h = 0; h < MAXH; ++h)
        if (h < H) acc[h] *= alpha_s[h];
      for (int j = 0; j < TILE; ++j) {
        const float cv = ts[j * lt.kpad + tid];
        const float4* p4 = reinterpret_cast<const float4*>(ps + j * MAXH);
#pragma unroll
        for (int h4 = 0; h4 < MAXH / 4; ++h4) {
          const float4 pv = p4[h4];
          acc[4 * h4] += pv.x * cv;
          acc[4 * h4 + 1] += pv.y * cv;
          acc[4 * h4 + 2] += pv.z * cv;
          acc[4 * h4 + 3] += pv.w * cv;
        }
      }
    }
    __syncthreads();  // the next copy into the tile, and ps, come after
  }

  if (live == 1) {
    if (warp < H && lane == 0) l_s[warp] = l;
    __syncthreads();
    if (tid < r) {
#pragma unroll
      for (int h = 0; h < MAXH; ++h)
        if (h < H) out[((long long)b * H + h) * r + tid] = acc[h] / fmaxf(l_s[h], 1e-30f);
    }
    return;
  }
  float* pr = part + ((long long)b * gridDim.y + split) * part_stride(H, r);
  if (warp < H && lane == 0) {
    pr[H * r + 2 * warp] = m * LOG2E;  // the combine weighs in log2 units
    pr[H * r + 2 * warp + 1] = l;
  }
  if (tid < r) {
#pragma unroll
    for (int h = 0; h < MAXH; ++h)
      if (h < H) pr[h * r + tid] = acc[h];
  }
}

// ---------------------------------------------------------------------------
// launch

constexpr int MAX_DEVICES = 64;

// cudaFuncSetAttribute once per kernel and device, again only when a launch
// needs more dynamic shared memory than any before it on that device (a
// limit, not a reservation)
template <int KIND, typename F>
int allow_smem(F* kernel, size_t smem) {
  static size_t allowed[MAX_DEVICES] = {};  // 0: not asked yet on that device
  if (smem <= (48 << 10)) return 0;  // what every kernel may use without asking
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && smem <= allowed[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = smem;
  return (int)e;
}

// the chunk of keys a range walks: a whole number of tiles, the ranges
// covering nb * bs keys
int chunk_of(int keys, int splits) {
  const int tiles = (keys + TILE - 1) / TILE;
  return (tiles + splits - 1) / splits * TILE;
}

size_t smem_of(int dtype, int H, int r, int dr, int bs, int chunk) {
  const int n_tab = chunk / bs + 2;  // table entries a range spans, at most
  return dtype == 1 ? Bf16Layout((r + dr + 15) / 16 * 16, n_tab).total
                    : F32Layout(H, r + dr, n_tab).total;
}

int launch(const Args& a, int dtype, cudaStream_t st) {
  const size_t smem = smem_of(dtype, a.H, a.r, a.dr, a.bs, a.chunk);
  const dim3 grid(a.B, a.splits);
  float* part = a.splits > 1 ? a.part : nullptr;
  if (dtype == 1) {
    const int rc = allow_smem<1>(mla_bf16_kernel, smem);
    if (rc) return rc;
    mla_bf16_kernel<<<grid, BNT, smem, st>>>(
        static_cast<const bf16*>(a.ql), static_cast<const bf16*>(a.qp),
        static_cast<const bf16*>(a.c), static_cast<const bf16*>(a.kpe), a.table, a.t_sb, a.pos,
        static_cast<bf16*>(a.out), part, a.H, a.r, a.dr, a.P, a.bs, a.nb, a.chunk,
        a.ql_sb, a.ql_sh, a.qp_sb, a.qp_sh, a.c_sb, a.c_ss, a.k_sb, a.k_ss,
        a.scale * LOG2E);  // scores in log2 units
  } else {
    const int rc = allow_smem<0>(mla_f32_kernel, smem);
    if (rc) return rc;
    mla_f32_kernel<<<grid, FNT, smem, st>>>(
        static_cast<const float*>(a.ql), static_cast<const float*>(a.qp),
        static_cast<const float*>(a.c), static_cast<const float*>(a.kpe), a.table, a.t_sb,
        a.pos, static_cast<float*>(a.out), part, a.H, a.r, a.dr, a.P, a.bs, a.nb,
        a.chunk, a.ql_sb, a.ql_sh, a.qp_sb, a.qp_sh, a.c_sb, a.c_ss, a.k_sb, a.k_ss, a.scale);
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0 || a.splits == 1) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, a.B);
  cfg.blockDim = dim3(CNT);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int S = a.nb * a.bs;
  if (dtype == 1)
    return (int)cudaLaunchKernelEx(&cfg, mla_combine_kernel<bf16>, (const float*)a.part,
                                   static_cast<bf16*>(a.out), a.pos, a.H, a.r, S, a.chunk,
                                   a.splits);
  return (int)cudaLaunchKernelEx(&cfg, mla_combine_kernel<float>, (const float*)a.part,
                                 static_cast<float*>(a.out), a.pos, a.H, a.r, S, a.chunk,
                                 a.splits);
}

bool aligned(const void* p, long long s0, long long s1, int esize, int to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0 && (s0 * esize) % to == 0 &&
         (s1 * esize) % to == 0;
}

bool shape_ok(int dtype, int H, int r, int dr, int bs, int nb, int splits) {
  return (dtype == 0 || dtype == 1) && H >= 1 && H <= MAXH && r >= 8 && r <= MAXR &&
         r % 8 == 0 && dr >= 8 && dr % 8 == 0 && r + dr <= MAXD && bs >= 1 && nb >= 1 &&
         splits >= 1 && splits <= MAX_SPLITS && splits <= (nb * bs + TILE - 1) / TILE;
}

}  // namespace

// q_lat (B, H, r) and q_pe (B, H, dr) by the given element strides (batch,
// head; the last dim contiguous; bfloat16 rows 16-byte aligned); c_pool
// (P, bs, r) and kpe_pool (P, bs, dr) by the given strides (block, slot; the
// last dim contiguous, bases and rows 16-byte aligned); table int32 (B, nb)
// with row stride t_sb (its last dim contiguous); out (B, H, r) contiguous.
// pos: pos_kind 0 = int32 array, 1 = int64 array (element stride pos_stride,
// 0 for one value for every row), 2 = the scalar pos_scalar (pos unused).
// The key axis is cut into `splits` ranges of whole 32-key tiles (1 <= splits
// <= min(128, ceil(nb * bs / 32))), one CTA each; with splits > 1, part is
// f32 scratch of B * splits * (H * r + 32) floats, and a second kernel, a
// CTA a (head, row), merges a row's ranges. dtype: 0 = float32,
// 1 = bfloat16. H <= 16, r <= 512, r and dr multiples of 8, r + dr <= 1024.
// Returns the CUDA error code of the launch (0 on success;
// cudaErrorMisalignedAddress before any launch for misaligned operands).
extern "C" int paged_mla_decode_attention_launch(
    const void* q_lat, const void* q_pe, const void* c_pool, const void* kpe_pool,
    const void* table, const void* pos, void* out, void* part, int B, int H,
    int r, int dr, int P, int bs, int nb, int splits, long long ql_sb, long long ql_sh,
    long long qp_sb, long long qp_sh, long long c_sb, long long c_ss, long long k_sb,
    long long k_ss, long long t_sb, long long pos_stride, long long pos_scalar, int pos_kind,
    float scale, int dtype, void* stream) {
  if (B < 1 || B > 65535 || P < 1 || !shape_ok(dtype, H, r, dr, bs, nb, splits) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  // a dim of size 1 is only ever read at index 0: its stride is free
  if (B == 1) ql_sb = qp_sb = 0;
  if (H == 1) ql_sh = qp_sh = 0;
  if (P == 1) c_sb = k_sb = 0;
  if (bs == 1) c_ss = k_ss = 0;
  const int es = dtype == 1 ? 2 : 4, qa = dtype == 1 ? 16 : 4;  // bf16 q rows go by TMA
  if (!aligned(c_pool, c_sb, c_ss, es, 16) || !aligned(kpe_pool, k_sb, k_ss, es, 16) ||
      !aligned(q_lat, ql_sb, ql_sh, es, qa) || !aligned(q_pe, qp_sb, qp_sh, es, qa))
    return (int)cudaErrorMisalignedAddress;
  Args a{q_lat, q_pe, c_pool, kpe_pool, static_cast<const int*>(table), t_sb,
         Pos{pos_kind == 2 ? nullptr : pos, pos_stride, pos_scalar, pos_kind == 1}, out,
         static_cast<float*>(part), B, H, r, dr, P, bs, nb,
         splits, chunk_of(nb * bs, splits), ql_sb, ql_sh, qp_sb, qp_sh, c_sb, c_ss, k_sb, k_ss,
         scale};
  return launch(a, dtype, static_cast<cudaStream_t>(stream));
}

// The CTAs an SM of the launch above would hold (the occupancy API, with its
// dynamic shared memory), or a negative CUDA error code.
extern "C" int paged_mla_decode_ctas_per_sm(int dtype, int H, int r, int dr, int bs, int nb,
                                            int splits) {
  if (!shape_ok(dtype, H, r, dr, bs, nb, splits)) return -(int)cudaErrorInvalidValue;
  const size_t smem = smem_of(dtype, H, r, dr, bs, chunk_of(nb * bs, splits));
  int rc, n = 0;
  if (dtype == 1) {
    rc = allow_smem<1>(mla_bf16_kernel, smem);
    if (!rc) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mla_bf16_kernel, BNT, smem);
  } else {
    rc = allow_smem<0>(mla_f32_kernel, smem);
    if (!rc) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mla_f32_kernel, FNT, smem);
  }
  return rc ? -rc : n;
}
