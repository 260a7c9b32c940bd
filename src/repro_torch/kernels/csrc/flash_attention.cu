// Prefill attention with an online softmax over key tiles (flash attention),
// written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py : flash_attention
// (Pallas, TPU). Same semantics: q (B, H, Sq, hd) against k, v (B, KH, Sk, hd),
// query head h reading key/value head h / (H / KH) (GQA);
//   s[i, j] = (q_i . k_j) * scale, masked to -1e30 unless j <= i (causal) and
//   j > i - window (sliding window), p zeroed under the mask,
// online (m, l, acc) in f32, and out_i = acc_i / max(l_i, 1e-30) in q's dtype.
// Query i and key j are absolute positions from 0, so a causal mask from query
// 0 is the mask of a whole-prompt prefill into a longer cache. Unlike the
// Pallas kernel, Sq and Sk need not be multiples of the tiles: the ragged
// tails are masked here.
//
// What bounds it on an H100: at the served prefill (128 queries, 160 keys,
// hd 128) the q, k, v bytes and the 2 * 2 * Sq * Sk * hd flop are both tiny,
// so latency bounds it: how soon the few CTAs get their tiles and how many
// SMs work. On long prompts the flop grow as Sq * Sk and the operations bound
// it (~4 * hd flop per score against a few bytes): 0.052 ms on the bf16
// tensor cores for 4096 causal queries of 12 heads, 0.77 ms on the f32 CUDA
// cores.
//
// bf16 (every served model): FlashAttention-2 on mma.sync.m16n8k16 (bf16 in,
// f32 accumulate).
//   * One CTA per (query tile, head, batch row); each warp owns 16 query
//     rows. The tile is 64 queries (4 warps), or 32 (2 warps) when
//     B * H * ceil(Sq / 64) CTAs would not give every SM one: qwen2's
//     served prefill (B 1, H 12, Sq 128) has 24 CTAs of 64 for 132 SMs, and
//     takes 48 CTAs of 32 that each wait on fewer rows. Query tiles are
//     launched last first, so the longest causal rows start first.
//   * Q, K and V reach shared memory as bf16 through 16-byte cp.async
//     copies (rows past Sq or Sk, and columns past hd, zero-filled by a
//     short source size), rows padded by 16 bytes so that ldmatrix's eight
//     row reads hit distinct banks. hd is rounded up to 16, 32, 64, 128 or
//     256.
//   * 64-key K/V tiles in a two-stage ring: tile j + 1's copies are in
//     flight (cp.async commit / wait groups) while tile j is computed, and
//     K and V are separate groups, so Q.K^T starts before V has landed.
//   * Q is loaded once into A fragments (ldmatrix); S = Q.K^T takes K rows
//     through ldmatrix as the B operand; the online softmax runs on the
//     accumulator fragments: row max and sum over the four lanes that share
//     a row, p = 2^(s * scale * log2(e) - m) in f32, one FMA and one ex2 a
//     score. P is rounded to bf16 in registers and is the A operand of P.V
//     directly, V coming through ldmatrix.trans. Shared memory 87 KB at hd
//     128 and 64 queries, so two CTAs fit an SM.
//   * hd 256 (Gemma3): a warp's 16 x 256 f32 output fragment alone is 128
//     registers a lane, so Q is not kept in registers (each k16 step reads
//     its A fragment from shared memory by ldmatrix, once a key tile) and
//     key tiles are 32 deep (16 score registers, not 32). Shared memory is
//     then 99 KB at 64 queries: two CTAs an SM, as at hd 128.
//   * The softmax's instruction count is the limit next to the mma: a tile that
//     every row of a warp sees takes a path with no mask test at all. A
//     masked score counts as -1e30: it never raises the row max (which
//     starts at -1e30) and its p is 0. A causal or windowed tile range
//     skips the key tiles that every query of the tile masks; their
//     skipped p would be 0 and their alpha 1.
// float32 (the card tests' exact reference path) stays on the CUDA cores,
// unchanged: neither bf16 nor TF32 tensor-core products hold the 1e-5
// agreement that f32 attention is tested to. One CTA per (64 queries, head,
// row), 64-key tiles of K (transposed) and V in f32 shared memory, warp w
// owning query rows 8w..8w+7, register-blocked scores, P through shared
// memory; a lane owns 4 output columns (8 at hd > 128: 214 KB of shared
// memory at hd 256).
// The next step (ROADMAP): wgmma with TMA (the FlashAttention-3 shape) for the bf16
// path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAXHD = 256;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block can use

__device__ __forceinline__ bool visible(int qi, int kj, int Sk, int causal, int window) {
  return kj < Sk && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}

// ---------------------------------------------------------------------------
// float32: on the CUDA cores

constexpr int NT = 256;        // threads
constexpr int NW = NT / 32;    // warps
constexpr int BQ = 64;         // queries per CTA
constexpr int BK = 64;         // keys per tile: two per lane
constexpr int RW = BQ / NW;    // query rows a warp owns

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

// Shared memory of one CTA, in floats from its start.
struct Layout {
  int qs, kt, vs, ps, total;
  __host__ __device__ explicit Layout(int hd) {
    qs = 0;                      // Q  [BQ][hd]
    kt = qs + BQ * hd;           // K^T [hd][BK + 1]
    vs = kt + hd * (BK + 1);     // V  [BK][hd]
    ps = vs + BK * hd;           // P  [BQ][BK]
    total = ps + BQ * BK;
  }
};

// NC: output columns a lane owns (4 up to hd 128, 8 up to hd 256)
template <int NC>
__global__ void __launch_bounds__(NT, 1)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int H, int KH, int Sq,
                    int Sk, int hd, long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                    long long o_ss, float scale, int causal, int window) {
  extern __shared__ __align__(16) float sm[];
  const Layout lt(hd);
  float* Qs = sm + lt.qs;
  float* Kt = sm + lt.kt;
  float* Vs = sm + lt.vs;
  float* Ps = sm + lt.ps;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kh * k_sh;
  const float* vb = v + b * v_sb + kh * v_sh;

  for (int e = tid; e < BQ * hd; e += NT) {
    const int i = e / hd, d = e % hd;
    Qs[e] = q0 + i < Sq ? qb[(q0 + i) * q_ss + d] : 0.f;
  }
  // the keys any query of this tile can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[RW], l[RW], acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int kt = k_lo / BK; kt * BK <= k_hi; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // the previous tile's K and V reads are done
    for (int e = tid; e < BK * hd; e += NT) {
      const int j = e / hd, d = e % hd;
      const bool ok = j0 + j < Sk;
      Kt[d * (BK + 1) + j] = ok ? kb[(j0 + j) * k_ss + d] : 0.f;
      Vs[j * hd + d] = ok ? vb[(j0 + j) * v_ss + d] : 0.f;  // zero past Sk
    }
    __syncthreads();
    // scores, register-blocked: per d a thread reads its warp's 8 q values
    // (broadcast) and its two keys' k values once, for 16 FMAs
    float sc[RW][2];
#pragma unroll
    for (int r = 0; r < RW; ++r) sc[r][0] = sc[r][1] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float k0 = Kt[d * (BK + 1) + lane], k1 = Kt[d * (BK + 1) + lane + 32];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float qd = Qs[(warp * RW + r) * hd + d];
        sc[r][0] += qd * k0;
        sc[r][1] += qd * k1;
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = warp * RW + r;
      float s0 = sc[r][0], s1 = sc[r][1];
      const bool v0 = visible(q0 + i, j0 + lane, Sk, causal, window);
      const bool v1 = visible(q0 + i, j0 + lane + 32, Sk, causal, window);
      s0 = v0 ? s0 * scale : NEG;
      s1 = v1 ? s1 * scale : NEG;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[r] - m_new);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      Ps[i * BK + lane] = p0;
      Ps[i * BK + lane + 32] = p1;
    }
    __syncwarp();  // a warp reads back only its own rows of P
    const int nj = min(BK, Sk - j0);
    for (int j = 0; j < nj; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < hd ? Vs[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float p = Ps[(warp * RW + r) * BK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += p * vj[c];
      }
    }
  }

  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = q0 + warp * RW + r;
    if (i >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) ob[i * o_ss + d] = acc[r][c] * inv;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int KH,
               int Sq, int Sk, int hd, long long q_sb, long long q_sh, long long q_ss,
               long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
               long long v_ss, long long o_sb, long long o_sh, long long o_ss, float scale,
               int causal, int window, cudaStream_t stream) {
  const size_t bytes = (size_t)Layout(hd).total * sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = hd > 128 ? flash_attention_f32<8> : flash_attention_f32<4>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
      v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: FlashAttention-2 on the tensor cores (mma.sync)

using bf16 = __nv_bfloat16;

// keys per tile: 64, or 32 at hd > 128, where the output fragment takes
// 128 registers a lane
template <int HD>
__host__ __device__ constexpr int key_tile() {
  return HD > 128 ? 32 : 64;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy; the source's first `src_bytes` (0..16) are
// read and the rest of the 16 bytes written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
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
// The online-softmax step of one score tile on the accumulator fragments
// (raw q.k in s; p out); FULL: every score of the warp's rows is visible.
template <bool FULL, int NB>
__device__ __forceinline__ void softmax_tile(float (&s)[NB][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int row0,
                                             int j0, int c2, int Sk, int causal, int window) {
  unsigned vis = 0xffffffffu;
  if (!FULL) {
    vis = 0u;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (visible(row0 + 8 * (e >> 1), j0 + 8 * nb + c2 + (e & 1), Sk, causal, window))
          vis |= 1u << (4 * nb + e);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (FULL || (vis >> (4 * nb + e)) & 1u) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * scale_log2);  // scale > 0: max commutes
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = FULL || (vis >> (4 * nb + e)) & 1u
                          ? ex2(fmaf(s[nb][e], scale_log2, -m[e >> 1]))
                          : 0.f;
      s[nb][e] = p;
      l[e >> 1] += p;
    }
}

// cp.async rows [r0, r0 + ROWS) of a (rows, hd) bf16 matrix (row stride ss
// elements) into shared rows of HD + 8 elements: zeros past row_end and
// past hd.
template <int HD, int ROWS, int NTH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ base, long long ss,
                                          int r0, int row_end, int hd, int tid) {
  constexpr int CPR = HD / 8, PITCH = HD + 8, RSTEP = NTH / CPR;
  static_assert(NTH % CPR == 0 && ROWS % RSTEP == 0, "whole copies per thread");
  const int c = (tid % CPR) * 8, n_c = min(16, max(0, 2 * (hd - c)));
  int row = r0 + tid / CPR;
  bf16* d = dst + (tid / CPR) * PITCH + c;
  const bf16* src = base + row * ss + c;
#pragma unroll 4
  for (int it = 0; it < ROWS / RSTEP; ++it) {
    const int n = row < row_end ? n_c : 0;
    cp_async16(d, n ? src : base, n);
    row += RSTEP;
    d += RSTEP * PITCH;
    src += RSTEP * ss;
  }
}

template <int HD, int NWQ>
__global__ void __launch_bounds__(NWQ * 32, 2)
flash_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int H, int KH, int Sq,
                     int Sk, int hd, long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                     long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                     long long o_ss, float scale_log2, int causal, int window) {
  constexpr int NTH = NWQ * 32, TQ = NWQ * 16, PITCH = HD + 8, TK = key_tile<HD>();
  constexpr int KS = HD / 16;  // k16 steps of q.k
  constexpr int NB = TK / 8;   // n8 blocks of a score tile: TK / 2 scores a lane
  constexpr int DB = HD / 8;   // n8 blocks of the output
  constexpr bool QREG = HD <= 128;  // Q's A fragments live in registers for the walk
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Qs = reinterpret_cast<bf16*>(smraw);  // [TQ][PITCH]
  bf16* Ks = Qs + TQ * PITCH;                 // [2][TK][PITCH]
  bf16* Vs = Ks + 2 * TK * PITCH;             // [2][TK][PITCH]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kh * k_sh;
  const bf16* vb = v + b * v_sb + kh * v_sh;

  // the key tiles any query of this tile can see
  const int q_last = min(q0 + TQ, Sq) - 1;
  const int k_hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / TK, t_hi = k_lo <= k_hi ? k_hi / TK : t_lo - 1;

  // commit groups, in order: Q + K(t_lo), V(t_lo), then K and V of each next
  // tile, so that S = Q K^T starts while V is still in flight
  if (t_lo <= t_hi) {
    load_rows<HD, TQ, NTH>(Qs, qb, q_ss, q0, Sq, hd, tid);
    load_rows<HD, TK, NTH>(Ks, kb, k_ss, t_lo * TK, Sk, hd, tid);
  }
  cp_async_commit();
  if (t_lo <= t_hi) load_rows<HD, TK, NTH>(Vs, vb, v_ss, t_lo * TK, Sk, hd, tid);
  cp_async_commit();

  const int wq0 = q0 + warp * 16;  // this warp's first query row
  const int row0 = wq0 + g;        // a lane's rows: row0 and row0 + 8
  unsigned qf[QREG ? KS : 1][4];
  float o[DB][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    // the next tile streams in while this one is computed (empty groups
    // past the last tile keep the count uniform)
    if (t < t_hi)
      load_rows<HD, TK, NTH>(Ks + (st ^ 1) * TK * PITCH, kb, k_ss, (t + 1) * TK, Sk, hd, tid);
    cp_async_commit();
    if (t < t_hi)
      load_rows<HD, TK, NTH>(Vs + (st ^ 1) * TK * PITCH, vb, v_ss, (t + 1) * TK, Sk, hd, tid);
    cp_async_commit();
    cp_async_wait<3>();  // K(t) (and Q) landed; V(t), K(t+1), V(t+1) may not have
    __syncthreads();
    if constexpr (QREG) {
      if (t == t_lo) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * PITCH + ks * 16 + (lane >> 4) * 8);
      }
    }
    const bf16* Kt = Ks + st * TK * PITCH;
    const bf16* Vt = Vs + st * TK * PITCH;

    // S = Q K^T: matrices (keys nb, d 0-7), (keys nb, d 8-15), (keys nb+1, ..)
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned qk[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qk[i] = qf[ks][i];
      } else {
        ldsm_x4(qk, Qs + (warp * 16 + (lane & 15)) * PITCH + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        unsigned kf[4];
        ldsm_x4(kf, Kt + ((nb + (mi >> 1)) * 8 + (lane & 7)) * PITCH + ks * 16 + (mi & 1) * 8);
        mma_bf16(s[nb], qk, kf[0], kf[1]);
        mma_bf16(s[nb + 1], qk, kf[2], kf[3]);
      }
    }

    // online softmax on the fragments: element e of block nb is row
    // row0 + 8 * (e >> 1), key j0 + 8 * nb + c2 + (e & 1)
    const int j0 = t * TK;
    const bool full = j0 + TK <= Sk && (!causal || j0 + TK - 1 <= wq0) &&
                      (window <= 0 || j0 > wq0 + 15 - window);
    float alpha[2];
    if (full)
      softmax_tile<true, NB>(s, m, l, alpha, scale_log2, row0, j0, c2, Sk, causal, window);
    else
      softmax_tile<false, NB>(s, m, l, alpha, scale_log2, row0, j0, c2, Sk, causal, window);
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      o[db][0] *= alpha[0];
      o[db][1] *= alpha[0];
      o[db][2] *= alpha[1];
      o[db][3] *= alpha[1];
    }

    cp_async_wait<2>();  // V(t) landed
    __syncthreads();
    // O += P V: P's accumulator blocks 2kk, 2kk + 1 are the A fragment of
    // keys 16kk..16kk+15; V through ldmatrix.trans, matrices (keys 0-7, d
    // db), (keys 8-15, d db), (keys 0-7, d db+1), (keys 8-15, d db+1)
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int db = 0; db < DB; db += 2) {
        unsigned vf[4];
        ldsm_x4_t(vf, Vt + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * PITCH + (db + (mi >> 1)) * 8);
        mma_bf16(o[db], pa, vf[0], vf[1]);
        mma_bf16(o[db + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile two on
  }
  cp_async_wait<0>();

  bf16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int i = row0 + 8 * r;
    if (i >= Sq) continue;
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = db * 8 + c2 + e;
        if (d < hd) ob[i * o_ss + d] = __float2bfloat16(o[db][2 * r + e] * inv);
      }
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

template <int HD, int NWQ>
int launch_bf16_t(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int H, int KH,
                  int Sq, int Sk, int hd, long long q_sb, long long q_sh, long long q_ss,
                  long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                  long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                  float scale_log2, int causal, int window, cudaStream_t stream) {
  constexpr int TQ = NWQ * 16;
  constexpr size_t bytes = (size_t)(TQ + 4 * key_tile<HD>()) * (HD + 8) * sizeof(bf16);
  static_assert(bytes <= MAX_SMEM, "shared memory");
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bf16<HD, NWQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((Sq + TQ - 1) / TQ, H, B);
  flash_attention_bf16<HD, NWQ><<<grid, NWQ * 32, bytes, stream>>>(
      q, k, v, out, H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      o_sb, o_sh, o_ss, scale_log2, causal, window);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16_hd(int nwq, const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
                   int H, int KH, int Sq, int Sk, int hd, long long q_sb, long long q_sh,
                   long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                   long long o_sh, long long o_ss, float scale_log2, int causal, int window,
                   cudaStream_t stream) {
  if (nwq == 2)
    return launch_bf16_t<HD, 2>(q, k, v, out, B, H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb,
                                k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale_log2,
                                causal, window, stream);
  return launch_bf16_t<HD, 4>(q, k, v, out, B, H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb, k_sh,
                              k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale_log2, causal,
                              window, stream);
}

bool aligned16(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s0 * 2) % 16 == 0 && (s1 * 2) % 16 == 0 &&
         (s2 * 2) % 16 == 0;
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H, int KH,
                int Sq, int Sk, int hd, long long q_sb, long long q_sh, long long q_ss,
                long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                long long v_ss, long long o_sb, long long o_sh, long long o_ss, float scale,
                int causal, int window, cudaStream_t stream) {
  // cp.async copies 16-byte chunks: every row and base must be 16-byte aligned
  // (the strides of size-1 dims are 0 by now)
  if (!aligned16(q, q_sb, q_sh, q_ss) || !aligned16(k, k_sb, k_sh, k_ss) ||
      !aligned16(v, v_sb, v_sh, v_ss))
    return (int)cudaErrorMisalignedAddress;
  const int HDP = hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  // 32-query tiles when 64-query tiles would leave SMs without a CTA
  const long long ctas64 = (long long)B * H * ((Sq + 63) / 64);
  const int nwq = ctas64 < sm_count() ? 2 : 4;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp2 for exp
  auto qp = static_cast<const bf16*>(q);
  auto kp = static_cast<const bf16*>(k);
  auto vp = static_cast<const bf16*>(v);
  auto op = static_cast<bf16*>(out);
#define FA_ARGS                                                                               \
  nwq, qp, kp, vp, op, B, H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, \
      v_ss, o_sb, o_sh, o_ss, sl2, causal, window, stream
  switch (HDP) {
    case 16: return launch_bf16_hd<16>(FA_ARGS);
    case 32: return launch_bf16_hd<32>(FA_ARGS);
    case 64: return launch_bf16_hd<64>(FA_ARGS);
    case 128: return launch_bf16_hd<128>(FA_ARGS);
    default: return launch_bf16_hd<256>(FA_ARGS);
  }
#undef FA_ARGS
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KH, Sk, hd), out (B, H, Sq, hd), one dtype, each
// by its element strides (batch, head, position; the last dim contiguous).
// causal: 0 or 1; window <= 0: none. dtype: 0 = float32, 1 = bfloat16 (then
// every base pointer and stride of a dim longer than 1 16-byte aligned, else
// cudaErrorMisalignedAddress, before any launch).
// hd <= 256, H a multiple of KH. Returns the CUDA error code of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KH, int Sq, int Sk, int hd,
                                      long long q_sb, long long q_sh, long long q_ss,
                                      long long k_sb, long long k_sh, long long k_ss,
                                      long long v_sb, long long v_sh, long long v_ss,
                                      long long o_sb, long long o_sh, long long o_ss,
                                      float scale, int causal, int window, int dtype,
                                      void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KH < 1 || H % KH || Sq < 1 || Sk < 1 ||
      hd < 1 || hd > MAXHD)
    return (int)cudaErrorInvalidValue;
  // a dim of size 1 is only ever read at index 0: its stride is free
  if (B == 1) q_sb = k_sb = v_sb = 0;
  if (H == 1) q_sh = 0;
  if (KH == 1) k_sh = v_sh = 0;
  if (Sq == 1) q_ss = 0;
  if (Sk == 1) k_ss = v_ss = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, B, H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                       v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window, st);
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                      v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
