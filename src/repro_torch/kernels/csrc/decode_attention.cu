// Flash-decode attention: one query token per row against a contiguous KV
// cache or a paged block pool, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py : decode_attention
// and src/repro/kernels/decode_attention/paged.py : paged_decode_attention
// (Pallas, TPU). Same semantics: online softmax over key tiles in f32,
// per-row pos (attend to kpos <= pos), GQA by head folding, -1e30 for masked
// scores, v zeroed under the mask, final divide by max(l, 1e-30).
//
// What bounds it on an H100: bytes. Each key row costs hd*2 multiply-adds
// per query head and hd*2 bytes per K and V row in bf16, so with G = 6
// query heads per KV head it does ~6 flop per byte, far below the ~295
// flop/byte where the tensor cores would become the limit. The design
// reads each K/V byte once and keeps enough of them in flight:
//   * the cache is read in its (B, S, KH, hd) storage layout by stride, so
//     the caller's (B, KH, S, hd) view costs no transpose copy; keys are
//     walked only up to min(pos, S-1), never the padded tail of the cache;
//   * each K/V tile reaches shared memory once and serves all G query heads
//     that share it.
// bf16 (every served model): flash-decoding on the tensor cores.
//   * The key axis is split: the grid is (B * KH, splits), and CTA
//     (row, KV head, s) walks keys [s * chunk, (s + 1) * chunk) of the row's
//     nk = min(pos, S-1) + 1; chunk is a whole number of 16-key tiles, and
//     splits (the wrapper's decode_splits) depends on static shapes only.
//     Ranges that start at or past nk exit at once. A row with one live
//     range writes its output from that CTA; otherwise each live range
//     writes its (m, l, acc) in f32 to scratch, and the last of them to
//     finish (an atomic counter per (row, KV head), which it resets to 0)
//     merges the ranges in range order, so the result does not depend on
//     which CTA came last: one launch a call.
//   * A CTA is 4 warps; warp w takes the range's tiles w, w + 4, ... through
//     its own two-stage cp.async ring (16-byte copies of 16 key rows of K and
//     of V, rows padded by 16 bytes so that ldmatrix's row reads hit
//     distinct banks; rows past the range zero-filled). 70 KB of shared
//     memory at hd 128, so three CTAs fit an SM. At hd 256 (Gemma3) the
//     padded rows double to 528 bytes and the ring to 132 KB: one CTA an
//     SM, whose 4 warps keep 64 KB of K and V in flight (more than the
//     ~25 KB an SM needs to cover the memory latency at 3.35 TB/s), and
//     with one CTA an SM the 128 accumulator registers a lane of the
//     16 x 256 output fragment fit without spilling. The split count
//     (decode_splits) reads the CTAs an SM each head width allows.
//   * S = Q.K^T and O += P.V on mma.sync.m16n8k16 (bf16 in, f32 out). The
//     G <= 8 query heads are rows 0..7 of the A operand, rows 8..15 zero:
//     Q sits in A fragments for the whole walk (read once from global
//     memory), K comes through ldmatrix as the B operand, and the online
//     softmax runs on the accumulator fragments (exp2 of pre-scaled
//     scores, one FMA and one ex2 a score; no mask test on a tile the range
//     covers whole). P is rounded to bf16 in registers and is P.V's A
//     operand directly (flash_attention.cu's mapping), V through
//     ldmatrix.trans.
//   * The warps' (m, l, acc) are combined in warp order in shared memory.
// float32 (the card tests' exact reference path) stays on the CUDA cores,
// one CTA per (row, KV head): 4 warps (2 at hd 256, whose 32-key f32 tiles
// would not fit 227 KB four times) take interleaved 32-key tiles, lane j
// scores key j for all G heads, each warp keeps its own online softmax
// state, and the warps are combined at the end (neither bf16 nor TF32
// products hold the 1e-5 that f32 attention is tested to).
// The paged form is a second instantiation of each kernel: only the address
// of a key row differs. Contiguous: k + b*sb + kh*sh + key*ss. Paged, over a
// (P, bs, KH, hd) pool and a per-row block table: pool + table[b, key/bs]*sblk
// + (key%bs)*ss + kh*sh. A CTA loads the table entries its own keys need into
// shared memory once, each clamped into [0, P) so a bad id cannot address
// outside the pool; the walk is clamped to min(pos, nb*bs-1), so a stale pos
// past the table reads nothing out of range. Same key order, same ranges,
// same arithmetic: on the same keys the paged output is bit-identical to the
// contiguous one. Any block size works, including one that does not divide
// a tile (a tile then spans several blocks).
// pos is read as the caller holds it (int32 or int64, one per row or one
// for all rows, or a scalar): the model's int64 positions cost no cast.
// Not done yet: TMA bulk copies, and a merge that overlaps the walk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int MAXG = 8;    // query heads per KV head
constexpr float NEG = -1e30f;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Row b's table entries [t_lo, t_lo + n) into shared memory, clamped into [0, P).
__device__ __forceinline__ void load_table(int* tab, const int* __restrict__ table,
                                           long long t_row, int t_lo, int n, int P) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = table[t_row + t_lo + i];
    tab[i] = t < 0 ? 0 : (t < P ? t : P - 1);
  }
}

// ---------------------------------------------------------------------------
// float32: on the CUDA cores, one CTA per (row, KV head)

constexpr int FT = 32;  // keys per warp tile: one per lane when scoring

// warps of the f32 kernel: four tiles of 32 f32 keys at hd 256 would take
// 268 KB of shared memory
template <int HD>
__host__ __device__ constexpr int f32_warps() {
  return HD > 128 ? 2 : WARPS;
}

template <int HD>
struct F32Layout {
  static constexpr int FW = f32_warps<HD>();
  static constexpr int CPR = HD / 4;    // 16-byte chunks per row
  static constexpr int KPAD = HD + 4;   // padded K row, in floats
  static constexpr int EPL = HD / 32;   // output dims owned by a lane
  static constexpr size_t Q_BYTES = MAXG * HD * 4;
  static constexpr size_t K_BYTES = FT * KPAD * 4;
  static constexpr size_t KV_BYTES = K_BYTES + FT * HD * 4;
  static constexpr size_t WARP_BYTES = KV_BYTES + MAXG * FT * 4;  // K, V, then p
  static constexpr size_t COMB_BYTES = FW * MAXG * (HD + 2) * 4;
  static constexpr size_t SMEM =
      Q_BYTES + (FW * WARP_BYTES > COMB_BYTES ? FW * WARP_BYTES : COMB_BYTES);
  static_assert(SMEM + 16384 * 4 <= 232448, "the layout and a table of 16384 blocks fit");
};

// PAGED == false: k, v are (B, KH, S, hd) by the strides (sb, sh, ss).
// PAGED == true: k, v are (P, bs, KH, hd) pools by the strides (sb = block,
// ss = slot, sh = head), table is int32 with row stride t_sb and S = nb * bs.
template <int HD, bool PAGED>
__global__ void __launch_bounds__(f32_warps<HD>() * 32)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, Pos pos, const int* __restrict__ table,
                  long long t_sb, float* __restrict__ out, int H, int KH, int S, int G, int bs,
                  int P, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                  long long k_ss, long long v_sb, long long v_sh, long long v_ss, float scale) {
  using Lt = F32Layout<HD>;
  constexpr int CPR = Lt::CPR, KPAD = Lt::KPAD, EPL = Lt::EPL, FW = Lt::FW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  int* tab = reinterpret_cast<int*>(smem + Lt::SMEM);  // PAGED: this row's block ids
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* wsm = smem + Lt::Q_BYTES + warp * Lt::WARP_BYTES;
  float* kd = reinterpret_cast<float*>(wsm);
  float* vd = reinterpret_cast<float*>(wsm + Lt::K_BYTES);
  float* ps = reinterpret_cast<float*>(wsm + Lt::KV_BYTES);
  const int nk = keys_of(pos, b, S);

  for (int i = tid; i < G * HD; i += blockDim.x) {
    const int g = i / HD, e = i % HD;
    qs[i] = q[b * q_sb + (long long)(kh * G + g) * q_sh + e];
  }
  if constexpr (PAGED) load_table(tab, table, b * t_sb, 0, (nk + bs - 1) / bs, P);
  __syncthreads();

  const float* kb = PAGED ? k + kh * k_sh : k + b * k_sb + kh * k_sh;
  const float* vb = PAGED ? v + kh * v_sh : v + b * v_sb + kh * v_sh;
  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp * FT; t0 < nk; t0 += FW * FT) {
    // the tile, all of its 16-byte copies in flight at once; rows past nk
    // are zero-filled, so masked v lanes are zero
#pragma unroll
    for (int it = 0; it < FT * CPR / 32; ++it) {
      const int c = lane + it * 32, r = c / CPR, cc = (c % CPR) * 4, key = t0 + r;
      const bool ok = key < nk;
      long long ko = 0, vo = 0;  // a valid address; nothing is read when !ok
      if (ok) {
        if constexpr (PAGED) {
          const long long blk = tab[key / bs], slot = key % bs;
          ko = blk * k_sb + slot * k_ss;
          vo = blk * v_sb + slot * v_ss;
        } else {
          ko = key * k_ss;
          vo = key * v_ss;
        }
      }
      cp_async16(kd + r * KPAD + cc, kb + ko + cc, ok ? 16 : 0);
      cp_async16(vd + r * HD + cc, vb + vo + cc, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    const float* krow = kd + lane * KPAD;
#pragma unroll 2
    for (int cc = 0; cc < CPR; ++cc) {
      const float4 kv4 = *reinterpret_cast<const float4*>(krow + cc * 4);
      const float kel[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) s[g] += qs[g * HD + cc * 4 + e] * kel[e];
      }
    }
    const bool valid = t0 + lane < nk;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float sg = valid ? s[g] * scale : NEG;
        const float mnew = fmaxf(m[g], warp_max(sg));
        const float pg = valid ? expf(sg - mnew) : 0.f;
        const float alpha = expf(m[g] - mnew);
        l[g] = l[g] * alpha + warp_sum(pg);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
        m[g] = mnew;
        ps[g * FT + lane] = pg;
      }
    }
    __syncwarp();

    for (int j = 0; j < FT; ++j) {
      float vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vf[e] = vd[j * HD + lane * EPL + e];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float pj = ps[g * FT + j];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += pj * vf[e];
        }
      }
    }
    __syncwarp();  // the next copy into this tile, and ps, come after
  }
  __syncthreads();

  // combine the warps' partial softmax states
  float* cm = reinterpret_cast<float*>(smem + Lt::Q_BYTES);  // [FW][MAXG]
  float* cl = cm + FW * MAXG;                                  // [FW][MAXG]
  float* ca = cl + FW * MAXG;                                  // [FW][MAXG][HD]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        cm[warp * MAXG + g] = m[g];
        cl[warp * MAXG + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) ca[(warp * MAXG + g) * HD + lane * EPL + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += blockDim.x) {
    const int g = i / HD, e = i % HD;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < FW; ++w) M = fmaxf(M, cm[w * MAXG + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < FW; ++w) {
      const float a = expf(cm[w * MAXG + g] - M);
      L += cl[w * MAXG + g] * a;
      O += ca[(w * MAXG + g) * HD + e] * a;
    }
    out[((long long)b * H + kh * G + g) * HD + e] = O / fmaxf(L, 1e-30f);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: flash-decoding on the tensor cores (mma.sync)

using bf16 = __nv_bfloat16;
constexpr int TK = 16;      // keys per warp tile
constexpr int STAGES = 2;   // cp.async ring depth, per warp
constexpr int BF16_CTAS = 3;  // CTAs an SM the shared memory allows at hd 128 (one at hd 256)
constexpr int MAX_SPLITS = 256;  // key ranges a (row, KV head): the merge's weights fit the ring

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
// Rows 8..15 of A are zero here: a0 = A[g][c..c+1], a2 = A[g][c+8..c+9].
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a2, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
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

template <int HD>
struct Bf16Layout {
  static constexpr int PITCH = HD + 8;  // a padded K or V row, in elements
  static constexpr int TILE = TK * PITCH;
  static constexpr size_t WARP_BYTES = (size_t)STAGES * 2 * TILE * sizeof(bf16);
  static constexpr size_t RING_BYTES = WARPS * WARP_BYTES;
  static constexpr size_t COMB_BYTES = WARPS * MAXG * (HD + 2) * 4;
  static constexpr size_t SMEM = RING_BYTES > COMB_BYTES ? RING_BYTES : COMB_BYTES;
  static_assert((2 * MAX_SPLITS + 1) * MAXG * 4 <= SMEM, "the merge's weights fit");
};

// Grid (B * KH, splits); keys of range s: [s * chunk, min((s + 1) * chunk, nk)).
// part: f32 scratch [B * KH][splits][G][HD + 2] (acc, then (m, l) per head);
// counters: int [B * KH], zero between launches. Both unused with one split.
template <int HD, bool PAGED>
__global__ void __launch_bounds__(WARPS * 32, HD > 128 ? 1 : BF16_CTAS)
decode_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, Pos pos, const int* __restrict__ table,
                   long long t_sb, bf16* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ counters, int H, int KH, int S, int G, int bs, int P,
                   int chunk, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                   long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                   float scale_log2) {
  using Lt = Bf16Layout<HD>;
  constexpr int PITCH = Lt::PITCH, CPR = HD / 8, KS = HD / 16, DB = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int grp = blockIdx.x, b = grp / KH, kh = grp % KH, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;
  // Q's A fragments (row g = query head kh * G + g, zero past G), the row's
  // pos and (paged) the first table entries of the range are read at once:
  // none waits on another
  unsigned qa[KS][2];
  {
    const bf16* qr = q + b * q_sb + (long long)(kh * G + (g < G ? g : 0)) * q_sh + c2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = g < G ? *reinterpret_cast<const unsigned*>(qr + ks * 16) : 0u;
      qa[ks][1] = g < G ? *reinterpret_cast<const unsigned*>(qr + ks * 16 + 8) : 0u;
    }
  }
  const int k0 = split * chunk, tab0 = k0 / bs;
  const int n_tab = PAGED ? (min(k0 + chunk, S) - 1) / bs - tab0 + 1 : 0;  // the range's entries
  const long long t_row = b * t_sb + tab0;
  const int t_first = tid < n_tab ? table[t_row + tid] : 0;
  const int nk = keys_of(pos, b, S);
  const int live = nk > chunk ? (nk + chunk - 1) / chunk : 1;  // ranges with keys (>= 1)
  if (split >= live) return;
  const int k1 = min(k0 + chunk, nk);                  // k1 <= k0 only when nk == 0
  int* tab = reinterpret_cast<int*>(smem + Lt::SMEM);  // PAGED: this range's block ids
  if constexpr (PAGED) {
    if (tid < n_tab) tab[tid] = t_first < 0 ? 0 : (t_first < P ? t_first : P - 1);
    for (int i = tid + WARPS * 32; i < n_tab; i += WARPS * 32) {
      const int t = table[t_row + i];
      tab[i] = t < 0 ? 0 : (t < P ? t : P - 1);
    }
    __syncthreads();
  }

  const bf16* kb = PAGED ? k + kh * k_sh : k + b * k_sb + kh * k_sh;
  const bf16* vb = PAGED ? v + kh * v_sh : v + b * v_sb + kh * v_sh;
  bf16* ring = reinterpret_cast<bf16*>(smem + warp * Lt::WARP_BYTES);
  const int ntiles = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;
  const int mine = ntiles > warp ? (ntiles - warp + WARPS - 1) / WARPS : 0;

  // the warp's i-th tile (the range's tile warp + i * WARPS) into stage st;
  // rows past the range are zero-filled, so masked v rows are zero
  // (paged: a block size that is a multiple of the tile puts a tile in one
  // block, so one table lookup serves it)
  const bool one_block = PAGED && bs % TK == 0;
  auto issue = [&](int i, int st) {
    const int t0 = k0 + (warp + i * WARPS) * TK;
    bf16* kd = ring + st * 2 * Lt::TILE;
    bf16* vd = kd + Lt::TILE;
    long long kt = (long long)t0 * k_ss, vt = (long long)t0 * v_ss;  // the tile's first row
    if (one_block) {
      const long long blk = tab[t0 / bs - tab0], slot = t0 % bs;
      kt = blk * k_sb + slot * k_ss;
      vt = blk * v_sb + slot * v_ss;
    }
#pragma unroll
    for (int it = 0; it < TK * CPR / 32; ++it) {
      const int c = lane + it * 32, r = c / CPR, cc = (c % CPR) * 8, key = t0 + r;
      const bool ok = key < k1;
      long long ko = 0, vo = 0;  // a valid address; nothing is read when !ok
      if (ok) {
        if (PAGED && !one_block) {
          const long long blk = tab[key / bs - tab0], slot = key % bs;
          ko = blk * k_sb + slot * k_ss;
          vo = blk * v_sb + slot * v_ss;
        } else {
          ko = kt + r * k_ss;
          vo = vt + r * v_ss;
        }
      }
      cp_async16(kd + r * PITCH + cc, kb + ko + cc, ok ? 16 : 0);
      cp_async16(vd + r * PITCH + cc, vb + vo + cc, ok ? 16 : 0);
    }
  };

  float o[DB][4], m = NEG, l = 0.f;  // row g's state; o[.][2..3] (rows 8..15) stay 0
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine) issue(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    // the tiles STAGES - 1 on stream in while this one is used (empty
    // groups past the last keep the count uniform)
    if (i + STAGES - 1 < mine) issue(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const bf16* Kt = ring + (i % STAGES) * 2 * Lt::TILE;
    const bf16* Vt = Kt + Lt::TILE;

    // S = Q K^T: matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, ..)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned kf[4];
      ldsm_x4(kf, Kt + ((mi >> 1) * 8 + (lane & 7)) * PITCH + ks * 16 + (mi & 1) * 8);
      mma_bf16(s[0], qa[ks][0], qa[ks][1], kf[0], kf[1]);
      mma_bf16(s[1], qa[ks][0], qa[ks][1], kf[2], kf[3]);
    }

    // online softmax of row g: s[nb][e] (e < 2) is key t0 + 8 nb + c2 + e;
    // the max and sum run over the four lanes that share the row
    const int t0 = k0 + (warp + i * WARPS) * TK;
    const bool full = t0 + TK <= k1;
    float mx = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (full || t0 + 8 * nb + c2 + e < k1) mx = fmaxf(mx, s[nb][e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx * scale_log2);  // scale > 0: max commutes
    const float alpha = ex2(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = full || t0 + 8 * nb + c2 + e < k1 ? ex2(fmaf(s[nb][e], scale_log2, -m))
                                                          : 0.f;
        s[nb][e] = p;
        l += p;
      }
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      o[db][0] *= alpha;
      o[db][1] *= alpha;
    }

    // O += P V: P's blocks 0 and 1 are the A fragment of keys 0..15; V
    // through ldmatrix.trans, matrices (keys 0-7, d db), (keys 8-15, d db),
    // (keys 0-7, d db+1), (keys 8-15, d db+1)
    const unsigned pa0 = pack_bf16(s[0][0], s[0][1]), pa2 = pack_bf16(s[1][0], s[1][1]);
#pragma unroll
    for (int db = 0; db < DB; db += 2) {
      unsigned vf[4];
      ldsm_x4_t(vf, Vt + ((mi & 1) * 8 + (lane & 7)) * PITCH + (db + (mi >> 1)) * 8);
      mma_bf16(o[db], pa0, pa2, vf[0], vf[1]);
      mma_bf16(o[db + 1], pa0, pa2, vf[2], vf[3]);
    }
    __syncwarp();  // the next copy into this stage comes after
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __syncthreads();  // every warp is done with its ring: it holds the combine now

  // combine the warps' states (m in log2 units) in warp order
  float* cm = reinterpret_cast<float*>(smem);  // [WARPS][MAXG]
  float* cl = cm + WARPS * MAXG;               // [WARPS][MAXG]
  float* ca = cl + WARPS * MAXG;               // [WARPS][MAXG][HD]
  if (g < G) {
    if ((lane & 3) == 0) {
      cm[warp * MAXG + g] = m;
      cl[warp * MAXG + g] = l;
    }
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      ca[(warp * MAXG + g) * HD + db * 8 + c2] = o[db][0];
      ca[(warp * MAXG + g) * HD + db * 8 + c2 + 1] = o[db][1];
    }
  }
  __syncthreads();
  bf16* ob = out + ((long long)b * H + kh * G) * HD;
  float* pr = part + ((long long)grp * gridDim.y + split) * G * (HD + 2);
  for (int i = tid; i < G * HD; i += blockDim.x) {
    const int gi = i / HD, e = i % HD;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, cm[w * MAXG + gi]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = ex2(cm[w * MAXG + gi] - M);
      L += cl[w * MAXG + gi] * a;
      O += ca[(w * MAXG + gi) * HD + e] * a;
    }
    if (live == 1) {
      ob[i] = __float2bfloat16(O / fmaxf(L, 1e-30f));
    } else {
      pr[i] = O;
      if (e == 0) {
        pr[G * HD + 2 * gi] = M;
        pr[G * HD + 2 * gi + 1] = L;
      }
    }
  }
  if (live == 1) return;

  // the last live range of this (row, KV head) merges them all, in range
  // order: each range's (m, l) per head into shared memory, the heads' M and
  // L and each range's weight 2^(m_r - M), then the acc of four ranges at a
  // time, their loads in flight together
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[grp], 1) == live - 1;
  __syncthreads();
  if (!last) return;
  if (tid == 0) counters[grp] = 0;  // ready for the next launch
  const int stride = G * (HD + 2);
  const float* p0 = part + (long long)grp * gridDim.y * stride;
  float* wt = reinterpret_cast<float*>(smem);  // [live][MAXG]: m_r, then its weight
  float* ls = wt + MAX_SPLITS * MAXG;          // [live][MAXG]: l_r
  float* tot = ls + MAX_SPLITS * MAXG;         // [MAXG]: L
  for (int j = tid; j < live * G; j += blockDim.x) {
    const int r = j / G, gi = j % G;
    wt[r * MAXG + gi] = __ldcg(p0 + r * stride + G * HD + 2 * gi);
    ls[r * MAXG + gi] = __ldcg(p0 + r * stride + G * HD + 2 * gi + 1);
  }
  __syncthreads();
  for (int gi = warp; gi < G; gi += WARPS) {
    float M = NEG;
    for (int r = lane; r < live; r += 32) M = fmaxf(M, wt[r * MAXG + gi]);
    M = warp_max(M);
    float L = 0.f;
    for (int r = lane; r < live; r += 32) {
      const float a = ex2(wt[r * MAXG + gi] - M);
      wt[r * MAXG + gi] = a;
      L += ls[r * MAXG + gi] * a;
    }
    L = warp_sum(L);
    if (lane == 0) tot[gi] = L;
  }
  __syncthreads();
  constexpr int NT = WARPS * 32, E = MAXG * HD / NT;  // elements a thread
  float O[E];
#pragma unroll
  for (int j = 0; j < E; ++j) O[j] = 0.f;
  int r = 0;
  for (; r + 4 <= live; r += 4) {
    float x[4][E];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < E; ++j)
        x[u][j] = tid + j * NT < G * HD ? __ldcg(p0 + (r + u) * stride + tid + j * NT) : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < E; ++j)
        if (tid + j * NT < G * HD) O[j] += wt[(r + u) * MAXG + (tid + j * NT) / HD] * x[u][j];
  }
  for (; r < live; ++r)
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (tid + j * NT < G * HD)
        O[j] += wt[r * MAXG + (tid + j * NT) / HD] * __ldcg(p0 + r * stride + tid + j * NT);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = tid + j * NT;
    if (i < G * HD) ob[i] = __float2bfloat16(O[j] / fmaxf(tot[i / HD], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// launch

struct Args {
  const void *q, *k, *v, *table;
  void *out, *part, *counters;
  Pos pos;
  long long t_sb;
  int B, H, KH, S, bs, P, splits;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
};

template <int HD, bool PAGED>
size_t bf16_smem(int S, int bs, int splits) {
  const int tiles = (S + TK - 1) / TK;
  const int chunk = (tiles + splits - 1) / splits * TK;
  return Bf16Layout<HD>::SMEM + (PAGED ? ((size_t)(chunk / bs + 2) * 4 + 15) / 16 * 16 : 0);
}

template <int HD, bool PAGED>
size_t f32_smem(int S, int bs) {
  return F32Layout<HD>::SMEM + (PAGED ? ((size_t)((S + bs - 1) / bs) * 4 + 15) / 16 * 16 : 0);
}

// cudaFuncSetAttribute once per kernel instance (Inst) and device, again
// only when a launch needs more dynamic shared memory than any before it on
// that device (a limit, not a reservation)
template <int HD, bool PAGED, bool BF16>
struct Inst {};

constexpr int MAX_DEVICES = 64;

template <typename I, typename F>
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

template <int HD, bool PAGED>
int launch_bf16(const Args& a, cudaStream_t st) {
  const int tiles = (a.S + TK - 1) / TK;
  if (a.splits < 1 || a.splits > tiles || a.splits > MAX_SPLITS ||
      (a.splits > 1 && (a.part == nullptr || a.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int chunk = (tiles + a.splits - 1) / a.splits * TK;
  const size_t smem = bf16_smem<HD, PAGED>(a.S, a.bs, a.splits);
  const int rc = allow_smem<Inst<HD, PAGED, true>>(decode_bf16_kernel<HD, PAGED>, smem);
  if (rc) return rc;
  decode_bf16_kernel<HD, PAGED><<<dim3(a.B * a.KH, a.splits), WARPS * 32, smem, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.pos, static_cast<const int*>(a.table), a.t_sb,
      static_cast<bf16*>(a.out), static_cast<float*>(a.part), static_cast<int*>(a.counters),
      a.H, a.KH, a.S, a.H / a.KH, a.bs, a.P, chunk, a.q_sb, a.q_sh, a.k_sb, a.k_sh, a.k_ss,
      a.v_sb, a.v_sh, a.v_ss, a.scale * 1.4426950408889634f);  // scores in log2 units
  return (int)cudaGetLastError();
}

template <int HD, bool PAGED>
int launch_f32(const Args& a, cudaStream_t st) {
  const size_t smem = f32_smem<HD, PAGED>(a.S, a.bs);
  if (a.splits != 1) return (int)cudaErrorInvalidValue;
  const int rc = allow_smem<Inst<HD, PAGED, false>>(decode_f32_kernel<HD, PAGED>, smem);
  if (rc) return rc;
  decode_f32_kernel<HD, PAGED><<<a.B * a.KH, f32_warps<HD>() * 32, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.pos, static_cast<const int*>(a.table), a.t_sb,
      static_cast<float*>(a.out), a.H, a.KH, a.S, a.H / a.KH, a.bs, a.P, a.q_sb, a.q_sh,
      a.k_sb, a.k_sh, a.k_ss, a.v_sb, a.v_sh, a.v_ss, a.scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, long long s0, long long s1, long long s2, int esize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s0 * esize) % 16 == 0 &&
         (s1 * esize) % 16 == 0 && (s2 * esize) % 16 == 0;
}

template <bool PAGED>
int launch(Args a, int hd, int dtype, cudaStream_t st) {
  if (a.B < 1 || a.KH < 1 || a.H % a.KH || a.H / a.KH > MAXG || a.S < 1 || a.bs < 1 ||
      a.P < 1 || (hd != 64 && hd != 128 && hd != 256))
    return (int)cudaErrorInvalidValue;
  // a dim of size 1 is only ever read at index 0: its stride is free
  if (!PAGED && a.B == 1) a.k_sb = a.v_sb = 0;
  if (a.B == 1) a.q_sb = 0;
  if (a.KH == 1) a.k_sh = a.v_sh = 0;
  if (a.H == 1) a.q_sh = 0;
  if (PAGED ? a.bs == 1 : a.S == 1) a.k_ss = a.v_ss = 0;
  if (PAGED && a.P == 1) a.k_sb = a.v_sb = 0;
  // K and V move in 16-byte copies; bf16 q in 4-byte pairs
  const int es = dtype == 1 ? 2 : 4;
  if (!aligned16(a.k, a.k_sb, a.k_sh, a.k_ss, es) || !aligned16(a.v, a.v_sb, a.v_sh, a.v_ss, es) ||
      (dtype == 1 && (reinterpret_cast<uintptr_t>(a.q) % 4 || a.q_sb % 2 || a.q_sh % 2)))
    return (int)cudaErrorMisalignedAddress;
  if (dtype == 1)
    return hd == 256   ? launch_bf16<256, PAGED>(a, st)
           : hd == 128 ? launch_bf16<128, PAGED>(a, st)
                       : launch_bf16<64, PAGED>(a, st);
  if (dtype == 0)
    return hd == 256   ? launch_f32<256, PAGED>(a, st)
           : hd == 128 ? launch_f32<128, PAGED>(a, st)
                       : launch_f32<64, PAGED>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <typename I, typename F>
int occupancy(F* kernel, int threads, size_t smem) {
  const int rc = allow_smem<I>(kernel, smem);
  if (rc) return -rc;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <int HD, bool PAGED>
int ctas_per_sm(int dtype, int S, int bs, int splits) {
  if (dtype == 1)
    return occupancy<Inst<HD, PAGED, true>>(decode_bf16_kernel<HD, PAGED>, WARPS * 32,
                                            bf16_smem<HD, PAGED>(S, bs, splits));
  return occupancy<Inst<HD, PAGED, false>>(decode_f32_kernel<HD, PAGED>, f32_warps<HD>() * 32,
                                           f32_smem<HD, PAGED>(S, bs));
}

Pos make_pos(const void* pos, long long pos_stride, long long pos_scalar, int pos_kind) {
  return Pos{pos_kind == 2 ? nullptr : pos, pos_stride, pos_scalar, pos_kind == 1};
}

}  // namespace

// q (B, H, hd); k, v viewed as (B, KH, S, hd) by the given element strides
// (the last dim contiguous; bases and strides 16-byte aligned); out (B, H, hd)
// contiguous. pos: pos_kind 0 = int32 array, 1 = int64 array (element
// stride pos_stride, 0 for one value for every row), 2 = the scalar
// pos_scalar (pos unused). dtype: 0 = float32 (splits must be 1),
// 1 = bfloat16: the key axis in `splits` ranges (1 <= splits <= ceil(S / 16));
// with splits > 1, part is f32 scratch of B * KH * splits * (H/KH) * (hd + 2)
// floats and counters B * KH ints, zero before the first call (the kernel
// leaves them zero). hd 64, 128 or 256, H/KH at most 8. Returns the CUDA error
// code of the launch (0 on success; cudaErrorMisalignedAddress before any
// launch for misaligned operands).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* part, void* counters,
                                       int B, int H, int KH, int S, int hd, int splits,
                                       long long q_sb, long long q_sh, long long k_sb,
                                       long long k_sh, long long k_ss, long long v_sb,
                                       long long v_sh, long long v_ss, long long pos_stride,
                                       long long pos_scalar, int pos_kind, float scale,
                                       int dtype, void* stream) {
  Args a{q, k, v, nullptr, out, part, counters, make_pos(pos, pos_stride, pos_scalar, pos_kind),
         0, B, H, KH, S, 1, 1, splits, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale};
  return launch<false>(a, hd, dtype, static_cast<cudaStream_t>(stream));
}

// q (B, H, hd); k_pool, v_pool (P, bs, KH, hd) by the given element strides
// (block, slot, head; the last dim contiguous, 16-byte aligned); table int32
// (B, nb) with row stride t_sb (its last dim contiguous); pos, out, part,
// counters, splits and dtype as above with S = nb * bs. Returns the CUDA
// error code of the launch.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table, const void* pos,
    void* out, void* part, void* counters, int B, int H, int KH, int P, int bs, int nb, int hd,
    int splits, long long q_sb, long long q_sh, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long t_sb, long long pos_stride,
    long long pos_scalar, int pos_kind, float scale, int dtype, void* stream) {
  if (nb < 1) return (int)cudaErrorInvalidValue;
  Args a{q,      k_pool, v_pool, table, out,  part, counters,
         make_pos(pos, pos_stride, pos_scalar, pos_kind),
         t_sb,   B,      H,      KH,    nb * bs, bs, P, splits,
         q_sb,   q_sh,   k_sp,   k_sh,  k_ss, v_sp, v_sh, v_ss, scale};
  return launch<true>(a, hd, dtype, static_cast<cudaStream_t>(stream));
}

// The CTAs an SM of the launch above would hold (the occupancy API, with its
// dynamic shared memory), or a negative CUDA error code.
extern "C" int decode_attention_ctas_per_sm(int dtype, int hd, int paged, int S, int bs,
                                            int splits) {
  if (splits < 1 || bs < 1 || S < 1 || (hd != 64 && hd != 128 && hd != 256) ||
      (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  if (hd == 256)
    return paged ? ctas_per_sm<256, true>(dtype, S, bs, splits)
                 : ctas_per_sm<256, false>(dtype, S, bs, splits);
  if (hd == 128)
    return paged ? ctas_per_sm<128, true>(dtype, S, bs, splits)
                 : ctas_per_sm<128, false>(dtype, S, bs, splits);
  return paged ? ctas_per_sm<64, true>(dtype, S, bs, splits)
               : ctas_per_sm<64, false>(dtype, S, bs, splits);
}
