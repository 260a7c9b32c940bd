// Mamba2 SSD chunk scan (state-space duality, arXiv:2405.21060), written by
// hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd/kernel.py : ssd_chunked (Pallas, TPU). Same
// semantics, one group (B and C shared by every head): for each (batch, head)
// the sequence is cut into chunks of CK = 64 steps; inside a chunk, with
// cum = the inclusive cumsum of dt * A,
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) (x_j dt_j)
//        + exp(cum_i) (C_i . state_in[p, :])            for every p
//   state_out = exp(cum_last) state_in + sum_j exp(cum_last - cum_j) (x_j dt_j) (x) B_j
// all in f32, the (hp, N) state carried from chunk to chunk; the state starts
// at zero. Outputs y (B, H, S, hp) and the final state (B, H, hp, N), f32.
//
// What bounds it on an H100: per (batch, head) and chunk the three products
// are ~2.9 M flop at hp 64, N 128, against ~50 KB of inputs: ~60 flop per
// byte, below the ~295 flop per byte where the tensor cores become the limit,
// so the bound is bytes. What sets a launch's time, though, is each CTA's
// chain of chunks, walked in order. The design:
//   * the grid is (H, B, hp / 32): rows p of the state and columns p of y
//     depend on the chunk's masked scores G = (C B^T) . L, which every CTA
//     recomputes, and on nothing else of the other columns, so a CTA takes a
//     32-wide slice of the head dim and needs no other CTA (160 CTAs at
//     Mamba2-2.7B's 80 heads, batch 1). The loop over chunks inside the
//     block takes the place of the Pallas grid's sequential chunk axis;
//   * a sequence that is not a multiple of CK is staged with x = dt = B = C = 0
//     past its end: such a step leaves cum and the state unchanged, and its
//     outputs are not written, so no caller pads.
// bf16 (the served model): the three products on the tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 out), 4 warps, warp w owning chunk rows
// 16w..16w+15. x, B and C arrive in bf16, so they are exact operands; each
// f32 factor is folded into the other operand and split into a bf16 hi and
// lo part (~2^-17 relative to the factor), each a product of its own:
//   * G = C B^T: both exact, one product; G . exp(cum_i - cum_j) dt_j is
//     formed on the accumulator fragments and, split hi + lo, becomes the
//     A operand of y_diag = G' x directly;
//   * y_off = exp(cum_i) (C state^T): C's A fragments serve G too; the f32
//     state is kept as bf16 hi + lo in shared memory for this product;
//   * state^T = exp(cum_last) state^T + (B . exp(cum_last - cum) dt)^T x: B
//     reaches A fragments through ldmatrix.trans and is scaled and split in
//     registers; the f32 state itself lives in the accumulators for the
//     whole walk.
//   C, B, x and dt of the next chunk stream in (cp.async, two stages) while
//   this one is computed; ~100 KB of shared memory, two CTAs an SM.
// float32 (the tiny configs and the card tests' exact path) stays on the
// CUDA cores (bf16 or TF32 products would not hold 1e-4), on the same grid:
// each chunk stages C, B (f32, B's rows padded by one float so that lanes
// reading different rows hit distinct banks) and x * dt, one warp forms cum
// with a shuffle scan, warp w owns rows 8w..8w+7 of each product (rows
// w + 8r of the state update) and lanes own columns.
// Not done yet: the chunk axis across CTAs (an ordered look-back), for
// shapes with fewer than one wave of (head, batch, slice) CTAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CK = 64;          // chunk length
constexpr int HS = 32;          // head-dim slice a CTA
constexpr int MAXHP = 64;       // head dim
constexpr int MAXN = 128;       // state dim
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// global -> shared copies that bypass registers (cp.async): 16 bytes, or 4;
// the source's first `src_bytes` are read, the rest written as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// bfloat16: the three products on the tensor cores (mma.sync)

using bf16 = __nv_bfloat16;
constexpr int BNT = 128;        // threads: 4 warps
constexpr int NP = MAXN + 8;    // a staged C or B row, in bf16 (padded by 16 bytes)
constexpr int XP = HS + 8;      // a staged x row
constexpr int TP = HS + 8;      // a state^T row [n][p]

// Dynamic shared memory of a bf16 CTA, in bytes: two stages of (C, B, x,
// dt), then the entering state^T as bf16 hi and lo, then the chunk's vectors.
constexpr size_t OFF_C = 0;
constexpr size_t OFF_B = OFF_C + CK * NP * sizeof(bf16);
constexpr size_t OFF_X = OFF_B + CK * NP * sizeof(bf16);
constexpr size_t OFF_DT = OFF_X + CK * XP * sizeof(bf16);
constexpr size_t STAGE = OFF_DT + CK * sizeof(float);
constexpr size_t OFF_HI = 2 * STAGE;
constexpr size_t OFF_LO = OFF_HI + MAXN * TP * sizeof(bf16);
constexpr size_t OFF_VEC = OFF_LO + MAXN * TP * sizeof(bf16);  // cum2, ecum, f [CK] f32
constexpr size_t BF16_SMEM = OFF_VEC + 3 * CK * sizeof(float);
static_assert(STAGE % 16 == 0 && OFF_X % 16 == 0 && OFF_DT % 16 == 0, "16-byte copies");

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
// (u, v) as bf16 hi + lo parts, each a packed pair: u - hi is exact in f32,
// so hi + lo is within ~2^-17 of (u, v) relative
__device__ __forceinline__ void split_bf16(float u, float v, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(u - __low2float(h), v - __high2float(h));
}
// a packed bf16 pair scaled by (fu, fv) in f32, then split
__device__ __forceinline__ void scale_split(unsigned pair, float fu, float fv, unsigned& hi,
                                            unsigned& lo) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&pair);
  split_bf16(__low2float(p) * fu, __high2float(p) * fv, hi, lo);
}

// Grid (H, B, slices); CTA (h, b, k) owns head dim p in [32k, 32k + 32).
// vec: x, B and C rows are 16-byte aligned with hp and N multiples of 8, so
// they stream through 16-byte cp.async copies (TMA bulk copies of these
// 64- and 256-byte rows measured slower on an H100); otherwise they are
// staged element by element. dt goes by 4-byte cp.async either way.
__global__ void __launch_bounds__(BNT, 2)
ssd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, float* __restrict__ y, float* __restrict__ state,
                int H, int S, int hp, int N, long long x_sb, long long x_sh, long long x_ss,
                long long d_sb, long long d_sh, long long d_ss, long long b_sb, long long b_ss,
                long long c_sb, long long c_ss, long long y_sb, long long y_sh, long long y_ss,
                int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * HS;
  const int hs = min(HS, hp - p0);  // the slice's columns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;
  const float a2 = A[h] * LOG2E;  // cum in log2 units
  const bf16* xb = x + b * x_sb + h * x_sh + p0;
  const float* db = dt + b * d_sb + h * d_sh;
  const bf16* bb = Bm + b * b_sb;
  const bf16* cb = Cm + b * c_sb;
  bf16* st_hi = reinterpret_cast<bf16*>(smem + OFF_HI);  // [MAXN][TP]: state^T, entering
  bf16* st_lo = reinterpret_cast<bf16*>(smem + OFF_LO);
  float* cum2 = reinterpret_cast<float*>(smem + OFF_VEC);  // [CK]
  float* ecum = cum2 + CK;                                 // exp(cum_i)
  float* fw = ecum + CK;                                   // exp(cum_last - cum_j) dt_j

  // chunk c into stage st: rows past S and columns past N or the slice are zeros
  auto stage = [&](int c, int st) {
    unsigned char* base = smem + st * STAGE;
    bf16* Cs = reinterpret_cast<bf16*>(base + OFF_C);
    bf16* Bs = reinterpret_cast<bf16*>(base + OFF_B);
    bf16* Xs = reinterpret_cast<bf16*>(base + OFF_X);
    const int t0 = c * CK;
    if (vec) {
      for (int i = tid; i < CK * (MAXN / 8); i += BNT) {
        const int row = i / (MAXN / 8), cc = (i % (MAXN / 8)) * 8, t = t0 + row;
        const bool ok = t < S && cc < N;
        cp_async16(Cs + row * NP + cc, ok ? cb + t * c_ss + cc : cb, ok ? 16 : 0);
        cp_async16(Bs + row * NP + cc, ok ? bb + t * b_ss + cc : bb, ok ? 16 : 0);
      }
      for (int i = tid; i < CK * (HS / 8); i += BNT) {
        const int row = i / (HS / 8), cc = (i % (HS / 8)) * 8, t = t0 + row;
        const bool ok = t < S && cc < hs;
        cp_async16(Xs + row * XP + cc, ok ? xb + t * x_ss + cc : xb, ok ? 16 : 0);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < CK * MAXN; i += BNT) {
        const int row = i / MAXN, n = i % MAXN, t = t0 + row;
        const bool ok = t < S && n < N;
        Cs[row * NP + n] = ok ? cb[t * c_ss + n] : zero;
        Bs[row * NP + n] = ok ? bb[t * b_ss + n] : zero;
      }
      for (int i = tid; i < CK * HS; i += BNT) {
        const int row = i / HS, p = i % HS, t = t0 + row;
        Xs[row * XP + p] = t < S && p < hs ? xb[t * x_ss + p] : zero;
      }
    }
    if (tid < CK) {
      const int t = t0 + tid;
      cp_async4(reinterpret_cast<float*>(base + OFF_DT) + tid, t < S ? db + t * d_ss : db,
                t < S ? 4 : 0);
    }
    cp_async_commit();
  };

  // state^T[n][p] of the slice, in accumulator fragments: rows n = 32 warp +
  // 16 mb + g (+ 8), columns p = 8 nb + c2 (+ 1)
  float sacc[2][HS / 8][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < HS / 8; ++nb) sacc[mb][nb][0] = sacc[mb][nb][1] = sacc[mb][nb][2] = sacc[mb][nb][3] = 0.f;
  const int i0 = 16 * warp + g, i1 = i0 + 8;  // this thread's chunk rows in G and y

  const int n_chunks = (S + CK - 1) / CK;
  stage(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * CK;
    cp_async_wait0();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c + 1 < n_chunks) stage(c + 1, (c + 1) & 1);
    const unsigned char* base = smem + (c & 1) * STAGE;
    const bf16* Cs = reinterpret_cast<const bf16*>(base + OFF_C);
    const bf16* Bs = reinterpret_cast<const bf16*>(base + OFF_B);
    const bf16* Xs = reinterpret_cast<const bf16*>(base + OFF_X);
    const float* Ds = reinterpret_cast<const float*>(base + OFF_DT);

    if (warp == 0) {  // inclusive cumsum of dt * A: lane l holds steps l and l + 32
      float s0 = Ds[lane] * a2, s1 = Ds[lane + 32] * a2;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, s0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, s1, o);
        if (lane >= o) {
          s0 += u0;
          s1 += u1;
        }
      }
      s1 += __shfl_sync(0xffffffffu, s0, 31);
      const float last = __shfl_sync(0xffffffffu, s1, 31);
      cum2[lane] = s0;
      cum2[lane + 32] = s1;
      ecum[lane] = exp2f(s0);
      ecum[lane + 32] = exp2f(s1);
      fw[lane] = exp2f(last - s0) * Ds[lane];
      fw[lane + 32] = exp2f(last - s1) * Ds[lane + 32];
    }

    // G = C B^T for rows i in [16 warp, 16 warp + 16), keys j <= i: C's A
    // fragments (kept for y_off), B through ldmatrix as the col operand
    unsigned ca[MAXN / 16][4];
#pragma unroll
    for (int kk = 0; kk < MAXN / 16; ++kk)
      ldsm_x4(ca[kk], Cs + (16 * warp + (mi & 1) * 8 + (lane & 7)) * NP + kk * 16 + (mi >> 1) * 8);
    float gacc[CK / 8][4];
#pragma unroll
    for (int jb = 0; jb < CK / 8; ++jb) gacc[jb][0] = gacc[jb][1] = gacc[jb][2] = gacc[jb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAXN / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < CK / 16; ++jp)
        if (jp <= warp) {
          unsigned kf[4];
          ldsm_x4(kf, Bs + (16 * jp + (mi >> 1) * 8 + (lane & 7)) * NP + kk * 16 + (mi & 1) * 8);
          mma_bf16(gacc[2 * jp], ca[kk], kf[0], kf[1]);
          mma_bf16(gacc[2 * jp + 1], ca[kk], kf[2], kf[3]);
        }
    __syncthreads();  // cum2, ecum, fw

    // y = exp(cum_i) (C state_in^T) + G' x: the state^T hi and lo parts
    // through ldmatrix.trans (n rows 0-7 / 8-15 x two 8-column blocks of p)
    float yacc[HS / 8][4];
#pragma unroll
    for (int nb = 0; nb < HS / 8; ++nb) yacc[nb][0] = yacc[nb][1] = yacc[nb][2] = yacc[nb][3] = 0.f;
    if (c > 0) {  // the state entering chunk 0 is zero
#pragma unroll
      for (int kk = 0; kk < MAXN / 16; ++kk)
#pragma unroll
        for (int pp = 0; pp < HS / 16; ++pp) {
          const int off = (kk * 16 + (mi & 1) * 8 + (lane & 7)) * TP + (2 * pp + (mi >> 1)) * 8;
          unsigned hf[4], lf[4];
          ldsm_x4_t(hf, st_hi + off);
          ldsm_x4_t(lf, st_lo + off);
          mma_bf16(yacc[2 * pp], ca[kk], hf[0], hf[1]);
          mma_bf16(yacc[2 * pp + 1], ca[kk], hf[2], hf[3]);
          mma_bf16(yacc[2 * pp], ca[kk], lf[0], lf[1]);
          mma_bf16(yacc[2 * pp + 1], ca[kk], lf[2], lf[3]);
        }
      const float e0 = ecum[i0], e1 = ecum[i1];
#pragma unroll
      for (int nb = 0; nb < HS / 8; ++nb) {
        yacc[nb][0] *= e0;
        yacc[nb][1] *= e0;
        yacc[nb][2] *= e1;
        yacc[nb][3] *= e1;
      }
    }
    // G' = G exp(cum_i - cum_j) dt_j for j <= i (else 0, never the overflowing
    // exp), split hi + lo: the accumulators of key blocks 2kk and 2kk + 1 are
    // the A fragment of k-step kk
    unsigned gh[CK / 16][4], gl[CK / 16][4];
    {
      const float ci0 = cum2[i0], ci1 = cum2[i1];
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        if (kk <= warp) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int jb = 2 * kk + half, j = 8 * jb + c2;
            const float* a = gacc[jb];
            const float w0 = exp2f(ci0 - cum2[j]) * Ds[j];
            const float w1 = exp2f(ci0 - cum2[j + 1]) * Ds[j + 1];
            const float w2 = exp2f(ci1 - cum2[j]) * Ds[j];
            const float w3 = exp2f(ci1 - cum2[j + 1]) * Ds[j + 1];
            split_bf16(j <= i0 ? a[0] * w0 : 0.f, j + 1 <= i0 ? a[1] * w1 : 0.f,
                       gh[kk][half * 2], gl[kk][half * 2]);
            split_bf16(j <= i1 ? a[2] * w2 : 0.f, j + 1 <= i1 ? a[3] * w3 : 0.f,
                       gh[kk][half * 2 + 1], gl[kk][half * 2 + 1]);
          }
        }
      }
    }
    // x as the col operand (k = j, n = p) through ldmatrix.trans: y_diag's
    // and the state update's
    unsigned xf[CK / 16][HS / 16][4];
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk)
#pragma unroll
      for (int pp = 0; pp < HS / 16; ++pp)
        ldsm_x4_t(xf[kk][pp],
                  Xs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * XP + (2 * pp + (mi >> 1)) * 8);
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk)
      if (kk <= warp)
#pragma unroll
        for (int pp = 0; pp < HS / 16; ++pp) {
          mma_bf16(yacc[2 * pp], gh[kk], xf[kk][pp][0], xf[kk][pp][1]);
          mma_bf16(yacc[2 * pp + 1], gh[kk], xf[kk][pp][2], xf[kk][pp][3]);
          mma_bf16(yacc[2 * pp], gl[kk], xf[kk][pp][0], xf[kk][pp][1]);
          mma_bf16(yacc[2 * pp + 1], gl[kk], xf[kk][pp][2], xf[kk][pp][3]);
        }
    {
      float* yb = y + b * y_sb + h * y_sh + p0;
#pragma unroll
      for (int nb = 0; nb < HS / 8; ++nb) {
        const int p = 8 * nb + c2;
        if (t0 + i0 < S) {
          float* yr = yb + (long long)(t0 + i0) * y_ss;
          if (p < hs) yr[p] = yacc[nb][0];
          if (p + 1 < hs) yr[p + 1] = yacc[nb][1];
        }
        if (t0 + i1 < S) {
          float* yr = yb + (long long)(t0 + i1) * y_ss;
          if (p < hs) yr[p] = yacc[nb][2];
          if (p + 1 < hs) yr[p + 1] = yacc[nb][3];
        }
      }
    }

    // state^T = exp(cum_last) state^T + (B . f)^T x over rows n of the warp:
    // B^T's A fragments through ldmatrix.trans (matrices n 0-7 / 8-15 x j
    // 0-7 / 8-15), each pair scaled by f_j and split hi + lo
    {
      const float el = ecum[CK - 1];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < HS / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[mb][nb][e] *= el;
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        const int j = 16 * kk + c2;
        const float f0 = fw[j], f1 = fw[j + 1], f8 = fw[j + 8], f9 = fw[j + 9];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          unsigned bt[4], ah[4], al[4];
          ldsm_x4_t(bt, Bs + (16 * kk + (mi >> 1) * 8 + (lane & 7)) * NP + 32 * warp + 16 * mb +
                            (mi & 1) * 8);
          scale_split(bt[0], f0, f1, ah[0], al[0]);
          scale_split(bt[1], f0, f1, ah[1], al[1]);
          scale_split(bt[2], f8, f9, ah[2], al[2]);
          scale_split(bt[3], f8, f9, ah[3], al[3]);
#pragma unroll
          for (int pp = 0; pp < HS / 16; ++pp) {
            mma_bf16(sacc[mb][2 * pp], ah, xf[kk][pp][0], xf[kk][pp][1]);
            mma_bf16(sacc[mb][2 * pp + 1], ah, xf[kk][pp][2], xf[kk][pp][3]);
            mma_bf16(sacc[mb][2 * pp], al, xf[kk][pp][0], xf[kk][pp][1]);
            mma_bf16(sacc[mb][2 * pp + 1], al, xf[kk][pp][2], xf[kk][pp][3]);
          }
        }
      }
    }
    if (c + 1 < n_chunks) {
      __syncthreads();  // every warp's y_off has read the entering state
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < HS / 8; ++nb) {
          const int n = 32 * warp + 16 * mb + g, p = 8 * nb + c2;
          unsigned hi, lo;
          split_bf16(sacc[mb][nb][0], sacc[mb][nb][1], hi, lo);
          *reinterpret_cast<unsigned*>(st_hi + n * TP + p) = hi;
          *reinterpret_cast<unsigned*>(st_lo + n * TP + p) = lo;
          split_bf16(sacc[mb][nb][2], sacc[mb][nb][3], hi, lo);
          *reinterpret_cast<unsigned*>(st_hi + (n + 8) * TP + p) = hi;
          *reinterpret_cast<unsigned*>(st_lo + (n + 8) * TP + p) = lo;
        }
    }
  }

  float* so = state + ((long long)b * H + h) * hp * N + (long long)p0 * N;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < HS / 8; ++nb) {
      const int n = 32 * warp + 16 * mb + g, p = 8 * nb + c2;
      if (n < N) {
        if (p < hs) so[p * N + n] = sacc[mb][nb][0];
        if (p + 1 < hs) so[(p + 1) * N + n] = sacc[mb][nb][1];
      }
      if (n + 8 < N) {
        if (p < hs) so[p * N + n + 8] = sacc[mb][nb][2];
        if (p + 1 < hs) so[(p + 1) * N + n + 8] = sacc[mb][nb][3];
      }
    }
}

// ---------------------------------------------------------------------------
// float32: on the CUDA cores, the same grid

constexpr int FNT = 256;        // threads
constexpr int NW = FNT / 32;    // warps
constexpr int RW = CK / NW;     // chunk rows a warp owns

// Shared memory of an f32 CTA, in floats from its start.
struct F32Layout {
  int st, bs, cs, xs, gs, cum, ecum, wdec, total;
  __host__ __device__ F32Layout(int N) {
    st = 0;                        // state [HS][N + 1]
    bs = st + HS * (N + 1);        // B     [CK][N + 1]
    cs = bs + CK * (N + 1);        // C     [CK][N]
    xs = cs + CK * N;              // x*dt  [CK][HS]
    gs = xs + CK * HS;             // G     [CK][CK]
    cum = gs + CK * CK;            // cum   [CK]
    ecum = cum + CK;               // exp(cum)
    wdec = ecum + CK;              // exp(cum_last - cum)
    total = wdec + CK;
  }
};

__global__ void __launch_bounds__(FNT)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y, float* __restrict__ state,
               int H, int S, int hp, int N, long long x_sb, long long x_sh, long long x_ss,
               long long d_sb, long long d_sh, long long d_ss, long long b_sb, long long b_ss,
               long long c_sb, long long c_ss, long long y_sb, long long y_sh, long long y_ss) {
  extern __shared__ __align__(16) float sm[];
  const F32Layout lt(N);
  float* St = sm + lt.st;
  float* Bs = sm + lt.bs;
  float* Cs = sm + lt.cs;
  float* Xs = sm + lt.xs;
  float* Gs = sm + lt.gs;
  float* cum = sm + lt.cum;
  float* ecum = sm + lt.ecum;
  float* wdec = sm + lt.wdec;
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * HS;
  const int hs = min(HS, hp - p0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int NP1 = N + 1;
  const float a_h = A[h];
  const float* xb = x + b * x_sb + h * x_sh + p0;
  const float* db = dt + b * d_sb + h * d_sh;
  const float* bb = Bm + b * b_sb;
  const float* cb = Cm + b * c_sb;

  for (int e = tid; e < HS * NP1; e += FNT) St[e] = 0.f;

  const int n_chunks = (S + CK - 1) / CK;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * CK;
    // -- stage the chunk: zeros past the sequence's end and the slice
    for (int e = tid; e < CK * N; e += FNT) {
      const int i = e / N, n = e % N, t = t0 + i;
      const bool ok = t < S;
      Bs[i * NP1 + n] = ok ? bb[t * b_ss + n] : 0.f;
      Cs[i * N + n] = ok ? cb[t * c_ss + n] : 0.f;
    }
    for (int e = tid; e < CK * HS; e += FNT) {
      const int i = e / HS, p = e % HS, t = t0 + i;
      Xs[i * HS + p] = t < S && p < hs ? xb[t * x_ss + p] * db[t * d_ss] : 0.f;
    }
    if (warp == 0) {  // inclusive cumsum of dt * A: lane l holds steps l and l + 32
      const int ta = t0 + lane, tb = t0 + lane + 32;
      float a0 = ta < S ? db[ta * d_ss] * a_h : 0.f;
      float a1 = tb < S ? db[tb * d_ss] * a_h : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, a0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, a1, o);
        if (lane >= o) {
          a0 += u0;
          a1 += u1;
        }
      }
      a1 += __shfl_sync(0xffffffffu, a0, 31);
      cum[lane] = a0;
      cum[lane + 32] = a1;
      const float last = __shfl_sync(0xffffffffu, a1, 31);
      ecum[lane] = expf(a0);
      ecum[lane + 32] = expf(a1);
      wdec[lane] = expf(last - a0);
      wdec[lane + 32] = expf(last - a1);
    }
    __syncthreads();

    // Each product is register-blocked: a thread keeps its RW rows x its
    // columns in registers and, per step of the contraction, reads RW
    // broadcast values of its warp's rows and one value per column.
    const int i0 = warp * RW;
    // -- G[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
    {
      float g[RW][2];
#pragma unroll
      for (int r = 0; r < RW; ++r) g[r][0] = g[r][1] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float b0 = Bs[lane * NP1 + n], b1 = Bs[(lane + 32) * NP1 + n];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float cv = Cs[(i0 + r) * N + n];
          g[r][0] += cv * b0;
          g[r][1] += cv * b1;
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = i0 + r;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = lane + 32 * cc;
          Gs[i * CK + j] = j <= i ? g[r][cc] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // -- y[i][p] = sum_{j <= i} G[i][j] xdt[j][p] + exp(cum_i) C_i . state[p];
    // lane p of the slice
    {
      const bool ok = lane < hs;
      float acc[RW], inter[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) acc[r] = inter[r] = 0.f;
      for (int j = 0; j < i0 + RW; ++j) {  // G is 0 past each row's diagonal
        const float xv = Xs[j * HS + lane];
#pragma unroll
        for (int r = 0; r < RW; ++r) acc[r] += Gs[(i0 + r) * CK + j] * xv;
      }
      for (int n = 0; n < N; ++n) {
        const float sv = St[lane * NP1 + n];
#pragma unroll
        for (int r = 0; r < RW; ++r) inter[r] += Cs[(i0 + r) * N + n] * sv;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = i0 + r, t = t0 + i;
        if (t < S && ok) y[b * y_sb + h * y_sh + t * y_ss + p0 + lane] = acc[r] + ecum[i] * inter[r];
      }
    }
    __syncthreads();  // every read of the entering state is done

    // -- state[p][n] = exp(cum_last) state[p][n] + sum_j wdec_j xdt[j][p] B[j][n];
    // warp w owns rows p = w + NW r, lane columns n = lane + 32 cn
    {
      constexpr int RP = HS / NW;
      const float e_last = ecum[CK - 1];
      float acc[RP][4];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int p = warp + NW * r;
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const int n = lane + 32 * cn;
          acc[r][cn] = n < N ? St[p * NP1 + n] * e_last : 0.f;
        }
      }
      for (int j = 0; j < CK; ++j) {
        const float w = wdec[j];
        float bn[4];
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const int n = lane + 32 * cn;
          bn[cn] = n < N ? Bs[j * NP1 + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float xw = Xs[j * HS + warp + NW * r] * w;
#pragma unroll
          for (int cn = 0; cn < 4; ++cn) acc[r][cn] += xw * bn[cn];
        }
      }
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int p = warp + NW * r;
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const int n = lane + 32 * cn;
          if (n < N) St[p * NP1 + n] = acc[r][cn];
        }
      }
    }
    __syncthreads();  // the next chunk's staging overwrites B, C and x*dt
  }

  float* so = state + ((long long)b * H + h) * hp * N + (long long)p0 * N;
  for (int e = tid; e < hs * N; e += FNT) so[e] = St[(e / N) * NP1 + e % N];
}

// ---------------------------------------------------------------------------
// launch

constexpr int MAX_DEVICES = 64;

// cudaFuncSetAttribute once per kernel and device (a limit, not a reservation)
template <int KIND, typename F>
int allow_smem(F* kernel, size_t smem) {
  static size_t allowed[MAX_DEVICES] = {};  // 0: not asked yet on that device
  if (smem <= (48 << 10)) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && smem <= allowed[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = smem;
  return (int)e;
}

size_t f32_smem(int N) { return (size_t)F32Layout(N).total * sizeof(float); }

bool aligned16(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s0 * 2) % 16 == 0 && (s1 * 2) % 16 == 0 &&
         (s2 * 2) % 16 == 0;
}

}  // namespace

// x (B, H, S, hp), Bm and Cm (B, S, N) of one dtype, by the given element
// strides (the last dim contiguous); dt (B, H, S) float32 by its strides; A
// (H,) float32 contiguous; y (B, H, S, hp) float32 by its strides; state
// (B, H, hp, N) float32 contiguous. dtype: 0 = float32, 1 = bfloat16.
// hp <= 64, N <= 128, S >= 1. The grid is (H, B, ceil(hp / 32)). Returns the
// CUDA error code of the launch.
extern "C" int ssd_chunked_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, void* y, void* state, int B, int H, int S,
                                  int hp, int N, long long x_sb, long long x_sh, long long x_ss,
                                  long long d_sb, long long d_sh, long long d_ss,
                                  long long b_sb, long long b_ss, long long c_sb,
                                  long long c_ss, long long y_sb, long long y_sh,
                                  long long y_ss, int dtype, void* stream) {
  if (B < 1 || H < 1 || B > 65535 || S < 1 || hp < 1 || hp > MAXHP || N < 1 || N > MAXN)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, (hp + HS - 1) / HS);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int rc = allow_smem<1>(ssd_bf16_kernel, BF16_SMEM);
    if (rc) return rc;
    const int vec = hp % 8 == 0 && N % 8 == 0 && aligned16(x, x_sb, x_sh, x_ss) &&
                    aligned16(Bm, b_sb, b_ss, 0) && aligned16(Cm, c_sb, c_ss, 0);
    ssd_bf16_kernel<<<grid, BNT, BF16_SMEM, st>>>(
        static_cast<const bf16*>(x), d, a, static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), yo, so, H, S, hp, N, x_sb, x_sh, x_ss, d_sb, d_sh, d_ss,
        b_sb, b_ss, c_sb, c_ss, y_sb, y_sh, y_ss, vec);
  } else if (dtype == 0) {
    const size_t smem = f32_smem(N);
    const int rc = allow_smem<0>(ssd_f32_kernel, smem);
    if (rc) return rc;
    ssd_f32_kernel<<<grid, FNT, smem, st>>>(
        static_cast<const float*>(x), d, a, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), yo, so, H, S, hp, N, x_sb, x_sh, x_ss, d_sb, d_sh, d_ss,
        b_sb, b_ss, c_sb, c_ss, y_sb, y_sh, y_ss);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The CTAs an SM of the launch above would hold (the occupancy API, with its
// dynamic shared memory), or a negative CUDA error code.
extern "C" int ssd_chunked_ctas_per_sm(int dtype, int N) {
  if (N < 1 || N > MAXN) return -(int)cudaErrorInvalidValue;
  int rc, n = 0;
  if (dtype == 1) {
    rc = allow_smem<1>(ssd_bf16_kernel, BF16_SMEM);
    if (!rc) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_bf16_kernel, BNT, BF16_SMEM);
  } else if (dtype == 0) {
    rc = allow_smem<0>(ssd_f32_kernel, f32_smem(N));
    if (!rc) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_f32_kernel, FNT, f32_smem(N));
  } else {
    return -(int)cudaErrorInvalidValue;
  }
  return rc ? -rc : n;
}
