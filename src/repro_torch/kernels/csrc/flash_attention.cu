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
// hd 128) the q, k, v bytes and the 2 * 2 * Sq * Sk * hd flop are both tiny and
// launch latency dominates; on long prompts the flop grow as Sq * Sk and the
// operations bound it (~4 * hd flop per score against a few bytes). The
// design, simple and right first:
//   * one CTA per (query tile of 64, head, batch row); key tiles of 64 stream
//     through shared memory in f32 (K transposed, rows padded by one float, so
//     that lane j reading key j hits its own bank);
//   * warp w owns query rows 8w..8w+7: lane j scores keys j and j + 32 of the
//     tile (register-blocked: per d, 8 broadcast q reads and 2 k reads feed
//     16 FMAs), the row's max and sum come from warp shuffles, and the
//     probabilities pass to the p.v product through shared memory; lane c owns
//     output columns c, c + 32, .. of its warp's rows;
//   * a causal or windowed tile range skips the key tiles that every query of
//     the tile masks; their skipped p would be 0 and their alpha 1.
// Not done yet: the tensor cores (mma.sync / wgmma) for both products, bf16
// tiles in shared memory, and keeping K/V loads in flight (cp.async or TMA).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads
constexpr int NW = NT / 32;    // warps
constexpr int BQ = 64;         // queries per CTA
constexpr int BK = 64;         // keys per tile: two per lane
constexpr int RW = BQ / NW;    // query rows a warp owns
constexpr int MAXHD = 128;     // four output columns a lane
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

__device__ __forceinline__ bool visible(int qi, int kj, int Sk, int causal, int window) {
  return kj < Sk && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H, int KH, int Sq,
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
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int e = tid; e < BQ * hd; e += NT) {
    const int i = e / hd, d = e % hd;
    Qs[e] = q0 + i < Sq ? to_f(qb[(q0 + i) * q_ss + d]) : 0.f;
  }
  // the keys any query of this tile can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[RW], l[RW], acc[RW][4];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  for (int kt = k_lo / BK; kt * BK <= k_hi; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // the previous tile's K and V reads are done
    for (int e = tid; e < BK * hd; e += NT) {
      const int j = e / hd, d = e % hd;
      const bool ok = j0 + j < Sk;
      Kt[d * (BK + 1) + j] = ok ? to_f(kb[(j0 + j) * k_ss + d]) : 0.f;
      Vs[j * hd + d] = ok ? to_f(vb[(j0 + j) * v_ss + d]) : 0.f;  // zero past Sk
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
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
      Ps[i * BK + lane] = p0;
      Ps[i * BK + lane + 32] = p1;
    }
    __syncwarp();  // a warp reads back only its own rows of P
    const int nj = min(BK, Sk - j0);
    for (int j = 0; j < nj; ++j) {
      float vj[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < hd ? Vs[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float p = Ps[(warp * RW + r) * BK + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += p * vj[c];
      }
    }
  }

  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = q0 + warp * RW + r;
    if (i >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) ob[i * o_ss + d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block can use

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KH,
           int Sq, int Sk, int hd, long long q_sb, long long q_sh, long long q_ss,
           long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
           long long v_ss, long long o_sb, long long o_sh, long long o_ss, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t bytes = (size_t)Layout(hd).total * sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
      v_ss, o_sb, o_sh, o_ss, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KH, Sk, hd), out (B, H, Sq, hd), one dtype, each
// by its element strides (batch, head, position; the last dim contiguous).
// causal: 0 or 1; window <= 0: none. dtype: 0 = float32, 1 = bfloat16.
// hd <= 128, H a multiple of KH. Returns the CUDA error code of the launch.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb,
                                 k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal,
                                 window, st);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, KH, Sq, Sk, hd, q_sb, q_sh, q_ss, k_sb, k_sh,
                         k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
