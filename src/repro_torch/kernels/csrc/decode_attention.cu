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
// therefore reads each K/V byte once:
//   * one CTA per (row, KV head); each K/V tile is loaded once into shared
//     memory and serves all G query heads that share it;
//   * the cache is read in its (B, S, KH, hd) storage layout by stride, so
//     the caller's (B, KH, S, hd) view costs no transpose copy;
//   * keys are walked only up to min(pos, S-1): a short row reads only its
//     own history, never the padded tail of the cache;
//   * tiles move global -> shared with cp.async, all of a tile's 16-byte
//     copies in flight at once, and (bf16) the next tile streams in while
//     the current one is used.
// Within a CTA, 4 warps take interleaved 32-key tiles: lane j scores key j
// for all G heads (K rows padded by 16 bytes in shared memory so the 32
// lanes' row reads hit distinct banks), the warp keeps its own online
// softmax state, and the warps' (m, l, acc) are combined at the end.
// The paged form is a second instantiation of the same kernel: only the
// address of a key row differs. Contiguous: k + b*sb + kh*sh + key*ss.
// Paged, over a (P, bs, KH, hd) pool and a per-row block table:
// pool + table[b, key/bs]*sblk + (key%bs)*ss + kh*sh. The CTA loads the
// table entries its walk needs into shared memory once; the walk is
// clamped to min(pos, nb*bs-1), so a stale pos past the table reads
// nothing out of range, and entries are clamped into [0, P) so a bad id
// cannot address outside the pool. Same key order, same arithmetic: on
// the same keys the paged output is bit-identical to the contiguous one.
// Any block size works, including one that does not divide the 32-key
// tile (a tile then spans several blocks).
// Not done yet: splitting the key axis across CTAs when B*KH is too small
// to fill the 132 SMs, and TMA bulk copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int TILE = 32;   // keys per warp tile: one per lane when scoring
constexpr int MAXG = 8;    // query heads per KV head
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte global -> shared copy that bypasses registers (cp.async); with
// valid == false it reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

template <typename T, int HD>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte chunk
  static constexpr int CPR = HD / VEC;         // chunks per row
  static constexpr int KPAD = HD + VEC;        // padded K row, in elements
  static constexpr int EPL = HD / 32;          // output dims owned by a lane
  static constexpr size_t Q_BYTES = MAXG * HD * sizeof(float);
  static constexpr size_t K_BYTES = TILE * KPAD * sizeof(T);
  static constexpr size_t V_BYTES = TILE * HD * sizeof(T);
  static constexpr size_t P_BYTES = MAXG * TILE * sizeof(float);
  // bf16 tiles are double-buffered (the next tile streams in while this one
  // is used); f32 tiles are twice the size and single-buffered
  static constexpr int NBUF = sizeof(T) == 2 ? 2 : 1;
  static constexpr size_t KV_BYTES = K_BYTES + V_BYTES;
  static constexpr size_t WARP_BYTES = NBUF * KV_BYTES + P_BYTES;
  static constexpr size_t COMB_BYTES = WARPS * MAXG * (HD + 2) * sizeof(float);
  static constexpr size_t SMEM = Q_BYTES + (WARPS * WARP_BYTES > COMB_BYTES
                                                ? WARPS * WARP_BYTES : COMB_BYTES);
};

// PAGED == false: k, v are (B, KH, S, hd) by the strides (sb, sh, ss).
// PAGED == true: k, v are (P, bs, KH, hd) pools by the strides (sb = block,
// ss = slot, sh = head), table is int32 (B, nb) and S = nb * bs.
template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        const int* __restrict__ table, T* __restrict__ out, int H,
                        int KH, int S, int G, int bs, int nb, int P,
                        long long q_sb, long long q_sh,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss, float scale) {
  using Lt = Layout<T, HD>;
  constexpr int VEC = Lt::VEC, CPR = Lt::CPR, KPAD = Lt::KPAD, EPL = Lt::EPL;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  int* tab = reinterpret_cast<int*>(smem + Lt::SMEM);  // PAGED: this row's block ids
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* wsm = smem + Lt::Q_BYTES + warp * Lt::WARP_BYTES;
  float* ps = reinterpret_cast<float*>(wsm + Lt::NBUF * Lt::KV_BYTES);

  const int p = pos[b];
  const int nk = p < 0 ? 0 : min(p, S - 1) + 1;  // keys with kpos <= pos, kpos < S

  for (int i = tid; i < G * HD; i += blockDim.x) {
    const int g = i / HD, e = i % HD;
    qs[i] = to_f(q[b * q_sb + (long long)(kh * G + g) * q_sh + e]);
  }
  if constexpr (PAGED) {
    for (int i = tid; i < (nk + bs - 1) / bs; i += blockDim.x) {
      const int t = table[(long long)b * nb + i];
      tab[i] = t < 0 ? 0 : (t < P ? t : P - 1);
    }
  }
  __syncthreads();

  const T* kb = PAGED ? k + kh * k_sh : k + b * k_sb + kh * k_sh;
  const T* vb = PAGED ? v + kh * v_sh : v + b * v_sb + kh * v_sh;
  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // stage one tile into buffer `buf`, all of its 16-byte copies in flight
  // at once; rows past nk are zero-filled, so masked v lanes are zero
  auto issue = [&](int t0, int buf) {
    T* kd = reinterpret_cast<T*>(wsm + buf * Lt::KV_BYTES);
    T* vd = reinterpret_cast<T*>(wsm + buf * Lt::KV_BYTES + Lt::K_BYTES);
#pragma unroll
    for (int it = 0; it < TILE * CPR / 32; ++it) {
      const int c = lane + it * 32, r = c / CPR, cc = c % CPR, key = t0 + r;
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
      cp_async16(kd + r * KPAD + cc * VEC, kb + ko + cc * VEC, ok);
      cp_async16(vd + r * HD + cc * VEC, vb + vo + cc * VEC, ok);
    }
    cp_async_commit();
  };

  int buf = 0;
  if (warp * TILE < nk) issue(warp * TILE, 0);
  for (int t0 = warp * TILE; t0 < nk; t0 += WARPS * TILE) {
    const int tn = t0 + WARPS * TILE;
    if (Lt::NBUF == 2 && tn < nk) {
      issue(tn, buf ^ 1);
      cp_async_wait<1>();  // this tile has landed; the next one is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* ks = reinterpret_cast<const T*>(wsm + buf * Lt::KV_BYTES);
    const T* vs = reinterpret_cast<const T*>(wsm + buf * Lt::KV_BYTES + Lt::K_BYTES);

    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    const T* krow = ks + lane * KPAD;
#pragma unroll 2
    for (int cc = 0; cc < CPR; ++cc) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + cc * VEC);
      const T* kel = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float kf = to_f(kel[e]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) s[g] += qs[g * HD + cc * VEC + e] * kf;
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
        ps[g * TILE + lane] = pg;
      }
    }
    __syncwarp();

    for (int j = 0; j < TILE; ++j) {
      float vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vf[e] = to_f(vs[j * HD + lane * EPL + e]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float pj = ps[g * TILE + j];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += pj * vf[e];
        }
      }
    }
    __syncwarp();  // the next copy into this buffer, and ps, come after
    if (Lt::NBUF == 1 && tn < nk) issue(tn, 0);
    buf = Lt::NBUF == 2 ? buf ^ 1 : 0;
  }
  __syncthreads();

  // combine the warps' partial softmax states
  float* cm = reinterpret_cast<float*>(smem + Lt::Q_BYTES);  // [WARPS][MAXG]
  float* cl = cm + WARPS * MAXG;                               // [WARPS][MAXG]
  float* ca = cl + WARPS * MAXG;                               // [WARPS][MAXG][HD]
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
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, cm[w * MAXG + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(cm[w * MAXG + g] - M);
      L += cl[w * MAXG + g] * a;
      O += ca[(w * MAXG + g) * HD + e] * a;
    }
    out[((long long)b * H + kh * G + g) * HD + e] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
}

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block can use

template <typename T, int HD, bool PAGED>
int launch(const void* q, const void* k, const void* v, const int* pos, const int* table,
           void* out, int B, int H, int KH, int S, int bs, int nb, int P,
           long long q_sb, long long q_sh, long long k_sb, long long k_sh, long long k_ss,
           long long v_sb, long long v_sh, long long v_ss, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<T, HD>::SMEM + (PAGED ? ((size_t)nb * 4 + 15) / 16 * 16 : 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(decode_attention_kernel<T, HD, PAGED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  decode_attention_kernel<T, HD, PAGED><<<B * KH, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      table, static_cast<T*>(out), H, KH, S, H / KH, bs, nb, P, q_sb, q_sh, k_sb, k_sh,
      k_ss, v_sb, v_sh, v_ss, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, hd); k, v viewed as (B, KH, S, hd) by the given element strides
// (the last dim contiguous); pos int32 (B,); out (B, H, hd) contiguous.
// dtype: 0 = float32, 1 = bfloat16. hd must be 64 or 128, H/KH at most 8.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, int B, int H, int KH,
                                       int S, int hd, long long q_sb, long long q_sh,
                                       long long k_sb, long long k_sh, long long k_ss,
                                       long long v_sb, long long v_sh, long long v_ss,
                                       float scale, int dtype, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > MAXG) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DA_LAUNCH(T, HD)                                                               \
  return launch<T, HD, false>(q, k, v, p, nullptr, out, B, H, KH, S, 1, 0, 0, q_sb, q_sh, \
                              k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, st)
  if (dtype == 1 && hd == 128) DA_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 64) DA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 0 && hd == 128) DA_LAUNCH(float, 128);
  if (dtype == 0 && hd == 64) DA_LAUNCH(float, 64);
#undef DA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// q (B, H, hd); k_pool, v_pool (P, bs, KH, hd) by the given element strides
// (block, slot, head; the last dim contiguous); table int32 (B, nb)
// contiguous; pos int32 (B,); out (B, H, hd) contiguous. dtype as above;
// hd 64 or 128, H/KH at most 8, nb small enough for the table to fit in
// shared memory beside the tiles. Returns the CUDA error code of the launch.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, int B, int H, int KH, int P, int bs, int nb, int hd,
    long long q_sb, long long q_sh, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, float scale, int dtype, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > MAXG || bs < 1 || nb < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PDA_LAUNCH(T, HD)                                                              \
  return launch<T, HD, true>(q, k_pool, v_pool, p, t, out, B, H, KH, nb * bs, bs, nb, P, \
                             q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss, scale, st)
  if (dtype == 1 && hd == 128) PDA_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 64) PDA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 0 && hd == 128) PDA_LAUNCH(float, 128);
  if (dtype == 0 && hd == 64) PDA_LAUNCH(float, 64);
#undef PDA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
