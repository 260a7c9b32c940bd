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
// What bounds it on an H100: at decode the latent stream is MQA-like (one
// stream serves all H heads), so the bytes are the rows' latents, about
// (r + dr) * 2 bytes a key in bf16, and the work is H * (2 r + dr) * 2 flop
// a key: ~30 flop per byte at H = 16, far below the ~295 flop per byte
// where the tensor cores would become the limit, so the bound is bytes. On
// the CUDA cores, though, 16 heads' scores and contexts per key make a
// row's arithmetic, not its bytes, the limit of one CTA. The design:
//   * one CTA per (row, key range). Each 32-key tile of c and k_pe is
//     staged in shared memory ONCE (cp.async, 16-byte copies; bf16 tiles
//     double-buffered) and serves all H heads. The Pallas grid (B*H, nb)
//     loaded every latent block once per head instead;
//   * the key axis is split across CTAs so that B rows fill the SMs: each
//     CTA writes its range's unnormalised (m, l, context) in f32, and a
//     second kernel merges the ranges of a row (with one range, the first
//     kernel writes the output itself);
//   * the CTA copies its row's table slice into shared memory once; the
//     walk is clamped to min(pos, nb*bs - 1), so a stale pos past the table
//     reads nothing out of range, and table entries are clamped into
//     [0, P). Any block size works: a tile may span several blocks;
//   * q_lat and q_pe sit in shared memory as f32, one combined (r + dr) row
//     per head; each staged key row is c then k_pe, padded by 16 bytes so
//     the 32 lanes' row reads hit distinct banks;
//   * scores: warp h scores head h, lane j key j of the tile, and keeps the
//     head's running max and sum (every lane holds them);
//   * context: thread e owns latent dim e for all heads, H accumulators in
//     registers, rescaled per tile by the heads' alpha.
// Not done yet: the tensor cores for the two products, and two CTAs per SM
// (the ~115 KB of shared memory allows one).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;      // threads: warp h scores head h; thread e owns dim e
constexpr int TILE = 32;     // keys per tile: one per lane when scoring
constexpr int MAXH = NT / 32;  // heads
constexpr int MAXR = NT;       // latent dims
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

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Dynamic shared memory of one CTA, in bytes from its start.
template <typename T>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte chunk
  static constexpr int NBUF = sizeof(T) == 2 ? 2 : 1;  // f32 tiles: single buffer
  int kpad;           // staged key row, in elements: r + dr, padded by 16 bytes
  size_t tile;        // NBUF tiles of TILE key rows
  size_t tile_bytes;
  size_t ps;          // p[TILE][MAXH] f32
  size_t stat;        // alpha[MAXH], l[MAXH] f32
  size_t tab;         // the block ids of the CTA's key range (int32)
  size_t total;
  __host__ __device__ Layout(int H, int D, int n_tab) {
    kpad = D + VEC;
    tile = align16((size_t)H * D * sizeof(float));  // after q[H][D] f32
    tile_bytes = (size_t)TILE * kpad * sizeof(T);
    ps = tile + NBUF * tile_bytes;
    stat = ps + TILE * MAXH * sizeof(float);
    tab = stat + 2 * MAXH * sizeof(float);
    total = tab + align16((size_t)n_tab * sizeof(int));
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)  // one CTA an SM: up to 128 registers a thread
paged_mla_decode_kernel(const T* __restrict__ ql, const T* __restrict__ qp,
                        const T* __restrict__ c_pool, const T* __restrict__ kpe_pool,
                        const int* __restrict__ table, const int* __restrict__ pos,
                        T* __restrict__ out, float* __restrict__ part, int H, int r, int dr,
                        int P, int bs, int nb, int chunk, long long ql_sb, long long ql_sh,
                        long long qp_sb, long long qp_sh, long long c_sb, long long c_ss,
                        long long k_sb, long long k_ss, float scale) {
  constexpr int VEC = Layout<T>::VEC, NBUF = Layout<T>::NBUF;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = r + dr;
  const Layout<T> lt(H, D, 0);  // the table slice's size matters to the launch only
  float* qs = reinterpret_cast<float*>(smem);                 // [H][D]
  float* ps = reinterpret_cast<float*>(smem + lt.ps);         // [TILE][MAXH]
  float* alpha_s = reinterpret_cast<float*>(smem + lt.stat);  // [MAXH]
  float* l_s = alpha_s + MAXH;                                // [MAXH]
  int* tab = reinterpret_cast<int*>(smem + lt.tab);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int p = pos[b];
  const int nk = p < 0 ? 0 : min(p, nb * bs - 1) + 1;  // keys with kpos <= pos, in the table
  // this CTA's keys: [k0, k1), at most `chunk` (a multiple of TILE)
  const int k0 = blockIdx.y * chunk, k1 = min(k0 + chunk, nk);
  const int tab0 = k0 / bs;  // tab[i] holds table entry tab0 + i

  for (int i = tid; i < H * D; i += NT) {
    const int h = i / D, e = i % D;
    qs[i] = e < r ? to_f(ql[b * ql_sb + h * ql_sh + e])
                  : to_f(qp[b * qp_sb + h * qp_sh + (e - r)]);
  }
  for (int i = tid; i < (k1 + bs - 1) / bs - tab0; i += NT) {
    const int t = table[(long long)b * nb + tab0 + i];
    tab[i] = t < 0 ? 0 : (t < P ? t : P - 1);
  }
  __syncthreads();

  const int CR = r / VEC, CPR = D / VEC;  // 16-byte chunks: latent, whole row
  // stage the tile of keys [t0, t0 + TILE) into buffer `buf`, all of its
  // 16-byte copies in flight at once; keys past k1 are zero-filled, so a
  // masked latent lane is zero
  auto issue = [&](int t0, int buf) {
    T* dst = reinterpret_cast<T*>(smem + lt.tile + buf * lt.tile_bytes);
    for (int i = tid; i < TILE * CPR; i += NT) {
      const int row = i / CPR, cc = i % CPR, key = t0 + row;
      const bool ok = key < k1;
      const T* src = c_pool;  // a valid address; nothing is read when !ok
      if (ok) {
        const long long blk = tab[key / bs - tab0], slot = key % bs;
        src = cc < CR ? c_pool + blk * c_sb + slot * c_ss + cc * VEC
                      : kpe_pool + blk * k_sb + slot * k_ss + (cc - CR) * VEC;
      }
      cp_async16(dst + row * lt.kpad + cc * VEC, src, ok);
    }
    cp_async_commit();
  };

  float m = NEG, l = 0.f;  // head `warp`: running max and sum
  float acc[MAXH];         // dim `tid` of every head's context
#pragma unroll
  for (int h = 0; h < MAXH; ++h) acc[h] = 0.f;
  const float* qh = qs + warp * D;
  const int ntiles = k1 > k0 ? (k1 - k0 + TILE - 1) / TILE : 0;

  if (ntiles > 0) issue(k0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int buf = NBUF == 2 ? (it & 1) : 0;
    if (NBUF == 2 && it + 1 < ntiles) {
      issue(k0 + (it + 1) * TILE, buf ^ 1);
      cp_async_wait<1>();  // this tile has landed; the next one is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ts = reinterpret_cast<const T*>(smem + lt.tile + buf * lt.tile_bytes);
    const int t0 = k0 + it * TILE;

    if (warp < H) {  // scores of head `warp` against key t0 + lane
      const T* krow = ts + lane * lt.kpad;
      float s = 0.f;
#pragma unroll 2
      for (int cc = 0; cc < CPR; ++cc) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + cc * VEC);
        const T* kel = reinterpret_cast<const T*>(&raw);
        const float4* q4 = reinterpret_cast<const float4*>(qh + cc * VEC);
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4) {
          const float4 qv = q4[e4];
          s += qv.x * to_f(kel[4 * e4]) + qv.y * to_f(kel[4 * e4 + 1])
             + qv.z * to_f(kel[4 * e4 + 2]) + qv.w * to_f(kel[4 * e4 + 3]);
        }
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
        const float cv = to_f(ts[j * lt.kpad + tid]);
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
    __syncthreads();  // the next copy into this buffer, and ps, come after
    if (NBUF == 1 && it + 1 < ntiles) issue(k0 + (it + 1) * TILE, 0);
  }

  if (part != nullptr) {  // one key range of several: its unnormalised state
    const long long row = (long long)b * gridDim.y + blockIdx.y;  // [B][splits]
    float* pacc = part + row * H * (r + 2);  // [H][r] context, then [H][2] (m, l)
    if (warp < H && lane == 0) {
      pacc[H * r + 2 * warp] = m;
      pacc[H * r + 2 * warp + 1] = l;
    }
    if (tid < r) {
#pragma unroll
      for (int h = 0; h < MAXH; ++h)
        if (h < H) pacc[h * r + tid] = acc[h];
    }
    return;
  }
  if (warp < H && lane == 0) l_s[warp] = l;
  __syncthreads();
  if (tid < r) {
#pragma unroll
    for (int h = 0; h < MAXH; ++h)
      if (h < H)
        out[((long long)b * H + h) * r + tid] = from_f<T>(acc[h] / fmaxf(l_s[h], 1e-30f));
  }
}

// Merge a row's key ranges: M = max m_s, L = sum l_s e^(m_s - M),
// O = sum acc_s e^(m_s - M), out = O / max(L, 1e-30). An empty range has
// m = -1e30, l = 0, acc = 0 and adds nothing.
template <typename T>
__global__ void __launch_bounds__(NT)
paged_mla_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int H, int r,
                         int splits) {
  const int b = blockIdx.x, e = threadIdx.x;
  if (e >= r) return;
  const float* base = part + (long long)b * splits * H * (r + 2);
  for (int h = 0; h < H; ++h) {
    float M = NEG;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, base[(long long)s * H * (r + 2) + H * r + 2 * h]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ps = base + (long long)s * H * (r + 2);
      const float a = expf(ps[H * r + 2 * h] - M);
      L += ps[H * r + 2 * h + 1] * a;
      O += ps[h * r + e] * a;
    }
    out[((long long)b * H + h) * r + e] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
}

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block can use

template <typename T>
int launch(const void* ql, const void* qp, const void* c_pool, const void* kpe_pool,
           const int* table, const int* pos, void* out, float* part, int B, int H, int r,
           int dr, int P, int bs, int nb, int splits, long long ql_sb, long long ql_sh,
           long long qp_sb, long long qp_sh, long long c_sb, long long c_ss, long long k_sb,
           long long k_ss, float scale, cudaStream_t stream) {
  // each range a whole number of tiles, the ranges covering nb * bs keys
  const int tiles = (nb * bs + TILE - 1) / TILE;
  const int chunk = (tiles + splits - 1) / splits * TILE;
  const Layout<T> lt(H, r + dr, (chunk + bs - 1) / bs + 1);  // table entries a range spans
  if (lt.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(paged_mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)lt.total);
  paged_mla_decode_kernel<T><<<dim3(B, splits), NT, lt.total, stream>>>(
      static_cast<const T*>(ql), static_cast<const T*>(qp), static_cast<const T*>(c_pool),
      static_cast<const T*>(kpe_pool), table, pos, static_cast<T*>(out),
      splits > 1 ? part : nullptr, H, r, dr, P, bs, nb, chunk, ql_sb, ql_sh, qp_sb, qp_sh,
      c_sb, c_ss, k_sb, k_ss, scale);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  paged_mla_combine_kernel<T><<<B, NT, 0, stream>>>(part, static_cast<T*>(out), H, r, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat (B, H, r) and q_pe (B, H, dr) by the given element strides (batch,
// head; the last dim contiguous); c_pool (P, bs, r) and kpe_pool (P, bs, dr)
// by the given strides (block, slot; the last dim contiguous, rows 16-byte
// aligned); table int32 (B, nb) contiguous; pos int32 (B,); out (B, H, r)
// contiguous. The key axis is cut into `splits` ranges, one CTA each; with
// splits > 1, part is f32 scratch of B * splits * H * (r + 2) floats.
// dtype: 0 = float32, 1 = bfloat16. H <= 16, r <= 512, r and dr multiples of
// 8. Returns the CUDA error code of the launches (0 on success).
extern "C" int paged_mla_decode_attention_launch(
    const void* q_lat, const void* q_pe, const void* c_pool, const void* kpe_pool,
    const void* table, const void* pos, void* out, void* part, int B, int H, int r, int dr,
    int P, int bs, int nb, int splits, long long ql_sb, long long ql_sh, long long qp_sb,
    long long qp_sh, long long c_sb, long long c_ss, long long k_sb, long long k_ss,
    float scale, int dtype, void* stream) {
  if (H < 1 || H > MAXH || r < 8 || r > MAXR || r % 8 || dr < 8 || dr % 8 || bs < 1 ||
      nb < 1 || P < 1 || splits < 1 || splits > 65535 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q_lat, q_pe, c_pool, kpe_pool, t, p, out, pt, B, H, r, dr, P,
                                 bs, nb, splits, ql_sb, ql_sh, qp_sb, qp_sh, c_sb, c_ss, k_sb,
                                 k_ss, scale, st);
  if (dtype == 0)
    return launch<float>(q_lat, q_pe, c_pool, kpe_pool, t, p, out, pt, B, H, r, dr, P, bs, nb,
                         splits, ql_sb, ql_sh, qp_sb, qp_sh, c_sb, c_ss, k_sb, k_ss, scale,
                         st);
  return (int)cudaErrorInvalidValue;
}
