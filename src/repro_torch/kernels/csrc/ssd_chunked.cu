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
// so the bound is bytes. On the CUDA cores, though, one CTA's products, not
// its bytes, set its time. The design:
//   * one CTA per (batch, head) walks the chunks in order: the loop inside the
//     block takes the place of the Pallas grid's sequential chunk axis, and the
//     (hp, N) state stays in shared memory (32 KB f32) for the whole walk;
//   * each chunk stages C, B (f32, B's rows padded by one float so that lanes
//     reading different rows hit distinct banks) and x * dt, and one warp
//     forms cum with a shuffle scan;
//   * warp w owns rows 8w..8w+7 of each product (rows w + 8r of the state
//     update); lanes own columns. The products are register-blocked: per
//     step of a contraction a thread reads its 8 rows' values (broadcast in
//     the warp) and its columns' values once, for 16 or 32 FMAs. The masked
//     scores G = (C B^T) . L go through shared memory to the y product;
//   * a sequence that is not a multiple of CK is staged with x = dt = B = C = 0
//     past its end: such a step leaves cum and the state unchanged, and its
//     outputs are not written, so no caller pads.
// Not done yet: the tensor cores (wgmma) for the three products, and more
// CTAs than batch x heads (80 at Mamba2-2.7B's width, batch 1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // threads
constexpr int NW = NT / 32;     // warps
constexpr int CK = 64;          // chunk length
constexpr int RW = CK / NW;     // chunk rows a warp owns
constexpr int MAXHP = 64;       // head dim: two columns a lane in the y product
constexpr int MAXN = 128;       // state dim: four columns a lane in the state update

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Shared memory of one CTA, in floats from its start.
struct Layout {
  int st, bs, cs, xs, gs, cum, ecum, wdec, total;
  __host__ __device__ Layout(int hp, int N) {
    st = 0;                        // state [hp][N + 1]
    bs = st + hp * (N + 1);        // B     [CK][N + 1]
    cs = bs + CK * (N + 1);        // C     [CK][N]
    xs = cs + CK * N;              // x*dt  [CK][hp]
    gs = xs + CK * hp;             // G     [CK][CK]
    cum = gs + CK * CK;            // cum   [CK]
    ecum = cum + CK;               // exp(cum)
    wdec = ecum + CK;              // exp(cum_last - cum)
    total = wdec + CK;
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_chunked_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, float* __restrict__ y, float* __restrict__ state,
                   int H, int S, int hp, int N, long long x_sb, long long x_sh, long long x_ss,
                   long long d_sb, long long d_sh, long long d_ss, long long b_sb,
                   long long b_ss, long long c_sb, long long c_ss, long long y_sb,
                   long long y_sh, long long y_ss) {
  extern __shared__ __align__(16) float sm[];
  const Layout lt(hp, N);
  float* St = sm + lt.st;
  float* Bs = sm + lt.bs;
  float* Cs = sm + lt.cs;
  float* Xs = sm + lt.xs;
  float* Gs = sm + lt.gs;
  float* cum = sm + lt.cum;
  float* ecum = sm + lt.ecum;
  float* wdec = sm + lt.wdec;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int NP = N + 1;
  const float a_h = A[h];
  const T* xb = x + b * x_sb + h * x_sh;
  const float* db = dt + b * d_sb + h * d_sh;
  const T* bb = Bm + b * b_sb;
  const T* cb = Cm + b * c_sb;

  for (int e = tid; e < hp * NP; e += NT) St[e] = 0.f;

  const int n_chunks = (S + CK - 1) / CK;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * CK;
    // -- stage the chunk: zeros past the sequence's end
    for (int e = tid; e < CK * N; e += NT) {
      const int i = e / N, n = e % N, t = t0 + i;
      const bool ok = t < S;
      Bs[i * NP + n] = ok ? to_f(bb[t * b_ss + n]) : 0.f;
      Cs[i * N + n] = ok ? to_f(cb[t * c_ss + n]) : 0.f;
    }
    for (int e = tid; e < CK * hp; e += NT) {
      const int i = e / hp, p = e % hp, t = t0 + i;
      Xs[i * hp + p] = t < S ? to_f(xb[t * x_ss + p]) * db[t * d_ss] : 0.f;
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
        const float b0 = Bs[lane * NP + n], b1 = Bs[(lane + 32) * NP + n];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float c = Cs[(i0 + r) * N + n];
          g[r][0] += c * b0;
          g[r][1] += c * b1;
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

    // -- y[i][p] = sum_{j <= i} G[i][j] xdt[j][p] + exp(cum_i) C_i . state[p]
    {
      const bool ok0 = lane < hp, ok1 = lane + 32 < hp;
      float acc[RW][2], inter[RW][2];
#pragma unroll
      for (int r = 0; r < RW; ++r) acc[r][0] = acc[r][1] = inter[r][0] = inter[r][1] = 0.f;
      for (int j = 0; j < i0 + RW; ++j) {  // G is 0 past each row's diagonal
        const float x0 = ok0 ? Xs[j * hp + lane] : 0.f;
        const float x1 = ok1 ? Xs[j * hp + lane + 32] : 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float g = Gs[(i0 + r) * CK + j];
          acc[r][0] += g * x0;
          acc[r][1] += g * x1;
        }
      }
      for (int n = 0; n < N; ++n) {
        const float s0 = ok0 ? St[lane * NP + n] : 0.f;
        const float s1 = ok1 ? St[(lane + 32) * NP + n] : 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float c = Cs[(i0 + r) * N + n];
          inter[r][0] += c * s0;
          inter[r][1] += c * s1;
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = i0 + r, t = t0 + i;
        if (t < S) {
          float* yt = y + b * y_sb + h * y_sh + t * y_ss;
          if (ok0) yt[lane] = acc[r][0] + ecum[i] * inter[r][0];
          if (ok1) yt[lane + 32] = acc[r][1] + ecum[i] * inter[r][1];
        }
      }
    }
    __syncthreads();  // every read of the entering state is done

    // -- state[p][n] = exp(cum_last) state[p][n] + sum_j wdec_j xdt[j][p] B[j][n];
    // warp w owns rows p = w + NW r, lane columns n = lane + 32 cn
    {
      constexpr int RP = MAXHP / NW;
      const float e_last = ecum[CK - 1];
      float acc[RP][4];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int p = warp + NW * r;
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const int n = lane + 32 * cn;
          acc[r][cn] = (p < hp && n < N) ? St[p * NP + n] * e_last : 0.f;
        }
      }
      for (int j = 0; j < CK; ++j) {
        const float w = wdec[j];
        float bn[4];
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          const int n = lane + 32 * cn;
          bn[cn] = n < N ? Bs[j * NP + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const int p = warp + NW * r;
          const float xw = p < hp ? Xs[j * hp + p] * w : 0.f;
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
          if (p < hp && n < N) St[p * NP + n] = acc[r][cn];
        }
      }
    }
    __syncthreads();  // the next chunk's staging overwrites B, C and x*dt
  }

  float* so = state + ((long long)b * H + h) * hp * N;
  for (int e = tid; e < hp * N; e += NT) so[e] = St[(e / N) * NP + e % N];
}

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block can use

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           float* y, float* state, int B, int H, int S, int hp, int N, long long x_sb,
           long long x_sh, long long x_ss, long long d_sb, long long d_sh, long long d_ss,
           long long b_sb, long long b_ss, long long c_sb, long long c_ss, long long y_sb,
           long long y_sh, long long y_ss, cudaStream_t stream) {
  const size_t bytes = (size_t)Layout(hp, N).total * sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(ssd_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  ssd_chunked_kernel<T><<<dim3(H, B), NT, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), y,
      state, H, S, hp, N, x_sb, x_sh, x_ss, d_sb, d_sh, d_ss, b_sb, b_ss, c_sb, c_ss, y_sb,
      y_sh, y_ss);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, S, hp), Bm and Cm (B, S, N) of one dtype, by the given element
// strides (the last dim contiguous); dt (B, H, S) float32 by its strides; A
// (H,) float32 contiguous; y (B, H, S, hp) float32 by its strides; state
// (B, H, hp, N) float32 contiguous. dtype: 0 = float32, 1 = bfloat16.
// hp <= 64, N <= 128, S >= 1. Returns the CUDA error code of the launch.
extern "C" int ssd_chunked_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, void* y, void* state, int B, int H, int S,
                                  int hp, int N, long long x_sb, long long x_sh, long long x_ss,
                                  long long d_sb, long long d_sh, long long d_ss,
                                  long long b_sb, long long b_ss, long long c_sb,
                                  long long c_ss, long long y_sb, long long y_sh,
                                  long long y_ss, int dtype, void* stream) {
  if (B < 1 || H < 1 || B > 65535 || S < 1 || hp < 1 || hp > MAXHP || N < 1 || N > MAXN)
    return (int)cudaErrorInvalidValue;
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, d, a, Bm, Cm, yo, so, B, H, S, hp, N, x_sb, x_sh, x_ss,
                                 d_sb, d_sh, d_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_sh, y_ss, st);
  if (dtype == 0)
    return launch<float>(x, d, a, Bm, Cm, yo, so, B, H, S, hp, N, x_sb, x_sh, x_ss, d_sb, d_sh,
                         d_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_sh, y_ss, st);
  return (int)cudaErrorInvalidValue;
}
