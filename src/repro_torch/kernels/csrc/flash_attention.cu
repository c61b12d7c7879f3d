// Flash attention forward (GQA, causal or full), K5.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention, kernel body _kernel): blockwise online-softmax
// attention, kv head h // (H / Hkv), a float32 accumulator, output in q's
// dtype. q is [B, H, S, D], k and v are [B, Hkv, Sk, D], all contiguous,
// float32 or bfloat16; D is 16, 32, 64 or 128.
//
// What bounds it on an H100: operations. The work is 4 * B * H * S * Sk * D
// floating-point operations (two products), half that under the causal
// mask, over q, k, v and o each moved once: at B = 4, H = 14,
// S = Sk = 2048, D = 64 that is 30 GFLOP against 29 MB, about 1,000
// operations per byte, far above the card's balance point. The bound at the
// tensor cores' bf16 rate (989 TFLOP/s) is about 0.03 ms. This first
// version does its arithmetic in float32 on the CUDA cores (67 TFLOP/s
// peak), so it cannot come within 15 times of that bound; mma.sync or
// wgmma, TMA and warp specialisation are for a later change.
//
// Design: the TPU kernel walked the kv tiles along a sequential grid axis
// and carried (m, l, acc) from one grid step to the next in VMEM. CUDA
// blocks run in no order, so one block owns one (b, h, q tile of 64 rows)
// and loops over the kv tiles itself, with m, l and the accumulator in
// registers. Under the causal mask the loop stops at the diagonal tile
// (the tiles past it are fully masked and change nothing), and the q tiles
// are scheduled longest first. The block stages its q tile (scaled), one
// k and one v tile and the tile of probabilities in dynamic shared memory,
// all in float32 (bf16 is converted with __bfloat162float as it is
// loaded): 68 KB at D = 64, more than the 48 KB of static shared memory,
// so the launcher opts in with cudaFuncSetAttribute. 128 threads: thread
// (ty, tx) = (tid / 8, tid % 8) owns q rows 4 ty .. 4 ty + 3, score columns
// tx + 8 j and the output columns of chunks of W = min(4, D / 8) starting
// at 8 W c + W tx. Rows of k and q are padded by 4 floats, so that the
// 16-byte shared-memory loads of eight neighbouring threads fall in
// distinct banks.
//
// The masked-row rule is the TPU kernel's: m_safe = m where m > -inf, else
// 0, and exp(-inf) = 0, so a row whose scores are all masked keeps a zero
// accumulator; the output is acc / max(l, 1e-30). The ragged edge is
// masked here (q rows >= S are computed on zeros and not stored; k columns
// >= Sk are -inf), so S and Sk need not be multiples of the tile, unlike
// the TPU kernel.
//
// Rounding: like the TPU kernel, q is scaled by 1/sqrt(D) in float32
// before the product; the plain version and the JAX reference scale the
// scores after it, a difference of one rounding per score. A bf16 x bf16
// product is exact in float32, so a later tensor-core version keeps these
// numbers up to the order of summation, except for the scale when
// D = 128 (1/sqrt(128) is not a power of two, so the scaled q no longer
// fits in bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // kv rows per tile
constexpr int kThreads = 128;
constexpr int kPad = 4;  // floats of padding per shared row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_bytes() {
  return sizeof(float) * (kBQ * (D + kPad) + kBK * (D + kPad) + kBK * D +
                          kBQ * (kBK + kPad));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
              int S, int Sk, int causal, float scale) {
  constexpr int DP = D + kPad;
  constexpr int KP = kBK + kPad;
  constexpr int W = D >= 32 ? 4 : 2;  // output columns per chunk
  constexpr int NC = D / (8 * W);     // output chunks per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][DP], scaled
  float* Ks = Qs + kBQ * DP;                    // [kBK][DP]
  float* Vs = Ks + kBK * DP;                    // [kBK][D]
  float* Ps = Vs + kBK * D;                     // [kBQ][KP]

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qb = q + ((long long)b * H + h) * S * D;
  const T* kb = k + ((long long)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((long long)b * Hkv + hk) * Sk * D;
  T* ob = o + ((long long)b * H + h) * S * D;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const float NEG = __uint_as_float(0xff800000u);  // -inf

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * DP + c] =
        q0 + r < S ? to_f(qb[(long long)(q0 + r) * D + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][W * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < W * NC; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed; Qs is written
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      const long long g = (long long)(k0 + r) * D + c;
      Ks[r * DP + c] = in ? to_f(kb[g]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * DP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax; the 8 threads of a row are neighbouring lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        if (kp >= Sk || (causal && qp < kp)) s[i][j] = NEG;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      const float m_new = fmaxf(m[i], rmax);
      const float m_safe = m_new > NEG ? m_new : 0.f;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);
        rsum += s[i][j];
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      const float alpha = expf(m[i] - m_safe);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < W * NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(ty * 4 + i) * KP + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * KP + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float* vp = &Vs[(kk + e) * D + 8 * W * c + W * tx];
          float vv[W];
          if constexpr (W == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vp);
            vv[0] = t.x, vv[1] = t.y, vv[2] = t.z, vv[3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vp);
            vv[0] = t.x, vv[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x
                            : e == 1 ? pv[i].y
                            : e == 2 ? pv[i].z
                                     : pv[i].w;
#pragma unroll
            for (int w = 0; w < W; ++w)
              acc[i][W * c + w] = fmaf(p, vv[w], acc[i][W * c + w]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int w = 0; w < W; ++w)
        store(&ob[(long long)r * D + 8 * W * c + W * tx + w],
              acc[i][W * c + w] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int S, int Sk, int causal,
                   float scale, cudaStream_t st) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, D><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, Sk, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Hkv, int S, int Sk, int D, int causal,
                     float scale, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, Hkv, S, Sk, causal, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, S, Sk, causal, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, S, Sk, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, S, Sk, causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// o = softmax(q k^T * scale [causal mask]) v per (b, h), kv head
// h / (H / Hkv). dtype 0 is float32, 1 bfloat16. Launches on `stream`;
// returns the first CUDA error (cudaErrorInvalidValue for a D, dtype or
// shape the kernel does not take).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int S, int Sk,
                               int D, int dtype, int causal, float scale,
                               void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, H, Hkv, S, Sk, D, causal, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, Sk, D, causal,
                                   scale, st);
  return cudaErrorInvalidValue;
}
