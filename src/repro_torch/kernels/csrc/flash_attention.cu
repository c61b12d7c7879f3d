// Flash attention forward (GQA, causal or full), K5's float32 path.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention, kernel body _kernel) for float32 inputs: blockwise
// online-softmax attention, kv head h // (H / Hkv), a float32 accumulator.
// q is [B, H, S, D], k and v are [B, Hkv, Sk, D] and o [B, H, S, D], each
// with its own strides (the last dimension contiguous); D is 16, 32, 64 or
// 128. bfloat16 inputs go to the tensor-core kernel of
// flash_attention_tc.cu.
//
// What bounds it on an H100: operations. The work is 4 * B * H * S * Sk * D
// floating-point operations (two products), half that under the causal
// mask, over q, k, v and o each moved once, far above the card's balance
// point. It runs in full float32 on the CUDA cores (67 TFLOP/s peak): the
// float32 bar of 2e-5 against the plain version cannot be met in TF32 on
// the tensor cores.
//
// Design: the TPU kernel walked the kv tiles along a sequential grid axis
// and carried (m, l, acc) from one grid step to the next in VMEM. CUDA
// blocks run in no order, so one block owns one (b, h, q tile of 64 rows)
// and loops over the kv tiles itself, with m, l and the accumulator in
// registers. Under the causal mask the loop stops at the diagonal tile
// (the tiles past it are fully masked and change nothing), and the q tiles
// are scheduled longest first. The block stages its q tile (scaled), one
// k and one v tile and the tile of probabilities in dynamic shared memory,
// all in float32: 68 KB at D = 64, more than the 48 KB of static shared memory,
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
// scores after it, a difference of one rounding per score.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // kv rows per tile
constexpr int kThreads = 128;
constexpr int kPad = 4;  // floats of padding per shared row

// element strides (batch, head, row) of q, k, v and o
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <int D>
constexpr int smem_bytes() {
  return sizeof(float) * (kBQ * (D + kPad) + kBK * (D + kPad) + kBK * D +
                          kBQ * (kBK + kPad));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides st,
              int H, int Hkv, int S, int Sk, int causal, float scale) {
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
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];
  float* ob = o + b * st.o[0] + h * st.o[1];
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const float NEG = __uint_as_float(0xff800000u);  // -inf

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * DP + c] =
        q0 + r < S ? qb[(q0 + r) * st.q[2] + c] * scale : 0.f;
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
      Ks[r * DP + c] = in ? kb[(k0 + r) * st.k[2] + c] : 0.f;
      Vs[r * D + c] = in ? vb[(k0 + r) * st.v[2] + c] : 0.f;
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
        ob[r * st.o[2] + 8 * W * c + W * tx + w] = acc[i][W * c + w] / den;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Strides& st, int B, int H, int Hkv, int S, int Sk,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, H, Hkv, S,
      Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// o = softmax(q k^T * scale [causal mask]) v per (b, h), kv head
// h / (H / Hkv), all float32. `strides` holds 12 element strides, (batch,
// head, row) of q, k, v and o in turn; the last dimension is contiguous.
// Launches on `stream`; returns the first CUDA error
// (cudaErrorInvalidValue for a D or shape the kernel does not take).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int S, int Sk, int D,
                                   const long long* strides, int causal,
                                   float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, st, B, H, Hkv, S, Sk, causal, scale, s);
    case 32:
      return launch<32>(q, k, v, o, st, B, H, Hkv, S, Sk, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, o, st, B, H, Hkv, S, Sk, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, o, st, B, H, Hkv, S, Sk, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
