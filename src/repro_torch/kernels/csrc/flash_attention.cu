// Kernel K6: forward flash attention for Hopper (sm_90a), in CUDA C++.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// kernel). q: (B, H, S, hd); k, v: (B, Hkv, S, hd), with GQA head h / G,
// G = H / Hkv; out: (B, H, S, hd) in q's type. fp32 or bf16 inputs,
// hd in {32, 64, 128, 256}, any S.
//
// What it computes, as the Pallas kernel does: scores s = (q . k) * scale
// in fp32, optionally tanh(s / cap) * cap, causal and sliding-window masks
// with -1e30, an online softmax whose p is zeroed where the mask is false
// (so a fully masked row of a live tile adds nothing to l or acc), and
// out = acc / max(l, 1e-30). Tiles that the Pallas `live` predicate
// rejects are skipped, so the work follows what the masks keep: O(S * W)
// for a local layer.
//
// What bounds it on this card: it does two matrix products, QK^T and PV,
// so it is bound by operations, not bytes (in bf16 some 440 operations a
// byte at qwen2-1.5b's shapes and 1,366 at a gemma2-9b layer's, against
// the ~295 above which the tensor cores, not HBM, are the limit). This
// first design computes both products in fp32 on the CUDA cores, as the
// reference's fp32 dots do (P is never rounded to bf16), so its ceiling
// is the card's fp32 rate, 67 TFLOP/s, not the tensor cores' 989: simple
// and right first; a wgmma and TMA design is later work.
//
// Design. One block of 256 threads (16 x 16) per (q-tile, head, batch); a
// loop over k-tiles takes the place of the TPU grid's sequential k axis.
// Thread (tx, ty) owns query rows ty + 16 i and, in turn, score columns
// tx + 16 j and output columns tx + 16 j, so a row's 16 owners are one
// half-warp and its max and sum are four shuffles each. The Q tile and each
// K/V tile are staged in shared memory as fp32 (Q and K transposed and
// padded by one column, so both the transposing stores and the product's
// loads are free of bank conflicts); P goes through shared memory between
// the two products. Scores, m, l and the output accumulator stay in fp32
// registers (64 accumulators a thread at hd = 256). At hd = 256 with
// 64 x 64 tiles the block needs 215,296 bytes of shared memory, which is
// only granted as dynamic shared memory after cudaFuncSetAttribute.
// Rows and columns past S are masked (and loaded as 0): nothing is padded.
// No fast-math: expf and tanhf stay within a few ulps of the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared-memory layout, in floats.
template <int HD, int BQ, int BK>
struct Smem {
  static constexpr int kLdq = BQ + 1;  // Q^T: [HD][BQ + 1]
  static constexpr int kLdk = BK + 1;  // K^T: [HD][BK + 1]
  static constexpr int kLdp = BQ + 1;  // P^T: [BK][BQ + 1]
  static constexpr int kQ = HD * kLdq;
  static constexpr int kK = HD * kLdk;
  static constexpr int kV = BK * HD;   // V: [BK][HD]
  static constexpr int kP = BK * kLdp;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int S,
          int causal, int has_window, int window, float scale,
          int has_softcap, float softcap) {
  using L = Smem<HD, BQ, BK>;
  constexpr int TM = BQ / 16;  // rows a thread owns
  constexpr int TN = BK / 16;  // score columns a thread owns
  constexpr int TD = HD / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + L::kQ;
  float* vs = ks + L::kK;
  float* ps = vs + L::kV;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qh = q + (size_t)(b * H + h) * S * HD;
  const T* kh = k + (size_t)(b * Hkv + hk) * S * HD;
  const T* vh = v + (size_t)(b * Hkv + hk) * S * HD;
  T* oh = o + (size_t)(b * H + h) * S * HD;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[d * L::kLdq + r] =
        q0 + r < S ? load_f32(qh + (size_t)(q0 + r) * HD + d) : 0.f;
  }

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  const int nk = (S + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    // the Pallas block-level skip: fully masked tiles do no work
    if (causal && k0 > q0 + BQ - 1) break;
    if (has_window && k0 + BK - 1 <= q0 - window) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < S;
      const size_t off = (size_t)(k0 + r) * HD + d;
      ks[d * L::kLdk + r] = in ? load_f32(kh + off) : 0.f;
      vs[r * HD + d] = in ? load_f32(vh + off) : 0.f;
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[TM], c[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[d * L::kLdq + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) c[j] = ks[d * L::kLdk + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[TN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (has_softcap) x = tanhf(x / softcap) * softcap;
        ok[j] = col < S && (!causal || col <= row) &&
                (!has_window || col > row - window);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_cur) : 0.f;
        ps[(tx + 16 * j) * L::kLdp + ty + 16 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[TM], w[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = ps[c * L::kLdp + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TD; ++j) w[j] = vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      store_f32(oh + (size_t)row * HD + tx + 16 * j, acc[i][j] / denom);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, S, causal, has_window, window;
  float scale;
  int has_softcap;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int HD, int BQ, int BK>
cudaError_t launch(const Args& a) {
  auto kern = flash_fwd<T, HD, BQ, BK>;
  const size_t smem = Smem<HD, BQ, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.H, a.Hkv, a.S,
      a.causal, a.has_window, a.window, a.scale, a.has_softcap, a.softcap);
  return cudaGetLastError();
}

// One tile, 64 x 64, for every head dim: other tiles get instances when a
// tuner has measured that they pay.
constexpr int kTile = 64;

template <typename T>
cudaError_t by_head_dim(const Args& a, int hd, int bq, int bk) {
  if (bq != kTile || bk != kTile) return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch<T, 32, kTile, kTile>(a);
    case 64: return launch<T, 64, kTile, kTile>(a);
    case 128: return launch<T, 128, kTile, kTile>(a);
    case 256: return launch<T, 256, kTile, kTile>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches K6 on `stream` without synchronising. Returns the launch's
// cudaError_t (0 on success); a refused launch never runs, so the caller
// must check it.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int S, int hd, int is_bf16, int causal, int has_window,
    int window, float scale, int has_softcap, float softcap, int block_q,
    int block_k, void* stream) {
  const Args a{q, k, v, o, B, H, Hkv, S, causal, has_window, window, scale,
               has_softcap, softcap, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? by_head_dim<__nv_bfloat16>(a, hd, block_q, block_k)
                 : by_head_dim<float>(a, hd, block_q, block_k);
}

// The dynamic shared memory a launch at head dim `hd` asks for, in bytes
// (the same for fp32 and bf16 inputs, which are staged as fp32); 0 for a
// head dim without an instance.
extern "C" long long repro_flash_attention_smem_bytes(int hd) {
  switch (hd) {
    case 32: return Smem<32, kTile, kTile>::kBytes;
    case 64: return Smem<64, kTile, kTile>::kBytes;
    case 128: return Smem<128, kTile, kTile>::kBytes;
    case 256: return Smem<256, kTile, kTile>::kBytes;
    default: return 0;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
