// Kernel K6: forward flash attention for Hopper (sm_90a), in CUDA C++.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// kernel). q: (B, H, S, hd); k, v: (B, Hkv, S, hd), with GQA head h / G,
// G = H / Hkv; out: (B, H, S, hd) in q's type. hd in {32, 64, 128, 256},
// any S. Two kernels, chosen by the inputs' type:
//   * bf16 inputs: `flash_fwd_wgmma`, on the tensor cores (below);
//   * fp32 inputs: `flash_fwd_simt`, fp32 FMAs on the CUDA cores.
//
// What both compute, as the Pallas kernel does: scores s = (q . k) * scale
// in fp32, optionally tanh(s / cap) * cap (tanhf), causal and
// sliding-window masks with -1e30, an online softmax whose p is zeroed where
// the mask is false (so a fully masked row of a live tile adds nothing to l
// or acc), l summed from the fp32 p, and out = acc / max(l, 1e-30). Tiles
// that the Pallas `live` predicate rejects are skipped, so the work follows
// what the masks keep: O(S * W) for a local layer. No fast-math: tanhf and
// expf are the accurate library functions (no tanh.approx, no ex2.approx
// in place of expf). The bf16 kernel computes p = e^(s - m) as the
// accurate exp2f of (s - m) * log2 e, log2 e folded in (see below).
//
// What bounds it on this card: two matrix products, QK^T and PV, so it is
// bound by operations, not bytes (in bf16 some 440 operations a byte at
// qwen2-1.5b's shapes and 1,366 at a gemma2-9b layer's, against the ~295
// above which the tensor cores, not HBM, are the limit): 989 TFLOP/s of
// bf16 tensor-core work. The reference keeps P in fp32, and a PV over P
// rounded once to bf16 (what SDPA and flex_attention do) misses the plain
// version by ~3e-3, far outside the port's check (1 bf16 ulp + 2e-5).
//
// The bf16 design, `flash_fwd_wgmma`:
//   * QK^T on the tensor cores: wgmma.mma_async m64nBKk16 .f32.bf16.bf16
//     with Q and K both K-major in shared memory. Products of bf16 values
//     are exact in fp32 and the sums are fp32, as the reference's fp32 dot
//     of upcast bf16 inputs.
//   * PV on the tensor cores with P split in two: P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi), built in registers from the fp32 scores'
//     accumulator (the fp32 C-fragment of QK^T, 16 columns at a time, is
//     the bf16 A-fragment of PV), go in as the register A operand of two
//     wgmma (RS form) against the same V tile, V the B operand MN-major
//     (the transpose bit), both into one fp32 O accumulator. P_hi + P_lo
//     carries ~16 bits of P's 24, and the emulation of this arithmetic
//     (tests/test_torch_flash_hopper.py) stays within ~6e-6 of the plain
//     version. It costs 1.5x the bound's tensor-core work: PV runs twice.
//   * Warp specialisation: warpgroups 0 and 1 consume, 64 query rows each
//     (a 128-row q-tile); warpgroup 2 produces, one thread issuing TMA
//     (cp.async.bulk.tensor) loads of Q once and of K/V tiles into a
//     2-stage ring, with mbarriers for "full" (transaction bytes) and
//     "free" (one arrival per consumer warp; K is freed after QK^T, V after
//     PV); setmaxnreg moves registers from the producer (24) to the
//     consumers (240).
//   * The consumers' schedule: tile i's step issues QK^T of tile i and PV
//     of tile i - 1 together, the two warpgroups taking turns (named
//     barriers), so one's softmax runs while the other's GEMMs do; at
//     hd <= 128 the softmax's max, exp and sums also run under the same
//     warpgroup's PV (two commit groups, wait_group 1). Scale, cap and mask
//     run as one branch-free loop for each of their four combinations: a
//     branch per score left each score's latency exposed, with only two
//     warps to a scheduler. p is exp2f((s - m) log2 e): the accurate
//     exp2f with log2 e folded in skips expf's range reduction; the two
//     agree within a few fp32 ulps of p, and the output stays within the
//     check.
//   * TMA through 3-D tensor maps, (hd, S, B*H) for q and (hd, S, B*Hkv)
//     for k and v, so a tile past S is zero-filled instead of reading the
//     next head's rows and the GQA head h / G is a coordinate. Shared
//     memory is 128-byte swizzled (64-byte at hd 32): a box is at most one
//     swizzle span wide (64 bf16 values), so hd 128 and 256 tiles load as
//     64-column boxes, which are also the wgmma descriptors' swizzle atoms.
//     The maps are encoded per launch on the host (cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint: the library links only the
//     runtime) and passed as __grid_constant__ parameters.
//   * Masks only where they bite: the causal, window and S-edge predicates
//     run only on tiles that straddle the diagonal, the window edge or S.
//     The grid walks the q-tiles with the most live k-tiles first (the
//     causal tail does not leave SMs idle) and puts the G q-heads of one
//     KV head side by side, for L2 reuse of K/V. Rows past S are not
//     stored (plain, masked stores from the O fragment).
//   * Tiles, block_q x block_k: 128 x 128 at hd <= 128 and 128 x 64 at
//     hd 256. Per consumer thread O is hd/2 fp32 registers (128 at hd
//     256), S BK/2 (64 or 32), P_hi and P_lo BK/4 each. At hd 256 a
//     128-wide k-tile would need 128 + 64 + 64, above the 240 registers a
//     consumer gets, so it takes 64; and even then O, S and both P
//     fragments live at once spilled, so at hd 256 PV completes before
//     QK^T is issued. ptxas then reports no spill and no serialized wgmma
//     for any instance (chip_smoke.py fails on either). Shared memory: Q
//     128 x hd plus 2 stages of K and V (BK x hd each): 40, 80, 160 and
//     192 KB at hd 32, 64, 128 and 256.
//   * No watchdog on the mbarrier waits: a clock and a trap in the wait
//     loop cost the consumers their setmaxnreg budget (ptxas kept them at
//     the launch's 168 registers, spilled, and serialized the wgmma).
//
// fp32 inputs stay on `flash_fwd_simt`: wgmma on fp32 operands is TF32,
// which would drop the reference's fp32 products, and no full-width caller
// runs fp32 attention. One block of 256 threads (16 x 16) per (q-tile,
// head, batch), 64 x 64 tiles; a loop over k-tiles takes the place of the
// TPU grid's sequential k axis. Thread (tx, ty) owns query rows ty + 16 i
// and, in turn, score columns tx + 16 j and output columns tx + 16 j, so a
// row's 16 owners are one half-warp and its max and sum are four shuffles
// each. The Q tile and each K/V tile are staged in shared memory as fp32
// (Q and K transposed and padded by one column, so both the transposing
// stores and the product's loads are free of bank conflicts); P goes
// through shared memory between the two products. Scores, m, l and the
// output accumulator stay in fp32 registers (64 accumulators a thread at
// hd = 256). At hd = 256 the block needs 215,296 bytes of shared memory,
// granted as dynamic shared memory after cudaFuncSetAttribute. Its
// ceiling is the card's fp32 rate, 67 TFLOP/s.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// fp32: the SIMT kernel
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // block_q = block_k = 64 at every head dim

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

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
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
               int S, int causal, int has_window, int window, float scale,
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

template <int HD>
cudaError_t launch(const Args& a) {
  auto kern = flash_fwd_simt<float, HD, kTile, kTile>;
  const size_t smem = Smem<HD, kTile, kTile>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.H, a.Hkv,
      a.S, a.causal, a.has_window, a.window, a.scale, a.has_softcap,
      a.softcap);
  return cudaGetLastError();
}

cudaError_t by_head_dim(const Args& a, int hd, int bq, int bk) {
  if (bq != kTile || bk != kTile) return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch<32>(a);
    case 64: return launch<64>(a);
    case 128: return launch<128>(a);
    case 256: return launch<256>(a);
    default: return cudaErrorInvalidValue;
  }
}

size_t smem_bytes(int hd) {
  switch (hd) {
    case 32: return Smem<32, kTile, kTile>::kBytes;
    case 64: return Smem<64, kTile, kTile>::kBytes;
    case 128: return Smem<128, kTile, kTile>::kBytes;
    case 256: return Smem<256, kTile, kTile>::kBytes;
    default: return 0;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: the wgmma kernel
// ---------------------------------------------------------------------------

namespace hopper {

// Operand lists of the wgmma wrappers below.
#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F8(i) F4(i), F4(i + 4)
#define F16(i) F8(i), F8(i + 8)
#define F32(i) F16(i), F16(i + 16)
#define F64(i) F32(i), F32(i + 32)
#define F128(i) F64(i), F64(i + 64)

// wgmma.mma_async of one warpgroup for an N-column output: `ss` with both
// operands in shared memory (QK^T; N = block_k), `rs` with A in registers
// and B transposed (PV; N = hd). D's fragment, per thread of warp w, lane t:
// d[i] is row 16 w + t / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4)
// + i % 2.
template <int N>
struct Mma;

template <>
struct Mma<32> {
  // D (64 x 32, fp32) += A (64 x 16, bf16, registers)
  //                     . B (16 x 32, bf16, shared memory, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : F16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  // D (64 x 64, fp32) (+)= A (64 x 16, bf16, shared memory, K-major)
  //                       . B (16 x 64, bf16, shared memory, K-major)
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n}\n"
        : F32(0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D (64 x 64, fp32) += A (64 x 16, bf16, registers)
  //                     . B (16 x 64, bf16, shared memory, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : F32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  // D (64 x 128, fp32) (+)= A (64 x 16, bf16, shared memory, K-major)
  //                       . B (16 x 128, bf16, shared memory, K-major)
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 0;\n}\n"
        : F64(0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D (64 x 128, fp32) += A (64 x 16, bf16, registers)
  //                     . B (16 x 128, bf16, shared memory, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : F64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  // D (64 x 256, fp32) += A (64 x 16, bf16, registers)
  //                     . B (16 x 256, bf16, shared memory, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : F128(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef F4
#undef F8
#undef F16
#undef F32
#undef F64
#undef F128

constexpr int kBQ = 128;        // q rows a block: two consumer warpgroups
constexpr int kStages = 2;      // depth of the K/V ring
constexpr int kThreads = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kConsumerWarps = 8;

// block_k at each head dim (block_q is kBQ)
constexpr int tile_k(int hd) { return hd == 256 ? 64 : 128; }

// Shared memory, in bytes from a 1024-aligned base: Q, the K stages, the V
// stages, then the mbarriers. Each tile is kBoxes boxes of [rows][kBoxCols]
// bf16, one swizzle span wide, as TMA writes them.
template <int HD, int BK>
struct Layout {
  static constexpr int kBoxCols = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = 2 * kBoxCols;  // the swizzle span
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kQBox = kBQ * kRowBytes;
  static constexpr int kKBox = BK * kRowBytes;    // a K or V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKBytes = kBoxes * kKBox;  // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kKBytes;
  static constexpr int kNumBars = 1 + 4 * kStages;  // q; k, v full; k, v free
  static constexpr size_t kBytes = kBar + 8 * kNumBars + 1024;  // + alignment
  static constexpr uint32_t kAtom = 8 * kRowBytes;  // 8 rows: the SBO
  // the descriptors' layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` to complete (no watchdog: see the
// note at the top).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma issue/wait pair (the hardware writes it asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Named barriers 1 and 2 pass the turn to issue GEMMs between the two
// consumer warpgroups (0 is __syncthreads): a warpgroup waits at its own,
// and arrives at the other's once its GEMMs are issued.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

template <int HD, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int B, int H, int Hkv, int S,
                int causal, int has_window, int window, float scale,
                int has_softcap, float softcap) {
  using L = Layout<HD, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  // per stage: K full, V full (transaction bytes); K free, V free (one
  // arrival per consumer warp). K is freed after QK^T, V after PV, one
  // tile later.
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto k_free = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };
  auto v_free = [&](int s) { return bar_q + 8u * (1 + 3 * kStages + s); };

  // block -> (q-tile, batch, kv head, q head in the group): the G q-heads
  // of one kv head side by side, the q-tiles with the most live k-tiles
  // (the last, under a causal mask) first
  const int G = H / Hkv;
  const int nq = (S + kBQ - 1) / kBQ;
  int idx = blockIdx.x;
  const int g = idx % G;
  idx /= G;
  const int hk = idx % Hkv;
  idx /= Hkv;
  const int b = idx % B;
  const int q0 = (nq - 1 - idx / B) * kBQ;
  const int h = hk * G + g;

  // the k-tiles the Pallas `live` predicate keeps, at this kernel's tiles
  const int nk = (S + BK - 1) / BK;
  const int kt_hi = causal ? min(nk, (q0 + kBQ - 1) / BK + 1) : nk;
  int kt_lo = 0;
  if (has_window && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BK;
  const int n = kt_hi - kt_lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_free(s), kConsumerWarps);
      mbar_init(v_free(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 2 * 128 && n > 0) {  // (no load a consumer would not wait for)
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load(sq + x * L::kQBox, &tq, bar_q, x * L::kBoxCols, q0,
                 b * H + h);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const uint32_t ph = ((i / kStages) & 1) ^ 1;  // round 0 passes
        const int row = (kt_lo + i) * BK;
        mbar_wait(k_free(s), ph);
        mbar_expect_tx(k_full(s), L::kKBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(sk + s * L::kKBytes + x * L::kKBox, &tk, k_full(s),
                   x * L::kBoxCols, row, b * Hkv + hk);
        mbar_wait(v_free(s), ph);
        mbar_expect_tx(v_full(s), L::kKBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(sv + s * L::kKBytes + x * L::kKBox, &tv, v_full(s),
                   x * L::kBoxCols, row, b * Hkv + hk);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    //
    // Tile i's step issues QK^T of tile i and PV of tile i - 1 together,
    // in turn with the other warpgroup (named barriers), then does tile
    // i's softmax while the other warpgroup's GEMMs run: the two
    // warpgroups alternate between the tensor cores and the softmax.
    // Within a step the softmax's first half (max, exp, row sums) also
    // overlaps this warpgroup's own PV: QK^T and PV are committed as two
    // groups, and the scores are read once the first is done.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    constexpr int NS = BK / 2;   // score registers a thread
    constexpr int NO = HD / 2;   // output registers a thread
    constexpr int KC = BK / 16;  // 16-key chunks of a tile
    // the softmax overlaps this warpgroup's own PV where O, S and both P
    // fragments fit the 240 registers together; at hd 256 (O alone is
    // 128) they spilled, so there PV completes before QK^T is issued
    constexpr bool kOverlap = HD < 256;
    const int wg = tid / 128;
    const int lane = tid % 32;
    const int qw0 = q0 + 64 * wg;                           // its 64 rows
    const int r0 = qw0 + 16 * ((tid / 32) % 4) + lane / 4;  // and r0 + 8
    const int cq = 2 * (lane % 4);  // column of d[0] in each 8-column chunk
    // Q rows of this warpgroup, K-major (LBO unused: 16 bytes)
    const uint32_t q_addr = sq + 64 * wg * L::kRowBytes;

    float acc[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] = 0.f;
    float sc[NS];                        // S of the tile, then its fp32 p
    uint32_t p_hi[KC][4], p_lo[KC][4];   // its P as two bf16 A fragments
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float alpha[2];

    // S = Q K^T of tile i, issued (K-major K from stage i % kStages)
    auto issue_qk = [&](int i) {
      const uint32_t k_addr = sk + (i % kStages) * L::kKBytes;
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[j] = 0.f;
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t box = kk * 16 / L::kBoxCols;
        const uint32_t col = (kk * 16 % L::kBoxCols) * 2;
        Mma<BK>::ss(sc,
                    desc(q_addr + box * L::kQBox + col, 16, L::kAtom,
                         L::kSwizzle),
                    desc(k_addr + box * L::kKBox + col, 16, L::kAtom,
                         L::kSwizzle),
                    kk > 0);
      }
    };
    // O += P_hi V + P_lo V of tile i, issued (V MN-major: LBO the step
    // between its 64-column boxes)
    auto issue_pv = [&](int i) {
      const uint32_t v_addr = sv + (i % kStages) * L::kKBytes;
      fence_regs(acc);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const uint64_t dv = desc(v_addr + c * 16 * L::kRowBytes, L::kKBox,
                                 L::kAtom, L::kSwizzle);
        Mma<HD>::rs(acc, p_hi[c], dv);
        Mma<HD>::rs(acc, p_lo[c], dv);
      }
    };
    // tile i's scores: scale, cap, mask (only where a mask bites), the row
    // max and alpha; p = expf(s - m) in place, and l from the fp32 p
    // (scale, cap and mask in one branch-free loop per combination: a
    // branch per score left each score's latency exposed)
    auto cap_and_mask = [&](auto cap, auto mask, int k0) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float x = sc[j] * scale;
        if constexpr (decltype(cap)::value) x = tanhf(x / softcap) * softcap;
        if constexpr (decltype(mask)::value) {
          const int row = r0 + 8 * ((j >> 1) & 1);
          const int col = k0 + 8 * (j >> 2) + cq + (j & 1);
          const bool keep = (col < S) & (!causal | (col <= row)) &
                            (!has_window | (col > row - window));
          // -inf, not the reference's -1e30: m starts at -1e30, so a
          // masked score leaves the max as -1e30 would, and its p,
          // expf(-inf - m), is the 0 the reference writes over it
          x = keep ? x : -INFINITY;
        }
        sc[j] = x;
      }
    };
    auto softmax = [&](int i) {
      const int k0 = (kt_lo + i) * BK;
      const bool masked = (causal && k0 + BK - 1 > qw0) ||
                          (has_window && k0 <= qw0 + 63 - window) ||
                          k0 + BK > S;
      if (has_softcap) {
        if (masked) cap_and_mask(std::true_type(), std::true_type(), k0);
        else cap_and_mask(std::true_type(), std::false_type(), k0);
      } else {
        if (masked) cap_and_mask(std::false_type(), std::true_type(), k0);
        else cap_and_mask(std::false_type(), std::false_type(), k0);
      }
      // the row max and sum over 4 partials a row (t = the 8-column chunk
      // mod 4), for short dependency chains
      float mx[2][4], sum[2][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) (&mx[0][0])[j] = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int r = (j >> 1) & 1, t = (j >> 2) & 3;
        mx[r][t] = fmaxf(mx[r][t], sc[j]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_cur = fmaxf(m[r], x);
        alpha[r] = expf(m[r] - m_cur);
        m[r] = m_cur;
#pragma unroll
        for (int t = 0; t < 4; ++t) sum[r][t] = 0.f;
      }
      // p = e^(s - m) as exp2f((s - m) log2 e) (see the note at the top)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int r = (j >> 1) & 1, t = (j >> 2) & 3;
        sc[j] = exp2f((sc[j] - m[r]) * kLog2e);
        sum[r][t] += sc[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] + ((sum[r][0] + sum[r][1]) +
                                  (sum[r][2] + sum[r][3]));
    };
    // once PV of the previous tile is done: O *= alpha, and P_hi =
    // bf16(p), P_lo = bf16(p - P_hi) as the A fragments of 16-key chunks
    // (a[j] holds d[8c + 2j], d[8c + 2j + 1] of the C fragment)
    auto split_p = [&]() {
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] *= alpha[(j >> 1) & 1];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p0 = sc[8 * c + 2 * j], p1 = sc[8 * c + 2 * j + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[c][j] = bf16x2_bits(hi);
          p_lo[c][j] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x,
                                                          p1 - hf.y));
        }
      }
    };
    auto phase = [](int i) { return static_cast<uint32_t>(i / kStages) & 1; };

    if (n > 0) {
      if (wg == 1) turn_pass(1);  // warpgroup 0 takes the first turn
      mbar_wait(bar_q, 0);
      // tile 0: QK^T only
      mbar_wait(k_full(0), 0);
      turn_wait(wg);
      wgmma_fence();
      issue_qk(0);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_free(0));
      softmax(0);
      split_p();
      // tile i: QK^T of i and PV of i - 1
      for (int i = 1; i < n; ++i) {
        mbar_wait(k_full(i % kStages), phase(i));
        mbar_wait(v_full((i - 1) % kStages), phase(i - 1));
        turn_wait(wg);
        if constexpr (kOverlap) {
          wgmma_fence();
          issue_qk(i);
          wgmma_commit();
          issue_pv(i - 1);
          wgmma_commit();
          turn_pass(wg);
          wgmma_wait<1>();  // QK^T is done; PV runs on under the softmax
          fence_regs(sc);
          if (lane == 0) mbar_arrive(k_free(i % kStages));
          softmax(i);
          wgmma_wait<0>();
          fence_regs(acc);
          if (lane == 0) mbar_arrive(v_free((i - 1) % kStages));
        } else {
          // PV first, so that its P fragments are free before S is
          // written: O, P and S are never live at once
          wgmma_fence();
          issue_pv(i - 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          if (lane == 0) mbar_arrive(v_free((i - 1) % kStages));
          wgmma_fence();
          issue_qk(i);
          wgmma_commit();
          turn_pass(wg);
          wgmma_wait<0>();
          fence_regs(sc);
          if (lane == 0) mbar_arrive(k_free(i % kStages));
          softmax(i);
        }
        split_p();
      }
      // PV of the last tile; the last turn of warpgroup 1 passes to none
      mbar_wait(v_full((n - 1) % kStages), phase(n - 1));
      turn_wait(wg);
      wgmma_fence();
      issue_pv(n - 1);
      wgmma_commit();
      if (wg == 0) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // out = acc / max(l, 1e-30), rows past S not stored
    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      denom[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* oh = o + (size_t)(b * H + h) * S * HD;
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      const int r = (j >> 1) & 1;
      const int row = r0 + 8 * r;
      if (row < S) {
        const int col = 8 * (j >> 2) + cq;
        *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)row * HD + col) =
            __floats2bfloat162_rn(acc[j] / denom[r], acc[j + 1] / denom[r]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the runtime, so it is looked up once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (hd, S, heads) bf16, boxes of [rows][one swizzle span]; rows and heads
// past the tensor's end are zero-filled.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd,
              int S, int heads, int rows) {
  const int cols = hd < 64 ? hd : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)S * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const Args& a) {
  constexpr int BK = tile_k(HD);
  using L = Layout<HD, BK>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(enc, &mq, a.q, HD, a.S, a.B * a.H, kBQ) ||
      !make_map(enc, &mk, a.k, HD, a.S, a.B * a.Hkv, BK) ||
      !make_map(enc, &mv, a.v, HD, a.S, a.B * a.Hkv, BK))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma<HD, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.S + kBQ - 1) / kBQ) * a.B * a.H;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, L::kBytes, a.stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.o), a.B, a.H, a.Hkv, a.S,
      a.causal, a.has_window, a.window, a.scale, a.has_softcap, a.softcap);
  return cudaGetLastError();
}

cudaError_t by_head_dim(const Args& a, int hd, int bq, int bk) {
  if (bq != kBQ || bk != tile_k(hd)) return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch<32>(a);
    case 64: return launch<64>(a);
    case 128: return launch<128>(a);
    case 256: return launch<256>(a);
    default: return cudaErrorInvalidValue;
  }
}

size_t smem_bytes(int hd) {
  switch (hd) {
    case 32: return Layout<32, tile_k(32)>::kBytes;
    case 64: return Layout<64, tile_k(64)>::kBytes;
    case 128: return Layout<128, tile_k(128)>::kBytes;
    case 256: return Layout<256, tile_k(256)>::kBytes;
    default: return 0;
  }
}

}  // namespace hopper

}  // namespace

// Launches K6 on `stream` without synchronising: the wgmma kernel for bf16
// inputs, the SIMT kernel for fp32. (block_q, block_k) must be the
// instance's tile. Returns the launch's cudaError_t (0 on success); a
// refused launch never runs, so the caller must check it.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int S, int hd, int is_bf16, int causal, int has_window,
    int window, float scale, int has_softcap, float softcap, int block_q,
    int block_k, void* stream) {
  const Args a{q, k, v, o, B, H, Hkv, S, causal, has_window, window, scale,
               has_softcap, softcap, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? hopper::by_head_dim(a, hd, block_q, block_k)
                 : simt::by_head_dim(a, hd, block_q, block_k);
}

// The dynamic shared memory a launch at head dim `hd` asks for, in bytes
// (bf16: the wgmma kernel's, with 1 KB of alignment slack; fp32: the SIMT
// kernel's); 0 for a head dim without an instance.
extern "C" long long repro_flash_attention_smem_bytes(int hd, int is_bf16) {
  return static_cast<long long>(is_bf16 ? hopper::smem_bytes(hd)
                                        : simt::smem_bytes(hd));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
