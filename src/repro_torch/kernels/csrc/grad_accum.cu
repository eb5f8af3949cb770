// Kernel K1: fused normalized gradient accumulation for Hopper (sm_90a),
// in CUDA C++, over a list of (accumulator, gradient) pairs in one launch.
//
// Replaces repro/kernels/grad_accum.py:110 (`grad_accum`, whose Pallas
// kernel is `_accum_kernel`): paper Fig. 2 step 4 with eq. (14),
// acc <- acc + g * scale, in place on the accumulator, with the scale
// (1/N_Smu or 1/N_B_valid) read from a 1-element fp32 device tensor, so
// nothing syncs with the host.
//
// What bounds it on this card: bytes. Per fp32 element it reads acc and g
// and writes acc, 12 bytes, against two flops: 5.53 ms at 3.35 TB/s for
// qwen2-1.5b's 1,543,714,304-element bucket. A loop over one flat pair
// runs near that bound (as PyTorch's add_ does), so a faster loop has
// almost nothing to win. What step 4 of a flat executor can lose is the
// copy in front of the kernel: the Pallas call takes one operand, so the
// reference concatenates the gradient leaves into a flat buffer first, 8
// more bytes an element (read the leaves, write the copy) and a second
// gradient kept live. This design removes the copy instead of speeding up
// the loop: each gradient leaf is read where autograd left it and added
// into its slice of the flat fp32 accumulator. The function is the same,
// acc_bucket += scale * concat(leaves), element by element.
//
// The design:
//   * The table. The pairs travel by value in the launch's parameter space
//     (a __grid_constant__ struct of up to kMaxEntries (acc, g, n) entries
//     and the prefix of their chunk counts), so a new list of leaves on
//     every micro-batch costs no copy and no host sync. The struct stays
//     under the 4 KB parameter limit; longer lists are split into launches
//     by the Python wrapper.
//   * One block owns one chunk of `block` elements of one entry, found by
//     a binary search over the prefix (read through the constant cache, the
//     same address for every thread). A chunk never spans two entries, and
//     the ragged tail of each entry is masked.
//   * Loads and stores are 16 bytes wide with streaming hints (__ldcs,
//     __stcs: each byte is touched once); 8 bf16 values pair with two fp32
//     vectors. All of a thread's loads are issued before its first store.
//     An entry whose acc or g address is not 16-byte aligned (a leaf at an
//     odd offset of a bucket) takes a scalar loop, still coalesced.
//   * Arithmetic: acc = __fadd_rn(acc, __fmul_rn((float)g, s)), two
//     roundings as the plain version has them; the intrinsics keep nvcc
//     from contracting the two into an FMA (it does by default, and an FMA
//     rounds once). A bf16 accumulator rounds g and the scale to bf16, the
//     product to bf16 and then the sum, as `ref.grad_accum_ref` does in
//     bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxEntries = 128;
constexpr int kUnroll = 4;  // 16-byte vectors a thread loads before storing

struct Table {
  void* acc[kMaxEntries];
  const void* g[kMaxEntries];
  long long n[kMaxEntries];
  int start[kMaxEntries + 1];  // start[e]: the first chunk of entry e
  int count;
};
static_assert(sizeof(Table) + 16 <= 4096, "K1's table must fit the 4 KB "
              "of kernel parameters");

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc + g * s with the plain version's roundings (A: the accumulator's
// type; g already in fp32, exact for a bf16 gradient)
template <typename A>
__device__ __forceinline__ float step(float acc, float g, float s) {
  if constexpr (std::is_same_v<A, float>) {
    return __fadd_rn(acc, __fmul_rn(g, s));
  } else {
    // grad.to(bf16) * scale.to(bf16) rounds to bf16, then the sum does
    const float p = round_bf16(__fmul_rn(round_bf16(g), s));
    return __fadd_rn(acc, p);  // rounded to bf16 by the store
  }
}

// VEC consecutive elements at a 16-byte-aligned address, as fp32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(p) + j);
      out[4 * j] = v.x;
      out[4 * j + 1] = v.y;
      out[4 * j + 2] = v.z;
      out[4 * j + 3] = v.w;
    }
  } else {
    static_assert(VEC == 8, "bf16 vectors hold 8 values");
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[2 * j] = __uint_as_float(w[j] << 16);
      out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      __stcs(reinterpret_cast<float4*>(p) + j,
             make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]));
    }
  } else {
    static_assert(VEC == 8, "bf16 vectors hold 8 values");
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = static_cast<unsigned>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * j]))) |
             (static_cast<unsigned>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * j + 1])))
              << 16);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
}

template <typename T>
__device__ __forceinline__ float load_one(const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    return __ldcs(p);
  } else {
    return __bfloat162float(__ldcs(p));
  }
}

template <typename T>
__device__ __forceinline__ void store_one(T* p, float x) {
  if constexpr (std::is_same_v<T, float>) {
    __stcs(p, x);
  } else {
    __stcs(p, __float2bfloat16_rn(x));
  }
}

template <typename A, typename G>
__global__ void grad_accum_kernel(const __grid_constant__ Table t,
                                  const float* __restrict__ scale,
                                  int block) {
  constexpr int VEC = (sizeof(A) == 2 || sizeof(G) == 2) ? 8 : 4;
  // the entry that owns this chunk: the last e with start[e] <= chunk
  const int chunk = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= chunk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long base = static_cast<long long>(chunk - t.start[lo]) * block;
  const long long len = min(static_cast<long long>(block), t.n[lo] - base);
  A* __restrict__ acc = static_cast<A*>(t.acc[lo]) + base;
  const G* __restrict__ g = static_cast<const G*>(t.g[lo]) + base;
  float s = __ldg(scale);
  if constexpr (!std::is_same_v<A, float>) s = round_bf16(s);

  long long done = 0;
  if (block % VEC == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(g) % 16 == 0) {
    const long long nv = len / VEC;
    const long long stride = blockDim.x;
    for (long long i0 = threadIdx.x; i0 < nv; i0 += kUnroll * stride) {
      float a[kUnroll][VEC], x[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * stride;
        if (i < nv) {
          load_vec<A, VEC>(acc + i * VEC, a[u]);
          load_vec<G, VEC>(g + i * VEC, x[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * stride;
        if (i < nv) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            a[u][j] = step<A>(a[u][j], x[u][j], s);
          }
          store_vec<A, VEC>(acc + i * VEC, a[u]);
        }
      }
    }
    done = nv * VEC;
  }
  // the ragged tail of a vector chunk, or all of an unaligned one
  for (long long i = done + threadIdx.x; i < len; i += blockDim.x) {
    store_one(acc + i, step<A>(load_one(acc + i), load_one(g + i), s));
  }
}

template <typename A, typename G>
cudaError_t launch(const Table& t, int chunks, const float* scale, int block,
                   int warps, cudaStream_t stream) {
  grad_accum_kernel<A, G><<<chunks, 32 * warps, 0, stream>>>(t, scale, block);
  return cudaGetLastError();
}

}  // namespace

// acc[e] += g[e] * (*scale) for each of `count` entries of n[e] elements,
// in one launch on `stream`. acc_bf16 / g_bf16 give the element types (0:
// fp32, 1: bf16), one for all entries; `block` elements a block, 32 *
// `warps` threads. Returns the launch's cudaError (0 when it was queued).
extern "C" int repro_grad_accum(void* const* acc, const void* const* g,
                                const long long* n, int count,
                                const float* scale, int acc_bf16, int g_bf16,
                                int block, int warps, void* stream) {
  if (count < 1 || count > kMaxEntries || block < 1 || warps < 1 ||
      warps > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  long long chunks = 0;
  for (int e = 0; e < count; ++e) {
    if (n[e] < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.acc[e] = acc[e];
    t.g[e] = g[e];
    t.n[e] = n[e];
    t.start[e] = static_cast<int>(chunks);
    chunks += (n[e] + block - 1) / block;
    if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.start[count] = static_cast<int>(chunks);
  t.count = count;
  if (chunks == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(chunks);
  cudaError_t err;
  if (acc_bf16) {
    err = g_bf16 ? launch<bf16, bf16>(t, c, scale, block, warps, s)
                 : launch<bf16, float>(t, c, scale, block, warps, s);
  } else {
    err = g_bf16 ? launch<float, bf16>(t, c, scale, block, warps, s)
                 : launch<float, float>(t, c, scale, block, warps, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
