// The CUDA surface the port's kernels use, for compiling them with a host
// C++ compiler (see emulate.py): qualifiers become nothing, threadIdx is
// per host thread, bf16 rounds to nearest even, and the warp-collective
// operations (ldmatrix, mma.sync, shuffles) and cp.async are functions of
// runtime.cpp that exchange data between the 32 host threads of a warp;
// so are Hopper's mbarriers, TMA tile loads and wgmma (w8a8_matmul.cu).
#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__
#define __grid_constant__
#define CUDART_VERSION 12080

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
extern thread_local uint3 threadIdx;
extern uint3 blockIdx;
extern dim3 gridDim, blockDim;

struct uint2 {
  unsigned x, y;
};
struct uint4 {
  unsigned x, y, z, w;
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
template <class T>
T __ldg(const T* p) {
  return *p;
}
template <class T>
T __ldcg(const T* p) {
  return *p;
}
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}

struct __nv_bfloat16 {
  uint16_t x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = uint32_t(v.x) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  return {uint16_t((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
// max of each half; a NaN in either operand gives the canonical NaN
inline __nv_bfloat16 emu_hmax_nan(__nv_bfloat16 a, __nv_bfloat16 b) {
  const float x = __bfloat162float(a), y = __bfloat162float(b);
  if (x != x || y != y) return {uint16_t(0x7fff)};
  return x < y ? b : a;
}
inline __nv_bfloat162 __hmax2_nan(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {emu_hmax_nan(a.x, b.x), emu_hmax_nan(a.y, b.y)};
}

// compiled with -ffp-contract=off, so each operation rounds on its own
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline size_t __cvta_generic_to_shared(const void* p) {
  return reinterpret_cast<size_t>(p);
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
// prmt in its default mode: byte i of the result is byte s_i of {y, x}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= unsigned((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorNotSupported = 801
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaDriverEntryPointQueryResult {
  cudaDriverEntryPointSuccess = 0,
  cudaDriverEntryPointSymbolNotFound = 1
};
enum { cudaEnableDefault = 0 };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// three SMs, so that a persistent grid walks several tiles a block
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 3;
  return cudaSuccess;
}
cudaError_t cudaGetDriverEntryPointByVersion(const char* name, void** fn,
                                             unsigned version,
                                             unsigned long long flags,
                                             cudaDriverEntryPointQueryResult* q);
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes;
  size_t sharedSizeBytes;
};
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  a->sharedSizeBytes = 0;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

void __syncthreads();
int __syncthreads_or(int pred);
// device-wide atomics and fences; blocks run one at a time (runtime.cpp),
// in an order that changes from launch to launch
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
void __syncwarp();
int __any_sync(unsigned, int pred);
float emu_ex2(float x);
unsigned emu_shfl(unsigned bits, int lane_mask);
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  unsigned u;
  memcpy(&u, &v, 4);
  u = emu_shfl(u, lane_mask);
  T r;
  memcpy(&r, &u, 4);
  return r;
}
void emu_ldsm(uint32_t (&r)[4], const void* row, bool trans);
void emu_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);
void emu_cp_async(void* dst, const void* src, int src_bytes, int bytes);
void emu_commit();
void emu_wait(int pending);
unsigned char* emu_smem();
uint32_t emu_smem_offset(const void* p);
void emu_mbar_init(void* bar, int count);
void emu_mbar_arrive(void* bar, uint32_t tx_bytes);
void emu_mbar_wait(void* bar, uint32_t parity);
void emu_tma_load_2d(void* dst, const void* map, void* bar, int c0, int c1);
void emu_wgmma_s8(int* d, int n, uint64_t da, uint64_t db, int scale_d);
void emu_wgmma_commit();
void emu_wgmma_wait(int pending);
void emu_launch(dim3 grid, int threads, std::function<void()> body);
