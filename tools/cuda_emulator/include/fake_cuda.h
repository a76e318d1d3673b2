// The CUDA surface the port's kernels use, for compiling them with a host
// C++ compiler (see emulate.py): qualifiers become nothing, threadIdx is
// per host thread, bf16 rounds to nearest even, and the warp-collective
// operations (ldmatrix, mma.sync, shuffles) and cp.async are functions of
// runtime.cpp that exchange data between the 32 host threads of a warp.
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

struct uint4 {
  unsigned x, y, z, w;
};
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

// compiled with -ffp-contract=off, so each operation rounds on its own
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline size_t __cvta_generic_to_shared(const void* p) {
  return reinterpret_cast<size_t>(p);
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes;
};
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
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
void emu_launch(dim3 grid, int threads, std::function<void()> body);
