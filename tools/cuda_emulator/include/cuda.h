// The driver API types of the tensor maps (see emulate.py): a map is an
// opaque 64-byte block that runtime.cpp's cuTensorMapEncodeTiled fills and
// its TMA copy reads.
#pragma once

#include <cstdint>

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
typedef struct CUtensorMap_st {
  alignas(64) uint64_t opaque[16];
} CUtensorMap;
typedef enum { CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0 } CUtensorMapDataType;
typedef enum { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 } CUtensorMapInterleave;
typedef enum {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0,
  CU_TENSOR_MAP_SWIZZLE_32B,
  CU_TENSOR_MAP_SWIZZLE_64B,
  CU_TENSOR_MAP_SWIZZLE_128B
} CUtensorMapSwizzle;
typedef enum {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
  CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_256B
} CUtensorMapL2promotion;
typedef enum { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 } CUtensorMapFloatOOBfill;
