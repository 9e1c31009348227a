// Declarations of the CUDA runtime and device names that
// ldt_torch/csrc/*.cu use, for a host compiler's syntax check of the
// sources (tests/test_torch_port_csrc_syntax.py). Nothing here runs.
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __syncthreads() ((void)0)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 threadIdx, blockIdx, blockDim, gridDim;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int);
template <typename K, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t*, K, A...);
cudaError_t cudaGetLastError();
cudaError_t cudaGetDevice(int*);
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
const char* cudaGetErrorString(cudaError_t);

float __fsub_rn(float, float);
float __fmul_rn(float, float);
float __fadd_rn(float, float);
float __shfl_xor_sync(unsigned, float, int);
int __shfl_xor_sync(unsigned, int, int);
unsigned __shfl_sync(unsigned, unsigned, int);
float __shfl_sync(unsigned, float, int);
unsigned __reduce_min_sync(unsigned, unsigned);
void __syncwarp(unsigned mask = 0xffffffffu);
unsigned atomicMin(unsigned*, unsigned);
unsigned __float_as_uint(float);
float __uint_as_float(unsigned);
int __float_as_int(float);
float __int_as_float(int);
template <typename T>
T __ldg(const T*);
int min(int, int);
int max(int, int);
unsigned min(unsigned, unsigned);
long long min(long long, long long);
int __dp4a(int, int, int);
size_t __cvta_generic_to_shared(const void*);
