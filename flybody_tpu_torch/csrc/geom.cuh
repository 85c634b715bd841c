// Vector algebra on 3-vectors in registers, shared by the collision
// kernels (narrowphase.cu, mpr.cu, efc_stage.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}

__device__ __forceinline__ V3 ld3(const float* p) { return v3(p[0], p[1], p[2]); }

__device__ __forceinline__ void st3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}

__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }

__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}

__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return v3(s * a.x, s * a.y, s * a.z);
}

__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return v3(a.x / s, a.y / s, a.z / s);
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }

__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// torch.sign: -1, 0 or 1.
__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// Row-major 3x3 matrix.
struct M3 {
  float m[9];
};

__device__ __forceinline__ M3 ld9(const float* p) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 9; ++i) r.m[i] = p[i];
  return r;
}

__device__ __forceinline__ V3 col(const M3& a, int j) {
  return v3(a.m[j], a.m[3 + j], a.m[6 + j]);
}

// M v
__device__ __forceinline__ V3 mul(const M3& a, V3 v) {
  return v3(a.m[0] * v.x + a.m[1] * v.y + a.m[2] * v.z,
            a.m[3] * v.x + a.m[4] * v.y + a.m[5] * v.z,
            a.m[6] * v.x + a.m[7] * v.y + a.m[8] * v.z);
}

// M^T v
__device__ __forceinline__ V3 mul_t(const M3& a, V3 v) {
  return v3(a.m[0] * v.x + a.m[3] * v.y + a.m[6] * v.z,
            a.m[1] * v.x + a.m[4] * v.y + a.m[7] * v.z,
            a.m[2] * v.x + a.m[5] * v.y + a.m[8] * v.z);
}

// Launch check shared by the C entries: the error of the launch itself
// (a refused launch never runs, and a synchronize would not report it).
inline int launch_status() { return (int)cudaGetLastError(); }
