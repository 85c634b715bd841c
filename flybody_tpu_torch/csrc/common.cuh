// Shared helpers of the stage kernels: the constant-table pack that each
// block stages into shared memory, and small 3-vector / quaternion /
// spatial-vector routines on plain float arrays (one thread per env).
//
// Table pack layout (built by flybody_tpu_torch/ops/_pack.py):
//   floats: every float table, concatenated;
//   ints:   [float offsets (NF) | int offsets (NI) | int tables...]
// Offsets are absolute within their own array. A kernel names its tables
// with two enums whose order matches the Python list of table names.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define FB_API extern "C" __attribute__((visibility("default")))

struct Tables {
  const float* f;  // shared-memory copy of the float tables
  const int* i;    // shared-memory copy of the int pack
  int nf;          // number of float tables
  __device__ __forceinline__ const float* F(int t) const { return f + i[t]; }
  __device__ __forceinline__ const int* I(int t) const { return i + i[nf + t]; }
};

// Copies both packs into dynamic shared memory (floats first, then ints)
// and returns a view on the copy. All threads of the block take part.
__device__ __forceinline__ Tables stage_tables(const float* fpack, int nfloat,
                                               const int* ipack, int nint,
                                               int nf) {
  extern __shared__ float smem_tables[];
  float* sf = smem_tables;
  int* si = reinterpret_cast<int*>(smem_tables + nfloat);
  for (int k = threadIdx.x; k < nfloat; k += blockDim.x) sf[k] = fpack[k];
  for (int k = threadIdx.x; k < nint; k += blockDim.x) si[k] = ipack[k];
  __syncthreads();
  Tables t;
  t.f = sf;
  t.i = si;
  t.nf = nf;
  return t;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// q1 * q2 (Hamilton), (w, x, y, z).
__device__ __forceinline__ void qmul(const float* a, const float* b,
                                     float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w;
  o[1] = x;
  o[2] = y;
  o[3] = z;
}

// R(q) v, expanded Rodrigues form divided by |q|^2 (the JAX package's
// rotate_vec_with_quat, exact for non-unit q).
__device__ __forceinline__ void qrot(const float* q, const float* v,
                                     float* o) {
  const float* u = q + 1;
  float s = q[0] * q[0] + dot3(u, u);
  float uv[3];
  cross3(u, v, uv);
  float a = s - 2.0f * dot3(u, u);
  float b = 2.0f * dot3(u, v);
  float inv = 1.0f / fmaxf(s, 1e-12f);
  float r0 = (v[0] * a + u[0] * b + 2.0f * q[0] * uv[0]) * inv;
  float r1 = (v[1] * a + u[1] * b + 2.0f * q[0] * uv[1]) * inv;
  float r2 = (v[2] * a + u[2] * b + 2.0f * q[0] * uv[2]) * inv;
  o[0] = r0;
  o[1] = r1;
  o[2] = r2;
}

__device__ __forceinline__ void qnormalize(float* q) {
  float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  float inv = 1.0f / fmaxf(n, 1e-12f);
  for (int k = 0; k < 4; ++k) q[k] *= inv;
}

// Row-major rotation matrix of a unit quaternion.
__device__ __forceinline__ void qmat(const float* q, float* m) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  m[0] = 1 - 2 * (yy + zz);
  m[1] = 2 * (xy - wz);
  m[2] = 2 * (xz + wy);
  m[3] = 2 * (xy + wz);
  m[4] = 1 - 2 * (xx + zz);
  m[5] = 2 * (yz - wx);
  m[6] = 2 * (xz - wy);
  m[7] = 2 * (yz + wx);
  m[8] = 1 - 2 * (xx + yy);
}

// o = M^T v for a row-major 3x3 M.
__device__ __forceinline__ void matTvec(const float* m, const float* v,
                                        float* o) {
  float x = m[0] * v[0] + m[3] * v[1] + m[6] * v[2];
  float y = m[1] * v[0] + m[4] * v[1] + m[7] * v[2];
  float z = m[2] * v[0] + m[5] * v[1] + m[8] * v[2];
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

// o = M v for a row-major 3x3 M.
__device__ __forceinline__ void matvec(const float* m, const float* v,
                                       float* o) {
  float x = m[0] * v[0] + m[1] * v[1] + m[2] * v[2];
  float y = m[3] * v[0] + m[4] * v[1] + m[5] * v[2];
  float z = m[6] * v[0] + m[7] * v[1] + m[8] * v[2];
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

// Spatial motion cross product v x_m m, (angular; linear).
__device__ __forceinline__ void motion_cross(const float* v, const float* m,
                                             float* o) {
  float a[3], b[3], c[3];
  cross3(v, m, a);
  cross3(v, m + 3, b);
  cross3(v + 3, m, c);
  o[0] = a[0];
  o[1] = a[1];
  o[2] = a[2];
  o[3] = b[0] + c[0];
  o[4] = b[1] + c[1];
  o[5] = b[2] + c[2];
}

// Spatial force cross product v x_f f.
__device__ __forceinline__ void force_cross(const float* v, const float* f,
                                            float* o) {
  float a[3], b[3], c[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  cross3(v, f + 3, c);
  o[0] = a[0] + b[0];
  o[1] = a[1] + b[1];
  o[2] = a[2] + b[2];
  o[3] = c[0];
  o[4] = c[1];
  o[5] = c[2];
}

// o = I v for a row-major 6x6 I.
__device__ __forceinline__ void mat6vec(const float* I, const float* v,
                                        float* o) {
  for (int r = 0; r < 6; ++r) {
    float s = 0.f;
    for (int c = 0; c < 6; ++c) s += I[r * 6 + c] * v[c];
    o[r] = s;
  }
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  float s = 0.f;
  for (int k = 0; k < 6; ++k) s += a[k] * b[k];
  return s;
}

// r / d, correctly rounded: a zero r over a d that is neither zero nor
// NaN gives the zero of the two signs' product without the division,
// whose fast path sends a zero numerator to its slow path (half the envs
// of the two-fly bench state have a zero right-hand side, and most of the
// Woodbury columns of the arrow Newton step are zero on a limb; PERF.md).
__device__ __forceinline__ float div_rn(float r, float d) {
  if (r == 0.f && d != 0.f && d == d)
    return __int_as_float((__float_as_int(r) ^ __float_as_int(d)) &
                          0x80000000);
  return r / d;
}

// Sum over the 32 lanes of a warp; every lane returns the total.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Launch geometry shared by the one-thread-per-env stage kernels.
constexpr int kEnvThreads = 32;

inline int env_blocks(int B) { return (B + kEnvThreads - 1) / kEnvThreads; }

// Sets the dynamic shared memory limit a kernel needs above 48 KB and
// returns the bytes for the launch.
template <typename K>
inline size_t table_smem(K kernel, int nfloat, int nint) {
  size_t bytes = sizeof(float) * (size_t)nfloat + sizeof(int) * (size_t)nint;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  return bytes;
}
