// The fused substep's forward kinematics for Hopper (sm_90a), one launch
// per call.
//
// Replaces no TPU kernel: the JAX package leaves FK to XLA, which fuses
// its scalarised 3x3 products (dwbc_tpu/sim/fused.py). In eager PyTorch
// the per-body loop is about 20 launches a body (the joint frame's cos,
// sin and scaled adds, the parent's rotation times the joint's, the
// position, and with qd the velocity transform, a cat and the subspace
// term): some 400 launches a call for a 21-body tree, each a few
// microseconds of host time for almost no device work. The profile of the
// training step on the card showed that host time as the largest span of
// the collect once the ABA kernel (csrc/aba.cu) had taken its own. The
// plain PyTorch version it is held against is
// dwbc_tpu_torch/sim/fk.py::fused_fk; the Python wrapper is
// dwbc_tpu_torch/ops/fk_kernel.py.
//
// What it computes, per env: the base's rotation from its xyzw quaternion
// (core/maths.quat_to_mat) at q[0:3]; per body in tree order the joint
// frame from q (sim/tree.py's joint_frame, recomputed the same way as
// csrc/aba.cu does), R = R_pa Rj and p = R_pa pj + p_pa; with qd the body
// spatial velocities [w; u] in body coordinates, the base's [R0^T qd[3:6];
// R0^T qd[0:3]] and a body's [Rj^T w_pa; Rj^T (u_pa + w_pa x pj)] + S qd.
//
// Bound: the kernel must read q, qd and the tree table and write the
// stacks, (9 + 3 + 6) floats per body and env: at 21 bodies x 5,000 envs
// with qd 8.6 MB, 2.6 us at 3.35 TB/s, and at 13 x 4,096 4.4 MB, 1.3 us;
// some 150 flops per body and env, under a microsecond at 67 TFLOP/s. As
// in the ABA kernel, the recursion is a serial chain per env, of which
// the card holds N threads, a warp or two per SM, so a launch is latency-
// bound at some multiple of the byte bound. What the kernel removes is the
// eager version's ~400 host launches a call; a launch of tens of
// microseconds is noise against the milliseconds of host time they cost.
//
// Design: one thread per env, a block of T = 32 envs (one warp). The
// tree's constants (TreeConst.table, the rows csrc/aba.cu reads, uploaded
// once per simulator) go to shared memory at block start; every thread
// reads the same entry, a broadcast. Each env keeps every body's pose
// (R, p and with qd v) in shared memory, laid out [body][slot][lane] so
// that a warp's access to one slot is conflict-free, and reads its
// parent's back from there. The outputs are (nb, N, k) stacks: a warp's 32
// envs write one contiguous run per body. q and qd are read a row per
// env, a stride from lane to lane. At 21 bodies with qd a block takes
// 50.7 KB of shared memory (dynamic; the launch raises the limit).
//
// Numerics: float32 with no fast-math and no TF32, every operation rounded
// on its own and in the order the plain version's eager operations round
// it on the card, as measured on an NVIDIA H100 with torch 2.11 (cuBLAS's
// batched 3x3 products accumulate a0 b0, then fuse a1 b1 and a2 b2; its
// matrix-vector products fuse a1 b1 into a0 b0 and add a2 b2; cosf and
// sinf equal sincosf; each elementwise operation rounds once). So at the
// shapes the benchmark runs (4,096 to 8,192 envs) the poses equal the
// eager ones bit for bit. That matters: the benchmark's reference repeats
// env steps with the eager FK, and a pose off by one rounding can move a
// contact sphere or a terrain sample across a discontinuity (one env's
// contact flip, 4.2e-4 over the widowGo1 cell's env_gap limit of 4e-4,
// when the kernel left the order to the compiler). The poses matched at
// every shape tried, 5 to 8,192 envs; where cuBLAS rounds otherwise (at 5
// and 2,048 envs its matrix-vector products fuse all three terms, so the
// velocities differ there), the two agree to float32 rounding. The subspace
// term adds S qd to all six components, as the plain version does, so a
// NaN or inf in qd spreads over the body's velocity in both.

#include <cstdint>
#include <cuda_runtime.h>

#define NB_MAX 32
#define T 32        // envs (threads) per block
#define TABLE_W 28  // columns of the tree table (sim/tree.py)

namespace {

// tree table columns (sim/tree.py)
enum { PARENT = 0, PRISMATIC = 1, AXIS = 2, TREE_ROT = 5, TREE_POS = 14,
       PRISM_DIR = 17 };

// per-body slots in shared memory: R (row-major), p, then with qd v
enum { S_R = 0, S_P = 9, S_V = 12 };

// Every operation below is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fmaf_rn: never contracted), in the order the eager version
// rounds it on the card (the source note, Numerics).

// a three-term dot product as cuBLAS's batched matrix products round it:
// a0 b0, then a1 b1 and a2 b2 each fused into the sum
__device__ __forceinline__ float dot_mm(float a0, float a1, float a2,
                                        float b0, float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// and as its matrix-vector products round it: a1 b1 fused into a0 b0,
// plus a2 b2
__device__ __forceinline__ float dot_mv(float a0, float a1, float a2,
                                        float b0, float b1, float b2) {
  return __fadd_rn(__fmaf_rn(a1, b1, __fmul_rn(a0, b0)), __fmul_rn(a2, b2));
}

// R^T x for a row-major 3x3 R, as the eager matrix-vector product
__device__ __forceinline__ void mtv(const float* R, const float* x, float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = dot_mv(R[r], R[3 + r], R[6 + r], x[0], x[1], x[2]);
}

// a x b as torch.linalg.cross computes it on the card
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  o[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  o[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// the joint frame (Rj, pj) of a body from its table row and its joint
// coordinate (sim/tree.py's joint_frame, the formula csrc/aba.cu uses):
// revolute Ra = (c I + (1 - c) a a^T) + s skew(a), Rj = tree_rot Ra, at
// tree_pos; prismatic tree_rot at tree_pos + prism_dir q. a a^T is formed
// in float32, where the plain version rounds the float64 product: the
// same numbers for the unit axes of every tree the tasks load
__device__ __forceinline__ void joint_frame(const float* tb, bool prism,
                                            float qj, float cq, float sq,
                                            float* Rj, float* pj) {
  const float* tr = tb + TREE_ROT;
  if (prism) {
#pragma unroll
    for (int k = 0; k < 9; ++k) Rj[k] = tr[k];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      pj[k] = __fadd_rn(tb[TREE_POS + k], __fmul_rn(tb[PRISM_DIR + k], qj));
    return;
  }
  const float a0 = tb[AXIS], a1 = tb[AXIS + 1], a2 = tb[AXIS + 2];
  const float a[3] = {a0, a1, a2};
  const float sk[9] = {0.0f, -a2, a1, a2, 0.0f, -a0, -a1, a0, 0.0f};
  const float omc = __fsub_rn(1.0f, cq);
  float Ra[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Ra[r * 3 + c] = __fadd_rn(
          __fadd_rn(__fmul_rn(r == c ? 1.0f : 0.0f, cq),
                    __fmul_rn(__fmul_rn(a[r], a[c]), omc)),
          __fmul_rn(sk[r * 3 + c], sq));
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Rj[r * 3 + c] = dot_mm(tr[r * 3], tr[r * 3 + 1], tr[r * 3 + 2], Ra[c],
                             Ra[3 + c], Ra[6 + c]);
#pragma unroll
  for (int k = 0; k < 3; ++k) pj[k] = tb[TREE_POS + k];
}

// VEL: whether qd is given and the velocities are computed; W is the
// floats per body and env in shared memory
template <bool VEL>
__global__ void __launch_bounds__(T) fk_kernel(
    const float* __restrict__ q, const float* __restrict__ qd,
    const float* __restrict__ tree, float* __restrict__ Rs,
    float* __restrict__ ps, float* __restrict__ vs, int nb, int n) {
  constexpr int W = VEL ? 18 : 12;
  extern __shared__ float smem[];
  float* tbl = smem;                  // (nb, TABLE_W)
  float* sw = smem + nb * TABLE_W;    // (nb, W, T)
  const int lane = threadIdx.x;
  for (int i = lane; i < nb * TABLE_W; i += T) tbl[i] = tree[i];
  __syncthreads();
  const int e = blockIdx.x * T + lane;
  if (e >= n) return;

  const uint32_t un = (uint32_t)n, ue = (uint32_t)e;
  const float* qe = q + ue * (uint32_t)(nb + 6);
  const float* qde = VEL ? qd + ue * (uint32_t)(nb + 5) : nullptr;
  // slot k of body b of this env
#define SW(b, k) sw[((b) * W + (k)) * T + lane]

  // ---- the base: R0 from the xyzw quaternion, p0 = q[0:3],
  // v0 = [R0^T qd[3:6]; R0^T qd[0:3]]
  {
    const float x = qe[3], y = qe[4], z = qe[5], w = qe[6];
    const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
    const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z), yz = __fmul_rn(y, z);
    const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y), wz = __fmul_rn(w, z);
    // core/maths.quat_to_mat: 1 - 2 (yy + zz), 2 (xy - wz), ...
    const float R[9] = {
        __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(yy, zz))),
        __fmul_rn(2.0f, __fsub_rn(xy, wz)), __fmul_rn(2.0f, __fadd_rn(xz, wy)),
        __fmul_rn(2.0f, __fadd_rn(xy, wz)),
        __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(xx, zz))),
        __fmul_rn(2.0f, __fsub_rn(yz, wx)), __fmul_rn(2.0f, __fsub_rn(xz, wy)),
        __fmul_rn(2.0f, __fadd_rn(yz, wx)),
        __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(xx, yy)))};
    float* Ro = Rs + ue * 9u;
    float* po = ps + ue * 3u;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      SW(0, S_R + k) = R[k];
      Ro[k] = R[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      SW(0, S_P + k) = qe[k];
      po[k] = qe[k];
    }
    if constexpr (VEL) {
      const float lin[3] = {qde[0], qde[1], qde[2]};
      const float ang[3] = {qde[3], qde[4], qde[5]};
      float v[6];
      mtv(R, ang, v);
      mtv(R, lin, v + 3);
      float* vo = vs + ue * 6u;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        SW(0, S_V + k) = v[k];
        vo[k] = v[k];
      }
    }
  }

  // ---- the bodies in tree order (every parent precedes its children)
  for (int i = 1; i < nb; ++i) {
    const float* tb = tbl + i * TABLE_W;
    const int pa = (int)tb[PARENT];
    const bool prism = tb[PRISMATIC] != 0.0f;
    const float qj = qe[6 + i];
    float cq = 0.0f, sq = 0.0f;
    if (!prism) sincosf(qj, &sq, &cq);
    float Rj[9], pj[3];
    joint_frame(tb, prism, qj, cq, sq, Rj, pj);

    float Rp[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rp[k] = SW(pa, S_R + k);
    // R = R_pa Rj, p = R_pa pj + p_pa
    float R[9], p[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        R[r * 3 + c] = dot_mm(Rp[r * 3], Rp[r * 3 + 1], Rp[r * 3 + 2], Rj[c],
                              Rj[3 + c], Rj[6 + c]);
      p[r] = __fadd_rn(dot_mv(Rp[r * 3], Rp[r * 3 + 1], Rp[r * 3 + 2], pj[0],
                              pj[1], pj[2]),
                       SW(pa, S_P + r));
    }
    const uint32_t row = (uint32_t)i * un + ue;
    float* Ro = Rs + row * 9u;
    float* po = ps + row * 3u;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      SW(i, S_R + k) = R[k];
      Ro[k] = R[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      SW(i, S_P + k) = p[k];
      po[k] = p[k];
    }

    if constexpr (VEL) {
      // [Rj^T w_pa; Rj^T (u_pa + w_pa x pj)] + S qd, S = [a; 0] revolute,
      // [0; a] prismatic
      const float wp[3] = {SW(pa, S_V), SW(pa, S_V + 1), SW(pa, S_V + 2)};
      float t[3];
      cross3(wp, pj, t);
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = __fadd_rn(SW(pa, S_V + 3 + k), t[k]);
      float v[6];
      mtv(Rj, wp, v);
      mtv(Rj, t, v + 3);
      const float qdj = qde[5 + i];
      const int o = prism ? 3 : 0;
      float* vo = vs + row * 6u;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float s = (k >= o && k < o + 3) ? tb[AXIS + k - o] : 0.0f;
        v[k] = __fadd_rn(v[k], __fmul_rn(s, qdj));
        SW(i, S_V + k) = v[k];
        vo[k] = v[k];
      }
    }
  }
#undef SW
}

template <bool VEL>
int launch(const float* q, const float* qd, const float* tree, float* Rs,
           float* ps, float* vs, int nb, int n, cudaStream_t stream) {
  constexpr int W = VEL ? 18 : 12;
  const size_t smem = ((size_t)nb * TABLE_W + (size_t)nb * W * T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fk_kernel<VEL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fk_kernel<VEL><<<dim3((n + T - 1) / T), dim3(T), smem, stream>>>(
      q, qd, tree, Rs, ps, vs, nb, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success). Pointers are device pointers to contiguous float32
// arrays of the shapes documented in ops/fk_kernel.py; qd and vs are both
// null (poses only) or both set (poses and velocities).
int dwbc_fk(const float* q, const float* qd, const float* tree, float* Rs,
            float* ps, float* vs, int nb, int n, void* stream) {
  if (nb <= 0 || nb > NB_MAX || n <= 0 || 9ull * nb * n > UINT32_MAX ||
      (qd == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return qd != nullptr ? launch<true>(q, qd, tree, Rs, ps, vs, nb, n, s)
                       : launch<false>(q, qd, tree, Rs, ps, vs, nb, n, s);
}

}  // extern "C"
