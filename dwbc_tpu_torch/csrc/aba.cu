// The fused substep's articulated-body algorithm for Hopper (sm_90a), one
// launch per physics substep.
//
// Replaces no TPU kernel: the JAX package leaves ABA to XLA, which fuses
// its scalarised 3x3 and 6x6 products (dwbc_tpu/sim/fused.py). In eager
// PyTorch the same recursion is about 40 launches a body in the backward
// pass and 12 in the forward pass, some 1,200 launches a substep for a
// 21-body tree, each a few microseconds of host time for almost no device
// work; the profile of the training step on the card showed that host
// time as half of widowGo1's collect. The plain PyTorch version it is held
// against is dwbc_tpu_torch/sim/aba.py::fused_aba; the Python wrapper is
// dwbc_tpu_torch/ops/aba_kernel.py.
//
// What it computes, per env: the joint-space extra torques (limit spring
// and damper, viscous and Coulomb friction capped by the torque that stops
// the joint in one dt); the body-frame bias forces (gravity through the
// com, the contact wrenches rotated into the body); the velocity-product
// terms; the backward pass (U, 1/d, u, the articulated inertia and bias
// force moved to the parent by Featherstone's block formula); the base's
// 6x6 Cholesky solve with the 1e-6 pivot floor; the forward pass for the
// joint accelerations; the base's world angular and linear accelerations.
// The joint frames are recomputed from q with sim/tree.py's joint_frame.
//
// Bound: at 21 bodies x 5,000 envs it needs 21.3 MB (the inputs, of the
// spatial inertias the upper triangles, and the outputs), 6.4 us at
// 3.35 TB/s, and some tens of kFLOP per env, microseconds at 67 TFLOP/s.
// On an NVIDIA H100 80GB HBM3 (700 W) a launch takes 62 us there and
// 35 us at 13 x 4,096 (PERF.md), about ten times the byte bound. Two
// limits can explain that, and no measurement yet tells them apart: the
// recursion over the tree is a serial chain per env, of which the card
// holds N threads, one warp per SM; and most inputs are read with a stride
// from lane to lane (below).
// What the kernel removes is the eager version's ~1,300 host launches.
//
// Design: one thread per env, a block of T = 32 envs (one warp). Only the
// contact wrenches bF, bN (3, nb, N) are planes with envs innermost, so a
// warp's load of one of their values is one contiguous run. The other
// inputs keep the layouts the substep hands over, with a row per env: the
// stacked rotations and velocities (nb, N, 9 / 6) step 36 / 24 bytes from
// lane to lane, the spatial inertias (N, nb, 6, 6) nb x 144 bytes, mass and
// com (N, nb), q, qd and tau a row each, so a warp's load of one value
// touches up to 32 sectors, whose other values serve the following loads
// only while they stay in cache. The tree's constants (TreeConst.table,
// uploaded once per simulator) go to shared memory at block start; every
// thread reads the same entry, a broadcast.
// Each env keeps its bodies' articulated inertias (21 floats, the upper
// triangle of the symmetric 6x6) and bias forces (6) in shared memory,
// laid out [body][slot][lane] so a warp's access to one slot is
// conflict-free. After its backward step a body's inertia slots hold U, 1/d,
// u, the velocity-product term and the joint angle's cos and sin, which the
// forward pass reads; its bias slots then hold its acceleration. The
// per-body arithmetic (the 3x3 block products, the rank-one update, the
// Cholesky solve) is unrolled into registers. At 21 bodies a block takes
// 74.9 KB of shared memory (dynamic; the launch raises the limit).
//
// Numerics: float32 with IEEE division and square root and the compiler's
// default contraction into fused multiply-adds (no fast-math, no TF32);
// the order of operations follows the plain version's where the block
// formula allows, so the two agree to float32 rounding, not bit for bit.
// NaN propagates as in the plain version (torch.clamp, torch.minimum and
// torch.sign semantics).

#include <cstdint>
#include <cuda_runtime.h>

#define NB_MAX 32
#define T 32        // envs (threads) per block
#define TABLE_W 28  // columns of the tree table (sim/tree.py)
#define BODY_W 27   // floats per body and env in shared memory

namespace {

// tree table columns (sim/tree.py)
enum {
  PARENT = 0, PRISMATIC = 1, AXIS = 2, TREE_ROT = 5, TREE_POS = 14,
  PRISM_DIR = 17, ARMATURE = 20, DAMPING = 21, FRICTION = 22, LOWER = 23,
  UPPER = 24, I_EFF = 25
};

// per-body slots: the articulated inertia's upper triangle, then the bias
// force; after the backward step the first slots hold U, 1/d, u, c, cos, sin
enum { S_IA = 0, S_PA = 21, S_U = 0, S_DINV = 6, S_UU = 7, S_C = 8,
       S_COS = 14, S_SIN = 15 };

struct Params {
  float limit_kp, limit_kd, dt, gx, gy, gz;
};

// index of (r, c) in the row-major upper triangle of a symmetric 6x6
__host__ __device__ constexpr int sym(int r, int c) {
  return r <= c ? r * 6 - r * (r - 1) / 2 + (c - r)
                : c * 6 - c * (c - 1) / 2 + (r - c);
}

// torch.clamp / torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// U = IA S, U.S and pA.S for the motion subspace S = [a; 0] (O = 0,
// revolute) or [0; a] (O = 3, prismatic); O is a template parameter so
// that every index into the register arrays is a constant
template <int O>
__device__ __forceinline__ void subspace(const float* Ia, const float* pA,
                                         const float* ax, float* U, float& dS,
                                         float& pS) {
#pragma unroll
  for (int r = 0; r < 6; ++r)
    U[r] = Ia[sym(r, O)] * ax[0] + Ia[sym(r, O + 1)] * ax[1] +
           Ia[sym(r, O + 2)] * ax[2];
  dS = U[O] * ax[0] + U[O + 1] * ax[1] + U[O + 2] * ax[2];
  pS = pA[O] * ax[0] + pA[O + 1] * ax[1] + pA[O + 2] * ax[2];
}

// the joint frame (Rj, pj) of a body from its table row and its joint
// coordinate: revolute R(q) = c I + (1 - c) a a^T + s skew(a) after
// tree_rot, at tree_pos; prismatic tree_rot at tree_pos + prism_dir q
__device__ __forceinline__ void joint_frame(const float* tb, bool prism,
                                            float qj, float cq, float sq,
                                            float* Rj, float* pj) {
  const float* tr = tb + TREE_ROT;
  if (prism) {
#pragma unroll
    for (int k = 0; k < 9; ++k) Rj[k] = tr[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) pj[k] = tb[TREE_POS + k] + tb[PRISM_DIR + k] * qj;
    return;
  }
  const float a0 = tb[AXIS], a1 = tb[AXIS + 1], a2 = tb[AXIS + 2];
  const float a[3] = {a0, a1, a2};
  const float sk[9] = {0.0f, -a2, a1, a2, 0.0f, -a0, -a1, a0, 0.0f};
  const float omc = 1.0f - cq;
  float Ra[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Ra[r * 3 + c] = (r == c ? cq : 0.0f) + a[r] * a[c] * omc + sk[r * 3 + c] * sq;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Rj[r * 3 + c] = tr[r * 3] * Ra[c] + tr[r * 3 + 1] * Ra[3 + c] +
                      tr[r * 3 + 2] * Ra[6 + c];
#pragma unroll
  for (int k = 0; k < 3; ++k) pj[k] = tb[TREE_POS + k];
}

__global__ void __launch_bounds__(T, 1) aba_kernel(
    const float* __restrict__ q, const float* __restrict__ qd,
    const float* __restrict__ tau, const float* __restrict__ Rs,
    const float* __restrict__ vs, const float* __restrict__ IAb,
    const float* __restrict__ mass, const float* __restrict__ com,
    const float* __restrict__ bF, const float* __restrict__ bN,
    const float* __restrict__ tree, float* __restrict__ qdd,
    float* __restrict__ base_acc, int nb, int n, Params P) {
  extern __shared__ float smem[];
  float* tbl = smem;                  // (nb, TABLE_W)
  float* sw = smem + nb * TABLE_W;    // (nb, BODY_W, T)
  const int lane = threadIdx.x;
  for (int i = lane; i < nb * TABLE_W; i += T) tbl[i] = tree[i];
  __syncthreads();
  const int e = blockIdx.x * T + lane;
  if (e >= n) return;

  const uint32_t un = (uint32_t)n, ue = (uint32_t)e, unb = (uint32_t)nb;
  const int nj = nb - 1, nq = nb + 6, nv = nb + 5;
  // slot k of body b of this env
#define SW(b, k) sw[((b) * BODY_W + (k)) * T + lane]

  // ---- bias forces: pA = v x* (I v) - [com x fg + R^T bN; fg + R^T bF]
  for (int b = 0; b < nb; ++b) {
    const float* R = Rs + ((uint32_t)b * un + ue) * 9u;
    const float* v = vs + ((uint32_t)b * un + ue) * 6u;
    const float* I = IAb + (ue * unb + (uint32_t)b) * 36u;
    float Rr[9], vv[6], Is[21];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rr[k] = R[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) vv[k] = v[k];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = r; c < 6; ++c) Is[sym(r, c)] = I[r * 6 + c];
    const float m = mass[ue * unb + b];
    const float cm[3] = {com[(ue * unb + b) * 3u], com[(ue * unb + b) * 3u + 1],
                         com[(ue * unb + b) * 3u + 2]};
    float fF[3], fN[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      fF[k] = bF[((uint32_t)k * unb + b) * un + ue];
      fN[k] = bN[((uint32_t)k * unb + b) * un + ue];
    }
    // R^T g, R^T bN, R^T bF
    float fg[3], rN[3], rF[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      fg[k] = (Rr[k] * P.gx + Rr[3 + k] * P.gy + Rr[6 + k] * P.gz) * m;
      rN[k] = Rr[k] * fN[0] + Rr[3 + k] * fN[1] + Rr[6 + k] * fN[2];
      rF[k] = Rr[k] * fF[0] + Rr[3 + k] * fF[1] + Rr[6 + k] * fF[2];
    }
    float cfg[3];
    cross3(cm, fg, cfg);
    // I v, then v x* (I v) = [w x f_ang + u x f_lin; w x f_lin]
    float f[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) s += Is[sym(r, c)] * vv[c];
      f[r] = s;
    }
    float t1[3], t2[3], t3[3];
    cross3(vv, f, t1);
    cross3(vv + 3, f + 3, t2);
    cross3(vv, f + 3, t3);
#pragma unroll
    for (int k = 0; k < 21; ++k) SW(b, S_IA + k) = Is[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      SW(b, S_PA + k) = (t1[k] + t2[k]) - (cfg[k] + rN[k]);
      SW(b, S_PA + 3 + k) = t3[k] - (fg[k] + rF[k]);
    }
  }

  // ---- backward pass over the tree
  for (int i = nb - 1; i >= 1; --i) {
    const float* tb = tbl + i * TABLE_W;
    const int pa = (int)tb[PARENT];
    const bool prism = tb[PRISMATIC] != 0.0f;
    const float ax[3] = {tb[AXIS], tb[AXIS + 1], tb[AXIS + 2]};
    const int j = i - 1;
    const float qj = q[ue * (uint32_t)nq + 7u + j];
    const float qdj = qd[ue * (uint32_t)nv + 6u + j];

    // joint-space extra torques
    const float below = tmin(qj - tb[LOWER], 0.0f);
    const float above = tmax(qj - tb[UPPER], 0.0f);
    const float ieff = tb[I_EFF];
    const float tl = -P.limit_kp * (below + above) * ieff;
    const float aq = fabsf(qdj);
    const float stop = ieff * aq / P.dt;
    float mag = tb[DAMPING] * aq + tb[FRICTION];
    mag = mag + ((below < 0.0f || above > 0.0f) ? P.limit_kd * aq : 0.0f);
    const float sg = (float)((qdj > 0.0f) - (qdj < 0.0f));
    const float tau_eff = tau[ue * (uint32_t)nj + j] + (tl - sg * tmin(mag, stop));

    float Ia[21], pA[6];
#pragma unroll
    for (int k = 0; k < 21; ++k) Ia[k] = SW(i, S_IA + k);
#pragma unroll
    for (int k = 0; k < 6; ++k) pA[k] = SW(i, S_PA + k);

    // velocity-product term c = v x (S qd): revolute [w x a qd; u x a qd],
    // prismatic [0; w x a qd]
    const float* v = vs + ((uint32_t)i * un + ue) * 6u;
    const float vv[6] = {v[0], v[1], v[2], v[3], v[4], v[5]};
    const float m3[3] = {ax[0] * qdj, ax[1] * qdj, ax[2] * qdj};
    float cv[6];
    if (prism) {
      cv[0] = cv[1] = cv[2] = 0.0f;
      cross3(vv, m3, cv + 3);
    } else {
      cross3(vv, m3, cv);
      cross3(vv + 3, m3, cv + 3);
    }

    // U = IA S, d = U.S + armature, u = tau - pA.S
    float U[6], dS, pS;
    if (prism)
      subspace<3>(Ia, pA, ax, U, dS, pS);
    else
      subspace<0>(Ia, pA, ax, U, dS, pS);
    const float dinv = 1.0f / (dS + tb[ARMATURE]);
    const float uu = tau_eff - pS;

    // Ia = IA - U U^T / d;  pa = pA + Ia c + U u / d
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = r; c < 6; ++c) Ia[sym(r, c)] += U[r] * U[c] * (-dinv);
    const float ud = uu * dinv;
    float pai[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) s += Ia[sym(r, c)] * cv[c];
      pai[r] = pA[r] + s + U[r] * ud;
    }

    float cq = 0.0f, sq = 0.0f;
    if (!prism) sincosf(qj, &sq, &cq);
    float Rj[9], pj[3];
    joint_frame(tb, prism, qj, cq, sq, Rj, pj);

    // what the forward pass reads
#pragma unroll
    for (int k = 0; k < 6; ++k) SW(i, S_U + k) = U[k];
    SW(i, S_DINV) = dinv;
    SW(i, S_UU) = uu;
#pragma unroll
    for (int k = 0; k < 6; ++k) SW(i, S_C + k) = cv[k];
    SW(i, S_COS) = cq;
    SW(i, S_SIN) = sq;

    // bias force to the parent: [Rj f_ang + pj x (Rj f_lin); Rj f_lin]
    float Rfu[3], Rfa[3], pxf[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      Rfu[r] = Rj[r * 3] * pai[3] + Rj[r * 3 + 1] * pai[4] + Rj[r * 3 + 2] * pai[5];
      Rfa[r] = Rj[r * 3] * pai[0] + Rj[r * 3 + 1] * pai[1] + Rj[r * 3 + 2] * pai[2];
    }
    cross3(pj, Rfu, pxf);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      SW(pa, S_PA + k) += Rfa[k] + pxf[k];
      SW(pa, S_PA + 3 + k) += Rfu[k];
    }

    // articulated inertia to the parent by the plain version's block
    // formula, Ia = [[A, B], [B^T, D]], P = skew(pj), Br = R B R^T:
    // D' = R D R^T, B' = Br + P D', A' = R A R^T + P Br^T - Br P - P D' P.
    // With Q_r = p x (row r of Br) and W_r = p x (row r of P D'),
    // (P Br^T)_rc = Q_cr, -(Br P)_rc = Q_rc and -(P D' P)_rc = W_rc, so
    // A'_rc = (R A R^T)_rc + Q_cr + Q_rc + W_rc: symmetric, upper half kept
    float RA[9], RB[9], RD[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float sa = 0.0f, sb = 0.0f, sd = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          sa += Rj[r * 3 + k] * Ia[sym(k, c)];
          sb += Rj[r * 3 + k] * Ia[sym(k, 3 + c)];
          sd += Rj[r * 3 + k] * Ia[sym(3 + k, 3 + c)];
        }
        RA[r * 3 + c] = sa;
        RB[r * 3 + c] = sb;
        RD[r * 3 + c] = sd;
      }
    float Ar[9], Br[9], Dr[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float sa = 0.0f, sb = 0.0f, sd = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          sa += RA[r * 3 + k] * Rj[c * 3 + k];
          sb += RB[r * 3 + k] * Rj[c * 3 + k];
          sd += RD[r * 3 + k] * Rj[c * 3 + k];
        }
        Ar[r * 3 + c] = sa;
        Br[r * 3 + c] = sb;
        Dr[r * 3 + c] = sd;
      }
    // pDr = P Dr: column c is p x (column c of Dr)
    float pDr[9];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float col[3] = {Dr[c], Dr[3 + c], Dr[6 + c]};
      float o3[3];
      cross3(pj, col, o3);
      pDr[c] = o3[0];
      pDr[3 + c] = o3[1];
      pDr[6 + c] = o3[2];
    }
    float Q[9], W[9];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      cross3(pj, Br + r * 3, Q + r * 3);
      cross3(pj, pDr + r * 3, W + r * 3);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = r; c < 3; ++c)
        SW(pa, S_IA + sym(r, c)) +=
            (Ar[r * 3 + c] + Q[c * 3 + r]) + (Q[r * 3 + c] + W[r * 3 + c]);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        SW(pa, S_IA + sym(r, 3 + c)) += Br[r * 3 + c] + pDr[r * 3 + c];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = r; c < 3; ++c) SW(pa, S_IA + sym(3 + r, 3 + c)) += Dr[r * 3 + c];
  }

  // ---- the base: IA0 a0 = -pA0 by Cholesky with a 1e-6 pivot floor
  float a0[6];
  {
    float M[21], b[6];
#pragma unroll
    for (int k = 0; k < 21; ++k) M[k] = SW(0, S_IA + k);
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = -SW(0, S_PA + k);
    float L[21];  // lower triangle, L[sym(r, c)] for c <= r
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < jj; ++k) s += L[sym(jj, k)] * L[sym(jj, k)];
      const float Ljj = sqrtf(tmax(M[sym(jj, jj)] - s, 1e-6f));
      L[sym(jj, jj)] = Ljj;
#pragma unroll
      for (int r = jj + 1; r < 6; ++r) {
        float t = 0.0f;
#pragma unroll
        for (int k = 0; k < jj; ++k) t += L[sym(r, k)] * L[sym(jj, k)];
        L[sym(r, jj)] = (M[sym(r, jj)] - t) / Ljj;
      }
    }
    float y[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < r; ++k) s += L[sym(r, k)] * y[k];
      y[r] = (b[r] - s) / L[sym(r, r)];
    }
#pragma unroll
    for (int r = 5; r >= 0; --r) {
      float s = 0.0f;
#pragma unroll
      for (int k = r + 1; k < 6; ++k) s += L[sym(k, r)] * a0[k];
      a0[r] = (y[r] - s) / L[sym(r, r)];
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) SW(0, S_PA + k) = a0[k];

  // ---- forward pass: joint accelerations
  for (int i = 1; i < nb; ++i) {
    const float* tb = tbl + i * TABLE_W;
    const int pa = (int)tb[PARENT];
    const bool prism = tb[PRISMATIC] != 0.0f;
    const float ax[3] = {tb[AXIS], tb[AXIS + 1], tb[AXIS + 2]};
    const float qj = prism ? q[ue * (uint32_t)nq + 6u + i] : 0.0f;
    float Rj[9], pj[3];
    joint_frame(tb, prism, qj, SW(i, S_COS), SW(i, S_SIN), Rj, pj);
    float ap[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) ap[k] = SW(pa, S_PA + k);
    // [Rj^T a_w; Rj^T (a_u + a_w x pj)] + c
    float t3[3], au[3];
    cross3(ap, pj, t3);
#pragma unroll
    for (int k = 0; k < 3; ++k) au[k] = ap[3 + k] + t3[k];
    float a[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a[k] = Rj[k] * ap[0] + Rj[3 + k] * ap[1] + Rj[6 + k] * ap[2];
      a[3 + k] = Rj[k] * au[0] + Rj[3 + k] * au[1] + Rj[6 + k] * au[2];
    }
    float Ua = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      a[k] += SW(i, S_C + k);
      Ua += SW(i, S_U + k) * a[k];
    }
    const float qdd_i = (SW(i, S_UU) - Ua) * SW(i, S_DINV);
    qdd[ue * (uint32_t)nj + (uint32_t)(i - 1)] = qdd_i;
    if (prism) {
#pragma unroll
      for (int k = 0; k < 3; ++k) a[3 + k] += ax[k] * qdd_i;
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) a[k] += ax[k] * qdd_i;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) SW(i, S_PA + k) = a[k];
  }

  // ---- base accelerations in world coordinates:
  // [R0 a0_w; R0 (a0_u + w0 x u0)]
  {
    const float* R = Rs + ue * 9u;
    const float* v = vs + ue * 6u;
    const float vv[6] = {v[0], v[1], v[2], v[3], v[4], v[5]};
    float wxu[3];
    cross3(vv, vv + 3, wxu);
    const float al[3] = {a0[3] + wxu[0], a0[4] + wxu[1], a0[5] + wxu[2]};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      base_acc[ue * 6u + r] = R[r * 3] * a0[0] + R[r * 3 + 1] * a0[1] + R[r * 3 + 2] * a0[2];
      base_acc[ue * 6u + 3 + r] = R[r * 3] * al[0] + R[r * 3 + 1] * al[1] + R[r * 3 + 2] * al[2];
    }
  }
#undef SW
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success). Pointers are device pointers to contiguous float32
// arrays of the shapes documented in ops/aba_kernel.py.
int dwbc_aba(const float* q, const float* qd, const float* tau,
             const float* Rs, const float* vs, const float* IAb,
             const float* mass, const float* com, const float* bF,
             const float* bN, const float* tree, float* qdd, float* base_acc,
             int nb, int n, float limit_kp, float limit_kd, float dt,
             float gx, float gy, float gz, void* stream) {
  if (nb <= 0 || nb > NB_MAX || n <= 0 || 36ull * nb * n > UINT32_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)nb * TABLE_W + (size_t)nb * BODY_W * T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      aba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Params P{limit_kp, limit_kd, dt, gx, gy, gz};
  aba_kernel<<<dim3((n + T - 1) / T), dim3(T), smem, (cudaStream_t)stream>>>(
      q, qd, tau, Rs, vs, IAb, mass, com, bF, bN, tree, qdd, base_acc, nb, n,
      P);
  return (int)cudaGetLastError();
}

}  // extern "C"
