// Warm-started terrain contact law for Hopper (sm_90a), one launch per
// physics substep.
//
// Replaces: dwbc_tpu/ops/contact_pallas.py::_kernel (the Pallas TPU kernel
// over dwbc_tpu/sim/contact.py::fused_terrain_law). The plain PyTorch
// version it is held against is dwbc_tpu_torch/sim/contact.py::
// fused_terrain_law; the Python wrapper is dwbc_tpu_torch/ops/
// contact_kernel.py.
//
// What it computes, for every (sphere g, env n): the cached tangent plane
// evaluated at the sphere (penetration phi, `active`), the per-body active
// count (the only coupling between spheres: m_share = min(m_solo,
// m_body/count), share_f), the directional Delassus masses 1/(d^T W d)
// along the normal and the tangent, the normal force (Baumgarte pushout
// capped at max_depen_vel plus an under-relaxed correction on the decayed
// warm-start carry, clipped to [0, fn_max]), Coulomb-cone friction, and the
// growth-clamped carry.
//
// Layout: every per-(g, n) array is a row-major (ng, N) float32 plane (a
// 3-vector is three consecutive planes of a (3, ng, N) tensor), so the
// env axis is the contiguous one.
//
// Bound at ng = 84, N = 8192: it reads 15 float32 (ng, N) planes (gp, gv,
// fprev, normal: 3 each; h, ax, ay) plus friction and the per-sphere
// constants, 41.3 MB, and writes 7 float32 planes (gF, cf_new, share_f)
// plus the 1-byte mask, 20.0 MB: 61.28 MB in all, 18.3 us at 3.35 TB/s.
// Its ~140 float operations per (g, n) (counted in chip_smoke.py) take
// ~1.4 us at 67 TFLOP/s, so it is bound by bytes. The law has no matrix
// product, so there is nothing for the tensor cores: the Pallas kernel's
// only products are the one-hot E . active count and its transpose
// (dwbc_tpu/sim/contact.py:206-210), which the exact integer count in
// shared memory below replaces.
//
// Design: one thread per (sphere, env) element. A block owns a tile of
// TILE = 32 consecutive envs across all ng spheres with ROWS = 16 sphere
// rows: thread (lane, row) takes env tile + lane and spheres row,
// row + ROWS, ... (at most K = ceil(ng / ROWS) <= 8, a template parameter,
// so the per-sphere state is a register array). One warp is one sphere
// row of the tile, so every plane load and store is one whole 128-byte
// line. At N = 8192 that is 256 blocks of 16 warps, two resident per SM:
// about 31 warps per SM.
//   Pass 1 loads gp, the normal, h, ax and ay once, and keeps phi and the
// normal in registers for pass 2. Each active sphere adds one to its
// body's count in shared memory, int s_cnt[nb][TILE], with a shared-memory
// atomicAdd: the counts are integers, so their sum is exact in any order
// and equals the plain version's index_add_ of 0/1 floats bit for bit; the
// geom->body map may be in any order. __syncthreads() separates the
// passes. Pass 2 loads only gv and fprev, takes friction from shared
// memory (read once per block) and writes gF, cf_new, share_f and
// `active`. So the kernel moves each byte its bound counts once. The
// per-sphere constants (radius, m_solo, m_body, W's six rows, geom->body)
// sit in shared memory; a warp reads one sphere's entry, a broadcast.
// Plane offsets are 32-bit (the wrapper keeps 3 ng N below 2^32), one
// address instruction per access.
//   Nothing is staged asynchronously. A variant that copied gv and fprev
// into shared memory with cp.async before pass 1, so that their reads
// overlapped pass 1 and the barriers, ran slower on the card (PERF.md): it
// moves every read ahead of all the law's arithmetic, and the arithmetic,
// not the reads, is what limits this kernel (below).
//
// Numerics: built with -fmad=false and in the plain version's operation
// order, with IEEE division and sqrt, so each float operation rounds as
// the plain version's separate elementwise ops do: `active` agrees bit for
// bit with the plain version on the card.
//
// What limits it now (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): at
// 84 x 8192 it takes 35.1 us per launch, 52% of the byte bound, and about
// the same (35.6 us) when its inputs sit in L2, so it is not waiting on
// HBM; a plain device copy of the same 61.28 MB takes 27.1 us there. Each
// element runs 14 IEEE divisions and 2 IEEE square roots, each a
// dependent chain with a range check and a slow-path branch, at the
// 64-register cap that two resident blocks per SM impose: the kernel is
// bound by the latency of that arithmetic. Other tile shapes (8-32 envs,
// 14-42 sphere rows, one to four blocks per SM) did no better.

#include <cstdint>
#include <cuda_runtime.h>

#define NB_MAX 32
#define NG_MAX 128
#define TILE 32
#define ROWS 16
#define KMAX ((NG_MAX + ROWS - 1) / ROWS)
#define NT (TILE * ROWS)

namespace {

struct LawParams {
  float baumgarte, max_depen_vel, growth_g, warm_decay, relax, slop, fn_max,
      dt;
};

// 1/(d^T W d) with W given as (xx, yy, zz, xy, xz, yz) at stride ng.
__device__ __forceinline__ float m_dir(const float* w, int ng, float d0,
                                       float d1, float d2) {
  float q = w[0] * d0 * d0 + w[ng] * d1 * d1 + w[2 * ng] * d2 * d2 +
            2.0f * (w[3 * ng] * d0 * d1 + w[4 * ng] * d0 * d2 +
                    w[5 * ng] * d1 * d2);
  return 1.0f / fmaxf(q, 1e-6f);
}

template <int K>
__global__ void __launch_bounds__(NT, 2) contact_law_kernel(
    const float* __restrict__ gp, const float* __restrict__ gv,
    const float* __restrict__ fprev, const float* __restrict__ nrm,
    const float* __restrict__ h_a, const float* __restrict__ ax,
    const float* __restrict__ ay, const float* __restrict__ friction,
    const float* __restrict__ radius, const float* __restrict__ m_solo,
    const float* __restrict__ m_body, const float* __restrict__ w6,
    const int* __restrict__ geom_body, float* __restrict__ gF,
    float* __restrict__ cf, float* __restrict__ share_f,
    uint8_t* __restrict__ active, int ng, int nb, int n, LawParams cp) {
  static_assert(K >= 1 && K <= KMAX, "K = ceil(ng / ROWS) with ng <= NG_MAX");
  extern __shared__ float smem[];
  float* s_rad = smem;
  float* s_ms = smem + ng;
  float* s_mb = smem + 2 * ng;
  float* s_w = smem + 3 * ng;  // 6 rows of ng
  int* s_gb = reinterpret_cast<int*>(smem + 9 * ng);
  int* s_cnt = s_gb + ng;  // (nb, TILE) active spheres per body and env
  float* s_fr = reinterpret_cast<float*>(s_cnt + nb * TILE);

  const int lane = threadIdx.x, row = threadIdx.y;
  const int tid = row * TILE + lane;
  const int e = blockIdx.x * TILE + lane;
  const bool live = e < n;
  // 32-bit element offsets (the wrapper keeps 3 ng N below 2^32): one
  // address instruction per access instead of 64-bit index arithmetic
  const uint32_t plane = (uint32_t)ng * (uint32_t)n;
  const uint32_t base = (uint32_t)row * (uint32_t)n + (uint32_t)e;
  const uint32_t step = (uint32_t)ROWS * (uint32_t)n;

  // pass 1, loads: (gp_z - h) * n_z and the normal, kept in registers;
  // the radius is subtracted after the barrier, in the same order
  float zn[K], q0[K], q1[K], q2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int g = row + k * ROWS;
    zn[k] = q0[k] = q1[k] = 0.0f;
    q2[k] = 1.0f;
    if (live && g < ng) {
      const uint32_t i0 = base + k * step;
      const float n0 = nrm[i0], n1 = nrm[plane + i0], n2 = nrm[2 * plane + i0];
      const float dhdx = -n0 / n2;
      const float dhdy = -n1 / n2;
      const float h = h_a[i0] + dhdx * (gp[i0] - ax[i0]) +
                      dhdy * (gp[plane + i0] - ay[i0]);
      zn[k] = (gp[2 * plane + i0] - h) * n2;
      q0[k] = n0;
      q1[k] = n1;
      q2[k] = n2;
    }
  }

  // per-block tables: sphere constants, zeroed counts, the tile's friction
  for (int i = tid; i < ng; i += NT) {
    s_rad[i] = radius[i];
    s_ms[i] = m_solo[i];
    s_mb[i] = m_body[i];
    for (int k = 0; k < 6; ++k) s_w[k * ng + i] = w6[k * ng + i];
    s_gb[i] = geom_body[i];
  }
  for (int i = tid; i < nb * TILE; i += NT) s_cnt[i] = 0;
  if (row == 0) s_fr[lane] = live ? friction[e] : 0.0f;
  __syncthreads();

  // pass 1, counts: phi < 0 marks a contact, counted per (body, env)
  float phi[K];
  uint32_t act = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int g = row + k * ROWS;
    phi[k] = 0.0f;
    if (live && g < ng) {
      phi[k] = zn[k] - s_rad[g];
      if (phi[k] < 0.0f) {
        act |= 1u << k;
        atomicAdd(&s_cnt[s_gb[g] * TILE + lane], 1);
      }
    }
  }
  __syncthreads();

  // pass 2: the law
  const float fr = s_fr[lane];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int g = row + k * ROWS;
    if (!live || g >= ng) continue;
    const uint32_t i0 = base + k * step, i1 = plane + i0, i2 = 2 * plane + i0;
    const bool a = (act >> k) & 1u;
    const float n0 = q0[k], n1 = q1[k], n2 = q2[k];
    const float v0 = gv[i0], v1 = gv[i1], v2 = gv[i2];
    const float p0 = fprev[i0], p1 = fprev[i1], p2 = fprev[i2];
    const float* w = s_w + g;

    const float ms = s_ms[g];
    const int cnt = s_cnt[s_gb[g] * TILE + lane];
    const float m_share = fminf(ms, s_mb[g] / fmaxf((float)cnt, 1.0f));
    const float sf = m_share / ms;

    const float vn = v0 * n0 + v1 * n1 + v2 * n2;
    const float push =
        fminf(cp.baumgarte * fmaxf(-phi[k] - cp.slop, 0.0f) / cp.dt,
              cp.max_depen_vel);
    const float m_n = sf * m_dir(w, ng, n0, n1, n2);
    const float vt0 = v0 - n0 * vn, vt1 = v1 - n1 * vn, vt2 = v2 - n2 * vn;
    const float vtn = sqrtf(vt0 * vt0 + vt1 * vt1 + vt2 * vt2 + 1e-12f);
    const float m_t = sf * m_dir(w, ng, vt0 / vtn, vt1 / vtn, vt2 / vtn);
    const float fdotn = p0 * n0 + p1 * n1 + p2 * n2;
    const float fn_prev = cp.warm_decay * fmaxf(fdotn, 0.0f);
    const float ftp0 = (p0 - n0 * fdotn) * cp.warm_decay;
    const float ftp1 = (p1 - n1 * fdotn) * cp.warm_decay;
    const float ftp2 = (p2 - n2 * fdotn) * cp.warm_decay;
    float fn = fn_prev + cp.relax * m_n * (push - vn) / cp.dt;
    fn = fminf(fmaxf(fn, 0.0f), cp.fn_max);
    fn = a ? fn : 0.0f;
    const float kt = -cp.relax * m_t / cp.dt;
    const float ftv0 = ftp0 + vt0 * kt, ftv1 = ftp1 + vt1 * kt,
                ftv2 = ftp2 + vt2 * kt;
    const float ftn = sqrtf(ftv0 * ftv0 + ftv1 * ftv1 + ftv2 * ftv2 + 1e-12f);
    const float fsc = fminf(fr * fn / ftn, 1.0f);
    const float fn_c = fminf(fn, fn_prev + cp.growth_g * m_n);
    const float fsc_c = fminf(fsc, (fr * fn_c) / ftn);

    gF[i0] = a ? fn * n0 + ftv0 * fsc : 0.0f;
    gF[i1] = a ? fn * n1 + ftv1 * fsc : 0.0f;
    gF[i2] = a ? fn * n2 + ftv2 * fsc : 0.0f;
    cf[i0] = a ? fn_c * n0 + ftv0 * fsc_c : 0.0f;
    cf[i1] = a ? fn_c * n1 + ftv1 * fsc_c : 0.0f;
    cf[i2] = a ? fn_c * n2 + ftv2 * fsc_c : 0.0f;
    share_f[i0] = sf;
    active[i0] = a ? 1 : 0;
  }
}

// Launches contact_law_kernel<K> for the k = ceil(ng / ROWS) of this call.
template <int K>
cudaError_t dispatch(int k, dim3 grid, size_t smem, cudaStream_t stream,
                     const float* gp, const float* gv, const float* fprev,
                     const float* nrm, const float* h_a, const float* ax,
                     const float* ay, const float* friction,
                     const float* radius, const float* m_solo,
                     const float* m_body, const float* w6,
                     const int* geom_body, float* gF, float* cf,
                     float* share_f, uint8_t* active, int ng, int nb, int n,
                     LawParams cp) {
  if (k == K) {
    contact_law_kernel<K><<<grid, dim3(TILE, ROWS), smem, stream>>>(
        gp, gv, fprev, nrm, h_a, ax, ay, friction, radius, m_solo, m_body, w6,
        geom_body, gF, cf, share_f, active, ng, nb, n, cp);
    return cudaGetLastError();
  }
  if constexpr (K < KMAX)
    return dispatch<K + 1>(k, grid, smem, stream, gp, gv, fprev, nrm, h_a, ax,
                           ay, friction, radius, m_solo, m_body, w6,
                           geom_body, gF, cf, share_f, active, ng, nb, n, cp);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the law on `stream`; returns the cudaError_t of the launch
// (0 on success). Pointers are device pointers to contiguous float32
// arrays of the shapes documented in ops/contact_kernel.py.
int dwbc_contact_law(const float* gp, const float* gv, const float* fprev,
                     const float* nrm, const float* h_a, const float* ax,
                     const float* ay, const float* friction,
                     const float* radius, const float* m_solo,
                     const float* m_body, const float* w6,
                     const int* geom_body, float* gF, float* cf,
                     float* share_f, uint8_t* active, int ng, int nb, int n,
                     float baumgarte, float max_depen_vel, float growth_g,
                     float warm_decay, float relax, float slop, float fn_max,
                     float dt, void* stream) {
  if (ng <= 0 || ng > NG_MAX || nb <= 0 || nb > NB_MAX || n <= 0 ||
      3ull * ng * n > UINT32_MAX)
    return (int)cudaErrorInvalidValue;
  const LawParams cp{baumgarte, max_depen_vel, growth_g, warm_decay,
                     relax,     slop,          fn_max,   dt};
  const dim3 grid((n + TILE - 1) / TILE);
  const int k = (ng + ROWS - 1) / ROWS;
  // sphere constants, counts and friction
  const size_t smem = ((size_t)10 * ng + (nb + 1) * TILE) * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch<1>(k, grid, smem, s, gp, gv, fprev, nrm, h_a, ax, ay,
                          friction, radius, m_solo, m_body, w6, geom_body, gF,
                          cf, share_f, active, ng, nb, n, cp);
}

}  // extern "C"
