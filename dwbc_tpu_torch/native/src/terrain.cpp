// Native terrain code for dwbc_tpu_torch: the fractal Perlin generator and
// the heightfield -> triangle mesh conversion.
//
// A copy of the JAX package's native layer (dwbc_tpu/native/src/
// terrain.cpp), kept in the port so that the port
// imports nothing of that package yet draws the SAME heightfield from the
// same seed: the RNG is splitmix64-seeded xoshiro256++, which differs from
// numpy's Generator, so matching the JAX package's terrain bit for bit
// needs this exact code built with the same flags
// (dwbc_tpu_torch/native/__init__.py).
//
// Algorithm: quintic-fade gradient Perlin, octaves summed with gain and
// lacunarity, each octave normalised to [0, 1] (sqrt(2)*n*0.5 + 0.5).

#include <cstdint>
#include <cmath>
#include <vector>

namespace {

struct Xoshiro256pp {
  uint64_t s[4];
  explicit Xoshiro256pp(uint64_t seed) {
    // splitmix64 expansion
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
};

inline double fade(double t) {
  return t * t * t * (t * (t * 6.0 - 15.0) + 10.0);
}

// One Perlin octave over an (xs, ys) grid with (rx, ry) gradient cells.
// Accumulates amp * value into out (row-major xs x ys).
void perlin_octave_accum(Xoshiro256pp &rng, int xs, int ys, int rx, int ry,
                         double amp, float *out) {
  const int dx = xs / rx, dy = ys / ry;  // samples per gradient cell
  std::vector<double> gx((rx + 1) * (ry + 1)), gy((rx + 1) * (ry + 1));
  for (int i = 0; i < (rx + 1) * (ry + 1); ++i) {
    double a = 2.0 * M_PI * rng.uniform();
    gx[i] = std::cos(a);
    gy[i] = std::sin(a);
  }
  const double inv_dx = 1.0 / dx, inv_dy = 1.0 / dy;
  const double k = std::sqrt(2.0) * 0.5;
#pragma omp parallel for schedule(static)
  for (int i = 0; i < xs; ++i) {
    const int ci = i / dx;
    const double fx = (i - ci * dx) * inv_dx;  // fractional position in cell
    const double u = fade(fx);
    const int row0 = ci * (ry + 1), row1 = (ci + 1) * (ry + 1);
    float *orow = out + (size_t)i * ys;
    for (int j = 0; j < ys; ++j) {
      const int cj = j / dy;
      const double fy = (j - cj * dy) * inv_dy;
      const double v = fade(fy);
      const double n00 = fx * gx[row0 + cj] + fy * gy[row0 + cj];
      const double n10 = (fx - 1.0) * gx[row1 + cj] + fy * gy[row1 + cj];
      const double n01 = fx * gx[row0 + cj + 1] + (fy - 1.0) * gy[row0 + cj + 1];
      const double n11 =
          (fx - 1.0) * gx[row1 + cj + 1] + (fy - 1.0) * gy[row1 + cj + 1];
      const double n0 = n00 * (1.0 - u) + u * n10;
      const double n1 = n01 * (1.0 - u) + u * n11;
      const double val = k * ((1.0 - v) * n0 + v * n1) + 0.5;
      orow[j] += (float)(amp * val);
    }
  }
}

}  // namespace

extern "C" {

// Fractal Perlin heightfield: out is (x_samples, y_samples) row-major
// float32, PRE-ZEROED by the caller. Per octave:
// noise += amp * perlin(res=(xscale, yscale)) * z_scale; amp *= gain;
// scales *= lacunarity. Returns 0 on success, nonzero on invalid args.
int dwbc_fractal_noise(int x_samples, int y_samples, int x_scale, int y_scale,
                       float z_scale, int octaves, float lacunarity,
                       float gain, uint64_t seed, float *out) {
  if (x_samples <= 0 || y_samples <= 0 || octaves <= 0) return 1;
  Xoshiro256pp rng(seed);
  double amp = 1.0;
  int rx = x_scale, ry = y_scale;
  for (int o = 0; o < octaves; ++o) {
    if (rx <= 0 || ry <= 0 || x_samples % rx || y_samples % ry) return 2;
    perlin_octave_accum(rng, x_samples, y_samples, rx, ry, amp * z_scale, out);
    amp *= gain;
    rx = (int)(lacunarity * rx);
    ry = (int)(lacunarity * ry);
  }
  return 0;
}

// Heightfield -> triangle mesh, parity with the external
// isaacgym.terrain_utils.convert_heightfield_to_trimesh consumed at
// reference terrain.py:57-60 (without the slope-threshold wall correction,
// which the reference leaves at None for the Perlin arena).
// verts: (H*W, 3) float32; tris: (2*(H-1)*(W-1), 3) int32. Row-major,
// x = i*cell + ox, y = j*cell + oy.
void dwbc_heightfield_to_trimesh(const float *h, int H, int W, float cell,
                                 float ox, float oy, float *verts,
                                 int32_t *tris) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < H; ++i) {
    for (int j = 0; j < W; ++j) {
      float *v = verts + 3 * ((size_t)i * W + j);
      v[0] = ox + i * cell;
      v[1] = oy + j * cell;
      v[2] = h[(size_t)i * W + j];
    }
  }
#pragma omp parallel for schedule(static)
  for (int i = 0; i < H - 1; ++i) {
    for (int j = 0; j < W - 1; ++j) {
      const int32_t a = i * W + j, b = i * W + j + 1;
      const int32_t c = (i + 1) * W + j, d = (i + 1) * W + j + 1;
      int32_t *t = tris + 6 * ((size_t)i * (W - 1) + j);
      t[0] = a; t[1] = b; t[2] = c;      // upper-left triangle
      t[3] = b; t[4] = d; t[5] = c;      // lower-right triangle
    }
  }
}

}  // extern "C"
