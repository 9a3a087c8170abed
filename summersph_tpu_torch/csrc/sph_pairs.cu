// SPH pair kernels for Hopper (sm_90a): fixed-h density and force sums
// over the sorted-window neighbour structure (ops/sorted_grid.py).
//
// Replaces the TPU Pallas kernels of summersph_tpu/ops/pallas_pairs.py in
// their fixed-h, ungated form:
//   density_fixed_h  <- _density_kernel / _density_body (pallas_density_sums)
//   force_fixed_h    <- _force_kernel / _force_body (pallas_force_sums)
//
// What bounds them: FP32 pair arithmetic.  Each row tests about 10^3
// candidates (9 windows of ~100 candidates on the N = 1,048,576 disc), of
// which ~15% lie inside the kernel support.  The bytes read are small by
// comparison: one tile entry (20 bytes for the density, 52 for the force)
// is read from device memory once per block and serves all its rows.
//
// Design: one CUDA block per window group of `wg` consecutive sorted rows,
// one thread per row.  For each of the 9 plane offsets the block walks the
// group's whole candidate range [starts[g, o], ends[g, o]) in tiles of
// TILE candidates staged through shared memory (every thread of the block
// reads the same tile entry, a broadcast without bank conflicts).  Each
// thread applies its own row's exact key mask k_j in [k_i + off - 1,
// k_i + off + 1], skips candidates outside the support 2h before any
// division, and accumulates in registers.  Because the kernel covers every
// [start, end), no candidate is ever dropped (the TPU kernels' fixed
// window sizes could drop some and counted them in window_overflow).
//
// The pair algebra follows the Pallas kernels term by term: the
// rsqrt(max(r^2, 1e-12)) form, the r^2 > 0 self exclusion in the density,
// the single-dW fixed-h force algebra, and the 1e-30 denominator guards.
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int KX = 1 << 20;
constexpr int KY = 1 << 10;
constexpr float INV_PI = 0.318309886183790671538f;

__device__ __forceinline__ int plane_offset(int o) {
  return (o / 3 - 1) * KX + (o % 3 - 1) * KY;
}

__device__ __forceinline__ float w_shape(float q) {
  if (q <= 1.0f) return 1.0f - 1.5f * q * q + 0.75f * q * q * q;
  if (q <= 2.0f) {
    float t = 2.0f - q;
    return 0.25f * t * t * t;
  }
  return 0.0f;
}

__device__ __forceinline__ float dw_shape(float q) {
  if (q <= 1.0f) return -3.0f * q + 2.25f * q * q;
  if (q <= 2.0f) {
    float t = 2.0f - q;
    return -0.75f * t * t;
  }
  return 0.0f;
}

// rho_raw[i] = sum_j m_j w(r_ij / h_i) / (pi h_i^3) over the 9 windows,
// r_ij > 0 (the self term is added by pairs.finalize_density).
__global__ void density_fixed_h_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const float* __restrict__ m,
    const float* __restrict__ h, const int* __restrict__ key,
    const int* __restrict__ starts, const int* __restrict__ ends,
    float* __restrict__ rho_raw, int n) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sm[TILE];
  __shared__ int sk[TILE];

  const int g = blockIdx.x;
  const int i = g * blockDim.x + threadIdx.x;
  const bool row = i < n;
  const float xi = row ? x[i] : 0.0f;
  const float yi = row ? y[i] : 0.0f;
  const float zi = row ? z[i] : 0.0f;
  const float hi = row ? h[i] : 1.0f;
  const int ki = row ? key[i] : 0;
  const float inv_hi = 1.0f / hi;
  const float support2 = 4.0f * hi * hi;

  float rho = 0.0f;
  for (int o = 0; o < 9; ++o) {
    const int s = starts[g * 9 + o];
    const int e = ends[g * 9 + o];
    const int lo = ki + plane_offset(o) - 1;
    const int hk = ki + plane_offset(o) + 1;
    for (int base = s; base < e; base += TILE) {
      const int cnt = min(TILE, e - base);
      for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
        sx[j] = x[base + j];
        sy[j] = y[base + j];
        sz[j] = z[base + j];
        sm[j] = m[base + j];
        sk[j] = key[base + j];
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const int kj = sk[j];
        if (kj < lo || kj > hk) continue;
        const float dx = xi - sx[j];
        const float dy = yi - sy[j];
        const float dz = zi - sz[j];
        const float r2 = dx * dx + dy * dy + dz * dz;
        if (!(r2 > 0.0f && r2 < support2)) continue;
        const float r = r2 * rsqrtf(fmaxf(r2, 1.0e-12f));
        rho += sm[j] * w_shape(r * inv_hi);
      }
      __syncthreads();
    }
  }
  if (row) rho_raw[i] = rho * (INV_PI * inv_hi * inv_hi * inv_hi);
}

// (ax, ay, az, du, alpha_raw)[i]: pressure + Monaghan viscosity with one
// dW (fixed h, h_j == h_i), summed over the 9 windows.  pterm_j =
// P_j / max(Omega_j rho_j^2, 1e-30) is formed once per tile entry.
__global__ void force_fixed_h_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const float* __restrict__ vx,
    const float* __restrict__ vy, const float* __restrict__ vz,
    const float* __restrict__ m, const float* __restrict__ h,
    const int* __restrict__ key, const float* __restrict__ pres,
    const float* __restrict__ rho, const float* __restrict__ omega,
    const float* __restrict__ cs, const float* __restrict__ alpha,
    const int* __restrict__ starts, const int* __restrict__ ends,
    float* __restrict__ out_ax, float* __restrict__ out_ay,
    float* __restrict__ out_az, float* __restrict__ out_du,
    float* __restrict__ out_araw, int n, float av_eps, float beta_factor) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE];
  __shared__ float svx[TILE], svy[TILE], svz[TILE];
  __shared__ float sm[TILE], spt[TILE], srho[TILE], scs[TILE], sal[TILE];
  __shared__ int sk[TILE];

  const int g = blockIdx.x;
  const int i = g * blockDim.x + threadIdx.x;
  const bool row = i < n;
  const float xi = row ? x[i] : 0.0f;
  const float yi = row ? y[i] : 0.0f;
  const float zi = row ? z[i] : 0.0f;
  const float vxi = row ? vx[i] : 0.0f;
  const float vyi = row ? vy[i] : 0.0f;
  const float vzi = row ? vz[i] : 0.0f;
  const float hi = row ? h[i] : 1.0f;
  const float rhoi = row ? rho[i] : 1.0f;
  const float pterm_i = row ? pres[i] / (omega[i] * rhoi * rhoi) : 0.0f;
  const float csi = row ? cs[i] : 0.0f;
  const float ali = row ? alpha[i] : 0.0f;
  const int ki = row ? key[i] : 0;
  const float inv_hi = 1.0f / hi;
  const float inv_pi_hi4 = INV_PI * inv_hi * inv_hi * inv_hi * inv_hi;
  const float support2 = 4.0f * hi * hi;
  const float av_h2 = av_eps * hi * hi;

  float ax = 0.0f, ay = 0.0f, az = 0.0f, du = 0.0f, araw = 0.0f;
  for (int o = 0; o < 9; ++o) {
    const int s = starts[g * 9 + o];
    const int e = ends[g * 9 + o];
    const int lo = ki + plane_offset(o) - 1;
    const int hk = ki + plane_offset(o) + 1;
    for (int base = s; base < e; base += TILE) {
      const int cnt = min(TILE, e - base);
      for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
        const int c = base + j;
        sx[j] = x[c];
        sy[j] = y[c];
        sz[j] = z[c];
        svx[j] = vx[c];
        svy[j] = vy[c];
        svz[j] = vz[c];
        sm[j] = m[c];
        const float rc = rho[c];
        spt[j] = pres[c] / fmaxf(omega[c] * rc * rc, 1.0e-30f);
        srho[j] = rc;
        scs[j] = cs[c];
        sal[j] = alpha[c];
        sk[j] = key[c];
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const int kj = sk[j];
        if (kj < lo || kj > hk) continue;
        const float dx = xi - sx[j];
        const float dy = yi - sy[j];
        const float dz = zi - sz[j];
        const float r2 = dx * dx + dy * dy + dz * dz;
        // dw_shape vanishes beyond 2h, and so does every term below
        if (!(r2 < support2)) continue;
        const float inv_r = rsqrtf(fmaxf(r2, 1.0e-12f));
        const float r = r2 * inv_r;
        const float dw = dw_shape(r * inv_hi) * inv_pi_hi4;
        const float dvx = vxi - svx[j];
        const float dvy = vyi - svy[j];
        const float dvz = vzi - svz[j];
        const float vdotr = dvx * dx + dvy * dy + dvz * dz;
        const float mu = hi * fminf(vdotr, 0.0f) / (r2 + av_h2);
        const float cbar = 0.5f * (csi + scs[j]);
        const float abar = 0.5f * (ali + sal[j]);
        const float rhobar = 0.5f * (rhoi + srho[j]);
        const float visc = (-abar * cbar * mu + beta_factor * abar * mu * mu)
                           / fmaxf(rhobar, 1.0e-30f);
        // self pairs vanish without a guard: dw(0) == 0 and vdotr == 0
        const float mj = sm[j];
        const float coef = -mj * ((pterm_i + spt[j] + visc) * dw) * inv_r;
        ax += coef * dx;
        ay += coef * dy;
        az += coef * dz;
        const float vgw = vdotr * inv_r * dw;
        du += mj * vgw * (pterm_i + 0.5f * visc);
        araw += mj * vgw;
      }
      __syncthreads();
    }
  }
  if (row) {
    out_ax[i] = ax;
    out_ay[i] = ay;
    out_az[i] = az;
    out_du[i] = du;
    out_araw[i] = araw;
  }
}

}  // namespace

extern "C" {

// n rows in n / wg window groups; starts/ends are [n / wg, 9].
int density_fixed_h(const float* x, const float* y, const float* z,
                    const float* m, const float* h, const int* key,
                    const int* starts, const int* ends, float* rho_raw,
                    int n, int wg, void* stream) {
  const int groups = n / wg;
  if (groups > 0) {
    density_fixed_h_kernel<<<groups, wg, 0, (cudaStream_t)stream>>>(
        x, y, z, m, h, key, starts, ends, rho_raw, n);
  }
  return (int)cudaGetLastError();
}

int force_fixed_h(const float* x, const float* y, const float* z,
                  const float* vx, const float* vy, const float* vz,
                  const float* m, const float* h, const int* key,
                  const float* pres, const float* rho, const float* omega,
                  const float* cs, const float* alpha, const int* starts,
                  const int* ends, float* ax, float* ay, float* az,
                  float* du, float* araw, int n, int wg, float av_eps,
                  float beta_factor, void* stream) {
  const int groups = n / wg;
  if (groups > 0) {
    force_fixed_h_kernel<<<groups, wg, 0, (cudaStream_t)stream>>>(
        x, y, z, vx, vy, vz, m, h, key, pres, rho, omega, cs, alpha,
        starts, ends, ax, ay, az, du, araw, n, av_eps, beta_factor);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
