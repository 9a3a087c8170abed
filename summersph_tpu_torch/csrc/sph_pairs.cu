// Pair kernels for Hopper (sm_90a) over the sorted-window neighbour
// structure (ops/sorted_grid.py): the SPH density and force sums, with
// fixed or variable smoothing length, and the TreePM short-range gravity
// sums.
//
// Replaces the TPU Pallas kernels of summersph_tpu/ops/pallas_pairs.py:
//   density_fixed_h     <- _density_kernel / _density_body (B1), fixed h
//   density_var_h       <- the same B1 with fixed_h=False: rho_raw and the
//                          grad-h sum Omega_raw
//   force_fixed_h       <- _force_kernel / _force_body (B2), fixed h
//   force_fixed_h_grav  <- the same B2 with fuse_grav: the force sums plus
//                          the short-range gravity sums on the same pairs
//   force_var_h         <- B2 with fixed_h=False: two gradients dW(h_i),
//                          dW(h_j), their mean, and hbar in the viscosity
//   force_var_h_grav    <- B2 with fixed_h=False and fuse_grav
//   grav_short          <- _grav_kernel / _grav_body (B3)
//   <name>_gated        <- each of the seven in its gated form (_gate_plan,
//                          block timesteps): only the window groups on a
//                          worklist are computed
// The variable-h forms are template instantiations of the fixed-h kernels
// (VARH), the gated forms of the ungated ones (GATED); the fixed-h and the
// ungated instantiations compile to the code they had.
//
// Gating: the caller passes worklist [groups] (ids of the window groups
// that hold an active row, compacted to the front) and count [1], both on
// the device.  The launch still has `groups` blocks; block b reads count[0]
// itself, returns at once when b >= count[0], and otherwise owns group
// worklist[b].  The host never learns the count, so a substep does not
// wait for the card; an entry past the count is never read as a group.
// Rows of groups that are not listed are not written (the wrappers hand in
// zero-filled outputs).  Only rows are gated, never columns: an active row
// sums over every candidate, active or not.
//
// What bounds them: FP32 pair arithmetic.  Each row tests about 10^3
// candidates (9 windows of ~100 candidates on the N = 1,048,576 disc; a
// few thousand for the gravity windows, whose cells are r_cut wide), of
// which a small share lies inside the support.  The bytes read are small
// by comparison: one tile entry (20 bytes for the density and gravity
// sums, 52 for the force) is read from device memory once per block and
// serves all its rows.
//
// Design: one CUDA block per window group of `wg` consecutive sorted rows,
// one thread per row.  For each of the 9 plane offsets the block walks the
// group's whole candidate range [starts[g, o], ends[g, o]) in tiles of
// TILE candidates staged through shared memory (every thread of the block
// reads the same tile entry, a broadcast without bank conflicts).  Each
// thread applies its own row's exact key mask k_j in [k_i + off - 1,
// k_i + off + 1], skips candidates outside the support before any
// division, and accumulates in registers.  The tile loop runs for any
// range length, so a clustered core with 10^5 candidates per range is
// summed whole.  Because the kernels cover every [start, end), no
// candidate is ever dropped (the TPU kernels' fixed window sizes could
// drop some and counted them in window_overflow).
//
// The pair algebra follows the Pallas kernels term by term: the
// rsqrt(max(r^2, 1e-12)) form, the r^2 > 0 self exclusion in the density
// and gravity sums, the single-dW fixed-h force algebra and the two-dW
// variable-h one, the 1e-30 denominator guards, grav_shape for the spline
// softening and the Abramowitz-Stegun erf (erf_approx), not erff.  With
// variable h a force pair contributes while r < 2 max(h_i, h_j), so the
// force kernels skip per pair at max(4 h_i^2, 4 h_j^2) (and r_cut^2 when
// fused), never at 4 h_i^2 alone, which would drop the j-side term of every
// pair with h_j > h_i.  The j-side h, its reciprocal, 4 h_j^2 and
// 1 / (pi h_j^4) are formed once per tile entry, not once per pair.  The
// gravity split scalars (r_s, r_cut) change every step; the kernels read
// them from a two-float device buffer, as the Pallas kernels read them
// from the pack's pad rows, so the host never waits for them.  Every entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int KX = 1 << 20;
constexpr int KY = 1 << 10;
constexpr float INV_PI = 0.318309886183790671538f;
constexpr float SQRT_PI = 1.772453850905516027298f;
constexpr float G_GRAV = 39.47841760435743f;  // utils/units.py: 4 pi^2

__device__ __forceinline__ int plane_offset(int o) {
  return (o / 3 - 1) * KX + (o % 3 - 1) * KY;
}

// The window group this block owns, or -1 when it has none.  Ungated:
// group blockIdx.x.  GATED: worklist[blockIdx.x] while blockIdx.x <
// count[0] (the whole block takes the same branch, so returning on -1
// skips no barrier another thread waits at).
template <bool GATED>
__device__ __forceinline__ int owned_group(const int* __restrict__ worklist,
                                           const int* __restrict__ count) {
  if constexpr (GATED) {
    if ((int)blockIdx.x >= count[0]) return -1;
    const int g = worklist[blockIdx.x];
    return (unsigned)g < gridDim.x ? g : -1;
  } else {
    return blockIdx.x;
  }
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

// Spline softening factor f(q) of G m / r^2 (ops/kernels.py grav_shape).
__device__ __forceinline__ float grav_shape(float q) {
  const float q2 = q * q;
  const float q3 = q2 * q;
  if (q <= 1.0f) {
    return (40.0f * q3 - 36.0f * q3 * q2 + 15.0f * q3 * q3) / 30.0f;
  }
  if (q <= 2.0f) {
    return (80.0f * q3 - 90.0f * q2 * q2 + 36.0f * q3 * q2 - 5.0f * q3 * q3
            - 2.0f) / 30.0f;
  }
  return 1.0f;
}

// erf(x), x >= 0, from e^(-x^2): Abramowitz-Stegun 7.1.26
// (ops/pm_gravity.py erf_approx).
__device__ __forceinline__ float erf_approx(float x, float expmx2) {
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return 1.0f - poly * expmx2;
}

// The split scalars of one step, read from the device buffer {r_s, r_cut}.
struct GravSplit {
  float rcut2 = 0.0f, inv_2rs = 0.0f, inv_rs_sqrtpi = 0.0f;
  __device__ void load(const float* split) {
    const float r_s = split[0];
    const float r_cut = split[1];
    rcut2 = r_cut * r_cut;
    inv_2rs = 0.5f / r_s;
    inv_rs_sqrtpi = 1.0f / (r_s * SQRT_PI);
  }
  // -G m_j [f(r / h_i) - S(r)] / r^3: the short-range complement of the
  // mesh force (ops/pm_gravity.py _short_factor), to multiply dx, dy, dz.
  __device__ float coef(float r, float inv_r, float inv_hi, float mj) const {
    const float x = r * inv_2rs;
    const float expmx2 = expf(-x * x);
    const float s_mesh = erf_approx(x, expmx2) - r * inv_rs_sqrtpi * expmx2;
    const float gshort = grav_shape(r * inv_hi) - s_mesh;
    return -G_GRAV * mj * gshort * (inv_r * inv_r * inv_r);
  }
};

// rho_raw[i] = sum_j m_j w(r_ij / h_i) / (pi h_i^3) over the 9 windows,
// r_ij > 0 (the self term is added by pairs.finalize_density).  VARH also
// writes omega_raw[i] = sum_j m_j dW/dh(r_ij, h_i), whose shape is
// -(3 w(q) + q w'(q)) / (pi h_i^4) (pallas_pairs.py _density_body).
template <bool VARH, bool GATED>
__global__ void density_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const float* __restrict__ m,
    const float* __restrict__ h, const int* __restrict__ key,
    const int* __restrict__ starts, const int* __restrict__ ends,
    float* __restrict__ rho_raw, float* __restrict__ omega_raw, int n,
    const int* __restrict__ worklist, const int* __restrict__ count) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sm[TILE];
  __shared__ int sk[TILE];

  const int g = owned_group<GATED>(worklist, count);
  if constexpr (GATED) {
    if (g < 0) return;
  }
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
  float om = 0.0f;
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
        if constexpr (VARH) {
          const float q = r * inv_hi;
          const float w = w_shape(q);
          rho += sm[j] * w;
          om += sm[j] * -(3.0f * w + q * dw_shape(q));
        } else {
          rho += sm[j] * w_shape(r * inv_hi);
        }
      }
      __syncthreads();
    }
  }
  const float inv_pi_h3 = INV_PI * inv_hi * inv_hi * inv_hi;
  if (row) {
    rho_raw[i] = rho * inv_pi_h3;
    if constexpr (VARH) omega_raw[i] = om * inv_pi_h3 * inv_hi;
  }
}

// (ax, ay, az, du, alpha_raw)[i]: pressure + Monaghan viscosity summed
// over the 9 windows.  pterm_j = P_j / max(Omega_j rho_j^2, 1e-30) is
// formed once per tile entry.  Without VARH (fixed h, h_j == h_i) one dW
// serves both sides.  VARH is the grad-h form: dW_i = w'(r/h_i) / (pi
// h_i^4), dW_j = w'(r/h_j) / (pi h_j^4), their mean dWbar in the viscous
// and heating terms, hbar = (h_i + h_j) / 2 in mu and in av_eps hbar^2;
// h_j, 1 / h_j, 1 / (pi h_j^4) and 4 h_j^2 are staged per tile entry, and
// a pair is skipped only beyond max(4 h_i^2, 4 h_j^2).
// FUSE adds (gx, gy, gz)[i], the short-range gravity sums over the same
// candidates for 0 < r < r_cut (the Pallas fuse_grav form).  Its early
// skip is then at max(that support, r_cut^2), so the gravity sums equal
// the Pallas ones even on a step whose r_cut exceeds the SPH cell (a step
// integrate.py reports in the grav_window_overflow slot).  Without FUSE
// the split and gravity outputs are unused and the code is the plain
// force kernel's; without VARH it is the fixed-h kernel's.
template <bool VARH, bool FUSE, bool GATED>
__global__ void force_kernel(
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
    float* __restrict__ out_araw, const float* __restrict__ split,
    float* __restrict__ out_gx, float* __restrict__ out_gy,
    float* __restrict__ out_gz, int n, float av_eps, float beta_factor,
    const int* __restrict__ worklist, const int* __restrict__ count) {
  constexpr int VT = VARH ? TILE : 1;
  __shared__ float sx[TILE], sy[TILE], sz[TILE];
  __shared__ float svx[TILE], svy[TILE], svz[TILE];
  __shared__ float sm[TILE], spt[TILE], srho[TILE], scs[TILE], sal[TILE];
  __shared__ int sk[TILE];
  __shared__ float sh[VT], sinv_h[VT], sinv_pi_h4[VT], ssup2[VT];

  const int g = owned_group<GATED>(worklist, count);
  if constexpr (GATED) {
    if (g < 0) return;
  }
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
  float cutoff2 = support2;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  GravSplit gs;
  if constexpr (FUSE) {
    gs.load(split);
    cutoff2 = fmaxf(support2, gs.rcut2);
  }

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
        if constexpr (VARH) {
          const float hc = h[c];
          const float ihc = 1.0f / hc;
          sh[j] = hc;
          sinv_h[j] = ihc;
          sinv_pi_h4[j] = (INV_PI * ihc * ihc) * (ihc * ihc);
          ssup2[j] = 4.0f * hc * hc;
        }
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const int kj = sk[j];
        if (kj < lo || kj > hk) continue;
        const float dx = xi - sx[j];
        const float dy = yi - sy[j];
        const float dz = zi - sz[j];
        const float r2 = dx * dx + dy * dy + dz * dz;
        // dw_shape vanishes beyond 2h, and so does every SPH term below;
        // with variable h beyond 2 max(h_i, h_j)
        float sph2 = support2;
        float cut2 = cutoff2;
        if constexpr (VARH) {
          sph2 = fmaxf(support2, ssup2[j]);
          cut2 = fmaxf(cutoff2, ssup2[j]);
        }
        if (!(r2 < cut2)) continue;
        const float inv_r = rsqrtf(fmaxf(r2, 1.0e-12f));
        const float r = r2 * inv_r;
        const float mj = sm[j];
        if constexpr (FUSE) {
          if (r2 > 0.0f && r2 < gs.rcut2) {
            const float gc = gs.coef(r, inv_r, inv_hi, mj);
            gx += gc * dx;
            gy += gc * dy;
            gz += gc * dz;
          }
          if (!(r2 < sph2)) continue;
        }
        if constexpr (VARH) {
          const float dw_i = dw_shape(r * inv_hi) * inv_pi_hi4;
          const float dw_j = dw_shape(r * sinv_h[j]) * sinv_pi_h4[j];
          const float dwbar = 0.5f * (dw_i + dw_j);
          const float dvx = vxi - svx[j];
          const float dvy = vyi - svy[j];
          const float dvz = vzi - svz[j];
          const float vdotr = dvx * dx + dvy * dy + dvz * dz;
          const float hbar = 0.5f * (hi + sh[j]);
          const float mu = hbar * fminf(vdotr, 0.0f)
                           / (r2 + av_eps * hbar * hbar);
          const float cbar = 0.5f * (csi + scs[j]);
          const float abar = 0.5f * (ali + sal[j]);
          const float rhobar = 0.5f * (rhoi + srho[j]);
          const float visc = (-abar * cbar * mu + beta_factor * abar * mu * mu)
                             / fmaxf(rhobar, 1.0e-30f);
          // self pairs vanish without a guard: dw(0) == 0 and vdotr == 0
          const float scal = pterm_i * dw_i + spt[j] * dw_j + visc * dwbar;
          const float coef = -mj * scal * inv_r;
          ax += coef * dx;
          ay += coef * dy;
          az += coef * dz;
          const float vgw = vdotr * inv_r * dwbar;
          du += mj * vgw * (pterm_i + 0.5f * visc);
          araw += mj * vgw;
        } else {
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
          const float coef = -mj * ((pterm_i + spt[j] + visc) * dw) * inv_r;
          ax += coef * dx;
          ay += coef * dy;
          az += coef * dz;
          const float vgw = vdotr * inv_r * dw;
          du += mj * vgw * (pterm_i + 0.5f * visc);
          araw += mj * vgw;
        }
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
    if constexpr (FUSE) {
      out_gx[i] = gx;
      out_gy[i] = gy;
      out_gz[i] = gz;
    }
  }
}

// (gx, gy, gz)[i] = sum_j -G m_j [f(r_ij / h_i) - S(r_ij)] r_ij / r_ij^3
// over 0 < r_ij < r_cut: the TreePM short-range complement, on the
// gravity sort (cells r_cut wide, ops/pm_gravity.py pm_short_range).
template <bool GATED>
__global__ void grav_short_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const float* __restrict__ m,
    const float* __restrict__ h, const int* __restrict__ key,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const float* __restrict__ split, float* __restrict__ out_gx,
    float* __restrict__ out_gy, float* __restrict__ out_gz, int n,
    const int* __restrict__ worklist, const int* __restrict__ count) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sm[TILE];
  __shared__ int sk[TILE];

  const int g = owned_group<GATED>(worklist, count);
  if constexpr (GATED) {
    if (g < 0) return;
  }
  const int i = g * blockDim.x + threadIdx.x;
  const bool row = i < n;
  const float xi = row ? x[i] : 0.0f;
  const float yi = row ? y[i] : 0.0f;
  const float zi = row ? z[i] : 0.0f;
  const float inv_hi = 1.0f / (row ? h[i] : 1.0f);
  const int ki = row ? key[i] : 0;
  GravSplit gs;
  gs.load(split);

  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
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
        if (!(r2 > 0.0f && r2 < gs.rcut2)) continue;
        const float inv_r = rsqrtf(fmaxf(r2, 1.0e-12f));
        const float gc = gs.coef(r2 * inv_r, inv_r, inv_hi, sm[j]);
        gx += gc * dx;
        gy += gc * dy;
        gz += gc * dz;
      }
      __syncthreads();
    }
  }
  if (row) {
    out_gx[i] = gx;
    out_gy[i] = gy;
    out_gz[i] = gz;
  }
}

// The launchers: a block per window group, gated or not (GATED launches
// the same grid; see the note on gating at the top).
#define SPH_GEOMETRY_PARAMS                                                  \
  const float *x, const float *y, const float *z, const float *m,           \
      const float *h, const int *key, const int *starts, const int *ends
#define SPH_GEOMETRY_ARGS x, y, z, m, h, key, starts, ends
#define SPH_FORCE_PARAMS                                                     \
  const float *x, const float *y, const float *z, const float *vx,          \
      const float *vy, const float *vz, const float *m, const float *h,     \
      const int *key, const float *pres, const float *rho,                  \
      const float *omega, const float *cs, const float *alpha,              \
      const int *starts, const int *ends, float *ax, float *ay, float *az,  \
      float *du, float *araw
#define SPH_FORCE_ARGS                                                       \
  x, y, z, vx, vy, vz, m, h, key, pres, rho, omega, cs, alpha, starts,      \
      ends, ax, ay, az, du, araw
#define SPH_GRAV_OUT_PARAMS const float *split, float *gx, float *gy, float *gz
#define SPH_GATE_PARAMS const int *worklist, const int *count

template <bool VARH, bool GATED>
int launch_density(SPH_GEOMETRY_PARAMS, float* rho_raw, float* omega_raw,
                   SPH_GATE_PARAMS, int n, int wg, void* stream) {
  const int groups = n / wg;
  if (groups > 0) {
    density_kernel<VARH, GATED><<<groups, wg, 0, (cudaStream_t)stream>>>(
        SPH_GEOMETRY_ARGS, rho_raw, omega_raw, n, worklist, count);
  }
  return (int)cudaGetLastError();
}

template <bool VARH, bool FUSE, bool GATED>
int launch_force(SPH_FORCE_PARAMS, SPH_GRAV_OUT_PARAMS, SPH_GATE_PARAMS,
                 int n, int wg, float av_eps, float beta_factor,
                 void* stream) {
  const int groups = n / wg;
  if (groups > 0) {
    force_kernel<VARH, FUSE, GATED><<<groups, wg, 0, (cudaStream_t)stream>>>(
        SPH_FORCE_ARGS, split, gx, gy, gz, n, av_eps, beta_factor, worklist,
        count);
  }
  return (int)cudaGetLastError();
}

template <bool GATED>
int launch_grav_short(SPH_GEOMETRY_PARAMS, SPH_GRAV_OUT_PARAMS,
                      SPH_GATE_PARAMS, int n, int wg, void* stream) {
  const int groups = n / wg;
  if (groups > 0) {
    grav_short_kernel<GATED><<<groups, wg, 0, (cudaStream_t)stream>>>(
        SPH_GEOMETRY_ARGS, split, gx, gy, gz, n, worklist, count);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n rows in n / wg window groups; starts/ends are [n / wg, 9].  Every
// `_gated` entry point takes its ungated form's arguments, then worklist
// [n / wg] and count [1] (device pointers), then n, wg, ..., stream.

int density_fixed_h(SPH_GEOMETRY_PARAMS, float* rho_raw, int n, int wg,
                    void* stream) {
  return launch_density<false, false>(SPH_GEOMETRY_ARGS, rho_raw, nullptr,
                                      nullptr, nullptr, n, wg, stream);
}

int density_fixed_h_gated(SPH_GEOMETRY_PARAMS, float* rho_raw,
                          SPH_GATE_PARAMS, int n, int wg, void* stream) {
  return launch_density<false, true>(SPH_GEOMETRY_ARGS, rho_raw, nullptr,
                                     worklist, count, n, wg, stream);
}

// density_fixed_h plus the grad-h sums omega_raw (variable h).
int density_var_h(SPH_GEOMETRY_PARAMS, float* rho_raw, float* omega_raw,
                  int n, int wg, void* stream) {
  return launch_density<true, false>(SPH_GEOMETRY_ARGS, rho_raw, omega_raw,
                                     nullptr, nullptr, n, wg, stream);
}

int density_var_h_gated(SPH_GEOMETRY_PARAMS, float* rho_raw,
                        float* omega_raw, SPH_GATE_PARAMS, int n, int wg,
                        void* stream) {
  return launch_density<true, true>(SPH_GEOMETRY_ARGS, rho_raw, omega_raw,
                                    worklist, count, n, wg, stream);
}

int force_fixed_h(SPH_FORCE_PARAMS, int n, int wg, float av_eps,
                  float beta_factor, void* stream) {
  return launch_force<false, false, false>(
      SPH_FORCE_ARGS, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      n, wg, av_eps, beta_factor, stream);
}

int force_fixed_h_gated(SPH_FORCE_PARAMS, SPH_GATE_PARAMS, int n, int wg,
                        float av_eps, float beta_factor, void* stream) {
  return launch_force<false, false, true>(
      SPH_FORCE_ARGS, nullptr, nullptr, nullptr, nullptr, worklist, count, n,
      wg, av_eps, beta_factor, stream);
}

// force_fixed_h plus the short-range gravity sums gx, gy, gz; split is
// the device buffer {r_s, r_cut}.
int force_fixed_h_grav(SPH_FORCE_PARAMS, SPH_GRAV_OUT_PARAMS, int n, int wg,
                       float av_eps, float beta_factor, void* stream) {
  return launch_force<false, true, false>(
      SPH_FORCE_ARGS, split, gx, gy, gz, nullptr, nullptr, n, wg, av_eps,
      beta_factor, stream);
}

int force_fixed_h_grav_gated(SPH_FORCE_PARAMS, SPH_GRAV_OUT_PARAMS,
                             SPH_GATE_PARAMS, int n, int wg, float av_eps,
                             float beta_factor, void* stream) {
  return launch_force<false, true, true>(
      SPH_FORCE_ARGS, split, gx, gy, gz, worklist, count, n, wg, av_eps,
      beta_factor, stream);
}

// The variable-h forms of the four entry points above, with the same
// arguments.
int force_var_h(SPH_FORCE_PARAMS, int n, int wg, float av_eps,
                float beta_factor, void* stream) {
  return launch_force<true, false, false>(
      SPH_FORCE_ARGS, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      n, wg, av_eps, beta_factor, stream);
}

int force_var_h_gated(SPH_FORCE_PARAMS, SPH_GATE_PARAMS, int n, int wg,
                      float av_eps, float beta_factor, void* stream) {
  return launch_force<true, false, true>(
      SPH_FORCE_ARGS, nullptr, nullptr, nullptr, nullptr, worklist, count, n,
      wg, av_eps, beta_factor, stream);
}

int force_var_h_grav(SPH_FORCE_PARAMS, SPH_GRAV_OUT_PARAMS, int n, int wg,
                     float av_eps, float beta_factor, void* stream) {
  return launch_force<true, true, false>(
      SPH_FORCE_ARGS, split, gx, gy, gz, nullptr, nullptr, n, wg, av_eps,
      beta_factor, stream);
}

int force_var_h_grav_gated(SPH_FORCE_PARAMS, SPH_GRAV_OUT_PARAMS,
                           SPH_GATE_PARAMS, int n, int wg, float av_eps,
                           float beta_factor, void* stream) {
  return launch_force<true, true, true>(
      SPH_FORCE_ARGS, split, gx, gy, gz, worklist, count, n, wg, av_eps,
      beta_factor, stream);
}

// Short-range gravity sums on the gravity sort; split is {r_s, r_cut}.
int grav_short(SPH_GEOMETRY_PARAMS, SPH_GRAV_OUT_PARAMS, int n, int wg,
               void* stream) {
  return launch_grav_short<false>(SPH_GEOMETRY_ARGS, split, gx, gy, gz,
                                  nullptr, nullptr, n, wg, stream);
}

int grav_short_gated(SPH_GEOMETRY_PARAMS, SPH_GRAV_OUT_PARAMS,
                     SPH_GATE_PARAMS, int n, int wg, void* stream) {
  return launch_grav_short<true>(SPH_GEOMETRY_ARGS, split, gx, gy, gz,
                                 worklist, count, n, wg, stream);
}

}  // extern "C"
