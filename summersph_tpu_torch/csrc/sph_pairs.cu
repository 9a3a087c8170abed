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
//   <name>_rows         <- density_fixed_h, density_var_h, force_fixed_h,
//                          force_var_h and grav_short in their row-slab form
//                          (_row_slices with rows=(p_rows, offset), the
//                          multi-device gather mode): the sums of a slice
//                          of the window groups against every column
//   pack_force          <- _pack (the force kernels' per-particle records)
// The variable-h forms are template instantiations of the fixed-h kernels
// (VARH), the gated forms of the ungated ones (GATED).
//
// Rows and columns: every kernel reads its rows (the group's own records,
// geo_rows, and for the force attr_rows; h, and for the force P and Omega,
// are read for the rows only) through pointers apart from its columns (geo,
// m, attr, sup2, indexed by the windows).  A whole-set launch passes the
// same records for both.  The `_rows` entry points launch the same
// instantiations as the ungated ones on a slice of the window groups: the
// caller passes the slice's row pointers (the columns' records from the
// slice's first row on), the windows of its groups (starts + g0 * 9) and
// its row count, and gets that many rows of output.  A row's bits depend
// only on its group's ranges and the columns, so the slabs of a launch,
// laid end to end, equal the whole launch bit for bit.
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
// What bounds them: FP32 scalar arithmetic and the instructions spent on
// candidates that are rejected, not bytes.  Each row tests about 10^3
// candidates (9 windows of ~100 candidates on the N = 1,048,576 disc;
// about 2,600 for the gravity windows, whose cells are r_cut wide), of
// which 6-15% lie inside the support.  The bytes are small by comparison: a
// 16-byte candidate record is read from device memory once per block and
// serves all its rows.  The sums are ragged, data-dependent scalar FP32
// work with divisions, an rsqrt and an exp per pair: wgmma, TMA tiles and
// the tensor cores have no use here.  The density pair is the cheapest
// (about 20 operations with fixed h, 31 with the grad-h sum, against 55-80
// for gravity and the force), so the density kernels are bound by the
// candidate test and staging more than by their arithmetic.
//
// Every pair kernel (density_kernel, force_kernel, grav_short_kernel)
// splits the candidate test from the pair arithmetic, so that a lane that
// rejects a candidate never waits while another lane of its warp runs the
// arithmetic of one it accepted:
//  - A block of NW = 8 warps owns one window group of `wg` consecutive
//    sorted rows (the block size is the kernel's own constant, not wg);
//    the group's rows are staged in shared memory once, and a warp takes
//    ROWS of them at a time (2 for the force, 4 for gravity and the
//    density).
//  - The group's 9 candidate ranges [starts[g, o], ends[g, o]), laid end to
//    end, are staged through shared memory in chunks of CHUNK = 1024
//    candidates as 16-byte records (x, y, z, key bits), with the range's
//    plane offset taken off the key, so that a row tests one key window
//    whatever range a candidate came from; the variable-h force kernel
//    stages 4 h_j^2 beside them, gravity and the density m_j (0 on dead
//    rows).  A typical SPH group fits one chunk; any range length is
//    walked whole, so no candidate is ever dropped (the TPU kernels' fixed window sizes could drop some and
//    counted them in window_overflow).  Staging goes through registers
//    (the key is rewritten on the way), in one flat loop with all of a
//    thread's loads in flight; four or five blocks are resident on an SM
//    (the density kernel asks for five, at 48 registers a thread), so one
//    block's staging overlaps the others' arithmetic, and there is no
//    second buffer inside a block, which would cost a resident block.
//  - Phase A, on every lane: the 32 lanes of a warp test 32 candidates per
//    load against the warp's ROWS rows, whose data are uniform registers:
//    the row's exact key mask k_j in [k_i + off - 1, k_i + off + 1], dx,
//    dy, dz, r^2 and the cutoff compare (the density's is r^2 < 4 h_i^2:
//    with variable h a gather sum at 2 h_i, as w and dW/dh vanish beyond
//    q = 2; its r = 0 self candidate passes and adds 0 in phase B, which is
//    cheaper than one more compare per test).  When a warp's rows share
//    one cell, as they mostly do, the density kernel tests the key window
//    once for all of them.  A survivor sets one bit of the lane's 32-bit
//    mask for that row: no ballot, no queue traffic per test.  (A first
//    version compacted survivors with __ballot_sync / __popc after every
//    32 candidates; that cost more than the test.)
//  - Phase B, on full warps, a row at a time: `compact` lays the set bits
//    of all lanes into the warp's queue in shared memory (one prefix sum
//    over the lanes' counts), then each lane takes queued candidates and
//    runs the whole pair arithmetic, reading x, y, z (and m_j for the
//    density and gravity) from shared memory and, for the force, one
//    32-byte record of the other fields (v, m, pterm_j, rho, cs, alpha;
//    with variable h 64 bytes, with h_j, 1 / h_j, 1 / (pi h_j^4)) by
//    index.  Those per-particle factors (pterm_j =
//    P_j / max(Omega_j rho_j^2, 1e-30), the powers of h_j) are formed once
//    per launch by pack_force_kernel, not per pair.
//  - Each lane keeps its own partial sums; one __shfl_xor_sync tree per
//    output ends the row's chunk, and lane 0 writes the row (adds to it
//    for a later chunk).  The density kernels keep a row's raw sums in
//    shared memory across chunks instead and write each row once, scaled
//    by 1 / (pi h_i^3), after the last chunk.  No float atomics: the bits
//    of a row depend only on its group's ranges, never on block placement
//    or on gating, so two launches agree bit for bit and a gated form
//    equals its ungated one.  Every multiply-add that decides those bits
//    is spelled out (dist2, w_shape_rn, dw_shape_rn, __fmaf_rn): ptxas
//    contracts a * b + c by context, differently per instantiation.
//  - The fused forms keep two masks, one for the SPH pairs (r^2 < 4 h^2,
//    or 4 max(h_i, h_j)^2) and one for the gravity pairs (0 < r^2 <
//    r_cut^2), and the force arithmetic spells out its fused multiply-adds,
//    so their SPH sums are the unfused kernel's bit for bit.
//
// The pair algebra follows the Pallas kernels term by term: the
// rsqrt(max(r^2, 1e-12)) form, the r^2 > 0 self exclusion in the density
// and gravity sums, the single-dW fixed-h force algebra and the two-dW
// variable-h one, the 1e-30 denominator guards, grav_shape for the spline
// softening and the Abramowitz-Stegun erf (erf_approx), not erff.  With
// variable h a force pair contributes while r < 2 max(h_i, h_j), so phase
// A cuts at max(4 h_i^2, 4 h_j^2), never at 4 h_i^2 alone, which would
// drop the j-side term of every pair with h_j > h_i.  The gravity split
// scalars (r_s, r_cut) change every step; the kernels read them from a
// two-float device buffer, as the Pallas kernels read them from the pack's
// pad rows, so the host never waits for them.  Every entry point launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

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

// ------------------------------------------------------------------------
// The warp-per-row machinery of the pair kernels (see the note at the
// top): chunk staging, the candidate test, the survivor queue, the row
// sums.

constexpr int NW = 8;                // warps per block
constexpr int NT = NW * 32;          // threads per block
constexpr int CHUNK = 1024;          // candidates staged at a time: one bit
                                     // per candidate in a lane's 32-bit mask
constexpr int ROWS_FORCE = 2;        // rows a warp tests per candidate load
constexpr int ROWS_GRAV = 4;
constexpr int ROWS_DENSITY = 4;
constexpr int WG_MAX = 128;          // rows of a window group, at most
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int KEY_NEVER = (int)0x80000000;  // a staged key no row accepts

// r^2 with its rounding spelled out, so that the candidate test (phase A)
// and the pair arithmetic (phase B) of every instantiation see one value.
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// a b + c d + e f, and the spline's w(q) and w'(q) (ops/kernels.py
// w_shape, dw_shape), with every fused multiply-add spelled out: the
// compiler contracts a * b + c by context, and the fused and unfused force
// kernels, like a gated kernel and its ungated form, must agree bit for
// bit.
__device__ __forceinline__ float fma3(float a, float b, float c, float d,
                                      float e, float f) {
  return __fmaf_rn(e, f, __fmaf_rn(c, d, __fmul_rn(a, b)));
}

__device__ __forceinline__ float w_shape_rn(float q) {
  if (q <= 1.0f) {
    const float q2 = __fmul_rn(q, q);
    return __fmaf_rn(__fmul_rn(0.75f, q2), q, __fmaf_rn(-1.5f, q2, 1.0f));
  }
  if (q <= 2.0f) {
    const float t = __fsub_rn(2.0f, q);
    return 0.25f * t * t * t;
  }
  return 0.0f;
}

__device__ __forceinline__ float dw_shape_rn(float q) {
  if (q <= 1.0f) return __fmaf_rn(2.25f * q, q, -3.0f * q);
  if (q <= 2.0f) {
    const float t = __fsub_rn(2.0f, q);
    return -0.75f * t * t;
  }
  return 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL_MASK, v, d);
  return v;
}

// Lane 0 writes a row's sum: the first chunk stores, a later one adds (the
// same thread wrote the row before, so it reads its own store).
__device__ __forceinline__ void store_row(float* __restrict__ out, int i,
                                          float v, bool first) {
  out[i] = first ? v : out[i] + v;
}

// The block's group: its 9 ranges into shared memory (ends clamped to the
// starts).  The caller synchronises the block before total_candidates.
__device__ __forceinline__ void load_ranges(const int* __restrict__ starts,
                                            const int* __restrict__ ends,
                                            int g, int* s_s, int* s_e) {
  if (threadIdx.x < 9) {
    const int s = starts[g * 9 + threadIdx.x];
    s_s[threadIdx.x] = s;
    s_e[threadIdx.x] = max(ends[g * 9 + threadIdx.x], s);
  }
}

__device__ __forceinline__ int total_candidates(const int* s_s,
                                                const int* s_e) {
  int total = 0;
#pragma unroll
  for (int o = 0; o < 9; ++o) total += s_e[o] - s_s[o];
  return total;
}

// Stage the candidates at positions [lo, lo + CHUNK) of the 9 ranges laid
// end to end, in that order; the slots up to the next multiple of 128 (the
// candidate test is unrolled by 4 x 32) get a record no row accepts.  srec
// gets (x, y, z, key - plane offset of the candidate's range), so that
// every row tests one key window [k_i - 1, k_i + 1] whatever range a
// candidate came from; sidx (if not null) its index in the sorted arrays;
// sextra (if not null) extra[index] (4 h_j^2 for the variable-h force, m_j
// for the density and gravity).  One flat loop, so that all of a thread's loads are in
// flight together.  Returns the number of 32-candidate tests; the caller
// synchronises the block afterwards.
__device__ __forceinline__ int stage_chunk(
    const int* s_s, const int* s_e, int lo, int total, float4* srec,
    int* sidx, float* sextra, const float4* __restrict__ geo,
    const float* __restrict__ extra) {
  const int cnt = max(min(CHUNK, total - lo), 0);
  const int n_it = (cnt + 127) / 128 * 4;
  for (int q = threadIdx.x; q < 32 * n_it; q += NT) {
    float4 c = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(KEY_NEVER));
    int src = 0;
    float ex = 0.0f;
    if (q < cnt) {
      // the range o that holds flat position lo + q
      const int pos = lo + q;
      int o = 0, cum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int len = s_e[k] - s_s[k];
        if (o == k && pos >= cum + len) {
          cum += len;
          o = k + 1;
        }
      }
      src = s_s[o] + (pos - cum);
      c = geo[src];
      c.w = __int_as_float(__float_as_int(c.w) - plane_offset(o));
      if (sextra != nullptr) ex = extra[src];
    }
    srec[q] = c;
    if (sidx != nullptr) sidx[q] = src;
    if (sextra != nullptr) sextra[q] = ex;
  }
  return n_it;
}

// In test k of a chunk, lane l takes the candidate in slot 32 k + (l + k /
// 4) % 32: the warp reads 32 consecutive records, and the slots of one
// lane's candidates rotate through the banks (one step every four tests,
// the unrolled stretch, so the rotation costs the test next to nothing),
// so that phase B reads a run of one lane's survivors (a dense clump,
// where nearly all survive) in as few passes as 32 scattered records take.
__device__ __forceinline__ int slot_of(int k, int lane) {
  return 32 * k + ((lane + (k >> 2)) & 31);
}

// Phase A's result for one row is a 32-bit mask per lane: bit k is set
// when the lane's candidate of test k (slot_of(k, lane)) survived.  compact lays
// the survivors' positions into the warp's queue in shared memory (lane 0's
// in ascending order, then lane 1's, ...) and returns how many there are,
// so that phase B runs one queued pair per lane on full warps.
__device__ __forceinline__ int compact(unsigned mask, unsigned short* slot,
                                       int lane) {
  __syncwarp();  // the queue's last readers are done
  const int mine = __popc(mask);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int below = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += below;
  }
  const int total = __shfl_sync(FULL_MASK, incl, 31);
  int w = incl - mine;
  while (mask != 0u) {
    const int k = __ffs((int)mask) - 1;
    mask &= mask - 1u;
    slot[w++] = (unsigned short)slot_of(k, lane);
  }
  __syncwarp();
  return total;
}

// Phase A of the density kernel: bit k of inside[u] is set when the lane's
// candidate of test k lies in row u's key window and inside its 2 h_u (w
// and dW/dh vanish beyond: the density gathers at h_i).  SAME: the rows
// share one key, as a warp's rows mostly do (rows are sorted by cell), so
// one key test serves them all.
template <int ROWS, bool SAME>
__device__ __forceinline__ void density_test(
    const float4* srec, int n_it, int lane, const float* rx, const float* ry,
    const float* rz, const int* rkey, const float* rsup, unsigned* inside) {
  for (int k0 = 0; k0 < n_it; k0 += 4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 c = srec[slot_of(k0 + kk, lane)];
      const int kj = __float_as_int(c.w);
      const unsigned bit = 1u << (k0 + kk);
      const bool key0 = (unsigned)kj - (unsigned)rkey[0] <= 2u;
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const float r2 = dist2(rx[u] - c.x, ry[u] - c.y, rz[u] - c.z);
        const bool in_key =
            SAME ? key0 : (unsigned)kj - (unsigned)rkey[u] <= 2u;
        if (in_key && r2 < rsup[u]) inside[u] |= bit;
      }
    }
  }
}

// rho_raw[i] = sum_j m_j w(r_ij / h_i) / (pi h_i^3) over the 9 windows,
// 0 < r_ij < 2 h_i (the self term is added by pairs.finalize_density).
// VARH also writes omega_raw[i] = sum_j m_j dW/dh(r_ij, h_i), whose shape
// is -(3 w(q) + q w'(q)) / (pi h_i^4) (pallas_pairs.py _density_body).
// geo holds the columns' (x, y, z, key bits), geo_rows and h the rows';
// m is the masked mass, staged beside the candidates as grav_short_kernel
// stages it.  A row's raw sums stay in
// shared memory (s_rho, s_om) until its last chunk; each row is written
// once, scaled, by one thread.
template <bool VARH, bool GATED>
__global__ void __launch_bounds__(NT, 5) density_kernel(
    const float4* __restrict__ geo, const float* __restrict__ m,
    const float4* __restrict__ geo_rows, const float* __restrict__ h,
    const int* __restrict__ starts,
    const int* __restrict__ ends, float* __restrict__ rho_raw,
    float* __restrict__ omega_raw, int wg, const int* __restrict__ worklist,
    const int* __restrict__ count) {
  constexpr int ROWS_A = ROWS_DENSITY;
  __shared__ float4 srec[CHUNK];
  __shared__ float smass[CHUNK];
  __shared__ unsigned short squeue[NW][CHUNK];
  __shared__ float4 s_rgeo[WG_MAX];
  __shared__ float s_rinv_h[WG_MAX], s_rsup[WG_MAX];
  __shared__ float s_rho[WG_MAX], s_om[VARH ? WG_MAX : 1];
  __shared__ int s_s[9], s_e[9];

  const int g = owned_group<GATED>(worklist, count);
  if constexpr (GATED) {
    if (g < 0) return;
  }
  load_ranges(starts, ends, g, s_s, s_e);
  if ((int)threadIdx.x < wg) {
    const float hi = h[g * wg + threadIdx.x];
    s_rgeo[threadIdx.x] = geo_rows[g * wg + threadIdx.x];
    s_rinv_h[threadIdx.x] = 1.0f / hi;
    s_rsup[threadIdx.x] = 4.0f * hi * hi;
  }
  __syncthreads();
  const int total = total_candidates(s_s, s_e);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned short* queue = squeue[warp];

  int lo = 0;
  do {
    // n_it tests of 32 candidates
    const int n_it = stage_chunk(s_s, s_e, lo, total, srec, nullptr, smass,
                                 geo, m);
    __syncthreads();
    for (int r0 = warp * ROWS_A; r0 < wg; r0 += NW * ROWS_A) {
      float rx[ROWS_A], ry[ROWS_A], rz[ROWS_A], rsup[ROWS_A];
      int rkey[ROWS_A];
      unsigned inside[ROWS_A];
#pragma unroll
      for (int u = 0; u < ROWS_A; ++u) {
        const int r = min(r0 + u, wg - 1);
        const float4 c = s_rgeo[r];
        rx[u] = c.x, ry[u] = c.y, rz[u] = c.z;
        rkey[u] = __float_as_int(c.w) - 1;
        rsup[u] = s_rsup[r];
        inside[u] = 0u;
      }
      bool same = true;
#pragma unroll
      for (int u = 1; u < ROWS_A; ++u) same = same && rkey[u] == rkey[0];
      if (same) {
        density_test<ROWS_A, true>(srec, n_it, lane, rx, ry, rz, rkey, rsup,
                                   inside);
      } else {
        density_test<ROWS_A, false>(srec, n_it, lane, rx, ry, rz, rkey,
                                    rsup, inside);
      }
#pragma unroll
      for (int u = 0; u < ROWS_A; ++u) {
        if (r0 + u >= wg) break;
        const float inv_hi = s_rinv_h[r0 + u];
        float rho = 0.0f, om = 0.0f;
        const int n_in = compact(inside[u], queue, lane);
        for (int t = lane; t < n_in; t += 32) {
          const int at = queue[t];
          const float4 c = srec[at];
          const float r2 = dist2(rx[u] - c.x, ry[u] - c.y, rz[u] - c.z);
          // r = 0, a row's own candidate, adds exactly 0
          const float mj = r2 > 0.0f ? smass[at] : 0.0f;
          const float q = r2 * rsqrtf(fmaxf(r2, 1.0e-12f)) * inv_hi;
          const float w = w_shape_rn(q);
          rho = __fmaf_rn(mj, w, rho);
          if constexpr (VARH) {
            om = __fmaf_rn(mj, -__fmaf_rn(q, dw_shape_rn(q),
                                          __fmul_rn(3.0f, w)), om);
          }
        }
        rho = warp_sum(rho);
        if constexpr (VARH) om = warp_sum(om);
        if (lane == 0) {
          // the same lane of the same warp owns row r0 + u in every chunk
          const bool first = lo == 0;
          s_rho[r0 + u] = first ? rho : s_rho[r0 + u] + rho;
          if constexpr (VARH) s_om[r0 + u] = first ? om : s_om[r0 + u] + om;
        }
      }
    }
    __syncthreads();
    lo += CHUNK;
  } while (lo < total);
  if ((int)threadIdx.x < wg) {
    const int i = g * wg + threadIdx.x;
    const float inv_hi = s_rinv_h[threadIdx.x];
    const float inv_pi_h3 = INV_PI * inv_hi * inv_hi * inv_hi;
    rho_raw[i] = s_rho[threadIdx.x] * inv_pi_h3;
    if constexpr (VARH) {
      omega_raw[i] = s_om[threadIdx.x] * inv_pi_h3 * inv_hi;
    }
  }
}

// The force kernels' per-particle records, formed once per launch (the
// counterpart of the TPU pack, pallas_pairs.py _pack: there a [F, N] slab
// with the key's bits in a float row for the DMA, here records a lane
// loads 16 bytes at a time): geo[i] = (x, y, z, key bits) for the
// candidate test, and for the pair arithmetic one record attr[i] that lies
// in one 32-byte sector of device memory (with VARH in two): vm = (vx, vy,
// vz, m with 0 on dead rows), thermo = (P / max(Omega rho^2, 1e-30), rho,
// cs, alpha) and, with VARH, hrec = (h, 1 / h, 1 / (pi h^4), 4 h^2) and
// four floats of padding; sup2[i] = 4 h^2 again, contiguous, for staging.
// Bound by bytes: 53 read and 48 written per particle (VARH 57 and 84).
constexpr int ATTR_FIXED = 2, ATTR_VAR = 4;   // float4s per attr record

template <bool VARH>
__global__ void pack_force_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ mass, const unsigned char* __restrict__ alive,
    const float* __restrict__ h, const int* __restrict__ key,
    const float* __restrict__ pres, const float* __restrict__ rho,
    const float* __restrict__ omega, const float* __restrict__ cs,
    const float* __restrict__ alpha, float4* __restrict__ geo,
    float4* __restrict__ attr, float* __restrict__ sup2, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  geo[i] = make_float4(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2],
                       __int_as_float(key[i]));
  float4* a = attr + (VARH ? ATTR_VAR : ATTR_FIXED) * i;
  a[0] = make_float4(vel[3 * i], vel[3 * i + 1], vel[3 * i + 2],
                     alive[i] ? mass[i] : 0.0f);
  const float r = rho[i];
  a[1] = make_float4(pres[i] / fmaxf(omega[i] * r * r, 1.0e-30f), r, cs[i],
                     alpha[i]);
  if constexpr (VARH) {
    const float hc = h[i];
    const float ihc = 1.0f / hc;
    const float s2 = 4.0f * hc * hc;
    a[2] = make_float4(hc, ihc, (INV_PI * ihc * ihc) * (ihc * ihc), s2);
    a[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    sup2[i] = s2;
  }
}

// One row of the force kernel: its data, uniform over the warp, and this
// lane's partial sums.  attr holds the per-particle records of
// pack_force_kernel: vm, thermo and, with VARH, hrec.
template <bool VARH>
struct ForceRow {
  float x, y, z, vx, vy, vz, h, inv_h, inv_pi_h4, av_h2;
  float rho, pterm, cs, alpha;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, du = 0.0f, araw = 0.0f;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;

  // From the row's staged records: c = (x, y, z, key bits), vr = (vx, vy,
  // vz, rho), t = (pterm_i, cs, alpha, h).
  __device__ __forceinline__ void load(const float4 c, const float4 vr,
                                       const float4 t, float av_eps) {
    x = c.x, y = c.y, z = c.z;
    vx = vr.x, vy = vr.y, vz = vr.z, rho = vr.w;
    pterm = t.x, cs = t.y, alpha = t.z, h = t.w;
    inv_h = 1.0f / h;
    inv_pi_h4 = INV_PI * inv_h * inv_h * inv_h * inv_h;
    av_h2 = av_eps * h * h;
  }

  // Pressure + Monaghan viscosity of the pair (row, j), j = sorted index
  // of the candidate staged as c.  Without VARH (fixed h, h_j == h_i) one
  // dW serves both sides.  VARH is the grad-h form: dW_i = w'(r/h_i) / (pi
  // h_i^4), dW_j = w'(r/h_j) / (pi h_j^4), their mean dWbar in the viscous
  // and heating terms, hbar = (h_i + h_j) / 2 in mu and in av_eps hbar^2.
  // Self pairs vanish without a guard: dw(0) == 0 and vdotr == 0.  While
  // the queue holds more than a warp's worth, phase B runs two queued
  // pairs per lane at a time, to have both pairs' reads in flight; a lane
  // without a second pair repeats its first with `live` false, which adds
  // zeros.
  __device__ __forceinline__ void sph_pair(
      const float4 c, int j, bool live, const float4* __restrict__ attr,
      float av_eps, float beta_factor) {
    const float4* a = attr + (VARH ? ATTR_VAR : ATTR_FIXED) * j;
    const float4 v = a[0];
    const float4 t = a[1];
    const float dx = x - c.x;
    const float dy = y - c.y;
    const float dz = z - c.z;
    const float r2 = dist2(dx, dy, dz);
    const float inv_r = rsqrtf(fmaxf(r2, 1.0e-12f));
    const float r = r2 * inv_r;
    const float mj = live ? v.w : 0.0f;  // every term carries m_j
    const float dvx = vx - v.x;
    const float dvy = vy - v.y;
    const float dvz = vz - v.z;
    const float vdotr = fma3(dvx, dx, dvy, dy, dvz, dz);
    const float cbar = 0.5f * (cs + t.z);
    const float abar = 0.5f * (alpha + t.w);
    const float rhobar = 0.5f * (rho + t.y);
    float dw_i = dw_shape_rn(r * inv_h) * inv_pi_h4;
    float dw_j = dw_i, dwbar = dw_i, hbar = h, av_hbar2 = av_h2;
    if constexpr (VARH) {
      const float4 hj = a[2];
      dw_j = dw_shape_rn(r * hj.y) * hj.z;
      dwbar = 0.5f * (dw_i + dw_j);
      hbar = 0.5f * (h + hj.x);
      av_hbar2 = av_eps * hbar * hbar;
    }
    const float mu = hbar * fminf(vdotr, 0.0f) / __fadd_rn(r2, av_hbar2);
    const float visc =
        __fmaf_rn(beta_factor * abar * mu, mu, -abar * cbar * mu)
        / fmaxf(rhobar, 1.0e-30f);
    // with fixed h: (pterm_i + pterm_j + visc) dW, one dW for both sides
    const float scal =
        VARH ? __fmaf_rn(visc, dwbar,
                         __fmaf_rn(t.x, dw_j, __fmul_rn(pterm, dw_i)))
             : (pterm + t.x + visc) * dw_i;
    const float coef = -mj * scal * inv_r;
    ax = __fmaf_rn(coef, dx, ax);
    ay = __fmaf_rn(coef, dy, ay);
    az = __fmaf_rn(coef, dz, az);
    const float vgw = vdotr * inv_r * dwbar;
    du = __fmaf_rn(mj * vgw, __fmaf_rn(0.5f, visc, pterm), du);
    araw = __fmaf_rn(mj, vgw, araw);
  }

  // The short-range gravity of the pair (row, candidate c of mass mj),
  // 0 < r < r_cut (FUSE).
  __device__ __forceinline__ void grav_pair(const float4 c, float mj,
                                            const GravSplit& gs) {
    const float dx = x - c.x;
    const float dy = y - c.y;
    const float dz = z - c.z;
    const float r2 = dist2(dx, dy, dz);
    const float inv_r = rsqrtf(fmaxf(r2, 1.0e-12f));
    const float gc = gs.coef(r2 * inv_r, inv_r, inv_h, mj);
    gx += gc * dx;
    gy += gc * dy;
    gz += gc * dz;
  }
};

// (ax, ay, az, du, alpha_raw)[i]: pressure + Monaghan viscosity summed
// over the 9 windows; the pairs inside 2 h (VARH: inside 2 max(h_i, h_j),
// read from the staged 4 h_j^2).  FUSE adds (gx, gy, gz)[i], the
// short-range gravity sums over the same candidates for 0 < r < r_cut (the
// Pallas fuse_grav form), from a second mask of the same test; they equal
// the Pallas sums even on a step whose r_cut exceeds the SPH cell (a step
// integrate.py reports in the grav_window_overflow slot).  Without FUSE
// the split and gravity outputs are unused.  The rows' records are
// geo_rows and attr_rows (with h, pres, omega), the columns' geo, attr and
// sup2.
template <bool VARH, bool FUSE, bool GATED>
__global__ void __launch_bounds__(NT) force_kernel(
    const float4* __restrict__ geo, const float4* __restrict__ attr,
    const float* __restrict__ sup2, const float4* __restrict__ geo_rows,
    const float4* __restrict__ attr_rows, const float* __restrict__ h,
    const float* __restrict__ pres, const float* __restrict__ omega,
    const int* __restrict__ starts, const int* __restrict__ ends,
    float* __restrict__ out_ax, float* __restrict__ out_ay,
    float* __restrict__ out_az, float* __restrict__ out_du,
    float* __restrict__ out_araw, const float* __restrict__ split,
    float* __restrict__ out_gx, float* __restrict__ out_gy,
    float* __restrict__ out_gz, int wg, float av_eps, float beta_factor,
    const int* __restrict__ worklist, const int* __restrict__ count) {
  constexpr int ROWS_A = ROWS_FORCE;
  __shared__ float4 srec[CHUNK];
  __shared__ int sidx[CHUNK];
  __shared__ float ssup[VARH ? CHUNK : 1];
  __shared__ unsigned short squeue[NW][CHUNK];
  __shared__ float4 s_rgeo[WG_MAX], s_rvr[WG_MAX], s_rt[WG_MAX];
  __shared__ int s_s[9], s_e[9];

  const int g = owned_group<GATED>(worklist, count);
  if constexpr (GATED) {
    if (g < 0) return;
  }
  load_ranges(starts, ends, g, s_s, s_e);
  if ((int)threadIdx.x < wg) {
    // the group's rows; a row's own pressure term carries no guard
    // (pterm_j does)
    const int i = g * wg + threadIdx.x;
    const float4 v = attr_rows[(VARH ? ATTR_VAR : ATTR_FIXED) * i];
    const float4 t = attr_rows[(VARH ? ATTR_VAR : ATTR_FIXED) * i + 1];
    s_rgeo[threadIdx.x] = geo_rows[i];
    s_rvr[threadIdx.x] = make_float4(v.x, v.y, v.z, t.y);
    s_rt[threadIdx.x] = make_float4(pres[i] / (omega[i] * t.y * t.y), t.z,
                                    t.w, h[i]);
  }
  __syncthreads();
  const int total = total_candidates(s_s, s_e);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned short* queue = squeue[warp];
  GravSplit gs;
  if constexpr (FUSE) gs.load(split);

  int lo = 0;
  do {
    // n_it tests of 32 candidates
    const int n_it = stage_chunk(s_s, s_e, lo, total, srec, sidx,
                                 VARH ? ssup : nullptr, geo, sup2);
    __syncthreads();
    for (int r0 = warp * ROWS_A; r0 < wg; r0 += NW * ROWS_A) {
      // phase A: every lane tests its candidates against ROWS_A rows
      float rx[ROWS_A], ry[ROWS_A], rz[ROWS_A], rsup[ROWS_A];
      int rkey[ROWS_A];
      unsigned in_sph[ROWS_A], in_grav[ROWS_A];
#pragma unroll
      for (int u = 0; u < ROWS_A; ++u) {
        const int r = min(r0 + u, wg - 1);
        const float4 c = s_rgeo[r];
        const float hi = s_rt[r].w;
        rx[u] = c.x, ry[u] = c.y, rz[u] = c.z;
        rkey[u] = __float_as_int(c.w) - 1;
        rsup[u] = 4.0f * hi * hi;
        in_sph[u] = 0u, in_grav[u] = 0u;
      }
      for (int k0 = 0; k0 < n_it; k0 += 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int at = slot_of(k0 + kk, lane);
          const unsigned bit = 1u << (k0 + kk);
          const float4 c = srec[at];
          const int kj = __float_as_int(c.w);
          float sup_j = 0.0f;
          if constexpr (VARH) sup_j = ssup[at];
#pragma unroll
          for (int u = 0; u < ROWS_A; ++u) {
            const float r2 = dist2(rx[u] - c.x, ry[u] - c.y, rz[u] - c.z);
            // k_j in [k_i + off - 1, k_i + off + 1]
            const bool in_key = (unsigned)kj - (unsigned)rkey[u] <= 2u;
            // dw_shape vanishes beyond 2h, and so does every SPH term;
            // with variable h beyond 2 max(h_i, h_j)
            const float sph2 = VARH ? fmaxf(rsup[u], sup_j) : rsup[u];
            if (in_key && r2 < sph2) in_sph[u] |= bit;
            if constexpr (FUSE) {
              if (in_key && r2 > 0.0f && r2 < gs.rcut2) in_grav[u] |= bit;
            }
          }
        }
      }
      // phase B, a row at a time: the survivors on full warps
#pragma unroll
      for (int u = 0; u < ROWS_A; ++u) {
        if (r0 + u >= wg) break;
        const int i = g * wg + r0 + u;
        ForceRow<VARH> row;
        row.load(s_rgeo[r0 + u], s_rvr[r0 + u], s_rt[r0 + u], av_eps);
        const int n_sph = compact(in_sph[u], queue, lane);
        for (int t0 = 0; t0 < n_sph; t0 += 64) {
          const int t = t0 + lane;
          if (t0 + 32 < n_sph) {  // two rounds' worth: both in flight
            const bool two = t + 32 < n_sph;
            const int at0 = queue[t], at1 = queue[two ? t + 32 : t];
            const float4 c0 = srec[at0], c1 = srec[at1];
            const int j0 = sidx[at0], j1 = sidx[at1];
            row.sph_pair(c0, j0, true, attr, av_eps, beta_factor);
            row.sph_pair(c1, j1, two, attr, av_eps, beta_factor);
          } else if (t < n_sph) {
            const int at = queue[t];
            row.sph_pair(srec[at], sidx[at], true, attr, av_eps,
                         beta_factor);
          }
        }
        float gx = 0.0f, gy = 0.0f, gz = 0.0f;
        if constexpr (FUSE) {
          const int n_grav = compact(in_grav[u], queue, lane);
          constexpr int stride = VARH ? ATTR_VAR : ATTR_FIXED;
          for (int t = lane; t < n_grav; t += 32) {
            const int at = queue[t];
            row.grav_pair(srec[at], attr[stride * sidx[at]].w, gs);
          }
          gx = warp_sum(row.gx), gy = warp_sum(row.gy);
          gz = warp_sum(row.gz);
        }
        const float ax = warp_sum(row.ax), ay = warp_sum(row.ay);
        const float az = warp_sum(row.az), du = warp_sum(row.du);
        const float araw = warp_sum(row.araw);
        if (lane == 0) {
          const bool first = lo == 0;
          store_row(out_ax, i, ax, first);
          store_row(out_ay, i, ay, first);
          store_row(out_az, i, az, first);
          store_row(out_du, i, du, first);
          store_row(out_araw, i, araw, first);
          if constexpr (FUSE) {
            store_row(out_gx, i, gx, first);
            store_row(out_gy, i, gy, first);
            store_row(out_gz, i, gz, first);
          }
        }
      }
    }
    __syncthreads();
    lo += CHUNK;
  } while (lo < total);
}

// (gx, gy, gz)[i] = sum_j -G m_j [f(r_ij / h_i) - S(r_ij)] r_ij / r_ij^3
// over 0 < r_ij < r_cut: the TreePM short-range complement, on the
// gravity sort (cells r_cut wide, ops/pm_gravity.py pm_short_range).  geo
// holds the columns' (x, y, z, key bits), geo_rows and h the rows'; m is
// the masked mass, staged beside the candidates, so the pair arithmetic
// reads shared memory only.
template <bool GATED>
__global__ void __launch_bounds__(NT) grav_short_kernel(
    const float4* __restrict__ geo, const float* __restrict__ m,
    const float4* __restrict__ geo_rows, const float* __restrict__ h,
    const int* __restrict__ starts,
    const int* __restrict__ ends, const float* __restrict__ split,
    float* __restrict__ out_gx, float* __restrict__ out_gy,
    float* __restrict__ out_gz, int wg, const int* __restrict__ worklist,
    const int* __restrict__ count) {
  constexpr int ROWS_A = ROWS_GRAV;
  __shared__ float4 srec[CHUNK];
  __shared__ float smass[CHUNK];
  __shared__ unsigned short squeue[NW][CHUNK];
  __shared__ float4 s_rgeo[WG_MAX];
  __shared__ float s_rinv_h[WG_MAX];
  __shared__ int s_s[9], s_e[9];

  const int g = owned_group<GATED>(worklist, count);
  if constexpr (GATED) {
    if (g < 0) return;
  }
  load_ranges(starts, ends, g, s_s, s_e);
  if ((int)threadIdx.x < wg) {
    s_rgeo[threadIdx.x] = geo_rows[g * wg + threadIdx.x];
    s_rinv_h[threadIdx.x] = 1.0f / h[g * wg + threadIdx.x];
  }
  __syncthreads();
  const int total = total_candidates(s_s, s_e);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned short* queue = squeue[warp];
  GravSplit gs;
  gs.load(split);

  int lo = 0;
  do {
    // n_it tests of 32 candidates
    const int n_it = stage_chunk(s_s, s_e, lo, total, srec, nullptr, smass,
                                 geo, m);
    __syncthreads();
    for (int r0 = warp * ROWS_A; r0 < wg; r0 += NW * ROWS_A) {
      float rx[ROWS_A], ry[ROWS_A], rz[ROWS_A];
      int rkey[ROWS_A];
      unsigned inside[ROWS_A];
#pragma unroll
      for (int u = 0; u < ROWS_A; ++u) {
        const float4 c = s_rgeo[min(r0 + u, wg - 1)];
        rx[u] = c.x, ry[u] = c.y, rz[u] = c.z;
        rkey[u] = __float_as_int(c.w) - 1;
        inside[u] = 0u;
      }
      for (int k0 = 0; k0 < n_it; k0 += 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 c = srec[slot_of(k0 + kk, lane)];
          const int kj = __float_as_int(c.w);
          const unsigned bit = 1u << (k0 + kk);
#pragma unroll
          for (int u = 0; u < ROWS_A; ++u) {
            const float r2 = dist2(rx[u] - c.x, ry[u] - c.y, rz[u] - c.z);
            if ((unsigned)kj - (unsigned)rkey[u] <= 2u && r2 > 0.0f
                && r2 < gs.rcut2) {
              inside[u] |= bit;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < ROWS_A; ++u) {
        if (r0 + u >= wg) break;
        const int i = g * wg + r0 + u;
        const float inv_hi = s_rinv_h[r0 + u];
        float gx = 0.0f, gy = 0.0f, gz = 0.0f;
        const int n_in = compact(inside[u], queue, lane);
        auto pair = [&](const float4 c, float mj) {
          const float dx = rx[u] - c.x;
          const float dy = ry[u] - c.y;
          const float dz = rz[u] - c.z;
          const float r2 = dist2(dx, dy, dz);
          const float inv_r = rsqrtf(fmaxf(r2, 1.0e-12f));
          const float gc = gs.coef(r2 * inv_r, inv_r, inv_hi, mj);
          gx += gc * dx;
          gy += gc * dy;
          gz += gc * dz;
        };
        for (int t = lane; t < n_in; t += 32) {
          const int at = queue[t];
          pair(srec[at], smass[at]);
        }
        gx = warp_sum(gx), gy = warp_sum(gy), gz = warp_sum(gz);
        if (lane == 0) {
          const bool first = lo == 0;
          store_row(out_gx, i, gx, first);
          store_row(out_gy, i, gy, first);
          store_row(out_gz, i, gz, first);
        }
      }
    }
    __syncthreads();
    lo += CHUNK;
  } while (lo < total);
}

// The launchers: a block of NT threads per window group of the rows,
// whatever wg is, gated or not (GATED launches the same grid; see the note
// on gating at the top).  n is the number of rows; the columns are only
// ever indexed through the windows.
#define SPH_GEO_PARAMS                                                       \
  const float4 *geo, const float *m, const float *h, const int *starts,     \
      const int *ends
#define SPH_GEO_ARGS geo, m, geo, h, starts, ends
#define SPH_GEO_ROWS_PARAMS                                                  \
  const float4 *geo, const float *m, const float4 *geo_rows, const float *h, \
      const int *starts, const int *ends
#define SPH_GEO_ROWS_ARGS geo, m, geo_rows, h, starts, ends
#define SPH_FORCE_OUT_PARAMS                                                 \
  const float *h, const float *pres, const float *omega, const int *starts, \
      const int *ends, float *ax, float *ay, float *az, float *du,           \
      float *araw
#define SPH_FORCE_PARAMS                                                     \
  const float4 *geo, const float4 *attr, const float *sup2,                  \
      SPH_FORCE_OUT_PARAMS
#define SPH_FORCE_ARGS                                                       \
  geo, attr, sup2, geo, attr, h, pres, omega, starts, ends, ax, ay, az, du, \
      araw
#define SPH_FORCE_ROWS_PARAMS                                                \
  const float4 *geo, const float4 *attr, const float *sup2,                  \
      const float4 *geo_rows, const float4 *attr_rows, SPH_FORCE_OUT_PARAMS
#define SPH_FORCE_ROWS_ARGS                                                  \
  geo, attr, sup2, geo_rows, attr_rows, h, pres, omega, starts, ends, ax,   \
      ay, az, du, araw
#define SPH_GRAV_OUT_PARAMS const float *split, float *gx, float *gy, float *gz
#define SPH_GATE_PARAMS const int *worklist, const int *count

template <bool VARH, bool GATED>
int launch_density(SPH_GEO_ROWS_PARAMS, float* rho_raw, float* omega_raw,
                   SPH_GATE_PARAMS, int n, int wg, void* stream) {
  if (wg < 1 || wg > WG_MAX) return (int)cudaErrorInvalidValue;
  const int groups = n / wg;
  if (groups > 0) {
    density_kernel<VARH, GATED><<<groups, NT, 0, (cudaStream_t)stream>>>(
        SPH_GEO_ROWS_ARGS, rho_raw, omega_raw, wg, worklist, count);
  }
  return (int)cudaGetLastError();
}

template <bool VARH, bool FUSE, bool GATED>
int launch_force(SPH_FORCE_ROWS_PARAMS, SPH_GRAV_OUT_PARAMS, SPH_GATE_PARAMS,
                 int n, int wg, float av_eps, float beta_factor,
                 void* stream) {
  if (wg < 1 || wg > WG_MAX) return (int)cudaErrorInvalidValue;
  const int groups = n / wg;
  if (groups > 0) {
    force_kernel<VARH, FUSE, GATED><<<groups, NT, 0, (cudaStream_t)stream>>>(
        SPH_FORCE_ROWS_ARGS, split, gx, gy, gz, wg, av_eps, beta_factor,
        worklist, count);
  }
  return (int)cudaGetLastError();
}

template <bool GATED>
int launch_grav_short(SPH_GEO_ROWS_PARAMS, SPH_GRAV_OUT_PARAMS,
                      SPH_GATE_PARAMS, int n, int wg, void* stream) {
  if (wg < 1 || wg > WG_MAX) return (int)cudaErrorInvalidValue;
  const int groups = n / wg;
  if (groups > 0) {
    grav_short_kernel<GATED><<<groups, NT, 0, (cudaStream_t)stream>>>(
        SPH_GEO_ROWS_ARGS, split, gx, gy, gz, wg, worklist, count);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n rows in n / wg window groups, wg at most WG_MAX; starts/ends are
// [n / wg, 9].  Every `_gated` entry point takes its ungated form's
// arguments, then worklist [n / wg] and count [1] (device pointers), then
// n, wg, ..., stream.  The force entry points take the per-particle records
// of pack_force (geo [n, 4], attr [n, 8] or with variable h [n, 16], sup2
// [n] or null), the density and gravity entry points geo and the masked
// mass m.  Every `_rows` entry point (the row-slab form) takes the
// columns' records and mass, then the rows' (geo_rows, and for the force
// attr_rows), then h (P, Omega) of the n rows, the windows of their n / wg
// groups and the n rows' outputs.

int density_fixed_h(SPH_GEO_PARAMS, float* rho_raw, int n, int wg,
                    void* stream) {
  return launch_density<false, false>(SPH_GEO_ARGS, rho_raw, nullptr,
                                      nullptr, nullptr, n, wg, stream);
}

int density_fixed_h_gated(SPH_GEO_PARAMS, float* rho_raw,
                          SPH_GATE_PARAMS, int n, int wg, void* stream) {
  return launch_density<false, true>(SPH_GEO_ARGS, rho_raw, nullptr,
                                     worklist, count, n, wg, stream);
}

int density_fixed_h_rows(SPH_GEO_ROWS_PARAMS, float* rho_raw, int n, int wg,
                         void* stream) {
  return launch_density<false, false>(SPH_GEO_ROWS_ARGS, rho_raw, nullptr,
                                      nullptr, nullptr, n, wg, stream);
}

// density_fixed_h plus the grad-h sums omega_raw (variable h).
int density_var_h(SPH_GEO_PARAMS, float* rho_raw, float* omega_raw,
                  int n, int wg, void* stream) {
  return launch_density<true, false>(SPH_GEO_ARGS, rho_raw, omega_raw,
                                     nullptr, nullptr, n, wg, stream);
}

int density_var_h_gated(SPH_GEO_PARAMS, float* rho_raw,
                        float* omega_raw, SPH_GATE_PARAMS, int n, int wg,
                        void* stream) {
  return launch_density<true, true>(SPH_GEO_ARGS, rho_raw, omega_raw,
                                    worklist, count, n, wg, stream);
}

int density_var_h_rows(SPH_GEO_ROWS_PARAMS, float* rho_raw, float* omega_raw,
                       int n, int wg, void* stream) {
  return launch_density<true, false>(SPH_GEO_ROWS_ARGS, rho_raw, omega_raw,
                                     nullptr, nullptr, n, wg, stream);
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

int force_fixed_h_rows(SPH_FORCE_ROWS_PARAMS, int n, int wg, float av_eps,
                       float beta_factor, void* stream) {
  return launch_force<false, false, false>(
      SPH_FORCE_ROWS_ARGS, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, n, wg, av_eps, beta_factor, stream);
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

// The variable-h forms of the force entry points above, with the same
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

int force_var_h_rows(SPH_FORCE_ROWS_PARAMS, int n, int wg, float av_eps,
                     float beta_factor, void* stream) {
  return launch_force<true, false, false>(
      SPH_FORCE_ROWS_ARGS, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, n, wg, av_eps, beta_factor, stream);
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

// The force kernels' records of n particles (pack_force_kernel): geo
// [n, 4], attr [n, 8], or with var_h [n, 16] and sup2 [n]; pos and vel are
// [n, 3], alive one byte a row.
int pack_force(const float* pos, const float* vel, const float* mass,
               const unsigned char* alive, const float* h, const int* key,
               const float* pres, const float* rho, const float* omega,
               const float* cs, const float* alpha, float4* geo,
               float4* attr, float* sup2, int n, int var_h, void* stream) {
  if (n > 0) {
    const int blocks = (n + NT - 1) / NT;
    if (var_h) {
      pack_force_kernel<true><<<blocks, NT, 0, (cudaStream_t)stream>>>(
          pos, vel, mass, alive, h, key, pres, rho, omega, cs, alpha, geo,
          attr, sup2, n);
    } else {
      pack_force_kernel<false><<<blocks, NT, 0, (cudaStream_t)stream>>>(
          pos, vel, mass, alive, h, key, pres, rho, omega, cs, alpha, geo,
          attr, sup2, n);
    }
  }
  return (int)cudaGetLastError();
}

// Short-range gravity sums on the gravity sort; split is {r_s, r_cut}.
int grav_short(SPH_GEO_PARAMS, SPH_GRAV_OUT_PARAMS, int n, int wg,
               void* stream) {
  return launch_grav_short<false>(SPH_GEO_ARGS, split, gx, gy, gz, nullptr,
                                  nullptr, n, wg, stream);
}

int grav_short_gated(SPH_GEO_PARAMS, SPH_GRAV_OUT_PARAMS, SPH_GATE_PARAMS,
                     int n, int wg, void* stream) {
  return launch_grav_short<true>(SPH_GEO_ARGS, split, gx, gy, gz, worklist,
                                 count, n, wg, stream);
}

int grav_short_rows(SPH_GEO_ROWS_PARAMS, SPH_GRAV_OUT_PARAMS, int n, int wg,
                    void* stream) {
  return launch_grav_short<false>(SPH_GEO_ROWS_ARGS, split, gx, gy, gz,
                                  nullptr, nullptr, n, wg, stream);
}

}  // extern "C"
