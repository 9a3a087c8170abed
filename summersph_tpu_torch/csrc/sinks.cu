// Sink kernels for Hopper (sm_90a): direct sink gravity, sink creation,
// accretion and merging (ops/gravity.py sink_gravity, ops/sinks.py
// create_sinks, accrete, merge_sinks; the wrappers are ops/cuda_sinks.py).
//
// They replace no TPU kernel.  The JAX package computes these layers as
// masked [S, N] array operations (summersph_tpu/ops/gravity.py,
// summersph_tpu/ops/sinks.py), and the port's plain versions
// (sink_gravity_plain, create_sinks_plain, accrete_plain,
// merge_sinks_plain) repeat them.  On the card those became chains of
// elementwise passes over [S, N] temporaries (S = 128 slots: 512 MB each
// in float32), each pass rebuilding the same separations: 32.5 ms of a
// 45.3 ms config 5 step at N = 2^20 and S = 128 on an H100 80GB HBM3;
// these kernels take 0.08 ms of it there (0.51 ms with all 128 slots
// live), the layer's bound being ~0.05 ms of FP32 work or ~0.03 ms of
// bytes.
//
//   sink_gravity_pass    per particle, the pull of the live sinks; per
//                        block, the gas's pull on each live sink
//   sink_gravity_reduce  one block: the blocks' partials summed in block
//                        order, plus the [S, S] sink-sink term
//   create_sinks_pass    per particle, the code density m (eta / h)^3 and
//                        the near-real-sink test; per block, the first
//                        densest eligible particle
//   create_sinks_pick    one block: the first densest over the blocks (or
//                        over the ranks' gathered candidates), the first
//                        free slot and the new sink
//   accrete_pass         per particle, its nearest eligible sink (the
//                        first minimum, as torch.argmin); the accreted
//                        particle is parked and zeroed in the same pass;
//                        per block, [S, 10] sums (mass, momentum,
//                        mass-weighted position, angular momentum about
//                        the sink)
//   accrete_reduce       one block: the blocks' sums in block order and
//                        the sinks' update
//   merge_sinks          one block on the [S, S] pairs, the pointer
//                        jumping done on the device
//
// The particle passes read each particle once and loop over the S slots,
// staged in shared memory as a list of the slots that can contribute
// (live; for accretion and the near-sink test live and massive), in slot
// order.  A slot off the list contributes exactly +0 in the plain version
// (its mask is false), so skipping it changes no bit; the cost is that of
// the live slots, at most MAX_SLOTS (512, ops/cuda_sinks.py).  With all
// 128 slots of config 5 live the work is 2^27 sink-particle pairs of ~25
// FP32 operations at N = 2^20 (~0.05 ms at 67 TFLOP/s) and ~40 MB of
// particle fields read once (and for accretion written once: the pass
// writes new alive, mass, pos and vel rather than changing its inputs).
//
// Rules for the arithmetic:
//  - No float atomics: every sum across threads runs in a fixed order
//    (a shuffle tree per warp, warps in order; the accreted particles of a
//    block in particle order; the blocks' partials by a fixed group of
//    lanes a sum, then a shuffle tree: reduce_partials), so two launches
//    agree bit for bit (the rule that made the CIC deposit deterministic).
//    The grid of a particle pass is a function of N alone (the wrappers'
//    blocks()), never of the card.
//  - Every quantity that decides a mask, an index or a slot (the squared
//    separations, the accretion and merge radii squared, the code
//    density, the near-sink reach) is formed in the plain version's order
//    with the rounding written out (mul_rn, add_rn, sub_rn, div_rn), so
//    that ptxas contracts nothing: every decision on the card equals the
//    plain version's.  The sums themselves are float sums in another
//    order than torch's, held to tolerances.
//
// Every entry point takes float32 or float64 (dbl), launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int NT = 256;          // threads of a particle-pass block
constexpr int NW = NT / 32;
constexpr int PPT = 4;           // particles a thread holds in sink_gravity
constexpr int RT = 512;          // threads of a one-block kernel
constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = INT_MAX;    // no candidate particle
constexpr double PARK = 1.0e12;  // state.PARK_POSITION

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float rsqrt_t(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_t(double a) { return rsqrt(a); }

// dx^2 + dy^2 + dz^2 in the plain versions' order, each step rounded.
template <typename T>
__device__ __forceinline__ T dist2(T dx, T dy, T dz) {
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

// Dynamic shared memory, carved in 16-byte aligned pieces; piece() is
// its host-side twin.
extern __shared__ __align__(16) unsigned char smem[];

struct Carve {
  unsigned char* p;
  template <typename U>
  __device__ U* take(int n) {
    U* r = reinterpret_cast<U*>(p);
    p += ((size_t)n * sizeof(U) + 15) & ~(size_t)15;
    return r;
  }
};

template <typename U>
size_t piece(int n) { return ((size_t)n * sizeof(U) + 15) & ~(size_t)15; }

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The slots k < S with keep(k), in slot order, into list[0, L); returns L
// to every thread.  flags: S bytes of shared scratch, count one int.
template <typename Keep>
__device__ int compact_slots(int S, Keep keep, unsigned char* flags,
                             int* list, int* count) {
  for (int k = threadIdx.x; k < S; k += blockDim.x) flags[k] = keep(k);
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    int base = 0;
    for (int c = 0; c < S; c += 32) {
      const int k = c + lane;
      const bool f = k < S && flags[k];
      const unsigned m = __ballot_sync(FULL, f);
      if (f) list[base + __popc(m & ((1u << lane) - 1u))] = k;
      base += __popc(m);
    }
    if (lane == 0) *count = base;
  }
  __syncthreads();
  return *count;
}

// red[k * C + c] = the sum over b < B of part[b, k, c] for the L slots k
// of list, by G lanes a sum: lane l of a group adds b = l, l + G, ... in
// order, then a shuffle tree of width G.  G, the most lanes up to 32 that
// give every sum its group in one pass of the block, depends on L and C
// alone, so the order is fixed: a few live slots take a warp a sum, all
// 128 one thread a sum (coalesced over the sums).  The other entries of
// red are left as they are.
template <typename T>
__device__ void reduce_partials(const T* __restrict__ part, int B, int S,
                                int C, const int* list, int L, T* red) {
  const int items = L * C;
  int G = 32;
  while (G > 1 && G * items > (int)blockDim.x) G >>= 1;
  const int lane = threadIdx.x % G, per_pass = blockDim.x / G;
  for (int base = 0; base < items; base += per_pass) {
    const int j = base + threadIdx.x / G;
    const int k = j < items ? list[j / C] : 0, c = j % C;
    T sum = T(0);
    if (j < items) {
#pragma unroll 4
      for (int b = lane; b < B; b += G) {
        sum += part[((long long)b * S + k) * C + c];
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1) {
      sum += __shfl_down_sync(FULL, sum, o, G);
    }
    if (j < items && lane == 0) red[k * C + c] = sum;
  }
}

// ------------------------------------------------------------- sink gravity

template <typename T>
size_t gravity_pass_smem(int S) {
  return piece<unsigned char>(S) + piece<int>(S) + piece<int>(1)
      + 4 * piece<T>(S) + piece<T>(NW * S * 3);
}

// acc[i] = sum over live sinks k of G m_k d / r^3 (d = sink - particle),
// masked pairs (a dead particle, r2 = 0) 0, and 0 on dead rows; part[b, k]
// = -sum over block b's particles of G m_i d / r^3 (the gas's pull on
// sink k), written for live k only.
template <typename T>
__global__ void __launch_bounds__(NT) sink_gravity_pass_kernel(
    const T* __restrict__ pos, const T* __restrict__ mass,
    const unsigned char* __restrict__ alive, const T* __restrict__ spos,
    const T* __restrict__ smass, const unsigned char* __restrict__ salive,
    T* __restrict__ acc, T* __restrict__ part, int n, int S, double G_) {
  Carve sm{smem};
  unsigned char* flags = sm.take<unsigned char>(S);
  int* list = sm.take<int>(S);
  int* count = sm.take<int>(1);
  T* sx = sm.take<T>(S);
  T* sy = sm.take<T>(S);
  T* sz = sm.take<T>(S);
  T* sms = sm.take<T>(S);
  T* wacc = sm.take<T>(NW * S * 3);   // per warp and live slot

  const int L = compact_slots(
      S, [&](int k) { return salive[k] != 0; }, flags, list, count);
  for (int j = threadIdx.x; j < L; j += NT) {
    const int k = list[j];
    sx[j] = spos[3 * k];
    sy[j] = spos[3 * k + 1];
    sz[j] = spos[3 * k + 2];
    sms[j] = smass[k];
  }
  for (int j = threadIdx.x; j < NW * L * 3; j += NT) wacc[j] = T(0);
  __syncthreads();

  const T G = (T)G_;
  const T tiny = (T)1.0e-12;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = (long long)NT * PPT;
  for (long long base = blockIdx.x * tile; base < n;
       base += (long long)gridDim.x * tile) {
    T px[PPT], py[PPT], pz[PPT], pm[PPT], ax[PPT], ay[PPT], az[PPT];
    bool ok[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const long long i = base + threadIdx.x + j * NT;
      const bool in = i < n;
      ok[j] = in && alive[i];
      px[j] = in ? pos[3 * i] : T(0);
      py[j] = in ? pos[3 * i + 1] : T(0);
      pz[j] = in ? pos[3 * i + 2] : T(0);
      pm[j] = ok[j] ? mass[i] : T(0);
      ax[j] = ay[j] = az[j] = T(0);
    }
    for (int kk = 0; kk < L; ++kk) {
      const T X = sx[kk], Y = sy[kk], Z = sz[kk], M = sms[kk];
      T fx = T(0), fy = T(0), fz = T(0);
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const T dx = sub_rn(X, px[j]), dy = sub_rn(Y, py[j]),
                dz = sub_rn(Z, pz[j]);
        const T r2 = dist2(dx, dy, dz);
        const T ir = rsqrt_t(r2 > tiny ? r2 : tiny);
        const T w = (ok[j] && r2 > T(0))
            ? mul_rn(G, mul_rn(mul_rn(ir, ir), ir)) : T(0);
        const T ws = mul_rn(w, M), wp = mul_rn(w, pm[j]);
        ax[j] += ws * dx;
        ay[j] += ws * dy;
        az[j] += ws * dz;
        fx += wp * dx;
        fy += wp * dy;
        fz += wp * dz;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        fx += __shfl_down_sync(FULL, fx, o);
        fy += __shfl_down_sync(FULL, fy, o);
        fz += __shfl_down_sync(FULL, fz, o);
      }
      if (lane == 0) {
        T* a = wacc + (warp * L + kk) * 3;
        a[0] += fx;
        a[1] += fy;
        a[2] += fz;
      }
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const long long i = base + threadIdx.x + j * NT;
      if (i < n) {
        acc[3 * i] = ok[j] ? ax[j] : T(0);
        acc[3 * i + 1] = ok[j] ? ay[j] : T(0);
        acc[3 * i + 2] = ok[j] ? az[j] : T(0);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L * 3; j += NT) {
    const int kk = j / 3, c = j - 3 * kk;
    T sum = T(0);
    for (int w = 0; w < NW; ++w) sum += wacc[(w * L + kk) * 3 + c];
    part[((long long)blockIdx.x * S + list[kk]) * 3 + c] = -sum;
  }
}

// out[k] = the sum of part[b, k] over b < B in order (0 for a dead slot);
// with finish, plus the sink-sink term, and 0 on dead slots.
template <typename T>
__global__ void __launch_bounds__(RT) sink_gravity_reduce_kernel(
    const T* __restrict__ part, int B, const T* __restrict__ spos,
    const T* __restrict__ smass, const unsigned char* __restrict__ salive,
    T* __restrict__ out, int S, double G_, int finish) {
  Carve sm{smem};
  T* red = sm.take<T>(3 * S);
  T* P = sm.take<T>(3 * S);
  T* M = sm.take<T>(S);
  unsigned char* A = sm.take<unsigned char>(S);
  int* list = sm.take<int>(S);
  int* count = sm.take<int>(1);
  for (int j = threadIdx.x; j < 3 * S; j += RT) {
    P[j] = spos[j];
    red[j] = T(0);
  }
  for (int k = threadIdx.x; k < S; k += RT) M[k] = smass[k];
  const int L = compact_slots(
      S, [&](int k) { return salive[k] != 0; }, A, list, count);
  reduce_partials(part, B, S, 3, list, L, red);
  __syncthreads();
  if (!finish) {
    for (int j = threadIdx.x; j < 3 * S; j += RT) out[j] = red[j];
    return;
  }
  const T G = (T)G_;
  for (int k = threadIdx.x; k < S; k += RT) {
    T o[3] = {T(0), T(0), T(0)};
    if (A[k]) {
      const T xk = P[3 * k], yk = P[3 * k + 1], zk = P[3 * k + 2];
      T s0 = T(0), s1 = T(0), s2 = T(0);
      for (int j = 0; j < S; ++j) {
        if (!A[j]) continue;
        const T dx = sub_rn(xk, P[3 * j]), dy = sub_rn(yk, P[3 * j + 1]),
                dz = sub_rn(zk, P[3 * j + 2]);
        const T r2 = dist2(dx, dy, dz);
        const T r = sqrt_rn(r2);
        if (!(r > T(0))) continue;
        const T wm = mul_rn(mul_rn(div_rn(T(1), mul_rn(r2, r)), G), M[j]);
        s0 += wm * dx;
        s1 += wm * dy;
        s2 += wm * dz;
      }
      o[0] = red[3 * k] - s0;
      o[1] = red[3 * k + 1] - s1;
      o[2] = red[3 * k + 2] - s2;
    }
    out[3 * k] = o[0];
    out[3 * k + 1] = o[1];
    out[3 * k + 2] = o[2];
  }
}

// ----------------------------------------------------------------- creation

template <typename T>
size_t create_pass_smem(int S) {
  return piece<unsigned char>(S) + piece<int>(S) + piece<int>(1)
      + 4 * piece<T>(S) + piece<T>(NW) + piece<int>(NW);
}

// (v1, i1) before (v0, i0): the larger value, on a tie the lower index,
// as torch.argmax takes the first maximum; NONE loses to any candidate.
template <typename T>
__device__ __forceinline__ bool before(T v1, int i1, T v0, int i0) {
  return i1 != NONE && (i0 == NONE || v1 > v0 || (v1 == v0 && i1 < i0));
}

// The block's first maximum of (v, i) to thread 0.  wv, wi: NW entries.
template <typename T>
__device__ void block_first_max(T& v, int& i, T* wv, int* wi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_down_sync(FULL, v, o);
    const int oi = __shfl_down_sync(FULL, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      if (before(wv[w], wi[w], v, i)) {
        v = wv[w];
        i = wi[w];
      }
    }
  }
}

// Eligible: live, code density m (eta / h)^3 above thr, and not within
// radius_k + 2 h of a real (live, massive) sink k.  best_val[b],
// best_idx[b]: block b's first densest eligible particle (NONE for none).
template <typename T>
__global__ void __launch_bounds__(NT) create_sinks_pass_kernel(
    const T* __restrict__ pos, const T* __restrict__ mass,
    const T* __restrict__ h, const unsigned char* __restrict__ alive,
    const T* __restrict__ spos, const T* __restrict__ srad,
    const T* __restrict__ smass, const unsigned char* __restrict__ salive,
    T* __restrict__ best_val, int* __restrict__ best_idx, int n, int S,
    double eta_, double thr_) {
  Carve sm{smem};
  unsigned char* flags = sm.take<unsigned char>(S);
  int* list = sm.take<int>(S);
  int* count = sm.take<int>(1);
  T* sx = sm.take<T>(S);
  T* sy = sm.take<T>(S);
  T* sz = sm.take<T>(S);
  T* sr = sm.take<T>(S);
  T* wv = sm.take<T>(NW);
  int* wi = sm.take<int>(NW);

  const int L = compact_slots(
      S, [&](int k) { return salive[k] != 0 && smass[k] > T(0); }, flags,
      list, count);
  for (int j = threadIdx.x; j < L; j += NT) {
    const int k = list[j];
    sx[j] = spos[3 * k];
    sy[j] = spos[3 * k + 1];
    sz[j] = spos[3 * k + 2];
    sr[j] = srad[k];
  }
  __syncthreads();

  const T eta = (T)eta_, thr = (T)thr_;
  T bv = T(0);
  int bi = NONE;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    if (!alive[i]) continue;
    const T hi = h[i];
    // (eta / h) ** 3 as torch computes it: reciprocal(h) * eta, cubed as
    // (r * r) * r, then times m
    const T r = mul_rn(div_rn(T(1), hi), eta);
    const T cd = mul_rn(mass[i], mul_rn(mul_rn(r, r), r));
    if (!(cd > thr)) continue;
    const T x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
    const T h2 = mul_rn(T(2), hi);
    bool near = false;
    for (int kk = 0; kk < L && !near; ++kk) {
      const T d2 = dist2(sub_rn(sx[kk], x), sub_rn(sy[kk], y),
                         sub_rn(sz[kk], z));
      const T reach = add_rn(sr[kk], h2);
      near = d2 < mul_rn(reach, reach);
    }
    if (!near && before(cd, (int)i, bv, bi)) {
      bv = cd;
      bi = (int)i;
    }
  }
  block_first_max(bv, bi, wv, wi);
  if (threadIdx.x == 0) {
    best_val[blockIdx.x] = bv;
    best_idx[blockIdx.x] = bi;
  }
}

// mode 0 (one device): the first densest of the B blocks' candidates, and
// the new sink in the first free slot.  mode 1 (a rank of a mesh): only the
// rank's candidate row cand_out [8] = (its density, or -inf for none;
// pos, vel, h).  mode 2 (a mesh, after the rows are gathered): the first
// densest of the R rows of cand [R, 8], a candidate only where its density
// is finite, and the new sink.  The new sink arrays are the old ones with
// the slot written; full = 1 when a candidate found no free slot.
template <typename T>
__global__ void __launch_bounds__(NT) create_sinks_pick_kernel(
    const T* __restrict__ best_val, const int* __restrict__ best_idx, int B,
    const T* __restrict__ cand, int R, const T* __restrict__ pos,
    const T* __restrict__ vel, const T* __restrict__ h,
    const T* __restrict__ spos, const T* __restrict__ svel,
    const T* __restrict__ sacc, const T* __restrict__ sspin,
    const T* __restrict__ smass, const T* __restrict__ srad,
    const unsigned char* __restrict__ salive, T* __restrict__ cand_out,
    unsigned char* __restrict__ alive_o, T* __restrict__ pos_o,
    T* __restrict__ vel_o, T* __restrict__ acc_o, T* __restrict__ spin_o,
    T* __restrict__ mass_o, T* __restrict__ rad_o, int* __restrict__ full_o,
    int S, double create_mass, int mode) {
  __shared__ T wv[NT / 32];
  __shared__ int wi[NT / 32];
  __shared__ T c[7];          // the candidate's pos, vel, h
  __shared__ int has_any, slot;

  if (mode != 2) {
    T v = T(0);
    int i = NONE;
    for (int b = threadIdx.x; b < B; b += NT) {
      if (before(best_val[b], best_idx[b], v, i)) {
        v = best_val[b];
        i = best_idx[b];
      }
    }
    block_first_max(v, i, wv, wi);
    if (threadIdx.x == 0) {
      has_any = i != NONE;
      const long long p = has_any ? i : 0;
      for (int d = 0; d < 3; ++d) {
        c[d] = pos[3 * p + d];
        c[3 + d] = vel[3 * p + d];
      }
      c[6] = h[p];
      if (mode == 1) {
        const T inf = (T)__longlong_as_double(0x7ff0000000000000LL);
        cand_out[0] = has_any ? v : -inf;
        for (int d = 0; d < 7; ++d) cand_out[1 + d] = c[d];
      }
    }
    if (mode == 1) return;
  } else if (threadIdx.x == 0) {
    // torch.argmax over the rows' densities: the first maximum, NaN first
    int win = 0;
    for (int r = 1; r < R; ++r) {
      const T a = cand[8 * r], b = cand[8 * win];
      if (!(b != b) && ((a != a) || a > b)) win = r;
    }
    has_any = isfinite(cand[8 * win]);
    for (int d = 0; d < 7; ++d) c[d] = cand[8 * win + 1 + d];
  }
  if (threadIdx.x == 0) slot = S;
  __syncthreads();
  for (int k = threadIdx.x; k < S; k += NT) {
    if (!salive[k]) atomicMin(&slot, k);   // integer: any order, one result
  }
  __syncthreads();
  const bool write = has_any && slot < S;
  for (int k = threadIdx.x; k < S; k += NT) {
    const bool w = write && k == slot;
    alive_o[k] = salive[k] || w;
    for (int d = 0; d < 3; ++d) {
      pos_o[3 * k + d] = w ? c[d] : spos[3 * k + d];
      vel_o[3 * k + d] = w ? c[3 + d] : svel[3 * k + d];
      acc_o[3 * k + d] = w ? T(0) : sacc[3 * k + d];
      spin_o[3 * k + d] = w ? T(0) : sspin[3 * k + d];
    }
    mass_o[k] = w ? (T)create_mass : smass[k];
    rad_o[k] = w ? mul_rn(T(2), c[6]) : srad[k];
  }
  if (threadIdx.x == 0) *full_o = has_any && slot >= S;
}

// ---------------------------------------------------------------- accretion

template <typename T>
size_t accrete_pass_smem(int S) {
  return piece<unsigned char>(S) + piece<int>(S) + piece<int>(1)
      + 7 * piece<T>(S) + piece<T>(S * 10) + piece<T>(NT * 10)
      + piece<int>(NT) + piece<unsigned>(NW);
}

// Each live particle goes to its nearest eligible sink (live, massive,
// r2 < radius^2; the first minimum of r2), is written out dead, massless,
// parked and still; every other particle is copied.  part[b, k, :] = the
// sums over block b's particles claimed by sink k of (m, m v, m x,
// m (x - x_k) x (v - v_k)), written for eligible k only.
template <typename T>
__global__ void __launch_bounds__(NT) accrete_pass_kernel(
    const T* __restrict__ pos, const T* __restrict__ vel,
    const T* __restrict__ mass, const unsigned char* __restrict__ alive,
    const T* __restrict__ spos, const T* __restrict__ svel,
    const T* __restrict__ smass, const T* __restrict__ srad,
    const unsigned char* __restrict__ salive,
    unsigned char* __restrict__ alive_o, T* __restrict__ mass_o,
    T* __restrict__ pos_o, T* __restrict__ vel_o, T* __restrict__ part,
    int n, int S) {
  Carve sm{smem};
  unsigned char* flags = sm.take<unsigned char>(S);
  int* list = sm.take<int>(S);
  int* count = sm.take<int>(1);
  T* sx = sm.take<T>(S);
  T* sy = sm.take<T>(S);
  T* sz = sm.take<T>(S);
  T* svx = sm.take<T>(S);
  T* svy = sm.take<T>(S);
  T* svz = sm.take<T>(S);
  T* sr2 = sm.take<T>(S);
  T* acc = sm.take<T>(S * 10);       // per eligible slot, this block's sums
  T* stage = sm.take<T>(NT * 10);    // a tile's accreted contributions
  int* stage_k = sm.take<int>(NT);
  unsigned* claims = sm.take<unsigned>(NW);

  const int L = compact_slots(
      S, [&](int k) { return salive[k] != 0 && smass[k] > T(0); }, flags,
      list, count);
  for (int j = threadIdx.x; j < L; j += NT) {
    const int k = list[j];
    sx[j] = spos[3 * k];
    sy[j] = spos[3 * k + 1];
    sz[j] = spos[3 * k + 2];
    svx[j] = svel[3 * k];
    svy[j] = svel[3 * k + 1];
    svz[j] = svel[3 * k + 2];
    sr2[j] = mul_rn(srad[k], srad[k]);
  }
  for (int j = threadIdx.x; j < L * 10; j += NT) acc[j] = T(0);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * NT; base < n;
       base += (long long)gridDim.x * NT) {
    const long long i = base + threadIdx.x;
    int best = -1;
    if (i < n) {
      const T x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
      const T vx = vel[3 * i], vy = vel[3 * i + 1], vz = vel[3 * i + 2];
      const T m = mass[i];
      const bool a = alive[i] != 0;
      if (a) {
        T bd = T(0);
        for (int kk = 0; kk < L; ++kk) {
          const T d2 = dist2(sub_rn(sx[kk], x), sub_rn(sy[kk], y),
                             sub_rn(sz[kk], z));
          if (d2 < sr2[kk] && (best < 0 || d2 < bd)) {
            best = kk;
            bd = d2;
          }
        }
      }
      const bool gone = best >= 0;
      alive_o[i] = a && !gone;
      mass_o[i] = gone ? T(0) : m;
      pos_o[3 * i] = gone ? (T)PARK : x;
      pos_o[3 * i + 1] = gone ? (T)PARK : y;
      pos_o[3 * i + 2] = gone ? (T)PARK : z;
      vel_o[3 * i] = gone ? T(0) : vx;
      vel_o[3 * i + 1] = gone ? T(0) : vy;
      vel_o[3 * i + 2] = gone ? T(0) : vz;
      if (gone) {
        const T rx = x - sx[best], ry = y - sy[best], rz = z - sz[best];
        const T ux = vx - svx[best], uy = vy - svy[best], uz = vz - svz[best];
        T* st = stage + threadIdx.x * 10;
        st[0] = m;
        st[1] = m * vx;
        st[2] = m * vy;
        st[3] = m * vz;
        st[4] = m * x;
        st[5] = m * y;
        st[6] = m * z;
        st[7] = m * (ry * uz - rz * uy);
        st[8] = m * (rz * ux - rx * uz);
        st[9] = m * (rx * uy - ry * ux);
        stage_k[threadIdx.x] = best;
      }
    }
    const unsigned mine = __ballot_sync(FULL, best >= 0);
    if (lane == 0) claims[warp] = mine;
    if (__syncthreads_or(best >= 0)) {
      // the tile's accreted particles in particle order, one thread per
      // sum: no two threads write one word
      if (threadIdx.x < 10) {
        for (int w = 0; w < NW; ++w) {
          unsigned bits = claims[w];
          while (bits) {
            const int j = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            acc[stage_k[j] * 10 + threadIdx.x] += stage[j * 10 + threadIdx.x];
          }
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L * 10; j += NT) {
    const int kk = j / 10, c = j - 10 * kk;
    part[((long long)blockIdx.x * S + list[kk]) * 10 + c] = acc[j];
  }
}

// The [S, 10] sums of part [B, S, 10] over b in order (0 for a slot no
// particle can reach).  Without finish they are written to sums; with
// finish the sinks take them: mass + dm, the combined centre of mass and
// momentum where dm > 0, spin + the angular momentum.
template <typename T>
__global__ void __launch_bounds__(RT) accrete_reduce_kernel(
    const T* __restrict__ part, int B, const T* __restrict__ spos,
    const T* __restrict__ svel, const T* __restrict__ smass,
    const T* __restrict__ sspin, const unsigned char* __restrict__ salive,
    T* __restrict__ sums, T* __restrict__ mass_o, T* __restrict__ pos_o,
    T* __restrict__ vel_o, T* __restrict__ spin_o, int S, int finish) {
  Carve sm{smem};
  T* red = sm.take<T>(10 * S);
  unsigned char* flags = sm.take<unsigned char>(S);
  int* list = sm.take<int>(S);
  int* count = sm.take<int>(1);
  for (int j = threadIdx.x; j < 10 * S; j += RT) red[j] = T(0);
  const int L = compact_slots(
      S, [&](int k) { return salive[k] != 0 && smass[k] > T(0); }, flags,
      list, count);
  reduce_partials(part, B, S, 10, list, L, red);
  __syncthreads();
  if (!finish) {
    for (int j = threadIdx.x; j < 10 * S; j += RT) sums[j] = red[j];
    return;
  }
  for (int k = threadIdx.x; k < S; k += RT) {
    const T* r = red + 10 * k;
    const T m = smass[k];
    const T nm = add_rn(m, r[0]);
    const bool grew = r[0] > T(0);
    const T inv = grew ? div_rn(T(1), nm) : T(0);
    for (int d = 0; d < 3; ++d) {
      const T x = spos[3 * k + d], v = svel[3 * k + d];
      pos_o[3 * k + d] = grew ? mul_rn(add_rn(mul_rn(m, x), r[4 + d]), inv) : x;
      vel_o[3 * k + d] = grew ? mul_rn(add_rn(mul_rn(m, v), r[1 + d]), inv) : v;
      spin_o[3 * k + d] = add_rn(sspin[3 * k + d], r[7 + d]);
    }
    mass_o[k] = nm;
  }
}

// ------------------------------------------------------------------ merging

template <typename T>
size_t merge_smem(int S) {
  return 3 * piece<T>(3 * S) + 2 * piece<T>(S) + piece<unsigned char>(S)
      + piece<int>(S);
}

// Real sinks (live, massive) closer than factor x min(radius_i, radius_j)
// pair up; each points at the lower of itself and its lowest-index partner,
// and `rounds` rounds of pointer jumping follow those pointers to a root.
// A root is a sink that points at itself: every local index minimum along
// a chain is one, so a chain whose slots do not fall in index order
// merges in parts, one a root, and the parts merge on a later call only
// if they are still within reach then (the rule of the JAX package's
// merge_sinks).  A root takes the members' mass, centre of mass position
// and velocity, the largest radius, and the spins plus the members'
// orbital angular momentum about the new centre; absorbed slots die and
// are parked.  n_merged = the absorbed count.
template <typename T>
__global__ void __launch_bounds__(RT) merge_sinks_kernel(
    const T* __restrict__ spos, const T* __restrict__ svel,
    const T* __restrict__ sspin, const T* __restrict__ smass,
    const T* __restrict__ srad, const unsigned char* __restrict__ salive,
    unsigned char* __restrict__ alive_o, T* __restrict__ mass_o,
    T* __restrict__ pos_o, T* __restrict__ vel_o, T* __restrict__ spin_o,
    T* __restrict__ rad_o, int* __restrict__ n_merged, int S, double factor_,
    int rounds) {
  Carve sm{smem};
  T* P = sm.take<T>(3 * S);
  T* V = sm.take<T>(3 * S);
  T* W = sm.take<T>(3 * S);
  T* M = sm.take<T>(S);
  T* Rd = sm.take<T>(S);
  unsigned char* real = sm.take<unsigned char>(S);
  int* tgt = sm.take<int>(S);

  for (int j = threadIdx.x; j < 3 * S; j += blockDim.x) {
    P[j] = spos[j];
    V[j] = svel[j];
    W[j] = sspin[j];
  }
  for (int k = threadIdx.x; k < S; k += blockDim.x) {
    M[k] = smass[k];
    Rd[k] = srad[k];
    real[k] = salive[k] && smass[k] > T(0);
  }
  __syncthreads();

  const T factor = (T)factor_;
  const int i = threadIdx.x;   // blockDim.x >= S
  if (i < S) {
    int partner = S;
    if (real[i]) {
      for (int j = 0; j < S; ++j) {
        if (j == i || !real[j]) continue;
        const T d2 = dist2(sub_rn(P[3 * i], P[3 * j]),
                           sub_rn(P[3 * i + 1], P[3 * j + 1]),
                           sub_rn(P[3 * i + 2], P[3 * j + 2]));
        const T th = mul_rn(factor, Rd[j] < Rd[i] ? Rd[j] : Rd[i]);
        if (d2 < mul_rn(th, th)) {
          partner = j;
          break;
        }
      }
    }
    tgt[i] = partner < i ? partner : i;
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    const int t = i < S ? tgt[tgt[i]] : 0;
    __syncthreads();
    if (i < S) tgt[i] = t;
    __syncthreads();
  }

  const bool absorbed = i < S && real[i] && tgt[i] != i;
  if (i < S) {
    T ms = T(0), xs[3] = {T(0), T(0), T(0)}, vs[3] = {T(0), T(0), T(0)},
      ws[3] = {T(0), T(0), T(0)}, rad = T(0);
    for (int j = 0; j < S; ++j) {
      if (!real[j] || tgt[j] != i) continue;
      ms += M[j];
      for (int d = 0; d < 3; ++d) {
        xs[d] += M[j] * P[3 * j + d];
        vs[d] += M[j] * V[3 * j + d];
        ws[d] += W[3 * j + d];
      }
      rad = Rd[j] > rad ? Rd[j] : rad;
    }
    const bool merged = ms > T(0);
    const T inv = merged ? div_rn(T(1), ms) : T(0);
    T cx[3], cv[3], orb[3] = {T(0), T(0), T(0)};
    for (int d = 0; d < 3; ++d) {
      cx[d] = xs[d] * inv;
      cv[d] = vs[d] * inv;
    }
    for (int j = 0; j < S; ++j) {
      if (!real[j] || tgt[j] != i) continue;
      const T rx = P[3 * j] - cx[0], ry = P[3 * j + 1] - cx[1],
              rz = P[3 * j + 2] - cx[2];
      const T ux = V[3 * j] - cv[0], uy = V[3 * j + 1] - cv[1],
              uz = V[3 * j + 2] - cv[2];
      orb[0] += M[j] * (ry * uz - rz * uy);
      orb[1] += M[j] * (rz * ux - rx * uz);
      orb[2] += M[j] * (rx * uy - ry * ux);
    }
    const bool upd = real[i] && !absorbed && merged;
    alive_o[i] = salive[i] && !absorbed;
    mass_o[i] = absorbed ? T(0) : (upd ? ms : M[i]);
    rad_o[i] = absorbed ? T(0) : (upd ? rad : Rd[i]);
    for (int d = 0; d < 3; ++d) {
      pos_o[3 * i + d] = absorbed ? (T)PARK : (upd ? cx[d] : P[3 * i + d]);
      vel_o[3 * i + d] = absorbed ? T(0) : (upd ? cv[d] : V[3 * i + d]);
      spin_o[3 * i + d] = absorbed ? T(0)
          : (upd ? ws[d] + orb[d] : W[3 * i + d]);
    }
  }
  const int gone = __syncthreads_count(absorbed);
  if (threadIdx.x == 0) *n_merged = gone;
}

// ----------------------------------------------------------------- launches

template <typename T>
int launch_gravity_pass(const void* pos, const void* mass,
                        const unsigned char* alive, const void* spos,
                        const void* smass, const unsigned char* salive,
                        void* acc, void* part, int n, int S, int blocks,
                        double G, void* stream) {
  const size_t bytes = gravity_pass_smem<T>(S);
  cudaError_t e = allow_smem(sink_gravity_pass_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  sink_gravity_pass_kernel<T><<<blocks, NT, bytes, (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)mass, alive, (const T*)spos, (const T*)smass,
      salive, (T*)acc, (T*)part, n, S, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gravity_reduce(const void* part, int B, const void* spos,
                          const void* smass, const unsigned char* salive,
                          void* out, int S, double G, int finish,
                          void* stream) {
  const size_t bytes = 2 * piece<T>(3 * S) + piece<T>(S)
      + piece<unsigned char>(S) + piece<int>(S) + piece<int>(1);
  cudaError_t e = allow_smem(sink_gravity_reduce_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  sink_gravity_reduce_kernel<T><<<1, RT, bytes, (cudaStream_t)stream>>>(
      (const T*)part, B, (const T*)spos, (const T*)smass, salive, (T*)out, S,
      G, finish);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_create_pass(const void* pos, const void* mass, const void* h,
                       const unsigned char* alive, const void* spos,
                       const void* srad, const void* smass,
                       const unsigned char* salive, void* best_val,
                       int* best_idx, int n, int S, int blocks, double eta,
                       double thr, void* stream) {
  const size_t bytes = create_pass_smem<T>(S);
  cudaError_t e = allow_smem(create_sinks_pass_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  create_sinks_pass_kernel<T><<<blocks, NT, bytes, (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)mass, (const T*)h, alive, (const T*)spos,
      (const T*)srad, (const T*)smass, salive, (T*)best_val, best_idx, n, S,
      eta, thr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_create_pick(const void* best_val, const int* best_idx, int B,
                       const void* cand, int R, const void* pos,
                       const void* vel, const void* h, const void* spos,
                       const void* svel, const void* sacc, const void* sspin,
                       const void* smass, const void* srad,
                       const unsigned char* salive, void* cand_out,
                       unsigned char* alive_o, void* pos_o, void* vel_o,
                       void* acc_o, void* spin_o, void* mass_o, void* rad_o,
                       int* full_o, int S, double create_mass, int mode,
                       void* stream) {
  create_sinks_pick_kernel<T><<<1, NT, 0, (cudaStream_t)stream>>>(
      (const T*)best_val, best_idx, B, (const T*)cand, R, (const T*)pos,
      (const T*)vel, (const T*)h, (const T*)spos, (const T*)svel,
      (const T*)sacc, (const T*)sspin, (const T*)smass, (const T*)srad,
      salive, (T*)cand_out, alive_o, (T*)pos_o, (T*)vel_o, (T*)acc_o,
      (T*)spin_o, (T*)mass_o, (T*)rad_o, full_o, S, create_mass, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_accrete_pass(const void* pos, const void* vel, const void* mass,
                        const unsigned char* alive, const void* spos,
                        const void* svel, const void* smass, const void* srad,
                        const unsigned char* salive, unsigned char* alive_o,
                        void* mass_o, void* pos_o, void* vel_o, void* part,
                        int n, int S, int blocks, void* stream) {
  const size_t bytes = accrete_pass_smem<T>(S);
  cudaError_t e = allow_smem(accrete_pass_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  accrete_pass_kernel<T><<<blocks, NT, bytes, (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)vel, (const T*)mass, alive, (const T*)spos,
      (const T*)svel, (const T*)smass, (const T*)srad, salive, alive_o,
      (T*)mass_o, (T*)pos_o, (T*)vel_o, (T*)part, n, S);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_accrete_reduce(const void* part, int B, const void* spos,
                          const void* svel, const void* smass,
                          const void* sspin, const unsigned char* salive,
                          void* sums, void* mass_o, void* pos_o, void* vel_o,
                          void* spin_o, int S, int finish, void* stream) {
  const size_t bytes = piece<T>(10 * S) + piece<unsigned char>(S)
      + piece<int>(S) + piece<int>(1);
  cudaError_t e = allow_smem(accrete_reduce_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  accrete_reduce_kernel<T><<<1, RT, bytes, (cudaStream_t)stream>>>(
      (const T*)part, B, (const T*)spos, (const T*)svel, (const T*)smass,
      (const T*)sspin, salive, (T*)sums, (T*)mass_o, (T*)pos_o, (T*)vel_o,
      (T*)spin_o, S, finish);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_merge(const void* spos, const void* svel, const void* sspin,
                 const void* smass, const void* srad,
                 const unsigned char* salive, unsigned char* alive_o,
                 void* mass_o, void* pos_o, void* vel_o, void* spin_o,
                 void* rad_o, int* n_merged, int S, double factor, int rounds,
                 void* stream) {
  const size_t bytes = merge_smem<T>(S);
  cudaError_t e = allow_smem(merge_sinks_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  const int threads = S > 32 ? (S + 31) / 32 * 32 : 32;
  merge_sinks_kernel<T><<<1, threads, bytes, (cudaStream_t)stream>>>(
      (const T*)spos, (const T*)svel, (const T*)sspin, (const T*)smass,
      (const T*)srad, salive, alive_o, (T*)mass_o, (T*)pos_o, (T*)vel_o,
      (T*)spin_o, (T*)rad_o, n_merged, S, factor, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points: `dbl` selects float64 for every floating array.  Sink
// arrays are [S] or [S, 3], particle arrays [n] or [n, 3], alive one byte
// a row; part is [blocks, S, 3] (gravity) or [blocks, S, 10] (accretion).
extern "C" {

int sink_gravity_pass(const void* pos, const void* mass,
                      const unsigned char* alive, const void* spos,
                      const void* smass, const unsigned char* salive,
                      void* acc, void* part, int n, int S, int blocks,
                      double G, int dbl, void* stream) {
  return dbl ? launch_gravity_pass<double>(pos, mass, alive, spos, smass,
                                           salive, acc, part, n, S, blocks,
                                           G, stream)
             : launch_gravity_pass<float>(pos, mass, alive, spos, smass,
                                          salive, acc, part, n, S, blocks, G,
                                          stream);
}

int sink_gravity_reduce(const void* part, int B, const void* spos,
                        const void* smass, const unsigned char* salive,
                        void* out, int S, double G, int finish, int dbl,
                        void* stream) {
  return dbl ? launch_gravity_reduce<double>(part, B, spos, smass, salive,
                                             out, S, G, finish, stream)
             : launch_gravity_reduce<float>(part, B, spos, smass, salive, out,
                                            S, G, finish, stream);
}

int create_sinks_pass(const void* pos, const void* mass, const void* h,
                      const unsigned char* alive, const void* spos,
                      const void* srad, const void* smass,
                      const unsigned char* salive, void* best_val,
                      int* best_idx, int n, int S, int blocks, double eta,
                      double thr, int dbl, void* stream) {
  return dbl ? launch_create_pass<double>(pos, mass, h, alive, spos, srad,
                                          smass, salive, best_val, best_idx,
                                          n, S, blocks, eta, thr, stream)
             : launch_create_pass<float>(pos, mass, h, alive, spos, srad,
                                         smass, salive, best_val, best_idx, n,
                                         S, blocks, eta, thr, stream);
}

int create_sinks_pick(const void* best_val, const int* best_idx, int B,
                      const void* cand, int R, const void* pos,
                      const void* vel, const void* h, const void* spos,
                      const void* svel, const void* sacc, const void* sspin,
                      const void* smass, const void* srad,
                      const unsigned char* salive, void* cand_out,
                      unsigned char* alive_o, void* pos_o, void* vel_o,
                      void* acc_o, void* spin_o, void* mass_o, void* rad_o,
                      int* full_o, int S, double create_mass, int mode,
                      int dbl, void* stream) {
  return dbl ? launch_create_pick<double>(
                   best_val, best_idx, B, cand, R, pos, vel, h, spos, svel,
                   sacc, sspin, smass, srad, salive, cand_out, alive_o, pos_o,
                   vel_o, acc_o, spin_o, mass_o, rad_o, full_o, S,
                   create_mass, mode, stream)
             : launch_create_pick<float>(
                   best_val, best_idx, B, cand, R, pos, vel, h, spos, svel,
                   sacc, sspin, smass, srad, salive, cand_out, alive_o, pos_o,
                   vel_o, acc_o, spin_o, mass_o, rad_o, full_o, S,
                   create_mass, mode, stream);
}

int accrete_pass(const void* pos, const void* vel, const void* mass,
                 const unsigned char* alive, const void* spos,
                 const void* svel, const void* smass, const void* srad,
                 const unsigned char* salive, unsigned char* alive_o,
                 void* mass_o, void* pos_o, void* vel_o, void* part, int n,
                 int S, int blocks, int dbl, void* stream) {
  return dbl ? launch_accrete_pass<double>(pos, vel, mass, alive, spos, svel,
                                           smass, srad, salive, alive_o,
                                           mass_o, pos_o, vel_o, part, n, S,
                                           blocks, stream)
             : launch_accrete_pass<float>(pos, vel, mass, alive, spos, svel,
                                          smass, srad, salive, alive_o,
                                          mass_o, pos_o, vel_o, part, n, S,
                                          blocks, stream);
}

int accrete_reduce(const void* part, int B, const void* spos,
                   const void* svel, const void* smass, const void* sspin,
                   const unsigned char* salive, void* sums, void* mass_o,
                   void* pos_o, void* vel_o, void* spin_o, int S, int finish,
                   int dbl, void* stream) {
  return dbl ? launch_accrete_reduce<double>(part, B, spos, svel, smass,
                                             sspin, salive, sums, mass_o,
                                             pos_o, vel_o, spin_o, S, finish,
                                             stream)
             : launch_accrete_reduce<float>(part, B, spos, svel, smass, sspin,
                                            salive, sums, mass_o, pos_o,
                                            vel_o, spin_o, S, finish, stream);
}

int merge_sinks(const void* spos, const void* svel, const void* sspin,
                const void* smass, const void* srad,
                const unsigned char* salive, unsigned char* alive_o,
                void* mass_o, void* pos_o, void* vel_o, void* spin_o,
                void* rad_o, int* n_merged, int S, double factor, int rounds,
                int dbl, void* stream) {
  return dbl ? launch_merge<double>(spos, svel, sspin, smass, srad, salive,
                                    alive_o, mass_o, pos_o, vel_o, spin_o,
                                    rad_o, n_merged, S, factor, rounds, stream)
             : launch_merge<float>(spos, svel, sspin, smass, srad, salive,
                                   alive_o, mass_o, pos_o, vel_o, spin_o,
                                   rad_o, n_merged, S, factor, rounds, stream);
}

}  // extern "C"
