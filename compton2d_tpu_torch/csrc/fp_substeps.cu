// FP substep kernel for Hopper (sm_90a): the Fokker-Planck electron solve's
// substep loop, every zone's substeps run to the end of the step in one
// launch.
//
// Replaces no TPU kernel: the JAX package runs this loop as XLA operations
// in a jax.lax.while_loop (compton2d_tpu/fp/update.py, fp_step). Its plain
// PyTorch version, fp/update.py::substep_loop_reference, launches some 500
// small kernels a substep and reads the loop's condition on the host after
// each, so the card sat idle while the host launched (a substep took about
// 4 ms, 7 us of host time a launch). The loop's state is a zone's own: its
// distribution, temperature, clock, d_t ladder and backoff; a done zone is
// never updated again, and the step's substep count is the largest zone's.
// So one block runs one zone's loop to its end, with nothing shared between
// blocks and no host in the loop.
//
// What bounds it on the H100. Not bytes (a zone's rows are read once and
// written once: about 3 KB at 200 bins) and not arithmetic (about 60
// operations a bin a substep, a few TFLOP/s-microseconds at the cells'
// shapes): latency along the substep's serial chain. A substep is three
// block sums, the two gamma_bar lookups, the scalar d_t ladder (powf,
// expf, logf, IEEE divisions), the Chang-Cooper coefficients (expm1f) and
// ceil(log2 N) rounds of parallel cyclic reduction, each round a
// __syncthreads. What helps: one thread a bin, the rows in registers, the
// neighbours through shared memory (double-buffered rounds, one barrier
// each), the per-zone scalars computed redundantly by every thread so that
// nothing is broadcast, and many zones' blocks resident on an SM so that
// one block's barriers hide behind another's arithmetic.
//
// The design:
// - One block a zone, one thread a bin (blockDim a multiple of 32, at most
//   MAX_BINS); blocks loop over the zones beyond the grid. At the start of
//   a zone the block loads its rows (the distribution, the inverse-Compton
//   drift, and per term the pair sources, the positrons and the e-p
//   Coulomb rows) and its scalars; at the end it writes the distribution,
//   the positrons, kT_e, the clock, the protons and its substep count.
// - The 512-knot gamma_bar table in shared memory, looked up with
//   jnp.interp's semantics (searchsorted(right=True), clamped).
// - Every term of the float32 card path, chosen by the flags of Scalars:
//   bremsstrahlung, the Coulomb terms from the tables (the e-e rows
//   interpolated here at each substep's Te, the e-p rows made before the
//   launch) or from the Spitzer-like drift, pick-up injection, the shock
//   injection (Gaussian, power law, or power law with the growing upper
//   cutoff g2var), the pair sources with the positrons through the same
//   coefficients (their PCR rounds share alpha and gamma), and the zone
//   farm's pad zones (valid 0).
// - Operations in the plain loop's order, each rounded as PyTorch's CUDA
//   kernels round it (a division by a host scalar is a product with its
//   reciprocal; x / y with a host x is (1 / y) * x; no contraction into
//   fma, -fmad=false), so the kernel departs from the plain loop only by
//   the order of its block sums.
// - The plain loop lets a done zone pass through the pair sources,
//   injection and escape with d_t = 1e-30 on each later substep; here a
//   done zone stops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BINS = 512;              // bins (threads) a block takes
constexpr int MAX_WARPS = MAX_BINS / 32;
constexpr int N_RED = 5;                   // block sums a substep may take

// the step's device scalars (Pointers::step)
enum { S_DT, S_TIME, S_KDT, S_FLOOR0, S_SLAB, S_PSUM, N_STEP };
// the injection of Scalars::inj
enum { INJ_NONE, INJ_GAUSS, INJ_PL, INJ_PL_G2VAR };
// the Coulomb terms of Scalars::coulomb
enum { COUL_NONE, COUL_TABLES, COUL_DRIFT };

// Rows (N,), zone values (Z,), zone rows (Z, N) and tables, all float32
// and contiguous; a pointer a flag leaves unread may be null.
struct Pointers {
  // rows
  const float* gamma;
  const float* wdg;
  const float* dg_a;
  const float* disp_a;
  const float* d_gm;
  const float* d_gp;
  const float* delta_g;
  const float* gauss;      // pick-up, INJ_GAUSS
  const float* prof;       // INJ_PL: the profile with its last bin 0
  const float* gpow;       // INJ_PL_G2VAR: gamma^-p
  const float* gmask;      // INJ_PL_G2VAR: 1 where gamma > g1
  const float* g11;        // brems: gamma^1.1
  const float* beta;       // COUL_DRIFT
  // zone values
  const float* th_e;
  const float* ne_c;       // clamp_min(ne, 1e-30)
  const float* n_p;
  const float* n_lept;
  const float* gr_num;     // 2.1e-3 sqrt(n_lept)
  const float* b_field;
  const float* f_sy;
  const float* c_ic;       // (k_mec2_vol volume) n_lept
  const float* eloss_sy;
  const float* th_p;
  const float* c_coul;     // ((k_coul n_p) (volume n_lept)) lnL
  const float* tna;
  const float* tlev;
  const float* vn;         // clamp_min(volume n_lept, 1e-30)
  const float* valid;      // 1, or 0 on a pad zone
  const float* t_lo;       // injection: t_row jrow
  const float* t_hi;       // injection: t_row (jrow + 1)
  const float* f_br;       // brems
  const float* cd_den;     // COUL_DRIFT: the e-p denominator's zone factor
  const float* thp_c;      // COUL_DRIFT: clamp_min(th_p, 1e-12)
  // zone rows
  const float* f;
  const float* dg_ic;
  const float* npos;       // pairs
  const float* src_e;      // pairs: dn_pp + dne_pa
  const float* src_p;      // pairs: dn_pp + dnp_pa
  const float* dg_cp;      // COUL_TABLES
  const float* disp_cp;    // COUL_TABLES
  // tables
  const float* lg_theta;   // gamma_bar: log theta knots
  const float* gbar;       //   gamma_bar at them
  const float* lg_gbar_m1; //   log(gamma_bar - 1)
  const float* lg_te;      // COUL_TABLES: (nte,) log Te knots
  const float* dg_ce;      //   (nte, N)
  const float* disp_ce;    //   (nte, N)
  const float* step;       // (N_STEP,)
  // outputs
  float* f_o;
  float* npos_o;           // pairs
  float* th_e_o;
  float* t_fp_o;
  float* npz_o;
  int* count_o;
};

struct Scalars {
  int z, n, knots, nte, max_sub, pairs, brems, coulomb, pickup, inj,
      threads, smem;
  float t_esc, emass_kev, df_implicit, df_t, pickup_rate, lum_fold, t_start,
      g2, cv, lnl, interp_eps;
};

// PyTorch's CUDA clamps and maximum: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// jnp.interp (physics.electron_dist.interp): linear in the knots xp, the
// index from searchsorted(xp, x, right=True) clamped to [1, n - 1], held
// at fp[0] below xp[0] and fp[n - 1] above xp[n - 1]
__device__ float interp(float x, const float* xp, const float* fp, int n,
                        float eps) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(xp[mid] > x)) lo = mid + 1; else hi = mid;
  }
  const int i = min(max(lo, 1), n - 1);
  const float df = fp[i] - fp[i - 1];
  const float dx = xp[i] - xp[i - 1];
  const float delta = x - xp[i - 1];
  const bool dx0 = fabsf(dx) <= eps;
  float f = dx0 ? fp[i - 1] : fp[i - 1] + (delta / (dx0 ? 1.0f : dx)) * df;
  if (x < xp[0]) f = fp[0];
  if (x > xp[n - 1]) f = fp[n - 1];
  return f;
}

// w / (e^w - 1) (fp/chang_cooper.py::_w_over_expm1)
__device__ __forceinline__ float w_over_expm1(float w) {
  const float wc = clamp(w, -500.0f, 500.0f);
  const bool small = fabsf(wc) < 1e-8f;
  const float safe = small ? 1.0f : wc;
  const float out = small ? 1.0f - 0.5f * wc : safe / expm1f(safe);
  return w < -500.0f ? -w : out;
}

// The block's sum of v, the same in every thread: a butterfly within each
// warp (both lanes of a pair add the same two values), then the warps'
// partials in order. `red` holds MAX_WARPS floats; a call site keeps its
// own, so one barrier a sum does.
__device__ __forceinline__ float block_sum(float v, float* red, int warps) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int k = 1; k < warps; ++k) s = s + red[k];
  return s;
}

__global__ void __launch_bounds__(MAX_BINS)
fp_substeps_kernel(const Pointers p, const Scalars s) {
  extern __shared__ float sm[];
  const int K = s.knots, N = s.n, T = blockDim.x, i = threadIdx.x;
  const int warps = T >> 5;
  float* k_lt = sm;                  // gamma_bar knots
  float* k_gb = k_lt + K;
  float* k_lg = k_gb + K;
  float* pcr = k_lg + K;             // [5 arrays][2 buffers][T]
  float* cc = pcr + 10 * T;          // dgdt, disp, big_c, big_w, w_pos
  float* red = cc + 5 * T;           // [N_RED][MAX_WARPS]
  for (int k = i; k < K; k += T) {
    k_lt[k] = p.lg_theta[k];
    k_gb[k] = p.gbar[k];
    k_lg[k] = p.lg_gbar_m1[k];
  }
  __syncthreads();

  const bool bin = i < N;
  const int ib = bin ? i : N - 1;    // a pad thread reads the last bin
  const bool edge = ib == 0 || ib == N - 1;
  const int ip = ib + 1 == N ? 0 : ib + 1;   // torch.roll's neighbours
  const int im = ib == 0 ? N - 1 : ib - 1;
  const float gam = p.gamma[ib], wdg = p.wdg[ib];
  const float dg_a = p.dg_a[ib], disp_a = p.disp_a[ib];
  const float d_gm = p.d_gm[ib], d_gp = p.d_gp[ib], delta_g = p.delta_g[ib];
  const float gauss = (s.pickup || s.inj == INJ_GAUSS) ? p.gauss[ib] : 0.0f;
  const float g11 = s.brems ? p.g11[ib] : 0.0f;
  const float beta = s.coulomb == COUL_DRIFT ? p.beta[ib] : 0.0f;
  const float gpow = s.inj == INJ_PL_G2VAR ? p.gpow[ib] : 0.0f;
  const bool gmask = s.inj == INJ_PL_G2VAR && p.gmask[ib] != 0.0f;
  const float dt = p.step[S_DT], time = p.step[S_TIME];
  const float kdt = p.step[S_KDT], floor0 = p.step[S_FLOOR0];
  const float slab = p.step[S_SLAB], psum = p.step[S_PSUM];
  int steps = 1;                     // max(1, (N - 1).bit_length())
  while ((1 << steps) < N) ++steps;

  for (int z = blockIdx.x; z < s.z; z += gridDim.x) {
    const size_t row = (size_t)z * N + ib;
    float fi = p.f[row];
    const float dgic = p.dg_ic[row];
    float pi = 0.0f, src_e = 0.0f, src_p = 0.0f;
    if (s.pairs) {
      pi = p.npos[row];
      src_e = p.src_e[row];
      src_p = p.src_p[row];
    }
    float dgcp = 0.0f, dpcp = 0.0f;
    if (s.coulomb == COUL_TABLES) {
      dgcp = p.dg_cp[row];
      dpcp = p.disp_cp[row];
    }
    const float ne_c = p.ne_c[z], n_lept = p.n_lept[z];
    const float gr_num = p.gr_num[z], bz = p.b_field[z], f_sy = p.f_sy[z];
    const float c_ic = p.c_ic[z], eloss_sy = p.eloss_sy[z], th_p = p.th_p[z];
    const float c_coul = p.c_coul[z], tna = p.tna[z], tlev = p.tlev[z];
    const float vn = p.vn[z];
    const bool valid = p.valid[z] != 0.0f;
    const float f_br = s.brems ? p.f_br[z] : 0.0f;
    float t_lo = 0.0f, t_hi = 0.0f;
    if (s.inj != INJ_NONE) {
      t_lo = p.t_lo[z];
      t_hi = p.t_hi[z];
    }
    float cd_den = 0.0f, thp_c = 0.0f;
    if (s.coulomb == COUL_DRIFT) {
      cd_den = p.cd_den[z];
      thp_c = p.thp_c[z];
    }
    float th_e = p.th_e[z], npz = p.n_p[z], nlz = n_lept;
    float t_fp = 0.0f, grow = 1.0f;
    bool done = false;
    int cnt = 0;

    // a fixed injection profile's sums, as the plain loop's each substep
    float prof = 0.0f, inj_sum = 0.0f, inj_rate = 0.0f;
    bool inj_ok = false;
    if (s.inj == INJ_GAUSS || s.inj == INJ_PL) {
      prof = s.inj == INJ_GAUSS ? gauss : p.prof[ib];
      inj_sum = clamp_min(
          block_sum(bin ? prof * wdg : 0.0f, red + 3 * MAX_WARPS, warps),
          1e-30f);
      const float e_mean = block_sum(bin ? (prof * gam) * wdg : 0.0f,
                                     red + 4 * MAX_WARPS, warps) / inj_sum;
      inj_rate = (1.0f / clamp_min(e_mean * slab, 1e-30f)) * s.lum_fold;
      inj_ok = inj_sum > 1e-20f;
    }

    while (cnt < s.max_sub && !done) {
      const float te = th_e * s.emass_kev;
      // ---- cool_heat_rates -------------------------------------------
      const float g_av = interp(logf(clamp_min(th_e, 1e-6f)), k_lt, k_gb, K,
                                s.interp_eps);
      const float gamma_r = gr_num / (bz * sqrtf(g_av));
      const float hsum = block_sum(bin ? (dgic * fi) * wdg : 0.0f, red,
                                   warps);
      const float hr_c = (-hsum) * c_ic;
      const float y = gamma_r / g_av;
      const float hr_sy =
          y < 90.0f ? (-eloss_sy) / (dt * expf(clamp_max(y, 90.0f))) : 0.0f;
      const float tsum = th_e + th_p;
      const float h_t =
          (0.79788f * (((2.0f * (tsum * tsum)) + (2.0f * tsum)) + 1.0f)) /
          (powf(clamp_min(tsum, 1e-12f), 1.5f) *
           ((1.0f + 1.875f * th_e) + 0.8203f * (th_e * th_e)));
      const float hr_coul = (c_coul * h_t) * (tna - te);
      const float hr_a = clamp_min(tlev * hr_coul, 1e-30f);
      const float hr_total = (hr_sy + hr_c) + hr_a;
      // ---- the d_t ladder --------------------------------------------
      const float dT_tot = (kdt * hr_total) / vn;
      const float f_imp = clamp(
          (s.df_implicit * te) / clamp_min(fabsf(dT_tot), 1e-30f), 0.0f,
          s.df_t);
      float d_t = f_imp * dt;
      const float floor = floor0 * grow;
      const bool floored = d_t < floor;
      d_t = maximum(d_t, floor);
      if (floored) grow = grow * 1.25f;
      const float rem = dt - t_fp;
      const bool last = d_t >= rem;
      if (last) d_t = rem;
      d_t = clamp_min(d_t, 1e-30f);
      // ---- pair sources and sinks ------------------------------------
      if (s.pairs) {
        fi = clamp_min(fi + (src_e * d_t) / ne_c, 0.0f);
        pi = clamp_min(pi + src_p * d_t, 0.0f);
      }
      // ---- injection -------------------------------------------------
      float n_inject = 0.0f, finj = fi;
      if (s.pickup) {
        const float rho = valid ? d_t * s.pickup_rate : 0.0f;
        finj = finj + ((rho * gauss) / psum) / ne_c;
        n_inject = n_inject + rho;
      }
      if (s.inj != INJ_NONE) {
        if (s.inj == INJ_PL_G2VAR) {
          const float ttz = (time + t_fp) - s.t_start;
          const float g2z =
              powf(10.0f, clamp(ttz * s.cv, 0.0f, 6.0f)) * s.g2;
          const float yv = gam / g2z;
          prof = (gmask && yv < 100.0f && ib != N - 1)
                     ? gpow * expf(-clamp_max(yv, 100.0f))
                     : 0.0f;
          inj_sum = clamp_min(
              block_sum(bin ? prof * wdg : 0.0f, red + 3 * MAX_WARPS, warps),
              1e-30f);
          const float e_mean = block_sum(bin ? (prof * gam) * wdg : 0.0f,
                                         red + 4 * MAX_WARPS, warps) /
                               inj_sum;
          inj_rate = (1.0f / clamp_min(e_mean * slab, 1e-30f)) * s.lum_fold;
          inj_ok = inj_sum > 1e-20f;
        }
        const float tt = (time + t_fp) - s.t_start;
        const bool active = tt > t_lo && tt < t_hi;
        const float rho = (active && inj_ok && valid) ? inj_rate * d_t : 0.0f;
        finj = finj + ((rho * prof) / inj_sum) / ne_c;
        n_inject = n_inject + rho;
      }
      npz = npz + n_inject;
      nlz = nlz + n_inject;
      // ---- escape ----------------------------------------------------
      const float esc = (1.0f / (d_t + s.t_esc)) * s.t_esc;
      npz = npz * esc;
      nlz = nlz * esc;
      // ---- operator --------------------------------------------------
      const float y_sy = gamma_r / gam;
      // the plain loop's -1e-50 is -0 in float32
      const float dg_sy =
          y_sy < 100.0f
              ? ((-f_sy) * (gam * gam - 1.0f)) / expf(clamp_max(y_sy, 100.0f))
              : -0.0f;
      float dgdt = (dg_sy + dgic) + dg_a;
      if (s.brems) dgdt = dgdt + (-f_br) * g11;
      float disp = disp_a;
      if (s.coulomb == COUL_TABLES) {
        // physics.coulomb._rows at Te
        const int n = s.nte;
        const float lt = logf(te);
        int lo = 0, hi = n;
        while (lo < hi) {
          const int mid = lo + ((hi - lo) >> 1);
          if (!(p.lg_te[mid] > lt)) lo = mid + 1; else hi = mid;
        }
        const int j = min(max(lo, 1), n - 1);
        const float x = clamp((float)(j - 1) + (lt - p.lg_te[j - 1]) /
                                                  (p.lg_te[j] - p.lg_te[j - 1]),
                              0.0f, (float)(n - 1));
        const int i0 = min(max((int)floorf(x), 0), n - 2);
        const float fr = x - (float)i0;
        const size_t r0 = (size_t)i0 * N + ib, r1 = r0 + N;
        const float dgce = p.dg_ce[r0] * (1.0f - fr) + p.dg_ce[r1] * fr;
        const float dpce = p.disp_ce[r0] * (1.0f - fr) + p.disp_ce[r1] * fr;
        dgdt = (dgdt + dgce * nlz) + dgcp * npz;
        disp = (disp + dpce * nlz) + dpcp * npz;
      } else if (s.coulomb == COUL_DRIFT) {
        const float pref = (npz * 1.194e-14f) * s.lnl;
        const float denom = (cd_den * (gam * gam)) * beta;
        const float dg_cp =
            ((-pref) / clamp_min(denom, 1e-30f)) * (gam - 1.0f);
        dgdt = dgdt + dg_cp;
        disp = disp + fabsf(dg_cp) * thp_c;
      }
      // ---- Chang-Cooper coefficients ---------------------------------
      cc[i] = dgdt;
      cc[T + i] = disp;
      __syncthreads();
      const float dg_p1 = cc[ip], dp_p1 = cc[T + ip];
      const float big_b =
          ib == 0 ? -(dgdt + dg_p1) : (-(dgdt + dg_p1)) * 0.5f;
      const float big_c = clamp_min((disp + dp_p1) * 0.5f, 1e-30f);
      const float smw = (d_gp * big_b) / big_c;
      const float big_w = w_over_expm1(smw);
      const float w_pos = smw + big_w;
      float a, b, c;
      c = (((-d_t) * big_c) * w_pos) / (delta_g * d_gp);
      cc[2 * T + i] = big_c;
      cc[3 * T + i] = big_w;
      cc[4 * T + i] = w_pos;
      __syncthreads();
      {
        const float c_m1 = cc[2 * T + im], w_m1 = cc[3 * T + im];
        const float wp_m1 = cc[4 * T + im];
        b = (1.0f + (d_t / delta_g) *
                        ((big_c * big_w) / d_gp + (c_m1 * wp_m1) / d_gm)) +
            d_t / s.t_esc;
        a = ((((-d_t) / delta_g) * c_m1) * w_m1) / d_gm;
      }
      if (edge) {
        a = 0.0f;
        b = 1.0f;
        c = 0.0f;
      }
      // ---- PCR: the electrons (d) and the positrons (e) --------------
      float d = finj, e = pi;
      for (int r = 0, sh = 1; r < steps; ++r, sh <<= 1) {
        float* A = pcr + (r & 1) * T;
        float* B = A + 2 * T;
        float* C = B + 2 * T;
        float* D = C + 2 * T;
        float* E = D + 2 * T;
        A[i] = a;
        B[i] = b;
        C[i] = c;
        D[i] = d;
        E[i] = e;
        __syncthreads();
        const bool hm = ib - sh >= 0, hp = ib + sh < N;
        const int jm = hm ? ib - sh : ib, jp = hp ? ib + sh : ib;
        const float alpha = (-a) / (hm ? B[jm] : 1.0f);
        const float gm = (-c) / (hp ? B[jp] : 1.0f);
        const float a_n = alpha * (hm ? A[jm] : 0.0f);
        const float c_n = gm * (hp ? C[jp] : 0.0f);
        const float b_n = (b + alpha * (hm ? C[jm] : 0.0f)) +
                          gm * (hp ? A[jp] : 0.0f);
        const float d_n = (d + alpha * (hm ? D[jm] : 0.0f)) +
                          gm * (hp ? D[jp] : 0.0f);
        if (s.pairs)
          e = (e + alpha * (hm ? E[jm] : 0.0f)) + gm * (hp ? E[jp] : 0.0f);
        a = a_n;
        b = b_n;
        c = c_n;
        d = d_n;
      }
      const float piv = fabsf(b) < 1e-30f ? 1e-30f : b;
      float fnew = edge ? 0.0f : clamp_min(d / piv, 0.0f);
      // ---- normalisation and the temperature from <gamma> ------------
      const float ssum = clamp_min(
          block_sum(bin ? fnew * wdg : 0.0f, red + MAX_WARPS, warps), 1e-30f);
      fnew = fnew / ssum;
      const float gb = block_sum(bin ? (gam * fnew) * wdg : 0.0f,
                                 red + 2 * MAX_WARPS, warps);
      const float th_new = expf(interp(logf(clamp_min(gb - 1.0f, 1e-12f)),
                                       k_lg, k_lt, K, s.interp_eps));
      fi = fnew;
      if (s.pairs) pi = edge ? 0.0f : clamp_min(e / piv, 0.0f);
      th_e = th_new;
      t_fp = last ? dt : t_fp + d_t;
      done = t_fp >= dt;
      cnt += 1;
    }

    if (bin) {
      p.f_o[row] = fi;
      if (s.pairs) p.npos_o[row] = pi;
    }
    if (i == 0) {
      p.th_e_o[z] = th_e;
      p.t_fp_o[z] = t_fp;
      p.npz_o[z] = npz;
      p.count_o[z] = cnt;
    }
  }
}

}  // namespace

extern "C" {

int fp_pointers_bytes() { return (int)sizeof(Pointers); }
int fp_scalars_bytes() { return (int)sizeof(Scalars); }

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(). `ptrs` and `scalars` point to a Pointers and a
// Scalars, whose sizes are checked against the caller's. The wrapper
// (fp/update.py::substep_loop_kernel) sizes the block (a multiple of 32
// threads, at least n, at most MAX_BINS) and its shared memory.
int fp_substeps_launch(const void* ptrs, const void* scalars, int p_bytes,
                       int s_bytes, int grid, void* stream) {
  if (p_bytes != (int)sizeof(Pointers) || s_bytes != (int)sizeof(Scalars))
    return (int)cudaErrorInvalidValue;
  const Pointers* p = static_cast<const Pointers*>(ptrs);
  const Scalars* s = static_cast<const Scalars*>(scalars);
  const int need = (int)sizeof(float) *
                   (3 * s->knots + 15 * s->threads + N_RED * MAX_WARPS);
  if (s->n < 2 || s->n > s->threads || s->threads > MAX_BINS ||
      s->threads % 32 != 0 || s->knots < 2 || s->smem != need ||
      s->smem > 48 * 1024 || grid < 1 || s->z < 1 ||
      (s->coulomb == COUL_TABLES && s->nte < 2))
    return (int)cudaErrorInvalidValue;
  fp_substeps_kernel<<<grid, s->threads, (size_t)s->smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(*p, *s);
  return (int)cudaGetLastError();
}

}  // extern "C"
