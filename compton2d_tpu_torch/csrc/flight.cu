// Photon flight kernel for Hopper (sm_90a): whole-step tracking with the
// Compton scatter sampler inlined, or with collisions handed back.
//
// Replaces compton2d_tpu/transport/flight_pallas2.py::_flight_kernel_v2 in
// its resident-table modes (the Pallas call at flight_pallas2.py:1124) and
// its windowed mode (the call at :1077), selected at run time by
// `inline_scatter`:
//   1  (inline scatter) each lane runs the state machine FLY -> SCT_A ->
//      SCT_B -> FLY until census, leak, weight kill or max_iters;
//   0  (stratified splitting) a collision freezes the lane with
//      FLAG_SCATTER after the move, as a leak does, so that the caller's
//      stratified sampler places the tail copies (flight_pallas2.py:
//      618-625); SCT_A / SCT_B and the event logs never run;
// and by `pair_switch` (either scatter mode):
//   1  the FLY state adds the zone's gamma-gamma opacity, log-linear on the
//      e_gg grid and scaled down by e / e_gg0 below it, to the absorption;
//      above 47 keV its share of the absorbed energy goes to epair instead
//      of edep (flight_pallas2.py:470-496, 549-560);
//   0  no gamma-gamma absorption (the kgg table is not read);
// and by `win_z` (any of the above):
//   0  per-zone tallies over the whole grid, nz * nr <= 1024;
//   W  grids above 1024 zones (nz, nr <= 127): each 1024-slot tile owns
//      the 2W-zone window that starts at zone base[tile] * W. At the top
//      of each iteration a FLY lane whose unclipped zone id lies outside
//      it freezes with FLAG_WINDOW for the caller's next round
//      (flight_pallas2.py:437-446); SCT lanes go on. The tallies are kept
//      per block window, (n / threads, 2, 2W), and the wrapper adds them
//      at base * W + j.
// The states:
//   FLY   optical-depth draw, log-linear sigma/kappa (and kgg) lookup,
//         distance to the next r-shell / z-plane, event select, continuous
//         absorption with per-zone edep/prdep tallies and the pair energy,
//         weight-floor kill, move, zone hop or leak (FLAG_LEAK keeps the
//         target jn/kn);
//   SCT_A guide-bracketed electron-CDF draw (SCAN_S bins per iteration),
//         flux-factor angle and Klein-Nishina acceptance, force-accept of
//         the last candidate at max_tries;
//   SCT_B sz rejection, boost, azimuth, w *= E'/E, event log (K_LOG deep).
//
// What bounds it on the H100. Not bytes and not arithmetic: at the main
// path's shapes the function moves 25 MB and does about 0.06 GFLOP, a
// bound of 7.6 us, while a launch takes about 200 us. It is latency along
// a serial chain: a warp runs as long as its longest-lived lane needs for
// its iterations one after another (58 at the main path's inputs, 93 in
// the pair mode, 66 in the windowed mode), and each iteration is a chain
// of dependent table reads by zone id and unfused IEEE logf / expf /
// sqrtf / divisions. What helps is a shorter iteration and as many lanes
// in flight per SM as the registers allow (1024 at 64 registers).
//
// The design:
// - One thread per slot in lock step within its warp, the state in
//   registers, as the first version of this kernel. About 12% of the
//   lanes a warp issues do work at the main path's inputs (10% in the
//   pair mode), yet they cost little: a warp's diverged state bodies
//   overlap their latencies under independent thread scheduling. A
//   design that regrouped the live photons of persistent blocks into
//   per-state queues every 4 iterations raised that share to 25-46% but
//   was slower than this kernel on the main path and in four of the six
//   path shapes (NVIDIA H100 80GB HBM3, 700 W; compare_flight.py, PERF.md
//   §6): each regrouping adds a load, a store, a partition and a
//   barrier, and its 80-101 registers halved the lanes in flight.
// - Packed tables (flight.build_flight_tables): one byte buffer holding
//   sigma and kappa interleaved per energy bin, so that a lerp reads two
//   float2; kgg; the r and z edges; the CDF; the guide as uint16;
//   gamma-1. Each section starts on 16 bytes.
// - Tables in shared memory. When the sections a mode reads fit beside a
//   1024-thread block's tallies (flight.table_placement, a function of the
//   shapes), thread 0 starts one 1-D bulk copy (TMA) per section onto an
//   mbarrier while the block loads its photons, and every table read is
//   ld.shared (the <true> instance). Otherwise (grids of many zones, the
//   windowed mode) the same layout is read from global memory through the
//   read-only path (<false>). The strat modes stage no scatter tables.
// - Block size. The wrapper picks 128 to 1024 threads a block from the
//   occupancy the build reports (flight_occupancy): the size that keeps
//   the most warps resident, the smaller on a tie. The main path's
//   178,544 bytes of shared memory (161,620 of tables) leave room for one
//   block per SM, so it and Mrk 421 run 1024-thread blocks, the pair
//   corona 4 blocks of 256, its strat variant and global tables 8 of 128
//   (6 on the 32x32 grid, whose per-warp tallies take 8 KB a warp).
// Registers (ptxas -v, sm_90a): 64 in both instances, no spills, 32 bytes
// of stack; __launch_bounds__(1024) caps a thread at 64, so an SM holds
// 32 warps, 1024 lanes in flight, in every mode but the 32x32 grid's.
//
// Random numbers: the reference's interpret-mode counter hash
// (flight_pallas2.py:114-140), keyed by (tile seed, iteration, draw, lane)
// with lane = slot % 1024, so the plain PyTorch version in
// transport/flight.py draws the same numbers lane for lane.
//
// Determinism: per-zone tallies are reduced in a fixed order. Within a
// warp, the lanes that deposit in the same zone in one iteration are
// summed in lane order by the lowest such lane into the warp's own
// shared-memory row; at exit the block adds its warps' rows in warp order
// into its partial, (n / threads, 2, nzr) or (n / threads, 2, 2W), which
// the wrapper sums. No float atomics, so equal inputs give bitwise-equal
// outputs.
//
// Counters: each warp writes its lane-iterations (lanes that ran an
// iteration) and its passes through the FLY, SCT_A and SCT_B bodies
// (iterations in which any of its lanes ran that body), (n / 32, 4) int32,
// from which chip_smoke.py prints the SIMT efficiency.
//
// Numerics follow the Pallas kernel: f32 throughout, the same clamps and
// floors, the 7-term KN series for zn <= 0.15, and the tiny_abs branch.
// Build without fast math and with -fmad=false so each operation rounds
// as the plain version's does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int K_LOG = 8;
constexpr int SCAN_S = 4;
constexpr int GUIDE_G = 512;
constexpr int MAX_THREADS = 1024;    // threads of the largest block
constexpr int SMEM_MAX = 232448;     // dynamic shared memory of one block
constexpr unsigned FULL = 0xffffffffu;

constexpr int FLAG_NONE = 0;
constexpr int FLAG_SCATTER = 1;
constexpr int FLAG_LEAK = 2;
constexpr int FLAG_WINDOW = 3;
constexpr int MODE_FLY = 0;
constexpr int MODE_SCT_A = 1;
constexpr int MODE_SCT_B = 2;

// sections of the packed tables
constexpr int SEC_OPAC = 0;          // (nzr, n_vol) float2 [sigma, kappa]
constexpr int SEC_KGG = 1;           // (nzr, n_gg) f32
constexpr int SEC_EDGES = 2;         // r edges (nr + 1), then z edges
constexpr int SEC_CDF = 3;           // (nzr, num_nt) f32
constexpr int SEC_GUIDE = 4;         // (nzr, GUIDE_G) uint16
constexpr int SEC_GM1 = 5;           // (num_nt - 1,) f32
constexpr int N_SEC = 6;
// per-warp counters: lane-iterations, passes through each state body
constexpr int N_COUNT = 4;

// f32 values of the Pallas kernel's Python constants
constexpr float CLAMP = 1.0f;                  // f32(0.99999999)
constexpr float CLAMP_S = 0x1.fffffcp-1f;      // f32(0.9999999)
constexpr float ONE_M_1E7 = 0x1.fffffcp-1f;    // f32(1 - 1e-7)
constexpr float ONE_M_2E7 = 0x1.fffffap-1f;    // f32(1 - 2e-7)
constexpr float FRAC_MAX = 0x1.ffffdep-1f;     // f32(0.999999)
constexpr float INV_LN2 = 0x1.715476p+0f;      // f32(1/ln 2)
constexpr float GUIDE_LOG_SCALE = 0x1.47ae14p+3f;  // f32(256 / 25)
constexpr float PI_F = 0x1.921fb6p+1f;         // f32(pi)
constexpr float C_LIGHT_F = 0x1.beb9c0p+34f;   // f32(2.9979245620e10)
constexpr float EMASS_KEV = 511.0f;
constexpr float U24 = 0x1.0p-24f;

struct Pointers {
  // photon SoA in
  const float* e; const float* w; const float* w0; const float* r;
  const float* z; const float* mu; const float* cphi; const float* sphi;
  const float* dcen; const int* jz; const int* kr; const uint8_t* alive;
  const int* seeds;
  const int* base;              // (n / TILE,) window base blocks (win_z > 0)
  const unsigned char* tables;  // the packed tables
  // outputs
  float* e_o; float* w_o; float* r_o; float* z_o; float* mu_o;
  float* cphi_o; float* sphi_o; float* dcen_o;
  int* jz_o; int* kr_o; uint8_t* alive_o; int* mode_o; int* flag_o;
  int* jn_o; int* kn_o; int* it_o;
  float* ekill_o; float* esct_o; float* epair_o; int* cnt_o;
  float* tally_part;   // (n / threads, 2, nzr), or (n / threads, 2, 2 win_z)
  int* counters;       // (n / 32, N_COUNT)
  int* iglog;          // (n, K_LOG)
  float* delog;        // (n, K_LOG)
};

struct Scalars {
  int n, nz, nr, n_vol, n_gg, num_nt, max_iters, max_tries, inline_scatter,
      pair_switch, win_z;
  int shared_tables;   // 1: the <true> instance, staged sections in smem
  int threads, smem;   // threads and dynamic shared memory of a block
  int sec_off[N_SEC];    // byte offset of each section in the tables
  int sec_bytes[N_SEC];  // bytes of each section
  int sec_smem[N_SEC];   // shared-memory offset of a staged section, or -1
  int off_tally, off_stage, off_count, off_bar;
  float e_ph_log0, e_ph_dlog, x_ph_hi, e_gg_log0, e_gg_dlog, x_gg_hi, e_gg0,
      weight_floor;
};

// NaN-propagating min/max/clip, as jnp.maximum / jnp.minimum / jnp.clip
__device__ __forceinline__ float mx(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a > b ? a : b);
}
__device__ __forceinline__ float mn(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a < b ? a : b);
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return mn(mx(x, lo), hi);
}
__device__ __forceinline__ int clipi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// uniform [0, 1) with a 24-bit mantissa (flight_pallas2._u01, interpret)
__device__ __forceinline__ float u01(uint32_t seed, uint32_t it,
                                     uint32_t draw, uint32_t lane) {
  uint32_t ctr = seed + it * 2654435761u + draw * 40503u;
  uint32_t bits = hash_u32(ctr ^ (lane * 2246822519u));
  return (float)(int32_t)(bits >> 8) * U24;
}

// composite 512-cell guide index (flight_pallas2._guide_cell)
__device__ __forceinline__ int guide_cell(float u) {
  int j_lin = (int)floorf(u * (float)GUIDE_G);
  float neg_l2 = -logf(mx(1.0f - u, 1e-9f)) * INV_LN2;
  int j_log = GUIDE_G / 2 + (int)floorf((neg_l2 - 1.0f) * GUIDE_LOG_SCALE);
  int j = (u < 0.5f) ? j_lin : j_log;
  return clipi(j, 0, GUIDE_G - 1);
}

// the 1-D bulk copy (TMA) of the staged tables, completed on an mbarrier
__device__ __forceinline__ uint32_t smem_addr(const void* q) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(q));
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// table reads: ld.shared in the staged instance, the read-only path else
template <bool S, typename T>
__device__ __forceinline__ T ld(const T* q) {
  if constexpr (S) return *q; else return __ldg(q);
}

template <bool S>
__global__ void __launch_bounds__(MAX_THREADS)
flight_kernel(Pointers p, Scalars s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int warps = blockDim.x >> 5;
  const int nzr = s.nz * s.nr;
  const int tw = s.win_z ? 2 * s.win_z : nzr;            // tally width
  float* wtally = reinterpret_cast<float*>(smem + s.off_tally);
  float* st_ed = reinterpret_cast<float*>(smem + s.off_stage);
  float* st_pr = st_ed + blockDim.x;
  int* wcount = reinterpret_cast<int*>(smem + s.off_count);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + s.off_bar);

  // ---- stage the tables this mode reads --------------------------------
  // thread 0 starts one bulk copy per section; the block loads its
  // photons meanwhile and waits on the mbarrier before the first iteration
  if constexpr (S) {
    if (tid == 0) {
      uint32_t total = 0;
      for (int k = 0; k < N_SEC; ++k)
        if (s.sec_smem[k] >= 0) total += (s.sec_bytes[k] + 15) & ~15;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(bar)), "r"(total) : "memory");
      for (int k = 0; k < N_SEC; ++k)
        if (s.sec_smem[k] >= 0)
          bulk_load(smem + s.sec_smem[k], p.tables + s.sec_off[k],
                    (s.sec_bytes[k] + 15) & ~15, bar);
    }
  }
  // a section's first byte: in shared memory if staged, else global
  auto at = [&](int k) -> const unsigned char* {
    if constexpr (S) return smem + max(s.sec_smem[k], 0);
    else return p.tables + s.sec_off[k];
  };
  const float2* t_opac = reinterpret_cast<const float2*>(at(SEC_OPAC));
  const float* t_kgg = reinterpret_cast<const float*>(at(SEC_KGG));
  const float* t_redges = reinterpret_cast<const float*>(at(SEC_EDGES));
  const float* t_zedges = t_redges + s.nr + 1;
  const float* t_cdf = reinterpret_cast<const float*>(at(SEC_CDF));
  const uint16_t* t_guide = reinterpret_cast<const uint16_t*>(at(SEC_GUIDE));
  const float* t_gm1 = reinterpret_cast<const float*>(at(SEC_GM1));

  for (int i = tid; i < warps * 2 * tw; i += blockDim.x) wtally[i] = 0.0f;
  if (tid < warps * N_COUNT) wcount[tid] = 0;

  const int slot = blockIdx.x * blockDim.x + tid;
  const uint32_t lane = (uint32_t)(slot % TILE);
  const uint32_t seed = (uint32_t)p.seeds[slot / TILE];
  const int win0 = s.win_z ? p.base[slot / TILE] * s.win_z : 0;

  float e = p.e[slot], w = p.w[slot], r = p.r[slot], z = p.z[slot];
  float mu = p.mu[slot], cphi = p.cphi[slot], sphi = p.sphi[slot];
  float dcen = p.dcen[slot];
  const float w0 = p.w0[slot];
  int jz = p.jz[slot], kr = p.kr[slot], alive = p.alive[slot];
  int flag = FLAG_NONE, jn = jz, kn = kr, mode = MODE_FLY;
  int scan_idx = -1, scan_hi = 0, scan_cnt = 0, tries = 0, igam = 0;
  int sct_cnt = 0;
  float u_e = 0.0f, gma = 1.0f, omg = 0.0f, znue = 1e-3f;
  float ekill = 0.0f, esct = 0.0f, epair = 0.0f;
  // the strat mode logs nothing: its log buffers have no rows
  if (s.inline_scatter) {
    for (int k = 0; k < K_LOG; ++k) {
      p.iglog[(size_t)slot * K_LOG + k] = -1;
      p.delog[(size_t)slot * K_LOG + k] = 0.0f;
    }
  }

  float* my_tally = wtally + warp * 2 * tw;
  float* my_ed = st_ed + warp * 32;
  float* my_pr = st_pr + warp * 32;
  int* my_count = wcount + warp * N_COUNT;
  __syncthreads();
  if constexpr (S) mbar_wait(bar, 0);

  int it = 0;
  while (true) {
    const bool live = (alive == 1) && (flag == FLAG_NONE);
    bool fly = live && (mode == MODE_FLY) && (dcen > 0.0f);
    const bool in_a = live && (mode == MODE_SCT_A);
    const bool in_b = live && (mode == MODE_SCT_B);
    const unsigned run =
        __ballot_sync(FULL, (it < s.max_iters) && (fly || in_a || in_b));
    if (!run) break;
    const uint32_t itu = (uint32_t)it;
    // global zone id (table rows) and the tally's zone key
    const int zid = clipi(jz * s.nr + kr, 0, nzr - 1);
    int tkey = zid;
    if (s.win_z) {
      // window-local id from the unclipped zone id; a FLY lane outside
      // the window freezes (an SCT lane stays in the zone it flew in)
      const int lz = jz * s.nr + kr - win0;
      if (fly && (lz < 0 || lz >= 2 * s.win_z)) {
        flag = FLAG_WINDOW;
        fly = false;
      }
      tkey = clipi(lz, 0, 2 * s.win_z - 1);
    }
    const unsigned pass_fly = __ballot_sync(FULL, fly);
    const unsigned pass_a = __ballot_sync(FULL, in_a);
    const unsigned pass_b = __ballot_sync(FULL, in_b);
    if (wl == 0) {
      my_count[0] += __popc(run);
      my_count[1] += pass_fly != 0u;
      my_count[2] += pass_a != 0u;
      my_count[3] += pass_b != 0u;
    }
    float edep_add = 0.0f, prdep_add = 0.0f, d_e = 0.0f;

    if (fly) {
      // ---- opacity lookup at the photon energy -------------------------
      const float log_e = logf(mx(e, 1e-30f));
      float x_ph = (log_e - s.e_ph_log0) / s.e_ph_dlog;
      x_ph = clip(x_ph, 0.0f, s.x_ph_hi);
      const int i_ph = (int)floorf(x_ph);
      const float f_ph = x_ph - (float)i_ph;
      const int i_p1 = min(i_ph + 1, s.n_vol - 1);
      const float2* orow = t_opac + (size_t)zid * s.n_vol;
      const float2 o0 = ld<S>(orow + i_ph);
      const float2 o1 = ld<S>(orow + i_p1);
      const float sig = mx(o0.x * (1.0f - f_ph) + o1.x * f_ph, 1e-30f);
      const float kap = o0.y * (1.0f - f_ph) + o1.y * f_ph;
      float kgg = 0.0f;
      if (s.pair_switch) {
        // gamma-gamma opacity on the e_gg grid, scaled down below it
        const float x_gg =
            clip((log_e - s.e_gg_log0) / s.e_gg_dlog, 0.0f, s.x_gg_hi);
        const int i_gg = (int)floorf(x_gg);
        const float f_gg = x_gg - (float)i_gg;
        const float* grow = t_kgg + (size_t)zid * s.n_gg;
        kgg = ld<S>(grow + clipi(i_gg, 0, s.n_gg - 1)) * (1.0f - f_gg) +
              ld<S>(grow + min(i_gg + 1, s.n_gg - 1)) * f_gg;
        if (!(e > s.e_gg0)) kgg = kgg * e / s.e_gg0;
      }

      // ---- tau draw + geometry + event select --------------------------
      const float u_tau = 1e-12f + u01(seed, itu, 0, lane) * 1.0f;
      const float dcol = -logf(u_tau) / sig;
      const int kr_c = clipi(kr, 0, s.nr - 1);
      const int jz_c = clipi(jz, 0, s.nz - 1);
      const float r_in = ld<S>(t_redges + kr_c);
      const float r_out = ld<S>(t_redges + kr_c + 1);
      const float z_bot = ld<S>(t_zedges + jz_c);
      const float z_top = ld<S>(t_zedges + jz_c + 1);

      const float eta = clip(cphi, -CLAMP, CLAMP);
      const float mu_c = clip(mu, -CLAMP, CLAMP);
      const float sin_mu = sqrtf(1.0f - mu_c * mu_c);
      const float disp = eta * r;
      const float rsp = r * sphi;
      const float psq = rsp * rsp;
      const bool inward = (eta < 0.0f) && (psq < r_in * r_in);
      const float inout = inward ? -1.0f : 1.0f;
      const float rbnd_shell = inward ? r_in : r_out;
      const float dpbsq = mx(rbnd_shell * rbnd_shell - psq, 1e-6f);
      const float disbr = mx(inout * sqrtf(dpbsq) - disp, 0.0f);
      const float trldb_r = disbr / mx(sin_mu, 1e-12f);
      const float z_r = z + mu_c * trldb_r;
      const bool hits_top = z_r > z_top;
      const bool hits_bot = z_r < z_bot;
      const float zbnd_z = hits_top ? z_top : z_bot;
      const float mu_den = (fabsf(mu_c) > 1e-12f) ? mu_c : 1e-12f;
      const float f_z = mx((zbnd_z - z) * sin_mu / mu_den, 0.0f);
      const float r_z =
          sqrtf(mx(r * r + f_z * f_z + 2.0f * r * f_z * eta, 0.0f));
      const float dzb = zbnd_z - z;
      const float trldb_z = sqrtf(f_z * f_z + dzb * dzb);
      const bool hits_zplane = hits_top || hits_bot;
      const float trldb = hits_zplane ? trldb_z : trldb_r;
      const int g_jnew = hits_top ? jz + 1 : (hits_bot ? jz - 1 : jz);
      const int g_knew = hits_zplane ? kr : kr + (int)inout;
      const float g_rbnd = hits_zplane ? r_z : rbnd_shell;
      const float g_zbnd = hits_zplane ? zbnd_z : z_r;

      float trld = mn(dcen, dcol);
      int ikind = (dcen <= dcol) ? 2 : 3;
      if (trldb < trld) {
        trld = trldb;
        ikind = 1;
      }

      // ---- continuous absorption ---------------------------------------
      const float sigabs = mx(kap + kgg, 1e-30f);
      const float xabs = sigabs * trld;
      const float ewnew = (xabs < 100.0f) ? w * expf(-xabs) : 0.0f;
      const float deleabs = mx(w - ewnew, 0.0f);
      // above 47 keV the gamma-gamma share becomes pairs, not heat
      const float frac_heat =
          (s.pair_switch && e > 47.0f) ? kap / sigabs : 1.0f;
      edep_add = deleabs * frac_heat;
      epair = epair + deleabs * (1.0f - frac_heat);
      const float u_s = 1e-7f + u01(seed, itu, 1, lane) * ONE_M_1E7;
      const bool tiny_abs = xabs <= 1e-5f;
      const float frac =
          clip((1.0f - expf(-xabs)) * u_s, 0.0f, FRAC_MAX);
      const float sstar =
          tiny_abs ? 0.5f * trld : -logf(mx(1.0f - frac, 1e-7f)) / sigabs;
      const float denom = sqrtf(
          mx(r * r + 2.0f * mu * r * sstar + sstar * sstar, 1e-20f));
      const float wmustar = tiny_abs ? mu : (mu * r + sstar) / denom;
      prdep_add = deleabs * wmustar * C_LIGHT_F;

      const bool killed = ewnew <= s.weight_floor * w0;
      if (killed) ekill = ekill + ewnew;

      // ---- move ---------------------------------------------------------
      const bool on_bnd = ikind == 1;
      const float f_h = trld * sqrtf(mx(1.0f - mu * mu, 0.0f));
      const float r_free =
          sqrtf(mx(f_h * f_h + r * r + 2.0f * f_h * r * cphi, 0.0f));
      const float rnew = on_bnd ? g_rbnd : r_free;
      const float znew = on_bnd ? g_zbnd : z + trld * mu;
      const float rs = mx(rnew, 1e-20f);
      float cphi_n = clip((f_h + cphi * r) / rs, -1.0f, 1.0f);
      float sphi_n = clip(sphi * r / rs, -1.0f, 1.0f);
      const float nrm =
          sqrtf(mx(cphi_n * cphi_n + sphi_n * sphi_n, 1e-12f));
      cphi_n = cphi_n / nrm;
      sphi_n = sphi_n / nrm;

      if (killed) {
        w = 0.0f;
        alive = 0;
      } else {
        w = ewnew;
        r = rnew;
        z = znew;
        cphi = cphi_n;
        sphi = sphi_n;
        dcen = dcen - trld;
        // ---- flight events ---------------------------------------------
        if (ikind == 1) {
          const bool in_dom = (g_jnew >= 0) && (g_jnew < s.nz) &&
                              (g_knew >= 0) && (g_knew < s.nr);
          if (in_dom) {
            jz = g_jnew;
            kr = g_knew;
          } else {
            flag = FLAG_LEAK;
            jn = g_jnew;
            kn = g_knew;
          }
        } else if (ikind == 3) {
          if (s.inline_scatter) {
            mode = MODE_SCT_A;
            scan_idx = -1;
            tries = 0;
          } else {
            flag = FLAG_SCATTER;
          }
        }
      }
    } else if (in_a) {
      // ---- SCT_A: electron draw + angle + KN acceptance ----------------
      if (scan_idx < 0) {
        u_e = 1e-7f + u01(seed, itu, 2, lane) * ONE_M_2E7;
        const int cell = guide_cell(u_e);
        const uint16_t* grow = t_guide + (size_t)zid * GUIDE_G;
        const int lo = ld<S>(grow + cell);
        const int hi =
            (cell >= GUIDE_G - 1) ? s.num_nt : (int)ld<S>(grow + cell + 1);
        scan_idx = lo;
        scan_cnt = lo;
        scan_hi = hi;
      }
      const float* crow = t_cdf + (size_t)zid * s.num_nt;
      for (int k = 0; k < SCAN_S; ++k) {
        const int m = scan_idx + k;
        if (m < scan_hi && ld<S>(crow + m) < u_e) scan_cnt += 1;
      }
      scan_idx += SCAN_S;
      if (scan_idx >= scan_hi) {
        const int idx = clipi(scan_cnt, 1, s.num_nt - 1);
        const float gma_new = ld<S>(t_gm1 + idx - 1) + 1.0f;
        const float beta_new =
            sqrtf(mx(1.0f - 1.0f / (gma_new * gma_new), 0.0f));
        float om = 2.0f * u01(seed, itu, 3, lane) - 1.0f;
        om = clip(om, -CLAMP_S, CLAMP_S);
        const float tl_u = u01(seed, itu, 4, lane);
        om = clip((tl_u > 0.5f * (1.0f - beta_new * om)) ? -om : om,
                  -CLAMP_S, CLAMP_S);
        const float znu = e / EMASS_KEV;
        const float zn = (1.0f - beta_new * om) * znu * gma_new;
        const float zs = mx(zn, 1e-6f);
        const float ser =
            1.0f - zn * (2.0f - zn * (5.2f - zn * (13.3f - zn * (
                0x1.057c58p+5f - zn * (0x1.36db6ep+6f
                - zn * 0x1.f34d34p+6f)))));
        const float z3 = zs * zs * zs;
        const float betz = 1.0f + 2.0f * zs;
        const float gamz = zs * (zs - 2.0f) - 2.0f;
        const float full =
            0.375f * (4.0f * zs + 2.0f * z3 * (1.0f + zs) / (betz * betz)
                      + gamz * logf(betz)) / z3;
        const float xknot = (zn <= 0.15f) ? ser : full;
        const float u_acc = u01(seed, itu, 5, lane);
        const bool ok = (zn >= 1e-10f) && (u_acc <= xknot);
        tries += 1;
        // the last candidate is force-accepted at max_tries (the
        // kernel's rule, flight_pallas2.py:722-734)
        if (ok || tries >= s.max_tries) {
          gma = gma_new;
          omg = om;
          znue = mx(zn, 1e-10f);
          igam = idx;
          mode = MODE_SCT_B;
        } else {
          scan_idx = -1;
        }
      }
    } else if (in_b) {
      // ---- SCT_B: sz rejection + finish --------------------------------
      const float betz_b = 1.0f + 2.0f * znue;
      const float phat = betz_b + 1.0f / betz_b;
      const float u1 = u01(seed, itu, 6, lane);
      const float sz = (1.0f + 2.0f * znue * u1) / betz_b;
      const float games_t = 1.0f + (1.0f - 1.0f / mx(sz, 1e-7f)) / znue;
      const bool ok_g = games_t * games_t <= 1.0f;
      const float tr_b = games_t * games_t - 1.0f + sz + 1.0f / sz;
      const float u2 = u01(seed, itu, 7, lane);
      if (ok_g && (u2 * phat <= tr_b)) {
        const float beta_f = sqrtf(mx(1.0f - 1.0f / (gma * gma), 0.0f));
        const float znues = znue * sz;
        const float a1 = PI_F * (2.0f * u01(seed, itu, 8, lane) - 1.0f);
        const float cazes = cosf(a1);
        const float omege =
            clip((omg - beta_f) / (1.0f - beta_f * omg), -CLAMP_S, CLAMP_S);
        const float games = clip(games_t, -CLAMP_S, CLAMP_S);
        float omeges = games * omege + cazes * sqrtf(mx(
            (1.0f - omege * omege) * (1.0f - games * games), 0.0f));
        omeges = clip(omeges, -CLAMP_S, CLAMP_S);
        const float znu_b = e / EMASS_KEV;
        const float znus = (1.0f + beta_f * omeges) * gma * znues;
        float gams = 1.0f - (znue - znues) / mx(znu_b * znus, 1e-30f);
        gams = clip(gams, -CLAMP_S, CLAMP_S);
        const float a2 = PI_F * (2.0f * u01(seed, itu, 9, lane) - 1.0f);
        const float cazs = clip(cosf(a2), -CLAMP_S, CLAMP_S);
        const float mu_b = clip(mu, -CLAMP_S, CLAMP_S);
        float wmus = mu_b * gams + cazs * sqrtf(mx(
            (1.0f - gams * gams) * (1.0f - mu_b * mu_b), 0.0f));
        wmus = clip(wmus, -CLAMP_S, CLAMP_S);
        float cosd = (gams - mu_b * wmus) / sqrtf(mx(
            (1.0f - mu_b * mu_b) * (1.0f - wmus * wmus), 1e-20f));
        cosd = clip(cosd, -CLAMP_S, CLAMP_S);
        float sind = sqrtf(mx(1.0f - cosd * cosd, 0.0f));
        const float sgn = (u01(seed, itu, 10, lane) < 0.5f) ? 1.0f : -1.0f;
        sind = sgn * sind;
        const float cphi_s = cphi * cosd - sphi * sind;
        const float sphi_s = sphi * cosd + cphi * sind;
        const float nrm_s =
            sqrtf(mx(cphi_s * cphi_s + sphi_s * sphi_s, 1e-12f));
        const float e_new = znus * EMASS_KEV;
        const float wscale = znus / mx(znu_b, 1e-30f);
        const float w_new = w * wscale;
        d_e = w_new - w;
        e = e_new;
        w = w_new;
        mu = wmus;
        cphi = cphi_s / nrm_s;
        sphi = sphi_s / nrm_s;
        mode = MODE_FLY;
        esct = esct + d_e;
        if (sct_cnt < K_LOG) {
          p.iglog[(size_t)slot * K_LOG + sct_cnt] = igam;
          p.delog[(size_t)slot * K_LOG + sct_cnt] = d_e;
        }
        sct_cnt += 1;
      }
    }

    // ---- per-zone tallies: fixed-order warp reduction ------------------
    const float ed_c = edep_add + d_e;
    const int key = (fly || in_b) ? tkey : -1;
    __syncwarp();
    my_ed[wl] = ed_c;
    my_pr[wl] = prdep_add;
    __syncwarp();
    const unsigned group = __match_any_sync(FULL, key);
    if (key >= 0 && (__ffs(group) - 1) == wl) {
      float sum_ed = 0.0f, sum_pr = 0.0f;
      unsigned m = group;
      bool first = true;
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        if (first) {
          sum_ed = my_ed[src];
          sum_pr = my_pr[src];
          first = false;
        } else {
          sum_ed = sum_ed + my_ed[src];
          sum_pr = sum_pr + my_pr[src];
        }
      }
      my_tally[key] = my_tally[key] + sum_ed;
      my_tally[tw + key] = my_tally[tw + key] + sum_pr;
    }
    __syncwarp();
    it += 1;
  }

  p.e_o[slot] = e;
  p.w_o[slot] = w;
  p.r_o[slot] = r;
  p.z_o[slot] = z;
  p.mu_o[slot] = mu;
  p.cphi_o[slot] = cphi;
  p.sphi_o[slot] = sphi;
  p.dcen_o[slot] = dcen;
  p.jz_o[slot] = jz;
  p.kr_o[slot] = kr;
  p.alive_o[slot] = (uint8_t)alive;
  p.mode_o[slot] = mode;
  p.flag_o[slot] = flag;
  p.jn_o[slot] = jn;
  p.kn_o[slot] = kn;
  p.it_o[slot] = it;
  p.ekill_o[slot] = ekill;
  p.esct_o[slot] = esct;
  p.epair_o[slot] = epair;
  p.cnt_o[slot] = sct_cnt;
  __syncwarp();
  if (wl < N_COUNT)
    p.counters[((size_t)blockIdx.x * warps + warp) * N_COUNT + wl] =
        my_count[wl];

  __syncthreads();
  float* part = p.tally_part + (size_t)blockIdx.x * 2 * tw;
  for (int i = tid; i < 2 * tw; i += blockDim.x) {
    float acc = wtally[i];
    for (int wp = 1; wp < warps; ++wp) acc = acc + wtally[wp * 2 * tw + i];
    part[i] = acc;
  }
}

using KernelFn = void (*)(Pointers, Scalars);

KernelFn kernel_for(int shared_tables) {
  return shared_tables ? flight_kernel<true> : flight_kernel<false>;
}

}  // namespace

extern "C" {

int flight_pointers_bytes() { return (int)sizeof(Pointers); }
int flight_scalars_bytes() { return (int)sizeof(Scalars); }

// Blocks of the kernel's instance (its staged-table one if shared_tables)
// that one SM holds at `threads` threads and `smem` bytes of dynamic
// shared memory a block, as cudaOccupancyMaxActiveBlocksPerMultiprocessor
// reports it; a negative cudaError on failure.
int flight_occupancy(int shared_tables, int threads, int smem) {
  const KernelFn fn = kernel_for(shared_tables);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      (size_t)smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// Launches the kernel on `stream` and returns cudaGetLastError(). `ptrs`
// and `scalars` point to a Pointers and a Scalars, whose sizes are checked
// against the caller's. The wrapper picks the block size and lays out the
// shared memory (transport/flight.py); a block of `threads` slots divides
// a 1024-slot tile, and n is a multiple of the tile. The per-warp tallies
// hold nz * nr <= 1024 zones (win_z = 0) or a window of 2 * win_z <= 1024
// (windowed, nz and nr <= 127, the reference's edge limit).
int flight_launch(const void* ptrs, const void* scalars, int p_bytes,
                  int s_bytes, void* stream) {
  if (p_bytes != (int)sizeof(Pointers) || s_bytes != (int)sizeof(Scalars))
    return (int)cudaErrorInvalidValue;
  const Pointers* p = static_cast<const Pointers*>(ptrs);
  const Scalars* s = static_cast<const Scalars*>(scalars);
  const bool grid_ok =
      s->win_z ? (s->win_z > 0 && 2 * s->win_z <= 1024 && s->nz <= 127 &&
                  s->nr <= 127)
               : s->nz * s->nr <= 1024;
  if (!grid_ok || s->n % TILE != 0 || s->threads < 32 ||
      s->threads > MAX_THREADS || TILE % s->threads != 0 ||
      s->smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const KernelFn fn = kernel_for(s->shared_tables);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  fn<<<s->n / s->threads, s->threads, (size_t)s->smem,
       reinterpret_cast<cudaStream_t>(stream)>>>(*p, *s);
  return (int)cudaGetLastError();
}

}  // extern "C"
