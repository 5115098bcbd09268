// Synchrotron sums kernel for Hopper (sm_90a): the zone pass's emission and
// absorption sums over the electron distribution, every zone and photon bin
// in one launch a step.
//
// Replaces no TPU kernel: the JAX package's
// compton2d_tpu.physics.emissivity.volume_em leaves these sums to XLA. The
// port's plain PyTorch version, physics/emissivity.py::sync_sums_reference,
// builds the argument t as a (zones, n_vol, num_nt) tensor in chunks of
// 2^25 elements and runs the synchrotron shape and its two Bessel fits as
// some 45 elementwise kernels over it, each reading and writing the whole
// intermediate: at 99x99 zones, 400 photon and 200 electron bins, about
// 800 GB of HBM traffic a step to make two (9801, 400) sums.
//
// What bounds it on the H100: operations. The benchmark's model counts 90
// a (zone, photon bin, electron bin) term, 70.6 GFLOP at 99x99, 1.05 ms at
// 67 TFLOP/s; the bytes are each zone's two rows in and two rows out. The
// terms' transcendentals (powf, expf, sqrtf) and IEEE divisions run on the
// SFU and the FMA pipes; nothing of a term leaves the registers.
//
// The design:
// - One block a zone, one thread a photon bin (blocks loop over the zones
//   beyond the grid, threads over the bins beyond the block). The zone's
//   fw and sg rows and its denominators 3 gamma^2 nu_b / 1e21 are staged
//   in shared memory; every thread of the block reads the same electron
//   bin at the same time, a broadcast.
// - Each thread adds its terms over the electron bins in ascending order
//   in registers: one fixed order, so a zone's sums depend on nothing
//   outside the zone, and the zone farm's slice of the zones gives bit
//   for bit what the whole grid gives for them.
// - A term with t >= 1e4 (or t NaN) is exactly 0 in the plain version
//   (torch.where(t < 1e4, ..., 0)), and adding it changes no sum: it is
//   skipped. t falls as gamma rises, so these terms are a leading run of
//   each thread's loop. So is a term whose factor exp(-2 min(ts, 60))
//   underflows to 0 (ts above some 52): the finite shape times 0. That
//   factor is computed first, and the fits only where it is not 0 (7%
//   of the kernel's time at 99x99). Where the zone's face, fw or sg
//   holds an inf or a NaN, (face * 0) * fw is not 0, and the block adds
//   such terms as the plain version does.
// - Only the branch of each fit that torch.where selects (ts <= 1) is
//   evaluated.
// - Every term's operations are those of sync_kernel_f32, _expk13_f32 and
//   _expk43_f32 in their order, each rounded as PyTorch's CUDA kernels
//   round it: a Python constant is folded in double and rounded to float;
//   a division by a host scalar is a product with its float reciprocal; a
//   host scalar over a tensor, c / y, is (1 / y) * c; torch.pow is powf
//   with the exponent rounded to float; no contraction into fma
//   (-fmad=false), IEEE division and square root, denormals kept. So the
//   kernel departs from the plain version only by the order of its two
//   sums over gamma.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;    // a block's threads (photon bins)
constexpr int MAX_BINS = 4096;      // electron bins staged (3 rows, 48 KB)

// Zone rows (Z, N) and (Z, V), zone values (Z,) and grid rows, all float32
// and contiguous.
struct Args {
  const float* nu21;   // (V,) photon frequency / 1e21 Hz
  const float* g3;     // (N,) 3 gamma^2
  const float* nbf;    // (Z,) nu_b / 1e21 Hz
  const float* face;   // (Z,) the emissivity's zone factor
  const float* fw;     // (Z, N) f wdg
  const float* sg;     // (Z, N) the absorption's slope gamma p
  float* j;            // (Z, V) sum_g face F(t) fw
  float* k;            // (Z, V) sum_g face F(t) sg
  int z, v, n;
};

// Python floats as PyTorch hands them to a float32 kernel
#define PY(x) static_cast<float>(x)
constexpr double PI = 3.141592653589793;

// 1 / (72 ts) and sqrt(0.5 pi / ts), shared by both fits' large branches
struct Large {
  float zl, sq;
};

__device__ __forceinline__ Large large_terms(float ts) {
  const float r = 1.0f / ts;                      // ts.reciprocal()
  Large l;
  l.zl = 1.0f / (ts * PY(72.0));
  l.sq = sqrtf(r * PY(0.5 * PI));
  return l;
}

// exp(t) K_{4/3}(t) (_expk43_f32), ts in [1e-12, 1e4)
__device__ __forceinline__ float expk43(float ts, Large l) {
  if (ts <= 1.0f) {
    const float a = PY(0.9757317) - ts * PY(7.6790616e-2);
    const float poly_s = ts * a + PY(1.0);
    const float p = powf((1.0f / ts) * PY(2.0), PY(4.0 / 3.0));
    return p * PY(0.44648975) * poly_s;
  }
  const float poly_l = l.zl * PY(55.0) * (PY(1.0) - l.zl * PY(8.5)) + PY(1.0);
  const float e = 1.0f / (ts * PY(50.0) * ts + PY(1.0)) + PY(1.0);
  return l.sq * poly_l * e;
}

// exp(t) K_{1/3}(t) (_expk13_f32), ts in [1e-12, 1e4)
__device__ __forceinline__ float expk13(float ts, Large l) {
  if (ts <= 1.0f) {
    const float z3 = ts * PY(1.5);
    const float zs = powf(z3, PY(1.0 / 3.0));
    const float z = zs * zs;
    const float z32 = z3 * z3;
    const float f1 =
        z32 * (1.0f / PY(6.0)) *
            (z32 * (1.0f / PY(30.0)) * (z32 * (1.0f / PY(56.0)) + PY(1.0)) +
             PY(1.0)) +
        PY(1.0);
    const float f2 =
        z * (z32 * (1.0f / PY(12.0)) *
                 (z32 * (1.0f / PY(42.0)) * (z32 * (1.0f / PY(90.0)) +
                                              PY(1.0)) +
                  PY(1.0)) +
             PY(1.0));
    const float h = expf(fminf(ts, PY(1.0))) * PY(PI * 1.7320508) / zs;
    return h * (f1 * PY(0.35502805) - f2 * PY(0.25881940));
  }
  const float poly = PY(1.0) - l.zl * PY(5.0) * (PY(1.0) - l.zl * PY(38.5));
  const float e = 1.0f / (ts * PY(58.0) * ts + PY(1.0)) + PY(1.0);
  return l.sq * poly / e;
}

// sync_kernel_f32 where t < 1e4, w its exp(-2 min(ts, 60))
__device__ __forceinline__ float sync_shape(float ts, float w) {
  const Large l = ts <= 1.0f ? Large{0.0f, 0.0f} : large_terms(ts);
  const float e43 = expk43(ts, l);
  const float e13 = expk13(ts, l);
  const float ff = ts * ts *
                   (e43 * e13 - ts * PY(0.6) * (e43 - e13) * (e43 + e13));
  return ff * w;
}

__global__ void __launch_bounds__(MAX_THREADS)
volume_em_kernel(const Args a) {
  extern __shared__ float sh[];
  float* den = sh;              // (N,) 3 gamma^2 nu_b / 1e21
  float* fw = sh + a.n;         // (N,)
  float* sg = sh + 2 * a.n;     // (N,)
  for (int z = blockIdx.x; z < a.z; z += gridDim.x) {
    __syncthreads();            // the previous zone's rows are read
    const float nb = a.nbf[z];
    const float face = a.face[z];
    const size_t row = (size_t)z * a.n;
    int odd = 0;
    for (int g = threadIdx.x; g < a.n; g += blockDim.x) {
      den[g] = a.g3[g] * nb;
      fw[g] = a.fw[row + g];
      sg[g] = a.sg[row + g];
      odd |= !isfinite(fw[g]) || !isfinite(sg[g]);
    }
    // a zone whose skipped terms are not all 0
    odd = __syncthreads_or(odd) || !isfinite(face);
    for (int v = threadIdx.x; v < a.v; v += blockDim.x) {
      const float nu = a.nu21[v];
      float sj = 0.0f, sk = 0.0f;
      for (int g = 0; g < a.n; ++g) {
        const float t = nu / den[g];
        float es;
        if (t < PY(1.0e4)) {
          const float ts = fminf(fmaxf(t, PY(1e-12)), PY(2.0e4));
          const float w = expf(fminf(ts, PY(60.0)) * PY(-2.0));
          if (w == 0.0f && !odd) continue;     // (face (ff 0)) fw: 0
          es = face * sync_shape(ts, w);
        } else if (odd) {
          es = face * 0.0f;
        } else {
          continue;
        }
        sj += es * fw[g];
        sk += es * sg[g];
      }
      a.j[(size_t)z * a.v + v] = sj;
      a.k[(size_t)z * a.v + v] = sk;
    }
  }
}

}  // namespace

extern "C" {

int volume_em_args_bytes() { return (int)sizeof(Args); }

// Launches the kernel on `stream` with `grid` blocks of `threads` and
// returns cudaGetLastError(). `args` points to an Args whose size is
// checked against the caller's. The wrapper
// (physics/emissivity.py::sync_sums_kernel) sizes the block: a multiple
// of 32 threads, at most MAX_THREADS; the shared memory is 3 rows of n.
int volume_em_launch(const void* args, int a_bytes, int grid, int threads,
                     void* stream) {
  if (a_bytes != (int)sizeof(Args)) return (int)cudaErrorInvalidValue;
  const Args* a = static_cast<const Args*>(args);
  if (a->z < 1 || a->v < 1 || a->n < 1 || a->n > MAX_BINS || grid < 1 ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * sizeof(float) * (size_t)a->n;
  volume_em_kernel<<<grid, threads, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
