// Native event-record processing for compton2d_tpu_torch (a copy of the
// JAX package's compton2d_tpu/native/evtproc.cpp; from the first include
// directive on, the two files are the same text).
//
// The reference's post-processing layer is native C (plcm.c / pspt.c):
// it streams multi-gigabyte text event files and bins millions of
// escaping-photon records. This host library has a plain C ABI and is
// loaded through ctypes by compton2d_tpu_torch.io.native, which builds it
// with g++ into the package's _build/ directory at first use.
//
// Functions:
//   evt_count_rows(path)                  -> number of 7-column records
//   evt_read(path, out, max_rows)         -> parse text event file
//   evt_doppler_lc(...)                   -> plcm.c binning loop
//   evt_doppler_sed(...)                  -> pspt.c time-window spectrum
//   evt_write_rows(path, data, n)         -> append e14.7 text records
//
// The Doppler transform matches plcm.c:386-396 of the reference's
// post-processors exactly.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

static const double C_INV = 3.33333333e-11;  // 1/c, plcm.c:391

int64_t evt_count_rows(const char* path) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    int64_t n = 0;
    int c;
    int saw_char = 0;
    while ((c = fgetc(f)) != EOF) {
        if (c == '\n') {
            if (saw_char) n++;
            saw_char = 0;
        } else if (c > ' ') {
            saw_char = 1;
        }
    }
    if (saw_char) n++;
    fclose(f);
    return n;
}

// Parse a 7-column text event file into out[n*7]. Returns rows read.
int64_t evt_read(const char* path, double* out, int64_t max_rows) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char line[512];
    int64_t n = 0;
    while (n < max_rows && fgets(line, sizeof(line), f)) {
        char* p = line;
        double* row = out + n * 7;
        int ok = 1;
        for (int c = 0; c < 7; ++c) {
            char* end;
            row[c] = strtod(p, &end);
            if (end == p) { ok = 0; break; }
            p = end;
        }
        if (ok) n++;
    }
    fclose(f);
    return n;
}

// Bulk-Doppler + time-of-flight transform (plcm.c:386-396), then bin
// into (nt x nmu x nb) accumulating F, F^2 and counts (plcm.c:440-464).
void evt_doppler_lc(
    const double* events, int64_t n,
    double gam_bulk, double r_max, double t_offset,
    const double* t_edges, int64_t nt,
    const double* mu_edges, int64_t nmu,  // nmu+1 edges
    const double* e_lo, const double* e_hi, int64_t nb,
    double* F, double* F2, double* counts  // (nt*nmu*nb) each
) {
    double beta = sqrt(fmax(1.0 - 1.0 / (gam_bulk * gam_bulk), 0.0));
    for (int64_t i = 0; i < n; ++i) {
        const double* ev = events + i * 7;
        double t = ev[0], E = ev[1], w = ev[2];
        double r = ev[3], z = ev[4], mu = -ev[5], phi = ev[6];
        double dop = gam_bulk * (1.0 + mu * beta);
        t = (t - beta * z * C_INV) / dop;
        E *= dop;
        w *= dop;
        mu = (mu + beta) / (1.0 + mu * beta);
        double cdt = z * mu / gam_bulk
                   + sqrt(fmax(1.0 - mu * mu, 0.0)) * (r_max - r * cos(phi));
        t = t + C_INV * cdt - t_offset;
        if (t < 0.0) continue;

        // time bin (binary search over edges)
        if (t < t_edges[0] || t >= t_edges[nt]) continue;
        int64_t lo = 0, hi = nt;
        while (hi - lo > 1) {
            int64_t mid = (lo + hi) / 2;
            if (t >= t_edges[mid]) lo = mid; else hi = mid;
        }
        int64_t it = lo;

        if (mu < mu_edges[0] || mu >= mu_edges[nmu]) continue;
        lo = 0; hi = nmu;
        while (hi - lo > 1) {
            int64_t mid = (lo + hi) / 2;
            if (mu >= mu_edges[mid]) lo = mid; else hi = mid;
        }
        int64_t imu = lo;

        for (int64_t b = 0; b < nb; ++b) {
            if (E >= e_lo[b] && E < e_hi[b]) {
                int64_t idx = (it * nmu + imu) * nb + b;
                F[idx] += w;
                F2[idx] += w * w;
                counts[idx] += 1.0;
            }
        }
    }
}

// Time-window-selected SED (pspt.c behavior).
void evt_doppler_sed(
    const double* events, int64_t n,
    double gam_bulk, double r_max,
    double t_start, double t_end,
    double mu_min, double mu_max,
    const double* e_edges, int64_t ne,  // ne+1 edges
    double* flux, double* counts        // (ne,)
) {
    double beta = sqrt(fmax(1.0 - 1.0 / (gam_bulk * gam_bulk), 0.0));
    for (int64_t i = 0; i < n; ++i) {
        const double* ev = events + i * 7;
        double t = ev[0], E = ev[1], w = ev[2];
        double r = ev[3], z = ev[4], mu = -ev[5], phi = ev[6];
        double dop = gam_bulk * (1.0 + mu * beta);
        t = (t - beta * z * C_INV) / dop;
        E *= dop;
        w *= dop;
        mu = (mu + beta) / (1.0 + mu * beta);
        double cdt = z * mu / gam_bulk
                   + sqrt(fmax(1.0 - mu * mu, 0.0)) * (r_max - r * cos(phi));
        t = t + C_INV * cdt;
        if (t < t_start || t >= t_end) continue;
        if (mu < mu_min || mu > mu_max) continue;
        if (E < e_edges[0] || E >= e_edges[ne]) continue;
        int64_t lo = 0, hi = ne;
        while (hi - lo > 1) {
            int64_t mid = (lo + hi) / 2;
            if (E >= e_edges[mid]) lo = mid; else hi = mid;
        }
        flux[lo] += w;
        counts[lo] += 1.0;
    }
}


// Append n 7-column records in the reference e14.7 text format
// (imcleak2d.f:105,181 / numpy "%14.7e") — the science event files.
// A buffered snprintf loop is ~3x faster than np.savetxt's
// per-element Python formatting that otherwise bottlenecks event
// spooling on large runs. Returns rows written, -1 on I/O error.
int64_t evt_write_rows(const char* path, const double* data, int64_t n) {
    FILE* fh = fopen(path, "a");
    if (!fh) return -1;
    static const size_t BUF = 1 << 20;
    char* buf = (char*)malloc(BUF);
    if (!buf) { fclose(fh); return -1; }
    size_t used = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double* r = data + 7 * i;
        int m = snprintf(buf + used, BUF - used,
                         "%14.7e %14.7e %14.7e %14.7e %14.7e %14.7e "
                         "%14.7e\n",
                         r[0], r[1], r[2], r[3], r[4], r[5], r[6]);
        if (m < 0) { free(buf); fclose(fh); return -1; }
        used += (size_t)m;
        if (used + 256 > BUF) {
            if (fwrite(buf, 1, used, fh) != used) {
                free(buf); fclose(fh); return -1;
            }
            used = 0;
        }
    }
    if (used && fwrite(buf, 1, used, fh) != used) {
        free(buf); fclose(fh); return -1;
    }
    free(buf);
    fclose(fh);
    return n;
}

}  // extern "C"
