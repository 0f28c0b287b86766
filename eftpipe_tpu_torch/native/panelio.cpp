// Native helpers for host-side data ingestion.
//
// The reference accelerates its integral-constraint table rearrangement with
// an optional numba kernel (eftpipe/icc.py:50-77) and warns
// that loading the big (l1,l2,s1,s2,value) text table takes ~1 min with
// pandas / ~10 min with np.loadtxt (icc.py:90-95).  Here both pieces are
// C++: a single-pass strtod table parser (mmap-free, stream-buffered) and a
// binary-search scatter into the 4-D panel array.  Exposed through ctypes
// (native/__init__.py) with a pure-NumPy fallback.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// Parse a whitespace-delimited numeric table.  Lines starting with '#' (after
// leading blanks) are skipped.  Returns 0 on success; fills *out (malloc'd,
// caller frees via free_buffer), *rows, *cols.  Ragged rows -> error 3.
int parse_table(const char* path, double** out, int64_t* rows, int64_t* cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (size > 0 && std::fread(buf.data(), 1, static_cast<size_t>(size), f)
            != static_cast<size_t>(size)) {
        std::fclose(f);
        return 2;
    }
    std::fclose(f);
    buf[static_cast<size_t>(size)] = '\0';

    std::vector<double> values;
    values.reserve(1 << 20);
    int64_t ncols = -1;
    int64_t nrows = 0;

    char* p = buf.data();
    char* end = buf.data() + size;
    while (p < end) {
        // one line
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p < end && *p == '#') {                 // comment line
            while (p < end && *p != '\n') ++p;
            if (p < end) ++p;
            continue;
        }
        int64_t row_count = 0;
        while (p < end && *p != '\n') {
            char* next = nullptr;
            double v = std::strtod(p, &next);
            if (next == p) {                        // not a number
                while (p < end && *p != '\n' && *p != ' ' && *p != '\t') ++p;
            } else {
                values.push_back(v);
                ++row_count;
                p = next;
            }
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        }
        if (p < end) ++p;                           // consume '\n'
        if (row_count == 0) continue;               // blank line
        if (ncols < 0) ncols = row_count;
        else if (row_count != ncols) return 3;      // ragged table
        ++nrows;
    }

    double* data = static_cast<double*>(std::malloc(values.size() * sizeof(double)));
    if (!data && !values.empty()) return 4;
    std::memcpy(data, values.data(), values.size() * sizeof(double));
    *out = data;
    *rows = nrows;
    *cols = ncols < 0 ? 0 : ncols;
    return 0;
}

void free_buffer(double* p) { std::free(p); }

static inline int64_t lower_bound_idx(const double* a, int64_t n, double x) {
    return std::lower_bound(a, a + n, x) - a;
}

// Scatter (l1,l2,s1,s2,value) rows into out[n1,n2,n3,n4] given the sorted
// unique grids (the numba kernel's job, reference icc.py:50-77).
int panel_scatter(const double* table, int64_t nrows,
                  const double* g1, int64_t n1,
                  const double* g2, int64_t n2,
                  const double* g3, int64_t n3,
                  const double* g4, int64_t n4,
                  double* out) {
    const int64_t s1 = n2 * n3 * n4, s2 = n3 * n4, s3 = n4;
    for (int64_t r = 0; r < nrows; ++r) {
        const double* row = table + 5 * r;
        int64_t i1 = lower_bound_idx(g1, n1, row[0]);
        int64_t i2 = lower_bound_idx(g2, n2, row[1]);
        int64_t i3 = lower_bound_idx(g3, n3, row[2]);
        int64_t i4 = lower_bound_idx(g4, n4, row[3]);
        if (i1 >= n1 || i2 >= n2 || i3 >= n3 || i4 >= n4) return 1;
        out[i1 * s1 + i2 * s2 + i3 * s3 + i4] = row[4];
    }
    return 0;
}

// Pair-weighted effective redshift over randoms with a separation window
// [smin, smax] (the numba kernel of script/zeff.py):
//   zeff = sum_{pairs} w_i w_j (z_i + z_j)/2 / sum_{pairs} w_i w_j.
// out[0] = numerator, out[1] = denominator (caller divides, so chunked calls
// can be accumulated).  Pass same_set=1 when both inputs are the same
// catalogue: each unordered pair is then counted once and i == j is skipped.
int pair_zeff(const double* x1, const double* y1, const double* z1,
              const double* red1, const double* w1, int64_t n1,
              const double* x2, const double* y2, const double* z2,
              const double* red2, const double* w2, int64_t n2,
              double smin, double smax, int same_set, double* out) {
    const double smin2 = smin * smin, smax2 = smax * smax;
    double num = 0.0, den = 0.0;
    for (int64_t i = 0; i < n1; ++i) {
        const int64_t jstart = same_set ? i + 1 : 0;
        const double xi = x1[i], yi = y1[i], zi = z1[i];
        const double ri = red1[i], wi = w1[i];
        for (int64_t j = jstart; j < n2; ++j) {
            const double dx = xi - x2[j], dy = yi - y2[j], dz = zi - z2[j];
            const double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < smin2 || d2 > smax2) continue;
            const double ww = wi * w2[j];
            num += ww * 0.5 * (ri + red2[j]);
            den += ww;
        }
    }
    out[0] = num;
    out[1] = den;
    return 0;
}

}  // extern "C"
