// Native CSV -> float32 matrix parser.
//
// Parity surface: DataVec's native record reading underpinning
// RecordReaderDataSetIterator (the reference's ETL hot path runs through
// JavaCC/opencsv on the JVM; libnd4j handles buffer creation). Here the hot
// path is one C++ pass over the byte buffer producing a dense float32
// matrix that numpy wraps zero-copy; non-numeric fields abort so the
// caller can fall back to the general Python reader.
//
// Build: g++ -O3 -shared -fPIC -o _fastcsv.so fastcsv.cpp   (no deps)
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ABI tag checked by the ctypes loader: bump whenever any exported
// signature or behavioral contract changes, so a stale committed-elsewhere
// .so can never be bound to mismatched expectations on a toolchain-less
// machine (it degrades to the Python fallback instead).
int64_t fastcsv_abi_version(void) { return 2; }

// First pass: count rows/columns. Returns 0 on success, -1 on ragged rows.
// Rows are '\n'-separated; a trailing newline is allowed; empty lines and
// the first skip_lines lines are ignored.
int64_t csv_shape(const char* buf, int64_t len, char delim, int64_t skip_lines,
                  int64_t* out_rows, int64_t* out_cols) {
    int64_t rows = 0, cols = -1, cur_cols = 1, line = 0;
    bool any = false;
    for (int64_t i = 0; i <= len; ++i) {
        bool eol = (i == len) || buf[i] == '\n';
        if (eol) {
            bool empty = !any;
            if (!empty && line >= skip_lines) {
                if (cols == -1) cols = cur_cols;
                else if (cols != cur_cols) return -1;
                rows++;
            }
            if (!empty || i < len) line++;
            cur_cols = 1;
            any = false;
            continue;
        }
        if (buf[i] == delim) cur_cols++;
        else if (buf[i] != '\r' && buf[i] != ' ') any = true;
    }
    *out_rows = rows;
    *out_cols = cols == -1 ? 0 : cols;
    return 0;
}

// Second pass: fill a preallocated rows*cols float32 buffer.
// Returns 0 on success, -2 on a non-numeric field (caller falls back).
int64_t csv_parse(const char* buf, int64_t len, char delim, int64_t skip_lines,
                  float* out, int64_t rows, int64_t cols) {
    int64_t r = 0, line = 0, i = 0;
    while (i < len && r < rows) {
        // find end of line
        int64_t eol = i;
        while (eol < len && buf[eol] != '\n') eol++;
        // empty line?
        bool any = false;
        for (int64_t j = i; j < eol; ++j)
            if (buf[j] != '\r' && buf[j] != ' ') { any = true; break; }
        if (!any || line < skip_lines) {
            line++;
            i = eol + 1;
            continue;
        }
        int64_t c = 0, field_start = i;
        for (int64_t j = i; j <= eol; ++j) {
            if (j == eol || buf[j] == delim) {
                if (c >= cols) return -1;
                char tmp[64];
                int64_t flen = j - field_start;
                if (flen <= 0 || flen >= (int64_t)sizeof(tmp)) return -2;
                memcpy(tmp, buf + field_start, flen);
                tmp[flen] = '\0';
                char* end = nullptr;
                double v = strtod(tmp, &end);
                // strip trailing ws/\r from validity check
                while (end && (*end == ' ' || *end == '\r')) end++;
                if (!end || *end != '\0') return -2;
                out[r * cols + c] = (float)v;
                c++;
                field_start = j + 1;
            }
        }
        if (c != cols) return -1;
        r++;
        line++;
        i = eol + 1;
    }
    return r == rows ? 0 : -1;
}

}  // extern "C"
