// MatrixMarket coordinate body parser, behind a plain C entry point.
//
// Parses the ASCII body of a .mtx file (the lines after the size line)
// into COO arrays with a single strtol/strtol/strtod sweep: whitespace
// and '%' comment lines are skipped, entries are read until nnz of them
// are in or the text ends, and the first token that does not parse as an
// index stops the sweep. Indices come out zero-based. Symmetric
// expansion and CSR assembly stay in Python (utils.exp_util,
// ops.sparse).
//
// The caller allocates rows (int64), cols (int64) and vals (float64) of
// nnz entries each; the return value is the number of entries parsed,
// which the caller compares with nnz. No Python or numpy headers: the
// library is loaded with ctypes (lanczos_adjoints_tpu_torch.native).

#include <cstdint>
#include <cstdlib>

extern "C" long long lat_mtx_parse_body(const char* text, long long text_len, long long nnz,
                                        int has_values, int64_t* rows, int64_t* cols,
                                        double* vals) {
  const char* p = text;
  const char* end = text + text_len;
  long long count = 0;
  while (p < end && count < nnz) {
    // Skip whitespace / newlines.
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p == '%') {  // comment line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    char* next;
    long r = strtol(p, &next, 10);
    if (next == p) break;
    p = next;
    long c = strtol(p, &next, 10);
    if (next == p) break;
    p = next;
    double v = 1.0;
    if (has_values) {
      v = strtod(p, &next);
      p = next;
    }
    rows[count] = r - 1;  // MatrixMarket is 1-based
    cols[count] = c - 1;
    vals[count] = v;
    ++count;
  }
  return count;
}
