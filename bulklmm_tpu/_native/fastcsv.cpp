// Multithreaded numeric-CSV parser for genotype/phenotype matrices.
//
// Counterpart of the reference's compiled CSV path (the reference
// relies on Julia's DelimitedFiles/CSV for src/readData.jl); here the host
// data-loader is a small C++ shared library driven through ctypes
// (bulklmm_tpu/_native/__init__.py). The file is read once into memory,
// line boundaries are found, and rows are parsed in parallel with
// std::from_chars — no allocations in the inner loop.
//
// C ABI:
//   fastcsv_dims(path, delim, skip_rows, &rows, &cols) -> 0 on success
//   fastcsv_read(path, delim, skip_rows, skip_cols_left, skip_cols_right,
//                out, rows, cols) -> 0 on success
// where `out` is a caller-allocated rows*cols double buffer and rows/cols
// are the *output* dims (after skipping header rows and id/sex columns).
// Non-numeric cells parse as NaN.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct FileBuf {
  std::string data;
  bool ok = false;
};

FileBuf read_file(const char* path) {
  FileBuf fb;
  FILE* f = std::fopen(path, "rb");
  if (!f) return fb;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  fb.data.resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(fb.data.data(), 1, static_cast<size_t>(size), f) : 0;
  std::fclose(f);
  fb.ok = (static_cast<long>(got) == size);
  return fb;
}

// Offsets of line starts (excluding empty trailing line).
std::vector<size_t> line_starts(const std::string& s) {
  std::vector<size_t> starts;
  starts.reserve(s.size() / 64 + 1);
  size_t i = 0;
  const size_t n = s.size();
  while (i < n) {
    starts.push_back(i);
    const char* nl = static_cast<const char*>(memchr(s.data() + i, '\n', n - i));
    if (!nl) break;
    i = static_cast<size_t>(nl - s.data()) + 1;
  }
  return starts;
}

size_t line_end(const std::string& s, size_t start) {
  const char* nl =
      static_cast<const char*>(memchr(s.data() + start, '\n', s.size() - start));
  size_t e = nl ? static_cast<size_t>(nl - s.data()) : s.size();
  while (e > start && (s[e - 1] == '\r' || s[e - 1] == ' ')) --e;
  return e;
}

int count_fields(const std::string& s, size_t start, char delim) {
  size_t e = line_end(s, start);
  if (e == start) return 0;
  int fields = 1;
  for (size_t i = start; i < e; ++i)
    if (s[i] == delim) ++fields;
  return fields;
}

double parse_cell(const char* b, const char* e) {
  // strip quotes / spaces
  while (b < e && (*b == ' ' || *b == '"')) ++b;
  while (e > b && (*(e - 1) == ' ' || *(e - 1) == '"')) --e;
  double v;
  auto res = std::from_chars(b, e, v);
  if (res.ec != std::errc()) return std::nan("");
  return v;
}

void parse_rows(const std::string& s, const std::vector<size_t>& starts,
                size_t row_begin, size_t row_stop, char delim, long skip_left,
                long total_cols, long out_cols, double* out) {
  for (size_t r = row_begin; r < row_stop; ++r) {
    size_t b = starts[r];
    size_t e = line_end(s, b);
    double* row_out = out + (r - 0) * out_cols;
    long field = 0;
    size_t fb = b;
    for (size_t i = b; i <= e; ++i) {
      if (i == e || s[i] == delim) {
        long oc = field - skip_left;
        if (oc >= 0 && oc < out_cols)
          row_out[oc] = parse_cell(s.data() + fb, s.data() + i);
        ++field;
        fb = i + 1;
        if (field >= total_cols && i != e) break;  // ignore extra fields
      }
    }
    // short rows: fill the rest with NaN
    long first_missing = field - skip_left;
    if (first_missing < 0) first_missing = 0;
    for (long oc = first_missing; oc < out_cols; ++oc)
      row_out[oc] = std::nan("");
  }
}

}  // namespace

extern "C" {

int fastcsv_dims(const char* path, char delim, long skip_rows, long* rows,
                 long* cols) {
  FileBuf fb = read_file(path);
  if (!fb.ok) return 1;
  std::vector<size_t> starts = line_starts(fb.data);
  // drop trailing blank lines
  while (!starts.empty() && line_end(fb.data, starts.back()) == starts.back())
    starts.pop_back();
  if (static_cast<long>(starts.size()) <= skip_rows) {
    *rows = 0;
    *cols = 0;
    return 0;
  }
  *rows = static_cast<long>(starts.size()) - skip_rows;
  *cols = count_fields(fb.data, starts[static_cast<size_t>(skip_rows)], delim);
  return 0;
}

int fastcsv_read(const char* path, char delim, long skip_rows, long skip_left,
                 long skip_right, double* out, long rows, long cols) {
  FileBuf fb = read_file(path);
  if (!fb.ok) return 1;
  std::vector<size_t> starts = line_starts(fb.data);
  while (!starts.empty() && line_end(fb.data, starts.back()) == starts.back())
    starts.pop_back();
  if (static_cast<long>(starts.size()) < skip_rows + rows) return 2;
  starts.erase(starts.begin(), starts.begin() + skip_rows);
  starts.resize(static_cast<size_t>(rows));

  long total_cols = cols + skip_left + skip_right;
  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = hw ? hw : 2;
  if (static_cast<size_t>(rows) < nthreads * 8) nthreads = 1;

  if (nthreads == 1) {
    parse_rows(fb.data, starts, 0, static_cast<size_t>(rows), delim, skip_left,
               total_cols, cols, out);
  } else {
    std::vector<std::thread> threads;
    size_t chunk = (static_cast<size_t>(rows) + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; ++t) {
      size_t b = t * chunk;
      size_t e = std::min(b + chunk, static_cast<size_t>(rows));
      if (b >= e) break;
      threads.emplace_back(parse_rows, std::cref(fb.data), std::cref(starts), b,
                           e, delim, skip_left, total_cols, cols, out);
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"
