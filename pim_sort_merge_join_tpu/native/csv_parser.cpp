// Multithreaded integer-CSV parser (the engine's one native component).
//
// Replacement for the reference's single-threaded strtok/atoi
// ingest loop (load_csv, app.c:59-92): the host-side CSV parse is the only
// part of the pipeline XLA cannot help with, and at >=100M-row benchmark
// scale a Python/numpy parse dominates end-to-end wall time. Parallel
// strategy: one pass to find the header, split the body at newline
// boundaries into per-thread chunks, each thread parses digits with a tight
// hand loop into the shared row-major int64 output (disjoint row ranges, no
// synchronization).
//
// Exposed as a tiny C ABI consumed via ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  const char* begin;
  const char* end;    // points one past the last byte of the chunk
  int64_t row_start;  // first output row index
};

// Parse one signed integer, advancing *p past the number.
inline int64_t parse_int(const char** p) {
  const char* s = *p;
  bool neg = false;
  if (*s == '-') {
    neg = true;
    ++s;
  }
  int64_t v = 0;
  while (*s >= '0' && *s <= '9') {
    v = v * 10 + (*s - '0');
    ++s;
  }
  *p = s;
  return neg ? -v : v;
}

void parse_chunk(const Chunk& c, int ncol, int64_t* out) {
  const char* p = c.begin;
  int64_t row = c.row_start;
  while (p < c.end) {
    int64_t* dst = out + row * ncol;
    for (int col = 0; col < ncol; ++col) {
      dst[col] = parse_int(&p);
      // Skip the delimiter (',' between fields, '\n'/"\r\n" after the row).
      if (p < c.end && *p == ',') ++p;
    }
    if (p < c.end && *p == '\r') ++p;
    if (p < c.end && *p == '\n') ++p;
    ++row;
  }
}

int64_t count_rows(const char* begin, const char* end) {
  int64_t n = 0;
  for (const char* p = begin; p < end; ++p) {
    if (*p == '\n') ++n;
  }
  if (end > begin && end[-1] != '\n') ++n;  // unterminated last line
  return n;
}

}  // namespace

extern "C" {

// Probe the header: returns number of columns, or -1 on error.
int csv_probe_cols(const char* buf, int64_t len) {
  int ncol = 1;
  for (int64_t i = 0; i < len; ++i) {
    if (buf[i] == ',') ++ncol;
    if (buf[i] == '\n') break;
  }
  return ncol;
}

// Count data rows (excluding the header line).
int64_t csv_count_rows(const char* buf, int64_t len) {
  const char* body = static_cast<const char*>(memchr(buf, '\n', len));
  if (!body) return 0;
  ++body;
  return count_rows(body, buf + len);
}

// Parse the body of an in-memory CSV into row-major int64 [nrow, ncol].
// Returns 0 on success, -1 on malformed input (row/field count mismatch).
int csv_parse_i64(const char* buf, int64_t len, int64_t* out, int64_t nrow,
                  int ncol, int nthreads) {
  const char* body = static_cast<const char*>(memchr(buf, '\n', len));
  if (!body) return -1;
  ++body;
  const char* end = buf + len;
  if (nthreads < 1) nthreads = 1;

  // Validate field structure cheaply: the row count must match, and the
  // body must contain exactly nrow * (ncol - 1) commas (catches ragged
  // rows that would otherwise parse silently as zeros).
  if (count_rows(body, end) != nrow) return -1;
  int64_t commas = 0;
  for (const char* p = body; p < end; ++p) {
    if (*p == ',') ++commas;
  }
  if (commas != nrow * (ncol - 1)) return -1;

  std::vector<Chunk> chunks;
  chunks.reserve(nthreads);
  int64_t approx = (end - body) / nthreads;
  const char* cur = body;
  int64_t row_start = 0;
  for (int t = 0; t < nthreads && cur < end; ++t) {
    const char* cend = (t == nthreads - 1) ? end : cur + approx;
    if (cend > end) cend = end;
    // Extend to the next newline so rows never straddle chunks.
    while (cend < end && cend[-1] != '\n') ++cend;
    chunks.push_back({cur, cend, row_start});
    row_start += count_rows(cur, cend);
    cur = cend;
  }
  if (row_start != nrow) return -1;

  std::vector<std::thread> threads;
  threads.reserve(chunks.size());
  for (const Chunk& c : chunks) {
    threads.emplace_back(parse_chunk, c, ncol, out);
  }
  for (auto& t : threads) t.join();
  return 0;
}

// Format a row-major int64 [nrow, ncol] array as CSV body bytes (no header).
// Returns the number of bytes written; `out` must hold at least
// nrow * ncol * 21 bytes. Multithreaded row-range formatting.
int64_t csv_format_i64(const int64_t* data, int64_t nrow, int ncol, char* out,
                       int nthreads) {
  if (nrow == 0) return 0;
  if (nthreads < 1) nthreads = 1;
  int64_t rows_per = (nrow + nthreads - 1) / nthreads;
  std::vector<int64_t> sizes(nthreads, 0);
  std::vector<std::vector<char>> bufs(nthreads);

  auto fmt_range = [&](int t) {
    int64_t r0 = t * rows_per;
    int64_t r1 = r0 + rows_per < nrow ? r0 + rows_per : nrow;
    if (r0 >= r1) return;
    std::vector<char>& b = bufs[t];
    b.resize(static_cast<size_t>((r1 - r0) * ncol * 21));
    char* p = b.data();
    for (int64_t r = r0; r < r1; ++r) {
      for (int c = 0; c < ncol; ++c) {
        p += sprintf(p, "%lld", static_cast<long long>(data[r * ncol + c]));
        *p++ = (c == ncol - 1) ? '\n' : ',';
      }
    }
    sizes[t] = p - b.data();
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(fmt_range, t);
  for (auto& t : threads) t.join();

  char* p = out;
  for (int t = 0; t < nthreads; ++t) {
    memcpy(p, bufs[t].data(), sizes[t]);
    p += sizes[t];
  }
  return p - out;
}

}  // extern "C"
