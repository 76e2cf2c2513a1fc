// Native CSV reader for the ingest hot path.
//
// The reference ingests with pandas.read_csv (reference train.py:273,
// main.py:242-245) — single-threaded C parsing plus Python-object overhead
// for every string cell. This reader mmaps the file, splits it at newline
// boundaries across threads, parses numeric columns straight to float64 and
// categorical columns to int32 codes against per-column dictionaries (merged
// across threads in a deterministic first-occurrence order), and hands the
// arrays to Python over a flat C ABI (ctypes, zero copies on the numeric
// data). Column kind is inferred from a 1000-row prefix (pandas infers over
// the whole column); a later non-numeric token in a numeric-classified
// column is coerced to NaN but COUNTED (csv_col_n_coerced), and rows with a
// field-count mismatch are dropped but counted (csv_n_bad_rows) — the
// Python wrapper surfaces both so auto-mode ingest can fall back to pandas
// instead of silently diverging.
//
// Build: hhrs_tpu_torch/runtime/__init__.py (g++ -O3 -std=c++17 -fPIC -shared -pthread)
// at first use, into build/hhrs_tpu_torch/. This is a copy of
// hhrs_tpu/runtime/csv_reader.cpp with two changes: find_eol's search for
// a bare \r stops at the next \n (it scanned to the chunk's end on every
// row, quadratic in a chunk's rows), and parse_f64 refuses a token with
// leading whitespace (the port's Python reader, not pandas, is the
// reference its tables must equal).

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Column {
  std::string name;
  int kind = 0;       // 0 = float64, 1 = categorical
  bool int_like = true;  // every token was plain integer text (pandas int64 rule)
  int64_t n_coerced = 0;  // non-numeric tokens coerced to NaN in a numeric column
  std::vector<double> f64;
  std::vector<int32_t> codes;          // -1 = missing
  std::vector<std::string> vocab;      // code -> string
  std::string vocab_joined;            // '\n'-joined, built at finalize
};

struct CsvResult {
  int64_t n_rows = 0;
  int64_t n_bad_rows = 0;  // non-blank rows dropped for a field-count mismatch
  int64_t n_nul_cells = 0;  // cells containing NUL (undeliverable over c_char_p)
  std::vector<Column> cols;
  std::string error;
};

// One thread's view of a categorical column: local codes into a local dict.
struct LocalCat {
  std::vector<int32_t> codes;
  std::vector<std::string> vocab;
  std::unordered_map<std::string, int32_t> dict;
};

inline const char* find_eol(const char* p, const char* end) {
  // pandas honors \n, \r\n, AND bare \r as row terminators; matching only
  // \n silently merged rows around a stray CR.
  // The \r search stops at the \n: a search to the chunk's end made every
  // row of a file without \r scan the rest of its chunk (quadratic).
  const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
  const char* lim = nl ? nl : end;
  const char* cr = static_cast<const char*>(memchr(p, '\r', lim - p));
  return cr ? cr : lim;
}

inline const char* after_eol(const char* eol, const char* end) {
  if (eol >= end) return end;
  if (*eol == '\r' && eol + 1 < end && eol[1] == '\n') return eol + 2;
  return eol + 1;
}

// Parse one line into fields (no quoted-comma support — the schema's city /
// hotel_type values never contain commas; quotes are stripped if present;
// a fully-quoted field's doubled "" escapes are un-escaped by the caller,
// RFC-4180/pandas doublequote semantics).
inline void split_fields(const char* p, const char* eol,
                         std::vector<std::pair<const char*, size_t>>& out) {
  out.clear();
  const char* start = p;
  for (const char* c = p; c <= eol; ++c) {
    if (c == eol || *c == ',') {
      const char* e = c;
      if (e > start && e[-1] == '\r') --e;
      const char* s = start;
      if (e - s >= 2 && *s == '"' && e[-1] == '"') { ++s; --e; }
      out.emplace_back(s, static_cast<size_t>(e - s));
      start = c + 1;
    }
  }
}

// Field bytes → owned string with "" un-doubled (pandas doublequote=True).
inline std::string field_string(const char* s, size_t len) {
  std::string key(s, len);
  size_t pos = 0;
  while ((pos = key.find("\"\"", pos)) != std::string::npos) {
    key.erase(pos, 1);
    ++pos;
  }
  return key;
}

inline bool parse_f64(const char* s, size_t len, double* out) {
  if (len == 0) { *out = NAN; return true; }  // empty → NaN (pandas parity)
  // strtod skips leading whitespace; an integer token with it would arrive
  // as a float64 where the Python reader types int64, so such a token is
  // not numeric here (the column then fails the wrapper's strict checks)
  if (isspace(static_cast<unsigned char>(s[0]))) return false;
  char buf[64];
  if (len >= sizeof(buf)) return false;
  memcpy(buf, s, len);
  buf[len] = 0;
  // pandas rejects C-literal forms strtod accepts: hex ('0x1A') and
  // nan/inf payloads ('nan(chars)') — a hex-id column must stay string
  for (size_t i = 0; i < len; ++i)
    if (s[i] == 'x' || s[i] == 'X' || s[i] == '(') return false;
  char* endp = nullptr;
  double v = strtod(buf, &endp);
  if (endp != buf + len) return false;
  *out = v;
  return true;
}

// pandas reads a numeric column as int64 only when every token is plain
// integer text (optional sign, digits only — no '.', exponent, or empties).
inline bool int_like_token(const char* s, size_t len) {
  if (len == 0) return false;
  size_t i = (*s == '-' || *s == '+') ? 1 : 0;
  if (i >= len) return false;
  for (; i < len; ++i)
    if (s[i] < '0' || s[i] > '9') return false;
  return true;
}

}  // namespace

extern "C" {

CsvResult* csv_load(const char* path, int n_threads) {
  auto* res = new CsvResult();

  int fd = open(path, O_RDONLY);
  if (fd < 0) { res->error = "open failed"; return res; }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    res->error = "stat failed or empty file";
    return res;
  }
  size_t size = static_cast<size_t>(st.st_size);
  const char* base =
      static_cast<const char*>(mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (base == MAP_FAILED) { res->error = "mmap failed"; return res; }
  const char* end = base + size;

  // Header.
  const char* hdr_eol = find_eol(base, end);
  std::vector<std::pair<const char*, size_t>> fields;
  split_fields(base, hdr_eol, fields);
  size_t n_cols = fields.size();
  res->cols.resize(n_cols);
  for (size_t i = 0; i < n_cols; ++i)
    res->cols[i].name.assign(fields[i].first, fields[i].second);

  const char* data_start = after_eol(hdr_eol, end);

  // Decide column kinds from a sample of up to 1000 data rows: a column is
  // numeric only if EVERY sampled non-empty token parses as a number (a
  // single empty/ambiguous first row must not misclassify a string column
  // — pandas infers over the whole column; 1000 rows is the pragmatic
  // approximation, documented in runtime/__init__.py).
  {
    std::vector<uint8_t> numeric(n_cols, 1);
    const char* p = data_start;
    for (int row = 0; row < 1000 && p < end; ++row) {
      const char* eol = find_eol(p, end);
      split_fields(p, eol, fields);
      if (fields.size() == n_cols) {
        for (size_t i = 0; i < n_cols; ++i) {
          if (fields[i].second == 0) continue;  // empty: uninformative
          double v;
          if (!parse_f64(fields[i].first, fields[i].second, &v)) numeric[i] = 0;
        }
      }
      p = after_eol(eol, end);
    }
    // All-empty sample → numeric (pandas reads a fully-empty column as
    // float64 NaN; a numeric column with an empty 1000-row prefix also
    // lands here — the rare opposite case, a string column with an empty
    // 1000-row prefix, is a documented limitation of sampling).
    for (size_t i = 0; i < n_cols; ++i)
      res->cols[i].kind = numeric[i] ? 0 : 1;
  }

  // Chunk the data region at newline boundaries.
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  std::vector<const char*> chunk_begin;
  size_t data_len = static_cast<size_t>(end - data_start);
  size_t target = data_len / static_cast<size_t>(n_threads) + 1;
  const char* cur = data_start;
  for (int t = 0; t < n_threads && cur < end; ++t) {
    chunk_begin.push_back(cur);
    const char* next = cur + target;
    if (next >= end) { cur = end; break; }
    next = find_eol(next, end);
    cur = after_eol(next, end);
  }
  chunk_begin.push_back(end);
  int actual_threads = static_cast<int>(chunk_begin.size()) - 1;

  // Parse chunks in parallel into per-thread buffers.
  struct ChunkOut {
    std::vector<std::vector<double>> f64;       // per float column
    std::vector<LocalCat> cat;                  // per cat column
    std::vector<uint8_t> int_like;              // per column
    std::vector<int64_t> coerced;               // per column NaN coercions
    int64_t rows = 0;
    int64_t bad_rows = 0;
    int64_t nul_cells = 0;
  };
  std::vector<ChunkOut> outs(actual_threads);
  std::vector<std::thread> threads;
  for (int t = 0; t < actual_threads; ++t) {
    threads.emplace_back([&, t] {
      ChunkOut& o = outs[t];
      o.f64.resize(n_cols);
      o.cat.resize(n_cols);
      o.int_like.assign(n_cols, 1);
      o.coerced.assign(n_cols, 0);
      std::vector<std::pair<const char*, size_t>> fl;
      const char* p = chunk_begin[t];
      const char* chunk_end = chunk_begin[t + 1];
      while (p < chunk_end) {
        const char* eol = find_eol(p, chunk_end);
        if (eol == p && eol + 1 >= chunk_end) break;  // trailing blank line
        split_fields(p, eol, fl);
        if (fl.size() == n_cols) {
          ++o.rows;
          for (size_t i = 0; i < n_cols; ++i) {
            if (res->cols[i].kind == 0) {
              double v;
              if (!parse_f64(fl[i].first, fl[i].second, &v)) {
                v = NAN;
                ++o.coerced[i];  // sampled-prefix misclassification signal
              }
              if (o.int_like[i] && !int_like_token(fl[i].first, fl[i].second))
                o.int_like[i] = 0;
              o.f64[i].push_back(v);
            } else {
              if (fl[i].second == 0) {
                o.cat[i].codes.push_back(-1);
              } else {
                if (memchr(fl[i].first, '\0', fl[i].second)) ++o.nul_cells;
                std::string key = field_string(fl[i].first, fl[i].second);
                auto it = o.cat[i].dict.find(key);
                int32_t code;
                if (it == o.cat[i].dict.end()) {
                  code = static_cast<int32_t>(o.cat[i].vocab.size());
                  o.cat[i].dict.emplace(key, code);
                  o.cat[i].vocab.push_back(std::move(key));
                } else {
                  code = it->second;
                }
                o.cat[i].codes.push_back(code);
              }
            }
          }
        } else if (!(fl.size() == 1 && fl[0].second == 0)) {
          ++o.bad_rows;  // non-blank row with a field-count mismatch
        }
        p = after_eol(eol, chunk_end);
      }
    });
  }
  for (auto& th : threads) th.join();

  // Merge: deterministic first-occurrence global dictionaries (chunk order).
  int64_t total = 0;
  for (auto& o : outs) {
    total += o.rows;
    res->n_bad_rows += o.bad_rows;
    res->n_nul_cells += o.nul_cells;
  }
  res->n_rows = total;
  for (size_t i = 0; i < n_cols; ++i) {
    Column& col = res->cols[i];
    if (col.kind == 0) {
      col.f64.reserve(total);
      for (auto& o : outs) {
        col.f64.insert(col.f64.end(), o.f64[i].begin(), o.f64[i].end());
        if (!o.int_like[i]) col.int_like = false;
        col.n_coerced += o.coerced[i];
      }
    } else {
      col.int_like = false;
      std::unordered_map<std::string, int32_t> global;
      col.codes.reserve(total);
      for (auto& o : outs) {
        std::vector<int32_t> remap(o.cat[i].vocab.size());
        for (size_t v = 0; v < o.cat[i].vocab.size(); ++v) {
          auto it = global.find(o.cat[i].vocab[v]);
          if (it == global.end()) {
            int32_t code = static_cast<int32_t>(col.vocab.size());
            global.emplace(o.cat[i].vocab[v], code);
            col.vocab.push_back(o.cat[i].vocab[v]);
            remap[v] = code;
          } else {
            remap[v] = it->second;
          }
        }
        for (int32_t c : o.cat[i].codes)
          col.codes.push_back(c < 0 ? -1 : remap[static_cast<size_t>(c)]);
      }
      for (size_t v = 0; v < col.vocab.size(); ++v) {
        if (v) col.vocab_joined.push_back('\n');
        col.vocab_joined += col.vocab[v];
      }
    }
  }

  munmap(const_cast<char*>(base), size);
  return res;
}

void csv_free(CsvResult* r) { delete r; }
const char* csv_error(CsvResult* r) { return r->error.empty() ? nullptr : r->error.c_str(); }
int64_t csv_n_rows(CsvResult* r) { return r->n_rows; }
int64_t csv_n_bad_rows(CsvResult* r) { return r->n_bad_rows; }
int64_t csv_n_nul_cells(CsvResult* r) { return r->n_nul_cells; }
int64_t csv_col_n_coerced(CsvResult* r, int i) { return r->cols[i].n_coerced; }
int csv_n_cols(CsvResult* r) { return static_cast<int>(r->cols.size()); }
const char* csv_col_name(CsvResult* r, int i) { return r->cols[i].name.c_str(); }
int csv_col_kind(CsvResult* r, int i) { return r->cols[i].kind; }
int csv_col_int_like(CsvResult* r, int i) { return r->cols[i].int_like ? 1 : 0; }
const double* csv_col_f64(CsvResult* r, int i) { return r->cols[i].f64.data(); }
const int32_t* csv_col_codes(CsvResult* r, int i) { return r->cols[i].codes.data(); }
const char* csv_col_vocab(CsvResult* r, int i) { return r->cols[i].vocab_joined.c_str(); }
int csv_col_vocab_size(CsvResult* r, int i) {
  return static_cast<int>(r->cols[i].vocab.size());
}

}  // extern "C"
