// Native batch .npz feature reader with fused row L2 normalization.
//
// A copy of univtg_tpu/native/src/feature_reader.cpp. The port's per-item
// feature IO (univtg_tpu_torch/data/features.py FeatureSource.get;
// reference semantics main/dataset.py:680-696) is
// np.load(<id>.npz)[key] -> astype(float32) -> row L2 norm. That path is
// dominated by zip/central-directory parsing, DEFLATE inflation and the
// normalization pass, all of which hold chunks of the work inside Python.
// This kernel does the whole pipeline in C++ — zip parse, raw inflate
// (zlib), npy header parse, dtype conversion (f2/f4/f8 -> f4) and the
// normalization — with an internal thread pool for batch reads, and
// releases the GIL for the entire call (ctypes).
//
// Scope: ZIP entries written by np.savez / np.savez_compressed (stored or
// deflate, no zip64), C-order npy arrays of 1 or 2 dimensions. Anything
// else returns an error code per file and the Python caller falls back to
// np.load.
//
// Exposed C ABI (see univtg_tpu_torch/native/reader.py):
//   read_npz_batch(paths, n, key, normalize, out_ptrs, out_rows, out_cols,
//                  n_threads)  -> fills malloc'd float32 buffers
//   free_feature_buffers(ptrs, n)

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Blob {
  std::vector<uint8_t> data;
};

bool read_file(const char* path, Blob* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->data.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(out->data.data(), 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

uint16_t rd16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}
uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

constexpr uint32_t kEOCD = 0x06054b50;
constexpr uint32_t kCentral = 0x02014b50;
constexpr uint32_t kLocal = 0x04034b50;

// Locate `name` inside the zip; returns pointer+size of the (possibly
// compressed) payload and the compression method (0 stored / 8 deflate).
bool zip_find(const Blob& zip, const std::string& name, const uint8_t** payload,
              size_t* comp_size, size_t* uncomp_size, uint16_t* method) {
  const uint8_t* d = zip.data.data();
  size_t n = zip.data.size();
  if (n < 22) return false;
  // EOCD: scan backwards over the (bounded 64KB) comment space.
  size_t scan_lo = n >= (1 << 16) + 22 ? n - ((1 << 16) + 22) : 0;
  size_t eocd = SIZE_MAX;
  for (size_t i = n - 22 + 1; i-- > scan_lo;) {
    if (rd32(d + i) == kEOCD) {
      eocd = i;
      break;
    }
  }
  if (eocd == SIZE_MAX) return false;
  uint16_t n_entries = rd16(d + eocd + 10);
  uint32_t cd_off = rd32(d + eocd + 16);
  size_t p = cd_off;
  for (uint16_t e = 0; e < n_entries; ++e) {
    if (p + 46 > n || rd32(d + p) != kCentral) return false;
    uint16_t meth = rd16(d + p + 10);
    uint32_t csize = rd32(d + p + 20);
    uint32_t usize = rd32(d + p + 24);
    uint16_t fn_len = rd16(d + p + 28);
    uint16_t extra_len = rd16(d + p + 30);
    uint16_t comment_len = rd16(d + p + 32);
    uint32_t local_off = rd32(d + p + 42);
    if (p + 46 + fn_len > n) return false;
    std::string fn(reinterpret_cast<const char*>(d + p + 46), fn_len);
    if (fn == name) {
      if (csize == 0xFFFFFFFFu || usize == 0xFFFFFFFFu) return false;  // zip64
      if (static_cast<size_t>(local_off) + 30 > n || rd32(d + local_off) != kLocal)
        return false;
      uint16_t lfn = rd16(d + local_off + 26);
      uint16_t lex = rd16(d + local_off + 28);
      size_t data_off = static_cast<size_t>(local_off) + 30 + lfn + lex;
      if (data_off + csize > n) return false;
      *payload = d + data_off;
      *comp_size = csize;
      *uncomp_size = usize;
      *method = meth;
      return true;
    }
    p += 46u + fn_len + extra_len + comment_len;
  }
  return false;
}

bool inflate_raw(const uint8_t* src, size_t src_len, uint8_t* dst,
                 size_t dst_len) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;  // raw deflate
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_len);
  int rc = inflate(&zs, Z_FINISH);
  bool ok = (rc == Z_STREAM_END) && zs.total_out == dst_len;
  inflateEnd(&zs);
  return ok;
}

// Minimal npy header parse: supports v1/v2 headers, C-order, 1-D or 2-D,
// little-endian f2/f4/f8. Returns element size and shape.
bool npy_parse(const uint8_t* buf, size_t len, size_t* data_off,
               int* elem_kind /* 2,4,8 */, int64_t* rows, int64_t* cols) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  uint8_t major = buf[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = rd16(buf + 8);
    hoff = 10;
  } else {
    if (len < 12) return false;
    hlen = rd32(buf + 8);
    hoff = 12;
  }
  if (hoff + hlen > len) return false;
  std::string h(reinterpret_cast<const char*>(buf + hoff), hlen);
  size_t dp = h.find("'descr'");
  size_t fp = h.find("'fortran_order'");
  size_t sp = h.find("'shape'");
  if (dp == std::string::npos || fp == std::string::npos ||
      sp == std::string::npos)
    return false;
  // dp points at the opening quote of 'descr' itself; the next quote after
  // its closing one (dp+6) opens the value string
  size_t q1 = h.find('\'', dp + 7);
  size_t q2 = q1 == std::string::npos ? q1 : h.find('\'', q1 + 1);
  if (q1 == std::string::npos || q2 == std::string::npos) return false;
  std::string descr = h.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4" || descr == "|f4")
    *elem_kind = 4;
  else if (descr == "<f8")
    *elem_kind = 8;
  else if (descr == "<f2")
    *elem_kind = 2;
  else
    return false;
  if (h.compare(fp + 17, 4, "True") == 0) return false;  // fortran order
  size_t po = h.find('(', sp);
  size_t pc = h.find(')', po);
  if (po == std::string::npos || pc == std::string::npos) return false;
  std::string shape = h.substr(po + 1, pc - po - 1);
  int64_t dims[2] = {0, 1};
  int nd = 0;
  const char* s = shape.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    if (nd >= 2) return false;  // >2-D: python fallback
    char* end;
    long long v = std::strtoll(s, &end, 10);
    if (end == s) return false;
    dims[nd++] = v;
    s = end;
  }
  // Strictly 2-D: the fused row-normalization below is only equivalent to
  // the numpy path (l2_normalize over the last axis) for matrices.
  if (nd != 2) return false;
  *rows = dims[0];
  *cols = dims[1];
  *data_off = hoff + hlen;
  return true;
}

// Half -> float (IEEE 754 binary16, round-trip exact).
float half_to_float(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {
      exp = 127 - 15 + 1;
      while ((mant & 0x400) == 0) {
        mant <<= 1;
        --exp;
      }
      mant &= 0x3FF;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

// status codes per file
enum : int64_t {
  kOk = 0,
  kErrOpen = -1,
  kErrZip = -2,
  kErrInflate = -3,
  kErrNpy = -4,
  kErrAlloc = -5,
};

int64_t read_one(const char* path, const std::string& member, int normalize,
                 float** out_ptr, int64_t* out_rows, int64_t* out_cols) {
  Blob zip;
  if (!read_file(path, &zip)) return kErrOpen;
  const uint8_t* payload;
  size_t csize, usize;
  uint16_t method;
  if (!zip_find(zip, member, &payload, &csize, &usize, &method)) return kErrZip;
  std::vector<uint8_t> inflated;
  const uint8_t* npy;
  size_t npy_len;
  if (method == 0) {
    npy = payload;
    npy_len = csize;
  } else if (method == 8) {
    inflated.resize(usize);
    if (!inflate_raw(payload, csize, inflated.data(), usize)) return kErrInflate;
    npy = inflated.data();
    npy_len = usize;
  } else {
    return kErrZip;
  }
  size_t data_off;
  int kind;
  int64_t rows, cols;
  if (!npy_parse(npy, npy_len, &data_off, &kind, &rows, &cols)) return kErrNpy;
  size_t count = static_cast<size_t>(rows) * static_cast<size_t>(cols);
  if (data_off + count * static_cast<size_t>(kind) > npy_len) return kErrNpy;
  float* buf = static_cast<float*>(std::malloc(count * sizeof(float) + 1));
  if (!buf) return kErrAlloc;
  const uint8_t* src = npy + data_off;
  if (kind == 4) {
    std::memcpy(buf, src, count * sizeof(float));
  } else if (kind == 8) {
    const double* s = reinterpret_cast<const double*>(src);
    for (size_t i = 0; i < count; ++i) buf[i] = static_cast<float>(s[i]);
  } else {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
    for (size_t i = 0; i < count; ++i) buf[i] = half_to_float(s[i]);
  }
  if (normalize) {
    // row L2 norm, additive eps (utils/basic_utils.py:97-99 semantics;
    // float64 accumulation like np.linalg.norm on promoted dot products)
    for (int64_t r = 0; r < rows; ++r) {
      float* row = buf + r * cols;
      double ss = 0.0;
      for (int64_t c = 0; c < cols; ++c)
        ss += static_cast<double>(row[c]) * static_cast<double>(row[c]);
      float inv = 1.0f / (static_cast<float>(std::sqrt(ss)) + 1e-5f);
      for (int64_t c = 0; c < cols; ++c) row[c] *= inv;
    }
  }
  *out_ptr = buf;
  *out_rows = rows;
  *out_cols = cols;
  return kOk;
}

}  // namespace

extern "C" {

// Reads n .npz files in parallel. out_ptrs[i] receives a malloc'd
// (rows*cols) float32 buffer on success (caller frees via
// free_feature_buffers); out_rows[i] is the row count on success or a
// negative error code.
void read_npz_batch(const char** paths, int64_t n, const char* key,
                    int32_t normalize, float** out_ptrs, int64_t* out_rows,
                    int64_t* out_cols, int64_t n_threads) {
  std::string member = std::string(key) + ".npy";
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      out_ptrs[i] = nullptr;
      out_cols[i] = 0;
      int64_t rows = 0, cols = 0;
      float* ptr = nullptr;
      int64_t rc = read_one(paths[i], member, normalize, &ptr, &rows, &cols);
      if (rc == kOk) {
        out_ptrs[i] = ptr;
        out_rows[i] = rows;
        out_cols[i] = cols;
      } else {
        out_rows[i] = rc;
      }
    }
  };
  int64_t t = n_threads < 1 ? 1 : (n_threads > n ? n : n_threads);
  if (t <= 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(t));
  for (int64_t i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

void free_feature_buffers(float** ptrs, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (ptrs[i]) {
      std::free(ptrs[i]);
      ptrs[i] = nullptr;
    }
  }
}

}  // extern "C"
