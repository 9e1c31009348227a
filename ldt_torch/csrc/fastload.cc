// Multithreaded bulk .npy loader for RAM-resident point-cloud datasets
// (the port's copy of the JAX package's native loader, built by
// ldt_torch/data/fastload.py).
//
// The datasets load their whole split into RAM once, at start-up; np.load
// of thousands of small .npy files is serial and holds the GIL. This
// library reads and parses them on a thread pool straight into one
// preallocated float32 block.
//
// Scope: C-contiguous little-endian '<f4' arrays of one shape, NPY format
// v1/v2/v3. Anything else gives that file an error status, and the Python
// wrapper falls back to np.load for it.
//
// Build: g++ -O2 -shared -fPIC -pthread -o <lib>.so fastload.cc

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Status codes surfaced to Python (keep in sync with fastload.py).
enum Status : int32_t {
  kOk = 0,
  kOpenFailed = 1,
  kBadMagic = 2,
  kBadHeader = 3,
  kWrongPayload = 4,
  kShortRead = 5,
};

// Parse the NPY header; return payload offset, or -1 on malformed input.
// Validates dtype '<f4', C order, and that the shape tuple matches
// `expected_shape` DIMENSION BY DIMENSION — an element-count-only check
// would silently accept transposed/flattened files of coincidentally equal
// size (e.g. (3,15000) vs (15000,3)) and load scrambled data.
long ParseNpyHeader(FILE* f, const int64_t* expected_shape,
                    int32_t expected_ndim, int32_t* status) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    *status = kBadMagic;
    return -1;
  }
  const int major = magic[6];
  uint32_t header_len = 0;
  size_t len_bytes = (major >= 2) ? 4 : 2;
  unsigned char lenbuf[4] = {0, 0, 0, 0};
  if (fread(lenbuf, 1, len_bytes, f) != len_bytes) {
    *status = kBadHeader;
    return -1;
  }
  header_len = lenbuf[0] | (lenbuf[1] << 8) | (lenbuf[2] << 16)
      | (lenbuf[3] << 24);
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) {
    *status = kBadHeader;
    return -1;
  }
  if (header.find("'descr': '<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    *status = kWrongPayload;
    return -1;
  }
  // shape tuple, compared dim by dim against the expected shape
  size_t p = header.find("'shape': (");
  if (p == std::string::npos) {
    *status = kBadHeader;
    return -1;
  }
  p += 10;
  int32_t ndim = 0;
  bool ok = true;
  while (p < header.size() && header[p] != ')') {
    if (header[p] >= '0' && header[p] <= '9') {
      int64_t v = 0;
      while (p < header.size() && header[p] >= '0' && header[p] <= '9') {
        v = v * 10 + (header[p] - '0');
        ++p;
      }
      if (ndim >= expected_ndim || v != expected_shape[ndim]) ok = false;
      ++ndim;
    } else {
      ++p;
    }
  }
  if (!ok || ndim != expected_ndim) {
    *status = kWrongPayload;
    return -1;
  }
  return static_cast<long>(8 + len_bytes + header_len);
}

void LoadOne(const char* path, float* dst, int64_t elems,
             const int64_t* expected_shape, int32_t expected_ndim,
             int32_t* status) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) {
    *status = kOpenFailed;
    return;
  }
  long payload = ParseNpyHeader(f, expected_shape, expected_ndim, status);
  if (payload < 0) {
    fclose(f);
    return;
  }
  if (fseek(f, payload, SEEK_SET) != 0 ||
      fread(dst, sizeof(float), static_cast<size_t>(elems), f)
          != static_cast<size_t>(elems)) {
    *status = kShortRead;
    fclose(f);
    return;
  }
  fclose(f);
  *status = kOk;
}

}  // namespace

extern "C" {

// Load `n_files` .npy files (each exactly shape[0] x ... x shape[ndim-1]
// '<f4', C order) into `out` (preallocated, n_files * prod(shape) floats).
// `statuses[i]` receives a Status per file. Returns the number of failures.
int ldt_load_npy_batch(const char** paths, int64_t n_files,
                       const int64_t* shape, int32_t ndim, float* out,
                       int32_t* statuses, int32_t n_threads) {
  int64_t elems_per_file = 1;
  for (int32_t d = 0; d < ndim; ++d) elems_per_file *= shape[d];
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n_files) n_threads = static_cast<int32_t>(n_files);
  std::atomic<int64_t> next(0);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&]() {
      while (true) {
        const int64_t i = next.fetch_add(1);
        if (i >= n_files) break;
        LoadOne(paths[i], out + i * elems_per_file, elems_per_file,
                shape, ndim, &statuses[i]);
      }
    });
  }
  for (auto& w : workers) w.join();
  int failures = 0;
  for (int64_t i = 0; i < n_files; ++i) {
    if (statuses[i] != kOk) ++failures;
  }
  return failures;
}

}  // extern "C"
