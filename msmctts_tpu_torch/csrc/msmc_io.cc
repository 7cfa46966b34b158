// Native feature-IO core of the port's data pipeline (a copy of the JAX
// package's native/msmc_io.cc with its own binding, data/native.py).
//
// A C++ thread pool parses .npy headers / RIFF chunks and fills
// caller-provided float32 arenas in parallel, entirely outside the Python
// GIL, so host-side batch assembly overlaps device steps without worker
// processes.
//
// Exposed C ABI (ctypes):
//   msmc_read_npy(path, out, cap, shape_out, ndim_out, row_start, row_count)
//   msmc_read_wav(path, out, cap, n_out, sr_out)
//   msmc_read_batch(paths, n, kinds, outs, caps, shapes, ndims, statuses, n_threads)
//
// Build (data/native.py does it at first use, into build/msmctts_tpu_torch/):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread msmc_io.cc -o libmsmc_io.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <atomic>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- .npy
// Minimal NumPy format parser: v1.0/v2.0 headers, C-order, dtypes
// <f4/<f8/<i4/<i8. Supports row-sliced reads via fseek (the reference's
// partial reader contract, utils/utils.py:20-99).
struct NpyInfo {
  int64_t shape[8];
  int ndim = 0;
  int itemsize = 0;
  char kind = 'f';
  long data_offset = 0;
  bool fortran = false;
};

bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  auto find_val = [&](const char* key) -> std::string {
    size_t p = header.find(key);
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    size_t e = p + 1;
    int depth = 0;
    while (e < header.size()) {
      char c = header[e];
      if (c == '(' || c == '[') depth++;
      if (c == ')' || c == ']') depth--;
      if ((c == ',' || c == '}') && depth <= 0) break;
      e++;
    }
    return header.substr(p + 1, e - p - 1);
  };

  std::string descr = find_val("'descr'");
  size_t q = descr.find('\'');
  if (q != std::string::npos) descr = descr.substr(q + 1, descr.find('\'', q + 1) - q - 1);
  if (descr.size() < 3) return false;
  info->kind = descr[1];
  info->itemsize = atoi(descr.c_str() + 2);

  info->fortran = find_val("'fortran_order'").find("True") != std::string::npos;

  std::string shape = find_val("'shape'");
  info->ndim = 0;
  const char* s = shape.c_str();
  while (*s && info->ndim < 8) {
    while (*s && (*s < '0' || *s > '9')) s++;
    if (!*s) break;
    info->shape[info->ndim++] = strtoll(s, const_cast<char**>(&s), 10);
  }
  if (info->ndim == 0) {  // scalar
    info->ndim = 1;
    info->shape[0] = 1;
  }
  return true;
}

template <typename T>
void convert_to_f32(const unsigned char* src, float* dst, int64_t n) {
  const T* s = reinterpret_cast<const T*>(src);
  for (int64_t i = 0; i < n; i++) dst[i] = static_cast<float>(s[i]);
}

}  // namespace

extern "C" {

// Returns 0 on success. shape_out must hold >= 8 entries. row_count < 0
// reads all rows from row_start.
int msmc_read_npy(const char* path, float* out, int64_t cap,
                  int64_t* shape_out, int* ndim_out,
                  int64_t row_start, int64_t row_count) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  if (!parse_npy_header(f, &info)) { fclose(f); return -2; }
  // Fortran order: supported for full 2-D reads (transposed on load,
  // matching the reference python reader, utils.py:20-99); row-sliced
  // Fortran reads would need per-column seeks — unsupported.
  bool fortran2d = info.fortran && info.ndim == 2;
  if (info.fortran && info.ndim > 1 && !fortran2d) { fclose(f); return -5; }
  if (fortran2d && (row_start != 0 || (row_count >= 0 && row_count != info.shape[0]))) {
    fclose(f); return -5;
  }

  int64_t rows = info.shape[0];
  int64_t row_elems = 1;
  for (int i = 1; i < info.ndim; i++) row_elems *= info.shape[i];
  if (row_start < 0) row_start = 0;
  if (row_start > rows) row_start = rows;
  if (row_count < 0 || row_start + row_count > rows) row_count = rows - row_start;

  int64_t n = row_count * row_elems;
  if (n > cap) { fclose(f); return -3; }

  fseek(f, info.data_offset + row_start * row_elems * info.itemsize, SEEK_SET);
  std::vector<unsigned char> buf(n * info.itemsize);
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) { fclose(f); return -4; }
  fclose(f);

  std::vector<float> tmp;
  float* dst = out;
  if (fortran2d) { tmp.resize(n); dst = tmp.data(); }

  if (info.kind == 'f' && info.itemsize == 4) {
    memcpy(dst, buf.data(), n * 4);
  } else if (info.kind == 'f' && info.itemsize == 8) {
    convert_to_f32<double>(buf.data(), dst, n);
  } else if (info.kind == 'i' && info.itemsize == 4) {
    convert_to_f32<int32_t>(buf.data(), dst, n);
  } else if (info.kind == 'i' && info.itemsize == 8) {
    convert_to_f32<int64_t>(buf.data(), dst, n);
  } else {
    return -5;
  }

  if (fortran2d) {
    // column-major [R, C] -> row-major out
    int64_t R = info.shape[0], C = info.shape[1];
    for (int64_t c = 0; c < C; c++)
      for (int64_t r = 0; r < R; r++)
        out[r * C + c] = tmp[c * R + r];
  }

  shape_out[0] = row_count;
  for (int i = 1; i < info.ndim; i++) shape_out[i] = info.shape[i];
  *ndim_out = info.ndim;
  return 0;
}

// PCM16/PCM32/float32 RIFF WAV -> mono float32 in [-1, 1].
int msmc_read_wav(const char* path, float* out, int64_t cap,
                  int64_t* n_out, int* sr_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char riff[12];
  if (fread(riff, 1, 12, f) != 12 || memcmp(riff, "RIFF", 4) != 0 ||
      memcmp(riff + 8, "WAVE", 4) != 0) { fclose(f); return -2; }

  uint16_t fmt = 0, channels = 1, bits = 16;
  uint32_t sr = 0;
  int64_t n_samples = 0;
  while (true) {
    char id[4];
    uint32_t size;
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) break;
    if (memcmp(id, "fmt ", 4) == 0) {
      unsigned char fbuf[16];
      if (fread(fbuf, 1, 16, f) != 16) { fclose(f); return -2; }
      fmt = fbuf[0] | (fbuf[1] << 8);
      channels = fbuf[2] | (fbuf[3] << 8);
      memcpy(&sr, fbuf + 4, 4);
      bits = fbuf[14] | (fbuf[15] << 8);
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (memcmp(id, "data", 4) == 0) {
      int64_t frames = size / (channels * (bits / 8));
      if (frames > cap) { fclose(f); return -3; }
      std::vector<unsigned char> buf(size);
      if (fread(buf.data(), 1, size, f) != size) { fclose(f); return -4; }
      for (int64_t i = 0; i < frames; i++) {
        double acc = 0;
        for (int c = 0; c < channels; c++) {
          const unsigned char* p = buf.data() + (i * channels + c) * (bits / 8);
          double v = 0;
          if (fmt == 3 && bits == 32) {
            float fv; memcpy(&fv, p, 4); v = fv;
          } else if (bits == 16) {
            int16_t s; memcpy(&s, p, 2); v = s / 32768.0;
          } else if (bits == 32) {
            int32_t s; memcpy(&s, p, 4); v = s / 2147483648.0;
          } else { fclose(f); return -5; }
          acc += v;
        }
        out[i] = static_cast<float>(acc / channels);
      }
      n_samples = frames;
      break;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (n_samples == 0) return -6;
  *n_out = n_samples;
  *sr_out = static_cast<int>(sr);
  return 0;
}

// Parallel batch read: kinds[i] 0 = npy, 1 = wav. Each output arena
// outs[i] has capacity caps[i] floats; shapes written to shapes[i*8..].
// statuses[i] receives the per-file return code.
void msmc_read_batch(const char** paths, int n, const int* kinds,
                     float** outs, const int64_t* caps,
                     int64_t* shapes, int* ndims, int* statuses,
                     int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  std::vector<std::thread> threads;
  std::atomic<int>* next = new std::atomic<int>(0);
  auto worker = [&]() {
    while (true) {
      int i = next->fetch_add(1);
      if (i >= n) return;
      if (kinds[i] == 0) {
        statuses[i] = msmc_read_npy(paths[i], outs[i], caps[i],
                                    shapes + i * 8, ndims + i, 0, -1);
      } else {
        int sr;
        int64_t ns;
        statuses[i] = msmc_read_wav(paths[i], outs[i], caps[i], &ns, &sr);
        shapes[i * 8] = ns;
        shapes[i * 8 + 1] = sr;  // sample rate rides the unused shape slot
        ndims[i] = 1;
      }
    }
  };
  int t = std::min<int>(n_threads, n);
  for (int i = 0; i < t; i++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  delete next;
}

}  // extern "C"
