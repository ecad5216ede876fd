// Native host-side IO for the data layer.
//
// The reference parses COLMAP binary models with per-record Python struct
// loops (the reference's scene/colmap_loader.py:83-294) — minutes for
// multi-million-point reconstructions.  This library does the same wire
// formats in C++ (the file read whole, one pass) and is exposed to Python via
// ctypes (gs_deformable_tpu_torch/io/native.py, built at first use by
// _build.py with the host compiler); the Python parsers remain as a fallback
// when no host compiler exists or a read fails.
//
// Exposed C ABI:
//   gsio_read_points3d_bin(path, &n) -> packed [x y z r g b err] float64 rows
//   gsio_read_images_bin(path, ...)  -> packed qvec/tvec/camera_id + names
//   gsio_read_cameras_bin(path, ...) -> packed id/model/width/height/params
//   gsio_free(ptr)
//
// All outputs are heap buffers owned by the caller (free with gsio_free).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T get() {
    if (p + sizeof(T) > end) {
      ok = false;
      return T{};
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }
  void skip(size_t n) {
    if (p + n > end) {
      ok = false;
      return;
    }
    p += n;
  }
};

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(sz);
  if (std::fread(buf.data(), 1, sz, f) != static_cast<size_t>(sz)) buf.clear();
  std::fclose(f);
  return buf;
}

}  // namespace

extern "C" {

void gsio_free(void* ptr) { std::free(ptr); }

// points3D.bin -> rows of [x, y, z, r, g, b, error] float64.
// Returns nullptr on failure; *out_n = number of points.
double* gsio_read_points3d_bin(const char* path, int64_t* out_n) {
  *out_n = -1;
  auto buf = read_file(path);
  if (buf.empty()) return nullptr;
  Reader r{buf.data(), buf.data() + buf.size()};
  const uint64_t n = r.get<uint64_t>();
  if (!r.ok) return nullptr;
  double* out = static_cast<double*>(std::malloc(sizeof(double) * 7 * n));
  if (!out) return nullptr;
  for (uint64_t i = 0; i < n; i++) {
    r.get<uint64_t>();  // point id
    double* row = out + 7 * i;
    row[0] = r.get<double>();
    row[1] = r.get<double>();
    row[2] = r.get<double>();
    row[3] = r.get<uint8_t>();
    row[4] = r.get<uint8_t>();
    row[5] = r.get<uint8_t>();
    row[6] = r.get<double>();
    const uint64_t track = r.get<uint64_t>();
    r.skip(8 * track);
    if (!r.ok) {
      std::free(out);
      return nullptr;
    }
  }
  *out_n = static_cast<int64_t>(n);
  return out;
}

// images.bin -> meta rows of [image_id, qw, qx, qy, qz, tx, ty, tz, camera_id]
// float64 plus a single '\n'-joined name blob.  The 2D point tracks are
// skipped (the active pipeline never reads them; dataset_readers.py ignores
// xys for training).
double* gsio_read_images_bin(const char* path, int64_t* out_n, char** out_names,
                             int64_t* out_names_len) {
  *out_n = -1;
  auto buf = read_file(path);
  if (buf.empty()) return nullptr;
  Reader r{buf.data(), buf.data() + buf.size()};
  const uint64_t n = r.get<uint64_t>();
  if (!r.ok) return nullptr;
  double* out = static_cast<double*>(std::malloc(sizeof(double) * 9 * n));
  std::string names;
  names.reserve(n * 24);
  for (uint64_t i = 0; i < n; i++) {
    double* row = out + 9 * i;
    row[0] = r.get<int32_t>();
    for (int k = 1; k <= 7; k++) row[k] = r.get<double>();
    row[8] = r.get<int32_t>();
    while (r.ok) {
      char c = static_cast<char>(r.get<uint8_t>());
      if (c == '\0') break;
      names.push_back(c);
    }
    names.push_back('\n');
    const uint64_t n2d = r.get<uint64_t>();
    r.skip(24 * n2d);
    if (!r.ok) {
      std::free(out);
      return nullptr;
    }
  }
  char* nm = static_cast<char*>(std::malloc(names.size() + 1));
  std::memcpy(nm, names.data(), names.size());
  nm[names.size()] = '\0';
  *out_names = nm;
  *out_names_len = static_cast<int64_t>(names.size());
  *out_n = static_cast<int64_t>(n);
  return out;
}

// cameras.bin -> rows of [camera_id, model_id, width, height, p0..p11] float64
// (params zero-padded to 12, the largest COLMAP model).
double* gsio_read_cameras_bin(const char* path, int64_t* out_n) {
  static const int kNumParams[] = {3, 4, 4, 5, 8, 8, 12, 5, 4, 5, 12};
  *out_n = -1;
  auto buf = read_file(path);
  if (buf.empty()) return nullptr;
  Reader r{buf.data(), buf.data() + buf.size()};
  const uint64_t n = r.get<uint64_t>();
  if (!r.ok) return nullptr;
  double* out = static_cast<double*>(std::malloc(sizeof(double) * 16 * n));
  for (uint64_t i = 0; i < n; i++) {
    double* row = out + 16 * i;
    row[0] = r.get<int32_t>();
    const int32_t model = r.get<int32_t>();
    row[1] = model;
    row[2] = static_cast<double>(r.get<uint64_t>());
    row[3] = static_cast<double>(r.get<uint64_t>());
    if (model < 0 || model > 10) {
      std::free(out);
      return nullptr;
    }
    const int np = kNumParams[model];
    for (int k = 0; k < 12; k++) row[4 + k] = 0.0;
    for (int k = 0; k < np; k++) row[4 + k] = r.get<double>();
    if (!r.ok) {
      std::free(out);
      return nullptr;
    }
  }
  *out_n = static_cast<int64_t>(n);
  return out;
}

}  // extern "C"
