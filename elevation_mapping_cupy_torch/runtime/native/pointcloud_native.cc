// Native sensor-buffer frontend: PointCloud2-style deinterleave + NaN filter.
//
// Equivalent of the reference C++ node's per-point ingest loop
// (elevation_mapping_cupy/src/elevation_mapping_ros.cpp:330-339), which
// copies interleaved sensor records field-by-field into a dense row-major
// matrix before handing it to the device. Exposed via a C ABI for ctypes.
//
// Built with g++ -O3 -shared -fPIC at first use (runtime/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Deinterleave `n` records of `point_step` bytes into out[n][n_fields],
// reading a float32 at each field offset. Returns the number of rows kept
// (rows whose first three fields contain NaN/Inf are dropped — the
// reference's isnan filter, elevation_mapping.py:458).
int64_t deinterleave_f32(
    const uint8_t* data,
    int64_t n,
    int64_t point_step,
    const int64_t* offsets,
    int64_t n_fields,
    float* out,
    int32_t drop_non_finite) {
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* rec = data + i * point_step;
    float* row = out + kept * n_fields;
    for (int64_t f = 0; f < n_fields; ++f) {
      float v;
      std::memcpy(&v, rec + offsets[f], sizeof(float));
      row[f] = v;
    }
    if (drop_non_finite) {
      bool ok = true;
      for (int64_t f = 0; f < 3 && f < n_fields; ++f) {
        if (!std::isfinite(row[f])) { ok = false; break; }
      }
      if (!ok) continue;
    }
    ++kept;
  }
  return kept;
}

// Pack an RGB uint8 image plane-triple into float32 bit-packed colors
// (the reference packs r<<16|g<<8|b into a float's bits).
void pack_rgb_f32(
    const uint8_t* r, const uint8_t* g, const uint8_t* b,
    int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits = (uint32_t(r[i]) << 16) | (uint32_t(g[i]) << 8) | uint32_t(b[i]);
    std::memcpy(&out[i], &bits, sizeof(float));
  }
}

}  // extern "C"
