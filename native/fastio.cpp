// fastio.cpp — native ASCII formatters for the hot IO paths.
//
// The analog of the reference's native IO layer (LBMIO.h): the solver
// itself is JAX/Pallas, but the large ASCII artifacts (legacy VTK frames,
// the per-cell velocity_field.csv) are formatted in C++ for throughput —
// fprintf-formatting a 1M-cell frame in Python costs seconds; here it is
// tens of milliseconds. Output bytes are identical to the reference's
// std::fixed << setprecision(8) streams (LBMIO.h:79-110, 312-320).
//
// Exposed via a plain C ABI and loaded from Python with ctypes
// (tpulbm/utils/native.py). Build: native/build.sh.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// Format v with "%.8f" into buf, returning chars written. snprintf is the
// bottleneck-safe choice (exact libc double formatting, same as iostreams).
inline int fmt8(char* buf, double v) { return std::snprintf(buf, 32, "%.8f", v); }

constexpr size_t kBuf = 1 << 22;  // 4 MiB stdio buffer

}  // namespace

extern "C" {

// Writes: header, then "ux uy 0.0" vector lines, then the magnitude scalar
// block, then the density scalar block — byte-for-byte the reference VTK
// layout (LBMIO.h:69-107). Returns 0 on success.
int fastio_write_vtk(const char* path, const char* header,
                     const double* ux, const double* uy, const double* rho,
                     int64_t n) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  setvbuf(f, nullptr, _IOFBF, kBuf);
  std::fputs(header, f);
  std::fputs("VECTORS velocity double\n", f);
  char line[128];
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, ux[i]);
    line[k++] = ' ';
    k += fmt8(line + k, uy[i]);
    std::memcpy(line + k, " 0.0\n", 5);
    std::fwrite(line, 1, k + 5, f);
  }
  std::fputs("\nSCALARS velocity_magnitude double\nLOOKUP_TABLE default\n", f);
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, std::sqrt(ux[i] * ux[i] + uy[i] * uy[i]));
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  std::fputs("\nSCALARS density double\nLOOKUP_TABLE default\n", f);
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, rho[i]);
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  return std::fclose(f) ? 1 : 0;
}

// 3-D variant: real uz in the vector lines and the magnitude
// (STRUCTURED_POINTS with DIMENSIONS nx ny nz in the header; same blocks).
int fastio_write_vtk3(const char* path, const char* header, const double* ux,
                      const double* uy, const double* uz, const double* rho,
                      int64_t n) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  setvbuf(f, nullptr, _IOFBF, kBuf);
  std::fputs(header, f);
  std::fputs("VECTORS velocity double\n", f);
  char line[192];
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, ux[i]);
    line[k++] = ' ';
    k += fmt8(line + k, uy[i]);
    line[k++] = ' ';
    k += fmt8(line + k, uz[i]);
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  std::fputs("\nSCALARS velocity_magnitude double\nLOOKUP_TABLE default\n", f);
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line,
                 std::sqrt(ux[i] * ux[i] + uy[i] * uy[i] + uz[i] * uz[i]));
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  std::fputs("\nSCALARS density double\nLOOKUP_TABLE default\n", f);
  for (int64_t i = 0; i < n; ++i) {
    int k = fmt8(line, rho[i]);
    line[k++] = '\n';
    std::fwrite(line, 1, k, f);
  }
  return std::fclose(f) ? 1 : 0;
}

// Per-cell CSV "x,y,ux,uy,rho,velocity_magnitude" (LBMIO.h:312-320).
int fastio_write_velocity_field(const char* path, const double* ux,
                                const double* uy, const double* rho,
                                int64_t ny, int64_t nx) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  setvbuf(f, nullptr, _IOFBF, kBuf);
  std::fputs("x,y,ux,uy,rho,velocity_magnitude\n", f);
  char line[256];
  for (int64_t y = 0; y < ny; ++y) {
    for (int64_t x = 0; x < nx; ++x) {
      int64_t i = y * nx + x;
      double mag = std::sqrt(ux[i] * ux[i] + uy[i] * uy[i]);
      int k = std::snprintf(line, sizeof(line), "%lld,%lld,", (long long)x,
                            (long long)y);
      k += fmt8(line + k, ux[i]);
      line[k++] = ',';
      k += fmt8(line + k, uy[i]);
      line[k++] = ',';
      k += fmt8(line + k, rho[i]);
      line[k++] = ',';
      k += fmt8(line + k, mag);
      line[k++] = '\n';
      std::fwrite(line, 1, k, f);
    }
  }
  return std::fclose(f) ? 1 : 0;
}

}  // extern "C"
