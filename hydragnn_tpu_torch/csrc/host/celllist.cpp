// Cell-list radius-graph builder (host preprocessing hot path).
//
// The port's copy of hydragnn_tpu/native/celllist.cpp, the code
// unchanged, so both packages find the same edges in the same order: the
// native replacement for the reference's vesin dependency
// (hydragnn/preprocess/graph_samples_checks_and_updates.py:30,172
// RadiusGraphPBC). Built by hydragnn_tpu_torch/native.py and called
// through ctypes.
//
// Conventions match hydragnn_tpu_torch/ops/neighbors.py: directed edges
// (sender, receiver), displacement = pos[s] - pos[r] + shift, shift =
// image @ cell. The caller passes capacity; on overflow the required
// size is returned as a negative number so the caller can retry.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Sentinel: geometry unsupported by the native path (e.g. bounding box
// too sparse for dense bins) — the Python caller falls back to numpy.
constexpr int64_t kUnsupported = INT64_MIN;

struct CellGrid {
  int nx = 0, ny = 0, nz = 0;
  bool ok = false;
  double inv_cell;  // 1 / cell_size
  double lo[3];
  std::vector<std::vector<int>> bins;

  CellGrid(const double* pos, int64_t n, double cell_size) {
    for (int d = 0; d < 3; ++d) lo[d] = pos[d];
    double hi[3] = {pos[0], pos[1], pos[2]};
    for (int64_t i = 0; i < n; ++i) {
      for (int d = 0; d < 3; ++d) {
        double v = pos[3 * i + d];
        if (v < lo[d]) lo[d] = v;
        if (v > hi[d]) hi[d] = v;
      }
    }
    inv_cell = 1.0 / cell_size;
    double fx = (hi[0] - lo[0]) * inv_cell + 1.0;
    double fy = (hi[1] - lo[1]) * inv_cell + 1.0;
    double fz = (hi[2] - lo[2]) * inv_cell + 1.0;
    // Dense bins only when the grid is reasonably occupied; outlier
    // geometries (fragments far apart, absurd coordinates) go back to
    // the numpy sparse-bin path instead of allocating the world.
    double total = fx * fy * fz;
    if (!(total > 0) || total > 8e6 || total > 64.0 * (double)n + 4096.0) {
      return;
    }
    nx = (int)fx;
    ny = (int)fy;
    nz = (int)fz;
    bins.resize((size_t)nx * ny * nz);
    for (int64_t i = 0; i < n; ++i) {
      bins[index_of(&pos[3 * i])].push_back((int)i);
    }
    ok = true;
  }

  size_t index_of(const double* p) const {
    int bx = (int)((p[0] - lo[0]) * inv_cell);
    int by = (int)((p[1] - lo[1]) * inv_cell);
    int bz = (int)((p[2] - lo[2]) * inv_cell);
    return ((size_t)bx * ny + by) * nz + bz;
  }
};

}  // namespace

extern "C" {

// Open-boundary radius graph. Returns the number of edges written, or
// -(needed) if max_pairs is too small (nothing written beyond capacity).
int64_t hgtpu_radius_graph(const double* pos, int64_t n, double radius,
                           int64_t max_pairs, int64_t* senders,
                           int64_t* receivers) {
  if (n <= 0) return 0;
  const double r2 = radius * radius;
  CellGrid grid(pos, n, radius > 1e-12 ? radius : 1e-12);
  if (!grid.ok) return kUnsupported;
  int64_t count = 0;
  for (int bx = 0; bx < grid.nx; ++bx) {
    for (int by = 0; by < grid.ny; ++by) {
      for (int bz = 0; bz < grid.nz; ++bz) {
        const auto& cell = grid.bins[((size_t)bx * grid.ny + by) * grid.nz + bz];
        if (cell.empty()) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          int ox = bx + dx;
          if (ox < 0 || ox >= grid.nx) continue;
          for (int dy = -1; dy <= 1; ++dy) {
            int oy = by + dy;
            if (oy < 0 || oy >= grid.ny) continue;
            for (int dz = -1; dz <= 1; ++dz) {
              int oz = bz + dz;
              if (oz < 0 || oz >= grid.nz) continue;
              const auto& other =
                  grid.bins[((size_t)ox * grid.ny + oy) * grid.nz + oz];
              for (int i : cell) {
                const double* pi = &pos[3 * i];
                for (int j : other) {
                  if (i == j) continue;
                  const double* pj = &pos[3 * j];
                  double ddx = pj[0] - pi[0], ddy = pj[1] - pi[1],
                         ddz = pj[2] - pi[2];
                  double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                  if (d2 <= r2) {
                    if (count < max_pairs) {
                      senders[count] = j;   // sender j -> receiver i
                      receivers[count] = i;
                    }
                    ++count;
                  }
                }
              }
            }
          }
        }
      }
    }
  }
  return count <= max_pairs ? count : -count;
}

// Periodic radius graph over a triclinic cell (row-major 3x3), mixed
// PBC flags per axis. Writes integer-image shifts premultiplied by the
// cell (shift vectors, [E,3]). Positions may lie outside the primary
// cell; they are wrapped internally and the shifts adjusted so that
// pos[s] - pos[r] + shift is the true minimum-image displacement for
// the ORIGINAL positions (same contract as
// hydragnn_tpu_torch/ops/neighbors.py radius_graph_pbc).
int64_t hgtpu_radius_graph_pbc(const double* pos_in, int64_t n,
                               const double* cell, const uint8_t* pbc,
                               double radius, int64_t max_pairs,
                               int64_t* senders, int64_t* receivers,
                               double* shifts) {
  if (n <= 0) return 0;
  const double r2 = radius * radius;

  // inverse cell (for fractional coords)
  double inv[9];
  {
    const double* c = cell;
    double det = c[0] * (c[4] * c[8] - c[5] * c[7]) -
                 c[1] * (c[3] * c[8] - c[5] * c[6]) +
                 c[2] * (c[3] * c[7] - c[4] * c[6]);
    double id = 1.0 / det;
    inv[0] = (c[4] * c[8] - c[5] * c[7]) * id;
    inv[1] = (c[2] * c[7] - c[1] * c[8]) * id;
    inv[2] = (c[1] * c[5] - c[2] * c[4]) * id;
    inv[3] = (c[5] * c[6] - c[3] * c[8]) * id;
    inv[4] = (c[0] * c[8] - c[2] * c[6]) * id;
    inv[5] = (c[2] * c[3] - c[0] * c[5]) * id;
    inv[6] = (c[3] * c[7] - c[4] * c[6]) * id;
    inv[7] = (c[1] * c[6] - c[0] * c[7]) * id;
    inv[8] = (c[0] * c[4] - c[1] * c[3]) * id;
  }

  // wrap into primary cell along periodic axes; remember offsets
  std::vector<double> pos(3 * n);
  std::vector<double> wrap(3 * n, 0.0);
  for (int64_t i = 0; i < n; ++i) {
    const double* p = &pos_in[3 * i];
    double f[3];
    for (int d = 0; d < 3; ++d)
      f[d] = p[0] * inv[3 * 0 + d] + p[1] * inv[3 * 1 + d] +
             p[2] * inv[3 * 2 + d];
    for (int d = 0; d < 3; ++d) {
      double w = pbc[d] ? std::floor(f[d]) : 0.0;
      wrap[3 * i + d] = w;
      f[d] -= w;
    }
    for (int d = 0; d < 3; ++d)
      pos[3 * i + d] = f[0] * cell[3 * 0 + d] + f[1] * cell[3 * 1 + d] +
                       f[2] * cell[3 * 2 + d];
  }

  // number of images per axis: face distance must cover the cutoff
  int nim[3];
  for (int a = 0; a < 3; ++a) {
    if (!pbc[a]) {
      nim[a] = 0;
      continue;
    }
    // height_a = 1 / |row a of inv(cell)^T| = 1 / |col a of inv|
    double nx = inv[3 * 0 + a], ny = inv[3 * 1 + a], nz = inv[3 * 2 + a];
    double h = 1.0 / std::sqrt(nx * nx + ny * ny + nz * nz);
    nim[a] = (int)std::ceil(radius / h);
  }
  // Degenerate cells (cutoff >> cell) would need absurd image counts.
  double n_images = (2.0 * nim[0] + 1) * (2.0 * nim[1] + 1) *
                    (2.0 * nim[2] + 1);
  if (!(n_images > 0) || n_images > 4096.0) return kUnsupported;

  // Bin the wrapped positions once (same CellGrid as the open-boundary
  // path); per image shift, each receiver queries the senders binned
  // around (pos[r] - shift) — O(n_images * n * density) instead of the
  // former all-pairs O(n_images * n^2) host preprocessing.
  CellGrid grid(pos.data(), n, radius > 1e-12 ? radius : 1e-12);

  int64_t count = 0;
  for (int ix = -nim[0]; ix <= nim[0]; ++ix) {
    for (int iy = -nim[1]; iy <= nim[1]; ++iy) {
      for (int iz = -nim[2]; iz <= nim[2]; ++iz) {
        double sh[3];
        for (int d = 0; d < 3; ++d)
          sh[d] = ix * cell[3 * 0 + d] + iy * cell[3 * 1 + d] +
                  iz * cell[3 * 2 + d];
        bool home = (ix == 0 && iy == 0 && iz == 0);
        for (int64_t r = 0; r < n; ++r) {
          const double* pr = &pos[3 * r];
          // candidates s with |pos[s] + sh - pos[r]| <= radius live in
          // bins around the query point q = pos[r] - sh.
          double q[3] = {pr[0] - sh[0], pr[1] - sh[1], pr[2] - sh[2]};
          auto emit = [&](int64_t s) {
            const double* ps = &pos[3 * s];
            double dx = ps[0] + sh[0] - pr[0];
            double dy = ps[1] + sh[1] - pr[1];
            double dz = ps[2] + sh[2] - pr[2];
            double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 <= r2) {
              if (count < max_pairs) {
                senders[count] = s;
                receivers[count] = r;
                // re-express against unwrapped caller positions
                double wx = wrap[3 * r + 0] - wrap[3 * s + 0];
                double wy = wrap[3 * r + 1] - wrap[3 * s + 1];
                double wz = wrap[3 * r + 2] - wrap[3 * s + 2];
                for (int d = 0; d < 3; ++d)
                  shifts[3 * count + d] =
                      sh[d] + wx * cell[3 * 0 + d] + wy * cell[3 * 1 + d] +
                      wz * cell[3 * 2 + d];
              }
              ++count;
            }
          };
          if (grid.ok) {
            int bq[3];
            bool reachable = true;
            for (int d = 0; d < 3; ++d) {
              double f = (q[d] - grid.lo[d]) * grid.inv_cell;
              bq[d] = (int)std::floor(f);
            }
            int dims[3] = {grid.nx, grid.ny, grid.nz};
            for (int d = 0; d < 3; ++d) {
              if (bq[d] < -1 || bq[d] > dims[d]) {
                reachable = false;  // > one bin outside: nothing in range
                break;
              }
            }
            if (!reachable) continue;
            for (int ox = bq[0] - 1; ox <= bq[0] + 1; ++ox) {
              if (ox < 0 || ox >= grid.nx) continue;
              for (int oy = bq[1] - 1; oy <= bq[1] + 1; ++oy) {
                if (oy < 0 || oy >= grid.ny) continue;
                for (int oz = bq[2] - 1; oz <= bq[2] + 1; ++oz) {
                  if (oz < 0 || oz >= grid.nz) continue;
                  const auto& bin =
                      grid.bins[((size_t)ox * grid.ny + oy) * grid.nz + oz];
                  for (int s : bin) {
                    if (home && s == r) continue;
                    emit(s);
                  }
                }
              }
            }
          } else {
            for (int64_t s = 0; s < n; ++s) {
              if (home && s == r) continue;
              emit(s);
            }
          }
        }
      }
    }
  }
  return count <= max_pairs ? count : -count;
}

}  // extern "C"
