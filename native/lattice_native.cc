// Native host-side lattice helpers for peapods_tpu.
//
// The engine's device tables are built host-side once per model; for
// large lattices (256^2-class 2D, 16^3+ 3D with high-coordination offsets)
// the pure-python greedy coloring is the slow part of model construction.
// This library provides the same routines in C++ (loaded via ctypes, with a
// python fallback when the library is absent):
//
//   * build_neighbor_tables: periodic Bravais forward/backward neighbor
//     indices (same semantics as the reference lattice construction,
//     /root/reference/spin-sim/src/geometry/lattice.rs:63-81 — row-major
//     strides, rem_euclid wraparound).
//   * greedy_color: first-fit proper coloring of the bond graph in site
//     order; colors partition sites into independent sets for the
//     synchronous multicolor sweeps.
//   * union_find_labels: min-site-index connected-component labels of a
//     forward-bond activation mask — the host-side oracle used by the test
//     suite against the device label-propagation kernel.
//
// Build: make -C native   (produces libpeapods_native.so)

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// shape: [n_dims], offsets: [n_nb * n_dims], out fwd/bwd: [n_spins * n_nb]
void build_neighbor_tables(const int64_t* shape, int n_dims,
                           const int64_t* offsets, int n_nb, int32_t* fwd,
                           int32_t* bwd) {
  std::vector<int64_t> strides(n_dims, 1);
  for (int d = n_dims - 2; d >= 0; --d) {
    strides[d] = strides[d + 1] * shape[d + 1];
  }
  int64_t n_spins = 1;
  for (int d = 0; d < n_dims; ++d) n_spins *= shape[d];

  std::vector<int64_t> coord(n_dims);
  for (int64_t i = 0; i < n_spins; ++i) {
    for (int d = 0; d < n_dims; ++d) {
      coord[d] = (i / strides[d]) % shape[d];
    }
    for (int k = 0; k < n_nb; ++k) {
      int64_t f = 0, b = 0;
      for (int d = 0; d < n_dims; ++d) {
        int64_t off = offsets[k * n_dims + d];
        int64_t cf = (coord[d] + off) % shape[d];
        if (cf < 0) cf += shape[d];
        int64_t cb = (coord[d] - off) % shape[d];
        if (cb < 0) cb += shape[d];
        f += cf * strides[d];
        b += cb * strides[d];
      }
      fwd[i * n_nb + k] = static_cast<int32_t>(f);
      bwd[i * n_nb + k] = static_cast<int32_t>(b);
    }
  }
}

// First-fit greedy coloring over the union of fwd+bwd adjacency; self-bonds
// ignored. Returns the number of colors used.
int32_t greedy_color(const int32_t* fwd, const int32_t* bwd, int64_t n_spins,
                     int n_nb, int32_t* colors) {
  for (int64_t i = 0; i < n_spins; ++i) colors[i] = -1;
  int32_t n_colors = 0;
  std::vector<uint8_t> used;
  for (int64_t i = 0; i < n_spins; ++i) {
    used.assign(static_cast<size_t>(n_colors) + 1, 0);
    for (int k = 0; k < n_nb; ++k) {
      for (const int32_t* tab : {fwd, bwd}) {
        int32_t j = tab[i * n_nb + k];
        if (j != i && colors[j] >= 0 &&
            colors[j] < static_cast<int32_t>(used.size())) {
          used[colors[j]] = 1;
        }
      }
    }
    int32_t c = 0;
    while (c < static_cast<int32_t>(used.size()) && used[c]) ++c;
    colors[i] = c;
    if (c + 1 > n_colors) n_colors = c + 1;
  }
  return n_colors;
}

// Union-find with union-to-min over active forward bonds; labels[i] becomes
// the minimum site index of i's component (the device kernel's convention).
void union_find_labels(const uint8_t* active_fwd, const int32_t* fwd,
                       int64_t n_spins, int n_nb, int32_t* labels) {
  std::vector<int32_t> parent(n_spins);
  for (int64_t i = 0; i < n_spins; ++i) parent[i] = static_cast<int32_t>(i);
  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int64_t i = 0; i < n_spins; ++i) {
    for (int k = 0; k < n_nb; ++k) {
      if (active_fwd[i * n_nb + k]) {
        int32_t a = find(static_cast<int32_t>(i));
        int32_t b = find(fwd[i * n_nb + k]);
        if (a != b) {
          if (a < b) parent[b] = a;
          else parent[a] = b;
        }
      }
    }
  }
  for (int64_t i = 0; i < n_spins; ++i) {
    labels[i] = find(static_cast<int32_t>(i));
  }
}

}  // extern "C"
