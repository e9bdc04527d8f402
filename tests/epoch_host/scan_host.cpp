// The code scan's layout (csrc/nj_scan.cuh codes_p_tile, codes_slot,
// codes_table_len, codes_table_index) and its row body on the host, for
// tests/test_torch_scan_layout.py: the kernel's tiles are staged in the
// laid-out order, each warp's 32 lanes run codes_rows_tile one after
// another on the kernel's groups of kCodesRowsPerWarp rows (or one row, as
// the join epoch's refresh scans take them), and the lanes' sums meet in
// the xor butterfly of scan_warp_sum.
//
//   g++ -std=c++20 -O1 -shared -fPIC -ffp-contract=off -Iinclude
//       -I../../veryfasttree_tpu_torch/csrc -o libscan_host.so scan_host.cpp
#include <vector>

#include "nj_scan.cuh"

extern "C" {

int vft_codes_p_tile(int P, int C) { return codes_p_tile(P, C); }
int vft_codes_slot(int q, int pt) { return codes_slot(q, pt); }
int64_t vft_codes_table_len(int P, int C) { return codes_table_len(P, C); }
int64_t vft_codes_table_index(int p, int P, int C) { return codes_table_index(p, P, C); }

// den and pick [L] of the code rows [L, P] against G [C, P] and wq [P], as
// nj_scan_codes_kernel sums them (rows_per_warp 0: in its groups of
// kCodesRowsPerWarp rows, one warp a group; 1: one row at a time)
void vft_codes_scan_host(const int8_t* codes, int64_t L, int P, int C, const double* G,
                         const double* wq, int rows_per_warp, double* den_out,
                         double* pick_out) {
  constexpr int kRows = kCodesRowsPerWarp;
  if (rows_per_warp != 1) rows_per_warp = kRows;
  const int p_tile = codes_p_tile(P, C), tile_len = codes_tile_len(p_tile);
  std::vector<double> sG((size_t)C * tile_len), sW(tile_len);
  std::vector<double> den((size_t)L * 32, 0.0), pick((size_t)L * 32, 0.0);
  for (int p0 = 0; p0 < P; p0 += p_tile) {
    const int pt = p_tile < P - p0 ? p_tile : P - p0;
    for (int c = 0; c < C; ++c)
      for (int q = 0; q < pt; ++q) sG[(size_t)c * tile_len + codes_slot(q, pt)] = G[(int64_t)c * P + p0 + q];
    for (int q = 0; q < pt; ++q) sW[codes_slot(q, pt)] = wq[p0 + q];
    for (int64_t row0 = 0; row0 < L; row0 += rows_per_warp) {
      const int n = L - row0 < rows_per_warp ? (int)(L - row0) : rows_per_warp;
      for (int lane = 0; lane < 32; ++lane) {
        double d[kRows], s[kRows];
        for (int r = 0; r < n; ++r) {
          d[r] = den[(row0 + r) * 32 + lane];
          s[r] = pick[(row0 + r) * 32 + lane];
        }
        if (rows_per_warp == 1)
          codes_row_tile<double>(codes + row0 * P + p0, pt, C, sG.data(), tile_len, sW.data(),
                                 lane, d[0], s[0]);
        else
          codes_rows_tile<double, kRows>(codes + row0 * P + p0, P, n, pt, C, sG.data(), tile_len,
                                         sW.data(), lane, d, s);
        for (int r = 0; r < n; ++r) {
          den[(row0 + r) * 32 + lane] = d[r];
          pick[(row0 + r) * 32 + lane] = s[r];
        }
      }
    }
  }
  // scan_warp_sum: v + v[lane ^ off], off = 16, 8, 4, 2, 1; lane 0's
  for (int64_t l = 0; l < L; ++l) {
    double* dv = &den[l * 32];
    double* sv = &pick[l * 32];
    for (int off = 16; off > 0; off >>= 1) {
      double d2[32], s2[32];
      for (int lane = 0; lane < 32; ++lane) {
        d2[lane] = dv[lane] + dv[lane ^ off];
        s2[lane] = sv[lane] + sv[lane ^ off];
      }
      for (int lane = 0; lane < 32; ++lane) {
        dv[lane] = d2[lane];
        sv[lane] = s2[lane];
      }
    }
    den_out[l] = dv[0];
    pick_out[l] = sv[0];
  }
}

}  // extern "C"
