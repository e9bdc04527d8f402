"""The code scan's query-table layout and lane order (csrc/nj_scan.cuh), on
the CPU.

nj_scan_codes and the join epoch's refresh scans read the projected query
table G [C, P] and its weights wq laid out per tile of positions: position
q of a tile of pt at slot (q % 16) * S + q // 16, S = pt // 16 rounded up
to odd (codes_slot).  The layout functions and the row body compile as host
C++ (tests/epoch_host/scan_host.cpp, built here with g++, the 32 lanes run
one after another).  Checked:

* the layout: a bijection of each tile onto its slots within
  codes_tile_len, for the tiles of codes_p_tile at 4 and 20 codes, one tile
  and several; at each step j the 16 lanes of a half-warp (positions
  16 v + j) read 16 distinct bank pairs of shared memory whatever code each
  lane's row has, and 16 threads staging 16 consecutive positions write 16
  distinct bank pairs; the Python mirrors (ops/scan_kernels.py) equal the
  C++ functions;
* the lane order: chip_smoke.codes_lane_replay (numpy: each lane's
  positions in order, then the xor butterfly) against the plain twin
  nj_scan_codes_ref within 1e-12 (both sum in float64, in different
  orders), with the same best index on the tied rows of _codes_inputs
  (test_torch_kernels.py), whose twin is held to the JAX package's Pallas
  kernel there; and the kernel's own row body on the host (its rows a
  warp, as the scan kernel; one, as the refresh scans) bit for bit the
  replay, over one tile and over several.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from test_torch_kernels import (M_REAL, MODES, N_ACTIVE, TIE, _codes_inputs,
                                _t)
from veryfasttree_tpu_torch.ops import _build
from veryfasttree_tpu_torch.ops import scan_kernels as sk

HERE = Path(__file__).resolve().parent
# (P, C): one tile at 4 and 20 codes; several tiles at 20 (1216 + 320) and
# at 4 (5120 x 4, the last shorter)
SHAPES = [(512, 4), (128, 20), (512, 20), (1536, 20), (20000, 4)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host scan body")
    out = tmp_path_factory.mktemp("scan_host") / "libscan_host.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
         f"-I{HERE / 'epoch_host' / 'include'}", f"-I{_build.SRC_DIR}",
         "-o", str(out), str(HERE / "epoch_host" / "scan_host.cpp")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    for name, args, res in (("vft_codes_p_tile", [i32, i32], i32),
                            ("vft_codes_slot", [i32, i32], i32),
                            ("vft_codes_table_len", [i32, i32], i64),
                            ("vft_codes_table_index", [i32, i32, i32], i64),
                            ("vft_codes_scan_host",
                             [ptr, i64, i32, i32, ptr, ptr, i32, ptr, ptr],
                             None)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _tiles(P, C):
    pt = sk.codes_p_tile(P, C)
    return [min(pt, P - p0) for p0 in range(0, P, pt)]


@pytest.mark.parametrize("P,C", SHAPES)
def test_layout_is_a_bijection_and_the_mirrors_agree(host_lib, P, C):
    p_tile = sk.codes_p_tile(P, C)
    assert p_tile == host_lib.vft_codes_p_tile(P, C) and p_tile % 16 == 0
    # the staged table fits the kernel's shared memory (227 KB a block)
    tile_len = 16 * ((p_tile // 16) | 1)
    assert (C + 1) * tile_len * 8 <= 227 * 1024
    for pt in _tiles(P, C):
        q = np.arange(pt)
        slots = sk.codes_slot(q, pt)
        assert sorted(set(slots.tolist())) == sorted(slots.tolist())
        assert slots.min() >= 0 and slots.max() < tile_len
        assert slots.tolist() == [host_lib.vft_codes_slot(int(x), pt)
                                  for x in q]
    z = sk.codes_table_len(P, C)
    assert z == host_lib.vft_codes_table_len(P, C)
    index = [host_lib.vft_codes_table_index(p, P, C) for p in range(P)]
    assert len(set(index)) == P and 0 <= min(index) and max(index) < z
    for t, p0 in enumerate(range(0, P, p_tile)):
        pt = min(p_tile, P - p0)
        want = t * tile_len + sk.codes_slot(np.arange(pt), pt)
        assert index[p0:p0 + pt] == want.tolist()


@pytest.mark.parametrize("P,C", SHAPES)
def test_half_warps_hit_distinct_bank_pairs(P, C):
    """A double at word 2 s spans banks 2 s and 2 s + 1 of 32: bank pair s %
    16.  Reads: lane v of a half-warp reads slot j S + v of its code's row
    (code c at c * tile_len), for every mix of codes.  Writes: thread i of a
    staging half-warp writes position q = i of the tile (16 consecutive,
    from a multiple of 16)."""
    tile_len = 16 * ((sk.codes_p_tile(P, C) // 16) | 1)
    rng = np.random.default_rng(0)
    assert tile_len % 16 == 0               # a code's row keeps the banks
    for pt in _tiles(P, C):
        n_chunks = pt // 16
        for v0 in range(0, n_chunks, 16):
            v = np.arange(v0, min(v0 + 16, n_chunks))
            for j in range(16):
                codes = rng.integers(0, C, len(v))
                words = codes * tile_len + sk.codes_slot(16 * v + j, pt)
                assert len(set((words % 16).tolist())) == len(v)
        for q0 in range(0, pt, 16):
            slots = sk.codes_slot(np.arange(q0, q0 + 16), pt)
            assert len(set((slots % 16).tolist())) == 16


@pytest.mark.parametrize("C,mode", MODES)
def test_lane_replay_is_the_twin(C, mode):
    codes, G, uq, wq, outd, ev, cf = _codes_inputs(C, mode)
    use_matrix = ev is not None
    bi, bc, d, w, c = sk.nj_scan_codes_ref(_t(codes), _t(G), _t(wq),
                                           _t(outd), N_ACTIVE, M_REAL,
                                           use_matrix)
    rb, rc, rd, rw, rcrit = chip_smoke.codes_lane_replay(
        codes, G, wq, outd, N_ACTIVE, M_REAL, use_matrix)
    np.testing.assert_allclose(rd, d.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(rw, w.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(rcrit, c.numpy(), rtol=1e-12, atol=1e-13)
    assert rb == int(bi) == TIE[0]
    assert rcrit[TIE[0]] == rcrit[TIE[1]]        # the tie is exact here too
    assert rd[5] == 1.0 and rw[5] == 0.0


def _inputs(rng, L, P, C):
    codes = rng.integers(0, C, size=(L, P)).astype(np.int8)
    codes[rng.random((L, P)) < 0.05] = 127
    codes[3] = 127
    G = rng.normal(size=(C, P))
    wq = rng.uniform(0.0, 1.0, P)
    return codes, G, wq


@pytest.mark.parametrize("P,C,rows_per_warp",
                         [(512, 4, 0), (512, 20, 0), (1536, 20, 0),
                          (1536, 20, 1), (20000, 4, 0)])
def test_host_body_is_the_lane_replay(host_lib, P, C, rows_per_warp):
    rng = np.random.default_rng(P + C)
    L = 11 if P > 5000 else 37              # the last group short
    codes, G, wq = _inputs(rng, L, P, C)
    den = np.zeros(L)
    pick = np.zeros(L)
    host_lib.vft_codes_scan_host(
        codes.ctypes.data, L, P, C, G.ctypes.data, wq.ctypes.data,
        rows_per_warp, den.ctypes.data, pick.ctypes.data)
    outd = rng.uniform(0.0, 1.0, L)
    for use_matrix in (False, True):
        _, _, rd, rw, _ = chip_smoke.codes_lane_replay(
            codes, G, wq, outd, L, L, use_matrix)
        assert rw.tobytes() == den.tobytes()
        top = pick if use_matrix else den - pick
        dist = np.where(den > 0, top / np.where(den > 0, den, 1.0), 1.0)
        assert rd.tobytes() == dist.tobytes()
    assert den[3] == 0.0 and pick[3] == 0.0
