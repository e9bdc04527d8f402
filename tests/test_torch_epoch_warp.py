"""The join epoch's warp decider (csrc/nj_epoch.cuh Master) on the CPU.

The decisions compile as host C++ (tests/epoch_host/host_epoch.cpp, built
here with g++): the deciding warp's 32 lanes are coroutines that meet at a
barrier in every collective, and the phases run serially with the kernel's
per-position bodies.  From the same NJ start, the decider must give the
host loop's join log (the kernel's plain twin, on the CPU), with branch
lengths, diameters and out-distances within chip_smoke.EPOCH_TWIN_ATOL (the
host phases sum their distances in another order, and update the
out-profile weights as the card does, a float32 ulp from the twin).  The
runs stop before the last join: at four active nodes a pair and its
complement have the same criterion in exact arithmetic (and give the same
unrooted tree), so the last bit of a sum decides between them.  Protein
(BLOSUM45) and -bionj starts hold near ties earlier, which the host
phases' last bits decide otherwise than the twin's, so they are held only
to the decider itself: the three layouts of its state (per-node arrays and
small lists in shared memory, or either in device memory) must agree bit
for bit, for every start.  The card tests (tests/test_torch_cuda.py) hold
the kernel itself to the host loop bit for bit, protein and -bionj
included, to the last join.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from veryfasttree_tpu_torch.engine import epoch
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
from veryfasttree_tpu_torch.models import DistanceMatrix
from veryfasttree_tpu_torch.ops import _build, epoch_kernels
from veryfasttree_tpu_torch.options import Options

HERE = Path(__file__).resolve().parent
N = 120


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host decider")
    out = tmp_path_factory.mktemp("epoch_host") / "libhost_epoch.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
         f"-I{HERE / 'epoch_host' / 'include'}",
         f"-I{_build.SRC_DIR}", "-o", str(out),
         str(HERE / "epoch_host" / "host_epoch.cpp")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.vft_nj_epoch_scratch.argtypes = [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    lib.vft_nj_epoch_scratch.restype = None
    lib.vft_nj_epoch_host.argtypes = [ctypes.c_void_p]
    lib.vft_nj_epoch_host.restype = ctypes.c_int
    return lib


def _nj(n, protein=False, two_tier=False, bionj=False):
    opts = Options(n_codes=20 if protein else 4, ml_nni=0, n_bootstrap=0,
                   show_progress=False, bionj=bionj,
                   **({"two_tier_min": 0} if two_tier else {}))
    opts.derive_settings()
    return NeighbourJoining(
        opts, chip_smoke.synth_codes(n, chip_smoke.MAIN_P,
                                     n_codes=opts.n_codes),
        DistanceMatrix.blosum45() if protein else None, None,
        device=torch.device("cpu"))


def _warp_run(lib, monkeypatch, n, max_joins=None, layout=None, **kw):
    """The NJ phase with its joins through the host decider's launches
    (ops/epoch_kernels._run_launches on a CPU store)."""
    def launch(state, seg, grid):
        p = state.params
        p.n_hi, p.n_lo, p.resume, p.stop_reset = (int(x) for x in seg)
        for name in ("ctl", "mark", "mark2"):
            state.t[name].zero_()
        assert lib.vft_nj_epoch_host(ctypes.byref(p)) == 0  # -3: lanes parted
        epoch_kernels.join_epoch.launches += 1
        return 1

    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(epoch_kernels, "_launch", launch)
    monkeypatch.setattr(epoch_kernels, "_check_store", lambda codes, W, U, f,
                        lo: (codes.shape[0], codes.shape[1], U.shape[-1]))
    monkeypatch.setattr(epoch, "run_epoch", lambda nj, th, mj=None:
                        epoch_kernels._run_launches(nj, th, mj, None,
                                                    **(layout or {})))
    nj = _nj(n, **kw)
    before = epoch_kernels.join_epoch.launches
    nj.fast_nj(max_joins)
    assert epoch_kernels.join_epoch.launches > before
    monkeypatch.undo()
    return chip_smoke.epoch_state(nj)


def _twin(n, max_joins=None, **kw):
    nj = _nj(n, **kw)
    nj.fast_nj(max_joins)
    return chip_smoke.epoch_state(nj)


def _near(a, b):
    assert np.array_equal(a["join_log"], b["join_log"])
    for k in ("branchlength", "diameter", "out_distances"):
        np.testing.assert_allclose(a[k], b[k], rtol=0,
                                   atol=chip_smoke.EPOCH_TWIN_ATOL)


@pytest.mark.parametrize("kw", [{}, {"two_tier": True}, {"max_joins": 10}],
                         ids=["dense", "two-tier", "max-joins"])
def test_warp_decider_is_the_host_loop(host_lib, monkeypatch, kw):
    kw = dict({"max_joins": N - 4}, **kw)
    warp = _warp_run(host_lib, monkeypatch, N, **kw)
    twin = _twin(N, **kw)
    assert len(warp["join_log"]) == kw["max_joins"]
    _near(warp, twin)


@pytest.mark.parametrize("kw,layout", [
    ({}, {"lists_in_smem": False}), ({}, {"state_in_smem": False}),
    ({}, {"state_in_smem": False, "lists_in_smem": False}),
    ({"protein": True}, {"state_in_smem": False, "lists_in_smem": False}),
    ({"bionj": True}, {"state_in_smem": False, "lists_in_smem": False})],
    ids=["lists-in-device-memory", "state-in-device-memory",
         "all-in-device-memory", "protein-all-in-device-memory",
         "bionj-all-in-device-memory"])
def test_warp_decider_layouts_agree(host_lib, monkeypatch, kw, layout):
    base = _warp_run(host_lib, monkeypatch, N, **kw)
    other = _warp_run(host_lib, monkeypatch, N, layout=layout, **kw)
    assert len(base["join_log"]) == N - 3
    assert chip_smoke.epoch_diff(base, other) == []
