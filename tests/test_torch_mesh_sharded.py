"""The PyTorch port's parallel/sharded.py against the JAX package's
veryfasttree_tpu/parallel/sharded.py on the same mesh shapes, (dp, sp) in
(1, 4), (2, 2), (4, 1): the JAX functions on this process's 8 virtual CPU
devices (tests/conftest.py), the port's in a world of 4 gloo rank
processes (tests/torch_mesh_runs.sharded_main), each on its own shards of
the same float64 inputs (tests/torch_mesh_runs.sharded_inputs).  The
scan's index equal; every float64 output within 1e-12 relative (sums in
another order); and hbm_plan held to a real sharded store's bytes per
rank."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_runs as runs

from veryfasttree_tpu.parallel.mesh import make_mesh
from veryfasttree_tpu.parallel import sharded as jsh

RTOL = 1e-12


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    procs = runs.start_sharded(4, out)
    runs.finish_world(procs, timeout=240)
    return out


def _jax(dp, sp):
    x = {k: jnp.asarray(v) for k, v in runs.sharded_inputs().items()}
    mesh = make_mesh(n_sp=sp, n_dp=dp)
    M = x["U"].shape[0]
    best, crit, dist, denom = jsh.dist_scan_sharded(mesh, False)(
        x["U"], x["W"], x["U"][3], x["W"][3], x["outd"], jnp.float64(M))
    f1 = x["U"][3] / x["W"][3][:, None]
    ll = jsh.pair_loglk_sharded(mesh)(
        f1, x["f2"], x["W"][3], x["w2"], x["psame"], x["pdiff"],
        x["ratecat"], x["mask_pos"])
    w_post, f_post = jsh.posterior_jc_sharded(mesh)(
        f1, x["f2"], x["W"][3], x["w2"], x["psame"], x["pdiff"], x["psame"],
        x["pdiff"], x["ratecat"])
    w_out, f_out = jsh.out_profile_sharded(mesh)(x["U"], x["W"],
                                                 x["mask_rows"])
    t = jsh.training_step(mesh)(
        x["U"], x["W"], x["U"][3], x["W"][3], x["outd"], jnp.float64(M),
        x["psame"], x["pdiff"], x["ratecat"], x["mask_pos"])
    return {k: np.asarray(v) for k, v in dict(
        best=best, crit=crit, dist=dist, denom=denom, ll=ll, w_post=w_post,
        f_post=f_post, w_out=w_out, f_out=f_out, t_best=t[0], t_crit=t[1],
        u_new=t[2], w_new=t[3], t_ll=t[4]).items()}


@pytest.mark.parametrize(("dp", "sp"), runs.SHARDED_SHAPES,
                         ids=[f"{dp}x{sp}" for dp, sp in runs.SHARDED_SHAPES])
def test_sharded_functions_match_jax(port, dp, sp):
    ref = _jax(dp, sp)
    M, P = ref["dist"].shape[0], ref["w_out"].shape[0]
    m, w = M // dp, P // sp
    for rank in range(dp * sp):
        d, s = divmod(rank, sp)
        got = dict(np.load(os.path.join(port, f"sharded_{dp}x{sp}_{rank}.npz")))
        rows, pos = slice(d * m, (d + 1) * m), slice(s * w, (s + 1) * w)
        assert int(got["best"]) == int(ref["best"]) == int(got["t_best"])
        for k in ("crit", "ll", "t_crit"):
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)
        for k in ("dist", "denom"):
            np.testing.assert_allclose(got[k], ref[k][rows], rtol=RTOL,
                                       err_msg=k)
        for k in ("w_post", "f_post", "w_out", "f_out"):
            np.testing.assert_allclose(got[k], ref[k][pos], rtol=RTOL,
                                       err_msg=k)
        if d == 0:      # the JAX package's u_new, w_new, ll are dp 0's
            np.testing.assert_allclose(got["t_ll"], ref["t_ll"], rtol=RTOL)
            for k in ("u_new", "w_new"):
                np.testing.assert_allclose(got[k], ref[k][pos], rtol=RTOL,
                                           err_msg=k)
        assert got["stats"][0] > 0


@pytest.mark.parametrize(("dp", "sp"), runs.SHARDED_SHAPES,
                         ids=[f"{dp}x{sp}" for dp, sp in runs.SHARDED_SHAPES])
def test_exchange_branches_agree(port, dp, sp):
    """Mesh.exchange stacks every rank's part in rank order along each
    axis, the same through its all_gather branch (NCCL's) as through its
    isend/irecv one (gloo's)."""
    for rank in range(dp * sp):
        d, s = divmod(rank, sp)
        got = np.load(os.path.join(port, f"exchange_{dp}x{sp}_{rank}.npz"))
        for axis, ranks in (("sp", [d * sp + t for t in range(sp)]),
                            ("dp", [e * sp + s for e in range(dp)])):
            want = np.stack([np.arange(6.0).reshape(2, 3) + 10 * r
                             for r in ranks])
            np.testing.assert_array_equal(got[f"send_{axis}"], want)
            np.testing.assert_array_equal(got[f"gather_{axis}"], want)


@pytest.mark.parametrize("sp", [2, 4])
def test_hbm_plan_is_a_sharded_stores_bytes(sp):
    """The port's hbm_plan per rank against a real ShardedMEProfiles'
    arrays (as tests/test_memory_plan.py:20-38 holds the JAX package's to
    its store), dense and two-tier."""
    from veryfasttree_tpu_torch.engine.profiles import (ShardedMEProfiles,
                                                        hbm_plan)
    from veryfasttree_tpu_torch.options import Options
    from veryfasttree_tpu_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(0)
    N, P = 40, 300
    codes = rng.integers(0, 4, size=(N, P)).astype(np.int8)
    for two_tier in (False, True):
        sizes = []
        for s in range(sp):
            opts = Options(n_codes=4)
            opts.derive_settings()
            opts.mesh = Mesh(1, sp, s, None, None)
            prof = ShardedMEProfiles(codes, opts, None, 2 * N,
                                     two_tier=two_tier)
            sizes.append(sum(t.numel() * t.element_size()
                             for t in (prof.codes, prof.W, prof.U))
                         + prof.p_pad * 5 * 4)
        plan = hbm_plan(N, P, two_tier=two_tier, n_sp=sp)
        assert sizes == [plan["per_device_bytes"]] * sp
        assert plan["per_device_bytes"] * sp == plan["total_bytes"]
        assert plan["fits_h100"]
    big = hbm_plan(1_000_000, 1300, two_tier=True)
    assert not big["fits_h100"] and hbm_plan(
        1_000_000, 1300, two_tier=True, n_sp=2)["fits_h100"]
