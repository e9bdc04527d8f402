"""Array-state checkpoints of a run (counterpart of
``veryfasttree_tpu/engine/checkpoint.py``, whose file layout it keeps key
for key, dtype for dtype and shape for shape, so that either package
resumes from the other's file).

The reference's only restart facility is tree-as-checkpoint: -log persists
intermediate Newicks and -intree resumes from one (ref main.cpp:125-128,
logTree tcc:5516-5522).  A checkpoint holds the whole engine state instead,
so that a long ML phase resumes mid-phase without replaying the NJ and ME
work or losing the CAT rates, the GTR fit or the NNI ages: the tree arrays,
the engine's per-node arrays, the ME store and out-profile, and, once the
ML phase has started, the ML store with its model (the rotation constants
of a fitted GTR matrix included) and CAT rates, beside a JSON meta record
(phase, round, convergence scalars).  The debug counters and the device's
posterior counts are not kept, so a resumed run's stats count from the
resume.

Format: one .npz written through ``path + ".tmp"`` and ``os.replace``
(atomic), uncompressed where the JAX package compresses: at N=2000, P=500 a
save is 218 MB, written in about 0.4 s, against 41 MB in 6.6 s with zlib
(PERF.md, PR 19).  ``np.load`` reads either.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

_FORMAT = 1


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_arrays(tree):
    return {
        "tree_parent": tree.parent, "tree_children": tree.children,
        "tree_n_child": tree.n_child, "tree_branchlength": tree.branchlength,
        "tree_support": tree.support,
        "tree_scal": np.array([tree.maxnode, tree.root], dtype=np.int64),
    }


def state_arrays(nj, meta: dict, extra: dict | None = None) -> dict:
    """The checkpoint's arrays by key: the engine's host arrays, the
    stores' arrays fetched from their device, `extra` under "x_" + key and
    the meta record (with the format and has_ml added) as JSON bytes."""
    data = dict(_tree_arrays(nj.tree))
    for k, v in (extra or {}).items():
        data["x_" + k] = np.asarray(v)
    data.update(
        nj_diameter=nj.diameter, nj_var_diameter=nj.var_diameter,
        nj_selfdist=nj.selfdist, nj_selfweight=nj.selfweight,
        nj_out_distances=nj.out_distances,
        nj_n_out_dist_active=nj.n_out_dist_active,
        nj_scal=np.array([nj.totdiam], dtype=np.float64),
    )
    if nj.n_cons:
        data.update(nj_con_on=nj.con_on, nj_con_off=nj.con_off,
                    nj_con_out_on=nj.con_out_on,
                    nj_con_out_off=nj.con_out_off)
    prof = nj.prof
    data.update(me_codes=_np(prof.codes), me_W=_np(prof.W), me_U=_np(prof.U),
                me_w_out=_np(prof.w_out), me_f_out=_np(prof.f_out))
    ml = getattr(nj, "ml", None)
    if ml is not None:
        data.update(
            ml_codes=_np(ml.codes), ml_W=_np(ml.W), ml_V=_np(ml.V),
            ml_rates=ml.rates_np, ml_ratecat=ml.ratecat_np,
            ml_code_freq=_np(ml.code_freq), ml_eigenval=_np(ml.eigenval),
            ml_statinv=_np(ml.statinv), ml_eigeninv=_np(ml.eigeninv),
            ml_eigentot=_np(ml.eigentot), ml_near_p=_np(ml.near_p),
            ml_near_freq=_np(ml.near_freq),
            ml_flags=np.array([int(ml.jc), int(ml.use_approx)],
                              dtype=np.int64),
        )
    meta = dict(meta)
    meta["format"] = _FORMAT
    meta["has_ml"] = ml is not None
    data["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)
    return data


def save_checkpoint(nj, path: str, meta: dict,
                    extra: dict | None = None) -> dict:
    """Snapshot the engine and its stores to `path` (atomic).  `extra` is
    a dict of caller-owned numpy arrays (the NNI ages) stored beside them.
    Returns the save's host-clock seconds, apart: "fetch_s" (the device
    arrays to the host) and "write_s" (the file), and its "bytes"."""
    t0 = time.perf_counter()
    data = state_arrays(nj, meta, extra)
    t1 = time.perf_counter()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **data)
    os.replace(tmp, path)
    return {"fetch_s": t1 - t0, "write_s": time.perf_counter() - t1,
            "bytes": os.path.getsize(path)}


def load_checkpoint(nj, path: str) -> tuple[dict, dict]:
    """Restore a checkpoint into an engine built from the SAME alignment,
    options and constraints; returns (meta, extra): the phase and round
    record and the caller's arrays stored through save_checkpoint(extra=).
    The ML store is built where the engine has none yet."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta_json"]).decode())
    if meta.get("format") != _FORMAT:
        raise ValueError(f"unsupported checkpoint format: {meta.get('format')}")
    nj.load_state(arrays)
    if meta.get("has_ml"):
        from .ml_profiles import MLProfiles

        ml = getattr(nj, "ml", None)
        if ml is None:
            ml = nj.ml = MLProfiles.shell(nj)
        model = {k[len("ml_"):]: arrays[k] for k in (
            "ml_code_freq", "ml_eigenval", "ml_statinv", "ml_eigeninv",
            "ml_eigentot", "ml_near_p", "ml_near_freq", "ml_flags")}
        ml.load_state(arrays["ml_codes"], arrays["ml_W"], arrays["ml_V"],
                      arrays["ml_rates"], arrays["ml_ratecat"], model=model)
    extra = {k[2:]: v for k, v in arrays.items() if k.startswith("x_")}
    return meta, extra

