"""The Python around the join epoch and the SPR and NNI round kernels that
runs on the CPU: the ptxas-report check of chip_smoke.py's phase 1
(ops/_build.resource_faults) on captured report text of the three kernels,
the epoch's parameter block and state words against their C declarations
in csrc/nj_epoch.cuh (a mismatch would only show on the card), and the
breakdown parser of scripts/profile_me_kernels.py on a captured PROFILE
line."""
import ctypes
import importlib.util
import json
import os
import re

import pytest

from veryfasttree_tpu_torch.ops import _build, epoch_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "veryfasttree_tpu_torch", "csrc")

# nvcc -Xptxas -v, cut from builds of the three kernels (names shortened):
# the join epoch's single deciding thread kept its state on a 1,536-byte
# stack frame, the rounds theirs on 112-byte frames
PTXAS = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__11_nj_epoch_cu15nj_epoch_kernelILi4EEEvNS_11EpochParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__11_nj_epoch_cu15nj_epoch_kernelILi4EEEvNS_11EpochParamsE
    1536 bytes stack frame, 76 bytes spill stores, 136 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers, 1536 bytes cumulative stack size, 480 bytes smem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__9_me_spr_cu19me_spr_round_kernelILi4EEEvNS_9StoreViewEPaPfS3_PKdPKfNS_9RoundArgsEiPKiiPiPhSB_Pxi' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__9_me_spr_cu19me_spr_round_kernelILi4EEEvNS_9StoreViewEPaPfS3_PKdPKfNS_9RoundArgsEiPKiiPiPhSB_Pxi
    112 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 125 registers, used 1 barriers, 112 bytes cumulative stack size, 960 bytes smem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__9_me_nni_cu19me_nni_round_kernelILi4EEEvNS_9StoreViewEPaPfS3_PKdPKfNS_9RoundArgsENS_8NniStatsEPiPhSA_PxPdi' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__9_me_nni_cu19me_nni_round_kernelILi4EEEvNS_9StoreViewEPaPfS3_PKdPKfNS_9RoundArgsENS_8NniStatsEPiPhSA_PxPdi
    112 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 124 registers, used 1 barriers, 112 bytes cumulative stack size, 448 bytes smem
"""
ME_KERNELS = ("nj_epoch_kernel", "me_spr_round_kernel", "me_nni_round_kernel")


NAMES = {
    "nj_epoch_kernel":
        "_ZN44_GLOBAL__N__11_nj_epoch_cu15nj_epoch_kernelILi4EEEvNS_11EpochParamsE",
    "me_spr_round_kernel":
        "_ZN41_GLOBAL__N__9_me_spr_cu19me_spr_round_kernelILi4EEEvNS_9StoreViewEPaPfS3_"
        "PKdPKfNS_9RoundArgsEiPKiiPiPhSB_Pxi",
    "me_nni_round_kernel":
        "_ZN41_GLOBAL__N__9_me_nni_cu19me_nni_round_kernelILi4EEEvNS_9StoreViewEPaPfS3_"
        "PKdPKfNS_9RoundArgsENS_8NniStatsEPiPhSA_PxPdi"}


def _report(frames):
    """ptxas text of the three kernels, {kernel: (stack bytes, spill store
    bytes)}, in the form of PTXAS."""
    lines = []
    for k, (stack, spills) in frames.items():
        lines += [
            f"ptxas info    : Compiling entry function '{NAMES[k]}' for 'sm_90a'",
            f"ptxas info    : Function properties for {NAMES[k]}",
            f"    {stack} bytes stack frame, {spills} bytes spill stores, "
            f"{spills} bytes spill loads",
            f"ptxas info    : Used 128 registers, used 1 barriers, {stack} bytes "
            "cumulative stack size, 480 bytes smem"]
    return "\n".join(lines) + "\n"


def test_resource_faults_hold_the_epoch_and_round_kernels():
    limits = {k: _build.STACK_LIMITS[k] for k in ME_KERNELS}
    rep = _build.ptxas_report(PTXAS)
    assert _build.kernel_resources(rep, "nj_epoch_kernel") == {
        "registers": 128, "stack": 1536, "spill_stores": 76,
        "spill_loads": 136, "cumulative_stack": 1536}
    # the frames before this port's redesign break every limit
    faults = _build.resource_faults(rep, limits)
    for k in ME_KERNELS:
        assert f"{k}<4>: " in " ".join(faults), (k, faults)
    # at their limits, with no spill stores, they pass; a byte more fails
    at = {k: (v, 0) for k, v in limits.items()}
    assert _build.resource_faults(_build.ptxas_report(_report(at)),
                                  limits) == []
    for k in ME_KERNELS:
        over = dict(at, **{k: (limits[k] + 8, 0)})
        assert _build.resource_faults(_build.ptxas_report(_report(over)),
                                      limits) == [
            f"{k}<4>: {limits[k] + 8} bytes of stack frame (at most "
            f"{limits[k]})"]
    # phase 1 holds all of them
    assert set(ME_KERNELS) <= set(_build.STACK_LIMITS)


def _c_struct_fields(text, name):
    """(field, C type) of struct `name` in C source text, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    out = []
    for line in body.splitlines():
        line = re.sub(r"^const\s+", "", line.split("//")[0].strip())
        if not line:
            continue
        m = re.match(r"([\w:]+\s*\**)\s*(.+);$", line)
        assert m, line
        ctype = m.group(1).replace(" ", "")
        for decl in m.group(2).split(","):
            decl = decl.strip()
            stars = len(decl) - len(decl.lstrip("*"))
            out.append((decl.lstrip("*"), ctype + "*" * stars))
    return out


def test_epoch_params_match_the_kernel_header():
    text = open(os.path.join(CSRC, "nj_epoch.cuh")).read()
    fields = _c_struct_fields(text, "EpochParams")
    py = epoch_kernels.EpochParams._fields_
    assert [f for f, _ in fields] == [f for f, _ in py]
    for (name, ctype), (_, pytype) in zip(fields, py):
        want = (ctypes.c_void_p if ctype.endswith("*") else
                ctypes.c_double if ctype == "double" else ctypes.c_int64)
        assert pytype is want, (name, ctype, pytype)
        if not ctype.endswith("*"):
            assert ctype in ("double", "int64_t"), (name, ctype)
    # every field 8 bytes, as the C struct's
    assert ctypes.sizeof(epoch_kernels.EpochParams) == 8 * len(fields)


def test_epoch_words_and_faults_match_the_kernel_header():
    text = open(os.path.join(CSRC, "nj_epoch.cuh")).read()
    body = re.search(r"enum : int \{\n  kWOutOps = 0,(.*?)kNumWords", text,
                     re.S).group(0)
    names = re.findall(r"\n  kW\w+(?: = 0)?,\s*// (\w+)", "\n" + body)
    assert tuple(names) == epoch_kernels.WORDS
    faults = re.search(r"enum : int \{\n  kFaultNone = 0,(.*?)\};", text,
                       re.S).group(1)
    codes = re.findall(r"kFault\w+,", faults)
    assert len(codes) == len(epoch_kernels.FAULTS)
    assert sorted(epoch_kernels.FAULTS) == list(range(1, len(codes) + 1))


def _profile_script():
    spec = importlib.util.spec_from_file_location(
        "profile_me_kernels", os.path.join(REPO, "scripts",
                                           "profile_me_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_breakdown_parser():
    prof = _profile_script()
    nj = [0] * prof.N_SLOTS
    nj[:len(prof.NJ_PHASES)] = [5, 10, 10, 25, 10, 5, 10, 5, 15, 5]
    spr = [0] * prof.N_SLOTS
    spr[:len(prof.ME_PHASES)] = [40, 5, 5, 10, 5, 10, 5, 5, 5, 5, 5]
    rec = {"root": "/x", "n": 2000, "card": "card, 700.00 W",
           "nj": {"cycles": nj, "ns": [100, 200], "wall_s": 0.5,
                  "launches": 10, "totals": {"joins": 4}},
           "spr": {"cycles": spr, "ns": [0, 0], "wall_s": 0.2,
                   "launches": 1, "totals": {"quartets": 20}}}
    text = "built\nPROFILE " + json.dumps(rec) + "\nother\n"
    (got,) = prof.parse_breakdown(text)
    assert got == rec
    total, sh = prof.shares("nj", got["nj"])
    assert total == 100
    assert "waiting" not in sh
    assert sh["merge"] == pytest.approx(0.25)
    assert sh["block-0 phases"] == pytest.approx(0.05)
    # the waits split 1:2 into handshake and work by the timer
    assert sh["handshake"] == pytest.approx(0.05)
    assert sh["phase work"] == pytest.approx(0.10)
    assert sum(sh.values()) == pytest.approx(1.0)
    total, sh = prof.shares("spr", got["spr"])
    assert total == 100 and sh["decisions"] == pytest.approx(0.4)
    assert prof.per_unit("nj", got["nj"]) == (25.0, "join")
    assert prof.per_unit("spr", got["spr"]) == (5.0, "quartet")
    lines = prof.report(got)
    assert lines[0] == "/x (N=2000, card, 700.00 W):"
    assert "nj: 100 cycles in 10 launches (25 per join)" in "\n".join(lines)
    bad = dict(rec, spr=dict(rec["spr"], cycles=spr[:5]))
    with pytest.raises(ValueError):
        prof.parse_breakdown("PROFILE " + json.dumps(bad))
    past = list(spr)
    past[prof.N_SLOTS - 1] = 1
    with pytest.raises(ValueError):
        prof.shares("spr", dict(rec["spr"], cycles=past))
