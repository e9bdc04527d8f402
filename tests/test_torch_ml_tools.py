"""The Python around the ML round kernels that runs on the CPU: the
ptxas-report check of chip_smoke.py's phase 1 (ops/_build.ptxas_report,
kernel_resources, resource_faults) on captured report text, and the
breakdown parser of scripts/profile_ml_round.py on a captured PROFILE
line."""
import importlib.util
import json
import os

import pytest

from veryfasttree_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# nvcc -Xptxas -v, cut from a build of the round kernels before they lost
# their stack frames (names shortened); nni_node is a function the kernel
# calls, whose properties are not the kernel's
PTXAS = """\
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__8_ml_lk_cu21ml_quartet_opt_kernelILi4EEEvNS_6MLViewE' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__8_ml_lk_cu21ml_quartet_opt_kernelILi4EEEvNS_6MLViewE
    32 bytes stack frame, 48 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compile time = 6246.024 ms
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__11_ml_round_cu19ml_nni_round_kernelILi4EEEvNS_6MLViewE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__11_ml_round_cu19ml_nni_round_kernelILi4EEEvNS_6MLViewE
    944 bytes stack frame, 48 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 128 registers, used 3 barriers, 944 bytes cumulative stack size, 240 bytes smem
ptxas info    : Compile time = 30504.424 ms
ptxas info    : Function properties for _ZN44_GLOBAL__N__11_ml_round_cu7MlRoundILi4EE8nni_nodeEi
    0 bytes stack frame, 228 bytes spill stores, 400 bytes spill loads
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__11_ml_round_cu22ml_lengths_pass_kernelILi4EEEvNS_6MLViewE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__11_ml_round_cu22ml_lengths_pass_kernelILi4EEEvNS_6MLViewE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 100 registers, used 2 barriers, 40 bytes cumulative stack size, 240 bytes smem
"""


def test_ptxas_report_reads_each_kernel():
    rep = _build.ptxas_report(PTXAS)
    assert len(rep) == 3
    assert _build.kernel_resources(rep, "ml_nni_round_kernel") == {
        "registers": 128, "stack": 944, "spill_stores": 48,
        "spill_loads": 40, "cumulative_stack": 944}
    assert _build.kernel_resources(rep, "ml_quartet_opt_kernel")[
        "registers"] == 80
    assert _build.kernel_resources(rep, "ml_lengths_pass_kernel") == {
        "registers": 100, "stack": 0, "spill_stores": 0, "spill_loads": 0,
        "cumulative_stack": 40}
    with pytest.raises(KeyError):
        _build.kernel_resources(rep, "ml_nni_round_kernel", n_codes=20)


# the ML kernels' limits (phase 1 holds more kernels, which PTXAS lacks)
ML_LIMITS = {k: _build.STACK_LIMITS[k] for k in (
    "ml_nni_round_kernel", "ml_lengths_pass_kernel", "ml_quartet_opt_kernel")}


def test_resource_faults_names_stack_and_spills():
    faults = _build.resource_faults(_build.ptxas_report(PTXAS), ML_LIMITS)
    # the round kernel's own frame and spills, the pass's callees' 40
    # bytes; the quartet kernel within its 32 bytes
    assert faults == [
        "ml_nni_round_kernel<4>: 944 bytes of stack frame (at most 0)",
        "ml_nni_round_kernel<4>: 48 bytes of spill stores",
        "ml_lengths_pass_kernel<4>: 40 bytes of stack frame (at most 0)"]
    clean = PTXAS.replace("944 bytes stack frame, 48 bytes spill stores",
                          "0 bytes stack frame, 0 bytes spill stores")
    clean = clean.replace("944 bytes cumulative", "0 bytes cumulative")
    clean = clean.replace("40 bytes cumulative", "0 bytes cumulative")
    assert _build.resource_faults(_build.ptxas_report(clean), ML_LIMITS) == []
    assert _build.resource_faults(_build.ptxas_report("")) == [
        f"0 entries of {k}<4> in the ptxas report"
        for k in _build.STACK_LIMITS]


def _profile_script():
    spec = importlib.util.spec_from_file_location(
        "profile_ml_round", os.path.join(REPO, "scripts",
                                         "profile_ml_round.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_breakdown_parser():
    prof = _profile_script()
    n_ph = len(prof.PHASES)
    round_cyc = [[0] * n_ph for _ in range(prof.N_SLOTS)]
    round_cyc[0] = [10, 30, 10, 10, 10, 20, 5, 5]
    round_cyc[4] = [0, 0, 0, 0, 0, 0, 0, 50]
    pass_cyc = [[0] * n_ph for _ in range(prof.N_SLOTS)]
    pass_cyc[0][6] = 7
    rec = {"root": "/x", "n": 2000, "card": "card, 700.00 W",
           "pass": {"cycles": pass_cyc, "wall_s": 0.1, "totals": {}},
           "round": {"cycles": round_cyc, "wall_s": 0.2, "totals": {}}}
    text = "built\nPROFILE " + json.dumps(rec) + "\nother\n"
    (got,) = prof.parse_breakdown(text)
    assert got == rec
    sh = prof.shares(got["round"]["cycles"])
    assert sorted(sh) == [0, 4]
    assert sh[0][0] == 100 and sh[0][1][1] == pytest.approx(0.3)
    assert sh[4] == (50, [0, 0, 0, 0, 0, 0, 0, 1.0])
    lines = prof.report(got)
    assert lines[0] == "/x (N=2000, card, 700.00 W):"
    assert "block 2 group 0: 50 cycles" in "\n".join(lines)
    bad = dict(rec, round={"cycles": round_cyc[:3], "wall_s": 0.2,
                           "totals": {}})
    with pytest.raises(ValueError):
        prof.parse_breakdown("PROFILE " + json.dumps(bad))
