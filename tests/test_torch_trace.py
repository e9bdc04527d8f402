"""VFT_TRACE (veryfasttree_tpu_torch/utils/trace.py) on the CPU: set, a run
of run_pipeline writes one torch.profiler Chrome trace into the directory,
holding the annotations of the phases that nj.timings names and the
run's host operations; unset, no profiler starts and the run's output is
the same.  (CUDA kernel events need the card: chip_smoke.py phase 10(c).)
"""
import io
import json
import os

import pytest
import torch

from util import simulate_alignment

from veryfasttree_tpu_torch import pipeline
from veryfasttree_tpu_torch.options import noml_options
from veryfasttree_tpu_torch.utils import trace

FASTA = "".join(f">s{i}\n{s}\n"
                for i, s in enumerate(simulate_alignment(12, 60, seed=4)))


def _run():
    out = io.StringIO()
    nj, _ = pipeline.run_pipeline(noml_options(), io.StringIO(FASTA), out,
                                  device=torch.device("cpu"))
    return out.getvalue(), nj


def test_trace_holds_the_phase_annotations(tmp_path, monkeypatch):
    monkeypatch.delenv("VFT_TRACE", raising=False)
    plain, _ = _run()
    monkeypatch.setenv("VFT_TRACE", str(tmp_path / "t"))
    newick, nj = _run()
    assert newick == plain
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "t" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    notes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    want = {k[:-2] for k in nj.timings if k.endswith("_s")}
    assert want == {"store", "tophits", "joins", "nni", "spr", "lengths",
                    "splits"}
    assert want <= notes
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_no_profiler_without_vft_trace(monkeypatch):
    monkeypatch.delenv("VFT_TRACE", raising=False)

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler started without VFT_TRACE")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    newick, _ = _run()
    assert newick.endswith(";\n")
    with trace.maybe_trace(), trace.annotate("nni"):
        pass


def test_trace_is_written_when_the_run_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("VFT_TRACE", str(tmp_path))
    with pytest.raises(KeyError):
        with trace.maybe_trace(), trace.annotate("joins"):
            raise KeyError("stop")
    assert len(os.listdir(tmp_path)) == 1
