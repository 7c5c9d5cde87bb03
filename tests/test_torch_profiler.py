"""The port's ``utils/profiler.py`` on the CPU: ``Profiler``'s sections,
counts and averages as the JAX package's keeps them, ``sync_on`` with CPU
tensors (nothing to wait for), and ``torch_trace`` writing a Chrome trace
of CPU activity only."""

import json
import os

import torch

from unopticalflow_tpu.utils.profiler import Profiler as JaxProfiler
from unopticalflow_tpu_torch.utils import profiler


def test_sections_counts_and_averages(capsys):
    prof, jprof = profiler.Profiler(silent=True), JaxProfiler(silent=True)
    for p in (prof, jprof):
        for _ in range(3):
            with p.section("load"):
                sum(range(2000))
        p.start("step")
        p.end("step", sync_on={"x": [torch.ones(3)], "y": (torch.zeros(2),)})
    for p in (prof, jprof):
        assert dict(p.counts) == {"load": 3, "step": 1}
        report = p.report_all()
        assert sorted(report) == ["load", "step"]
        assert report["load"] == p.totals["load"] / 3 and report["load"] > 0
    assert capsys.readouterr().out == ""
    loud = profiler.Profiler()
    with loud.section("x", sync_on=torch.ones(1)):
        pass
    loud.report_all()
    out = capsys.readouterr().out
    assert "[profiler] x:" in out and "1 calls, avg" in out


def test_torch_trace_writes_a_cpu_trace(tmp_path):
    logdir = tmp_path / "trace"
    assert not torch.cuda.is_available()  # so the trace holds CPU activity only
    with profiler.torch_trace(str(logdir)) as prof:
        a = torch.randn(64, 64)
        (a @ a).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert prof.trace_path == str(logdir / files[0])
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("matmul" in n or "mm" in n for n in names)
    assert not any(e.get("cat") in ("kernel", "gpu_memcpy") for e in events)
