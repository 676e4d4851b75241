"""``bench/trace.py`` (torch.profiler capture and the per-op breakdown) and
the ``trace`` command on the CPU, where a trace has host ops only; the
device-event rules (only kernels, copies and sets count, scaffolding
dropped, the span of the device events) on a synthetic Chrome trace."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from conftest import REPO_DIR, subprocess_env
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io.checkpoint import save_params as jsave
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu_torch.bench.trace import (
    OpStat,
    capture_trace,
    device_ms,
    format_breakdown,
    op_breakdown,
    summarize,
    trace_events,
)


def _toy():
    a = torch.tensor(np.random.default_rng(0).normal(size=(64, 64)), dtype=torch.float32)
    return (lambda u, v: torch.tanh(u @ v).sum()), (a, a)


def test_capture_trace_persists_and_breaks_down(tmp_path):
    fn, args = _toy()
    out = capture_trace(fn, *args, out_dir=str(tmp_path / "tr"))
    assert os.path.isfile(os.path.join(out, "trace.json"))
    stats = op_breakdown(out)
    assert stats and all(isinstance(s, OpStat) and s.count >= 1 and s.total_ms >= 0 for s in stats)
    totals = [s.total_ms for s in stats]
    assert totals == sorted(totals, reverse=True)
    names = {s.name for s in stats}
    assert "aten::matmul" in names or "aten::mm" in names
    assert not any(n.startswith("ProfilerStep#") or "profiler" in n or n.startswith("cuda") for n in names)
    assert len(op_breakdown(out, top=1)) == 1


def _synthetic():
    """A card's trace of one call: two launches of one kernel and one of
    another, a copy and a set, each behind its runtime call, within the
    annotation, plus profiler and Python frames."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": "bench.trace.call", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.trace.call", "ts": 5, "dur": 90, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "ProfilerStep#3", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "python_function", "name": "api.py(230): predict", "ts": 1, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 3, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 6, "dur": 3, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10, "dur": 4, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "recurrence_chain<false>", "ts": 10, "dur": 30, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "recurrence_chain<false>", "ts": 45, "dur": 30, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "gemm_f32", "ts": 76, "dur": 5, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 82, "dur": 2, "tid": 7},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 85, "dur": 1, "tid": 7},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 90},
        {"ph": "M", "name": "process_name", "pid": 0},
    ]


def test_breakdown_of_device_events():
    stats = op_breakdown(_synthetic())
    assert stats == [OpStat("recurrence_chain<false>", 2, 0.06), OpStat("gemm_f32", 1, 0.005),
                     OpStat("Memcpy DtoH (Device -> Pageable)", 1, 0.002), OpStat("Memset (Device)", 1, 0.001)]
    assert op_breakdown(_synthetic(), top=2) == stats[:2]
    assert device_ms(_synthetic()) == pytest.approx(0.076)  # first kernel's start to the set's end
    assert sum(s.total_ms for s in stats) <= device_ms(_synthetic())


def test_cpu_only_trace_counts_outermost_ops_once():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.trace.call", "ts": 0, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "ts": 1, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 2, "dur": 15, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::tanh", "ts": 25, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "ts": 31, "dur": 10, "tid": 1},
    ]
    stats = op_breakdown(events)
    assert stats == [OpStat("aten::linear", 2, 0.03), OpStat("aten::tanh", 1, 0.005)]
    assert device_ms(events) == pytest.approx(0.05)


def test_summarize_and_format(tmp_path):
    fn, args = _toy()
    s = summarize(fn, *args, out_dir=str(tmp_path / "tr"), top=5)
    assert s["trace_dir"] == str(tmp_path / "tr") and s["device_ms"] > 0
    assert 0 < len(s["ops"]) <= 5
    assert sum(o.total_ms for o in op_breakdown(trace_events(s["trace_dir"]))) <= s["device_ms"]
    table = format_breakdown(s["ops"], total_ms=s["device_ms"])
    assert s["ops"][0].name[:20] in table.split("\n")[1] and "%" in table
    assert format_breakdown([]) == "(no workload events in trace)"
    long = format_breakdown([OpStat("k" * 80, 1, 1.0)])
    assert long.split("\n")[1].startswith("k" * 59 + "…")  # names cut to 60 characters


def test_trace_of_predict_on_the_cpu(tmp_path):
    m = P.load_params(os.path.join(REPO_DIR, "model_saves", "pretrained_30units_v4_n1.5.npz"), device="cpu")
    x = torch.tensor(np.random.default_rng(1).normal(size=(16, 16)), dtype=torch.float32)
    s = summarize(lambda mm, xx: P.predict(mm, xx), m, x, out_dir=str(tmp_path / "tr"), top=0)
    names = {o.name for o in s["ops"]}
    assert names and all(n.startswith("aten::") for n in names)
    assert sum(o.total_ms for o in s["ops"]) <= s["device_ms"]
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def _run(*args):
    out = subprocess.run([sys.executable, "-m", "svd_lstm_tpu_torch", *args], env=subprocess_env(),
                         cwd=REPO_DIR, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("checkpoint", [None, "reduced"])
def test_trace_command_on_the_cpu(tmp_path, checkpoint):
    """The command on a random 4x40 stack and on a reduced checkpoint
    written by the JAX package (the input width read from the model)."""
    args = [str(tmp_path / "tr"), "--steps", "8", "--top", "5", "--device", "cpu"]
    if checkpoint:
        dense = init_stacked_lstm(jax.random.PRNGKey(2), input_dim=6, units=(8, 8))
        path = str(tmp_path / "reduced.npz")
        jsave(path, make_reduced_model(make_singular_model(dense), rank=5))
        args += ["--checkpoint", path]
    out = _run("trace", *args)
    assert "call total (CPU, host ops):" in out and "trace ->" in out
    assert os.path.isfile(tmp_path / "tr" / "trace.json")
    rows = out.split("\n")[2:7]
    assert len(rows) == 5 and all(r.startswith("aten::") for r in rows)
