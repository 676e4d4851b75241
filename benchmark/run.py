"""Run one cell of the benchmark of ``svd_lstm_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernel library, weights,
surgery, inputs, warm-up of the cell's own shapes) is timed from the start
of this process to the first timed call; the window then runs the cell's
traffic for ``--seconds``; the outputs are checked against the plain
reference once the window has closed and the device's peak memory has been
read. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read under torch.profiler),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit. The same numbers are the last lines of
standard error.

Exits 2 without a result where the checkout holds no program to run, or
there is no CUDA card or too few for the cell; 3 where JAX, its libraries
or the JAX package were loaded.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout: program and benchmark

from benchmark.core import cell as cells  # noqa: E402
from benchmark.core import checks, devtrace, guard  # noqa: E402
from benchmark.core.record import Run  # noqa: E402

TRACE_ATTEMPTS = 3  # a trace that lost kernels is taken again, at most this many times


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name, power limit and clocks, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def host_line() -> str:
    """The host's load average and the cores this process may run on: the
    batch-1 cells issue from the host, and a busier host slows them."""
    try:
        with open("/proc/loadavg") as f:
            load = " ".join(f.read().split()[:3])
    except OSError as e:
        load = f"unknown ({e})"
    return f"load average {load}, {len(os.sched_getaffinity(0))} cores"


def traced_window(kind, st, seconds: float, kernels: dict):
    """The window under torch.profiler: ``(t_start, calls, trace)``. A
    trace whose kernel count disagrees with the launch counters is taken
    again (torch.profiler has dropped kernels on the H100 before); where
    none of ``TRACE_ATTEMPTS`` traces counts every kernel, ``trace`` is
    None, and the run reports nothing read from the device's trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        before = kind.launch_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(devtrace.WINDOW):
                t_start, calls = kind.window(st, seconds)
                sync(st.device)
        launched = {k: v - before.get(k, 0) for k, v in kind.launch_counters().items()}
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        trace = devtrace.parse(events)
        lost = devtrace.launch_mismatch(trace, launched, kernels)
        if not lost:
            return t_start, calls, trace
        log(f"trace {attempt}: kernel counts (launched, traced) disagree: {lost}"
            + ("; tracing again" if attempt < TRACE_ATTEMPTS else
               "; no trace counted every kernel: the device-trace metrics, busy_s, window_s "
               "and the breakdown are left out"))
    return t_start, calls, None


def program_missing() -> str:
    """Why the program cannot run from this checkout ("" where it can): it
    has to be the checkout's own copy, not one installed elsewhere."""
    spec = importlib.util.find_spec(guard.PROGRAM)
    if spec is None or spec.origin is None:
        return f"no package {guard.PROGRAM} beside the benchmark"
    if cells.ROOT not in Path(spec.origin).resolve().parents:
        return f"{guard.PROGRAM} is at {spec.origin}, outside the checkout {cells.ROOT}"
    return ""


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device):
    """Set up, time, check and read one run of ``cell`` on ``device``: the
    result object, or an exit code where forbidden modules were loaded."""
    import torch

    t_cell = time.perf_counter()
    kind = cells.kind(cell.traffic["kind"])
    st = kind.setup(cell, seed, device)
    t_route = time.perf_counter()
    route = kind.route(st)
    sync(device)
    setup_s = time.perf_counter() - T_PROCESS
    log(f"card: {card_line()}")
    log(f"host: {host_line()}")
    log(f"route: {route}")
    log(f"set-up {setup_s:.3f} s: imports and card {t_cell - T_PROCESS:.3f}, the cell's set-up "
        f"{t_route - t_cell:.3f}, the route's look {T_PROCESS + setup_s - t_route:.3f}")

    tr = None
    if trace:
        kernels = cells.launch_kernels()
        t_start, calls, tr = traced_window(kind, st, seconds, kernels)
    else:
        t_start, calls = kind.window(st, seconds)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    loaded = guard.loaded_forbidden()
    if loaded:
        log(f"forbidden modules loaded: {loaded}")
        return 3

    correct, compared = checks.verdict(kind.numbers(st)["program"], cell.limits)
    run = Run(workload=cell.name, seed=seed, setup_s=setup_s, t_start=t_start, calls=calls,
              layers=st.layers, steps=st.steps, trace=tr)
    failed = sum(not c.ok for c in calls)
    done = run.done
    if done:
        log(f"window: {len(done)} calls, {run.window_s:.3f} s; a call's mean: host in the entry "
            f"{1e3 * sum(c.t_ret - c.t0 for c in done) / len(done):.4f} ms, to its output "
            f"{1e3 * sum(c.t_done - c.t0 for c in done) / len(done):.4f} ms; host: {host_line()}")
    if failed:
        log(f"{failed} of {len(calls)} calls failed")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct and failed == 0 and bool(calls), "attempted": len(calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_by_host()}
    loaded = guard.loaded_forbidden()
    if loaded:
        log(f"forbidden modules loaded: {loaded}")
        return 3
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = cells.resolve(args.workload)
    missing = program_missing()
    if missing:
        log(f"the program is missing: {missing}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    if isinstance(result, int):
        return result
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
