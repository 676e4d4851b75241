"""Command-line entry: ``python -m svd_lstm_tpu_torch <command> [args]``.

Counterpart of ``svd_lstm_tpu/__main__.py``. The deployment and evaluation commands:

    export — checkpoint -> deployment artifacts: per-gate CSVs (dense) or
             two-step factor CSVs (reduced), optionally the JSON dump and the
             int8 artifacts (``model_int8.npz``, ``model_int8.bin``): the
             reference's LabVIEW export surface (code/load_preprocess.py:80-165)
    stream — frame-at-a-time inference over a CSV or stdin frame stream from
             any deployment artifact (checkpoint, CSV export directory, int8
             .bin), on the card, on the CPU or through the native C++ runtime:
             the reference's LabVIEW consumer loop
             (code/old_versions/svd_classes.py:104-119) as a pipe-able command
    trace  — capture a torch.profiler trace of one whole-run ``predict`` and
             print its per-op time breakdown (``bench/trace.py``): the
             device's kernels on the card, the host's ops on the CPU
    tune   — time every valid ``predict`` impl of a checkpoint on this
             device, print the table and store the winner in the autotune
             cache that ``predict(impl="auto")`` consults
             (``bench/autotune.py``); with ``--train`` every training
             regime's whole train step instead, the winner's TrainConfig
             flags stored for ``fit``'s ``auto_flags``

The workflow commands, each a module of ``examples/`` with ``run`` and
``main`` (``--device cuda`` by default; outputs under ``torch_runs/``):

    train        — train the full dense regressor (examples/train_full_model)
    compress     — factorize -> Hoyer fine-tune -> truncate -> time and score
                   (examples/svd_acceleration)
    sweep        — rank-reduction sweep: the RMSE curve and the gif
                   (examples/rank_sweep)
    rank-rmse    — the published 4x30 rank-RMSE configuration
                   (examples/rank_rmse_published)
    timing       — reduced/full timing ratio at each rank cut (examples/timing_curves)
    freq         — toy sine-series task (examples/frequency_prediction)
    batched      — batched multi-sequence inference (examples/batched_inference)
    seq-train    — parallel -> sequential merge, then more training
                   (examples/sequentialize_train)
    native-bench — per-step latency of the native C++ runtime (examples/bench_native)
    distributed  — dp training and pp inference over torch.distributed ranks
                   (examples/distributed_training)

Not ported yet: ``bench`` (ROADMAP queue 1, item 1: the CUDA benchmark).
"""

import os
import sys

# command -> its module under svd_lstm_tpu_torch.examples
_WORKFLOW = {
    "train": "train_full_model",
    "compress": "svd_acceleration",
    "sweep": "rank_sweep",
    "rank-rmse": "rank_rmse_published",
    "timing": "timing_curves",
    "freq": "frequency_prediction",
    "batched": "batched_inference",
    "seq-train": "sequentialize_train",
    "native-bench": "bench_native",
    "distributed": "distributed_training",
}
# the JAX package's commands still to port, and the ROADMAP item that holds each
_NOT_PORTED = {
    "bench": "ROADMAP queue 1, item 1 (the CUDA benchmark, a benchmark PR)",
}
_COMMANDS = ("export", "stream", "trace", "tune", *_WORKFLOW)


def _load_checkpoint_f32(path, device):
    """``load_params`` + dequantize: an int8-quantized checkpoint (``export
    --int8``'s model_int8.npz) loads as the float32 model it encodes; a
    float32 checkpoint passes through."""
    from svd_lstm_tpu_torch.io.checkpoint import load_params
    from svd_lstm_tpu_torch.utils.quantize import dequantize_params

    return dequantize_params(load_params(path, device=device))


def _export(argv):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m svd_lstm_tpu_torch export",
        description="Export a dense or reduced checkpoint to deployment artifacts.",
    )
    ap.add_argument("checkpoint", help=".npz checkpoint of either package")
    ap.add_argument("outdir", help="output directory")
    ap.add_argument("--json", action="store_true", help="also dump model_weights.json (dense only)")
    ap.add_argument("--int8", action="store_true",
                    help="also write model_int8.npz (quantized checkpoint) and "
                    "model_int8.bin (the native runtime's int8 artifact)")
    ap.add_argument("--device", default="cuda",
                    help="where the model is loaded and quantized (default: the card)")
    args = ap.parse_args(argv)

    from svd_lstm_tpu_torch.io.checkpoint import save_params
    from svd_lstm_tpu_torch.io.csv_weights import (
        save_model_weights_as_csv,
        save_model_weights_as_json,
    )
    from svd_lstm_tpu_torch.models.conv import CONV_TYPES, inner_stack
    from svd_lstm_tpu_torch.models.reduced import ReducedLSTM
    from svd_lstm_tpu_torch.models.singular import SingularLSTM

    params = _load_checkpoint_f32(args.checkpoint, args.device)
    # the family of the stack: a conv hybrid exports as its stack does, plus conv/
    if isinstance(inner_stack(params), SingularLSTM):
        raise SystemExit(
            "singular (factorized) checkpoints have no deployment export: "
            "collapse to dense first (factor.svd.singular_to_dense / "
            "conv_singular_to_dense) or truncate (make_reduced_model)"
        )
    os.makedirs(args.outdir, exist_ok=True)
    is_reduced = isinstance(inner_stack(params), ReducedLSTM)
    if is_reduced:
        from svd_lstm_tpu_torch.io.native import save_reduced_weights_as_csv

        save_reduced_weights_as_csv(params, args.outdir)
        print(f"two-step factor CSVs -> {args.outdir}/")
    else:
        save_model_weights_as_csv(params, args.outdir)
        print(f"per-gate CSVs -> {args.outdir}/")
    if args.json:
        if is_reduced or isinstance(params, CONV_TYPES):
            raise SystemExit(
                "--json covers the reference's dense JSON dump "
                "(load_preprocess.py:80-90) only; export a dense (non-conv) checkpoint or "
                "drop --json"
            )
        path = os.path.join(args.outdir, "model_weights.json")
        save_model_weights_as_json(params, path)
        print(f"JSON dump -> {path}")
    if args.int8:
        from svd_lstm_tpu_torch.io.int8_export import save_model_int8_bin
        from svd_lstm_tpu_torch.utils.quantize import param_bytes, quantize_params

        q = quantize_params(params)
        path = os.path.join(args.outdir, "model_int8.npz")
        save_params(path, q)
        print(f"int8 checkpoint -> {path} ({param_bytes(q)} vs {param_bytes(params)} bytes on device)")
        bin_path = os.path.join(args.outdir, "model_int8.bin")
        nbytes = save_model_int8_bin(params, bin_path)
        print(f"int8 native artifact -> {bin_path} ({nbytes} bytes; "
              "loads via NativeModel.from_int8 / svdlstm_load_int8)")


def _stream(argv):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m svd_lstm_tpu_torch stream",
        description="Frame-at-a-time streaming inference from a deployment "
        "artifact: each input line is one frame (comma/space-separated "
        "floats), each output line one prediction, flushed per frame. The "
        "torch path runs on the card unless --device cpu is given (the JAX "
        "package's stream pins the CPU; this package's entry points default "
        "to the card); --native runs the C++ runtime on the host.",
    )
    ap.add_argument(
        "artifact",
        help=".npz checkpoint (dense, singular or reduced, float32 or int8), a "
        "CSV weight-export directory, or an int8 .bin native artifact",
    )
    ap.add_argument("--input", default="-", help="frame CSV path, or '-' for stdin (default)")
    ap.add_argument("--output", default="-",
                    help="prediction output path, or '-' for stdout (default)")
    ap.add_argument(
        "--native", action="store_true",
        help="run through the C++ runtime (io.native). Implied for .bin "
        "artifacts and for two-step CSV export dirs (which only the native "
        "runtime consumes); a checkpoint is exported to a temporary CSV dir first",
    )
    ap.add_argument(
        "--force-two-step", action="store_true",
        help="native path: skip the load-time execution dispatch and force "
        "the two-step on every reduced side",
    )
    ap.add_argument("--stats", action="store_true",
                    help="print per-frame host-latency percentiles to stderr at EOF")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch path (default: the card)")
    args = ap.parse_args(argv)

    import time

    import numpy as np

    is_bin = args.artifact.endswith(".bin")
    is_dir_export = os.path.isdir(args.artifact) and os.path.exists(
        os.path.join(args.artifact, "dense_top")
    )
    reduced_csv = False
    if is_dir_export:
        from svd_lstm_tpu_torch.io.csv_weights import list_layer_dirs

        dirs = list_layer_dirs(args.artifact)
        reduced_csv = bool(dirs) and not os.path.exists(
            os.path.join(args.artifact, dirs[0], "Wi.csv")
        )
    use_native = args.native or is_bin or reduced_csv

    tmpdir = None
    if use_native:
        from svd_lstm_tpu_torch.io.native import NativeModel

        if is_bin:
            nm = NativeModel.from_int8(args.artifact, force_two_step=args.force_two_step)
        elif is_dir_export:
            nm = NativeModel.from_export_dir(args.artifact, force_two_step=args.force_two_step)
        else:
            # checkpoint -> temporary CSV export -> native load, all on the host
            import tempfile

            from svd_lstm_tpu_torch.models.conv import inner_stack
            from svd_lstm_tpu_torch.models.reduced import ReducedLSTM
            from svd_lstm_tpu_torch.models.singular import SingularLSTM

            params = _load_checkpoint_f32(args.artifact, "cpu")
            if isinstance(inner_stack(params), SingularLSTM):
                raise SystemExit(
                    "--native cannot run a singular (factorized) checkpoint: the "
                    "native runtime consumes dense or two-step reduced exports. "
                    "Truncate first (make_reduced_model) or drop --native."
                )
            tmpdir = tempfile.TemporaryDirectory(prefix="svdlstm_stream_")
            if isinstance(inner_stack(params), ReducedLSTM):
                from svd_lstm_tpu_torch.io.native import save_reduced_weights_as_csv

                save_reduced_weights_as_csv(params, tmpdir.name)
            else:
                from svd_lstm_tpu_torch.io.csv_weights import save_model_weights_as_csv

                save_model_weights_as_csv(params, tmpdir.name)
            nm = NativeModel.from_export_dir(tmpdir.name, force_two_step=args.force_two_step)

        in_dim = nm.input_dim
        engine = "native"

        def step(frame):
            return [nm.step(frame)]
    else:
        import torch

        from svd_lstm_tpu_torch.api import model_input_dim
        from svd_lstm_tpu_torch.models.streaming import make_stream_fn

        device = torch.device(args.device)
        if is_dir_export:
            from svd_lstm_tpu_torch.io.csv_weights import load_model_from_csv

            params = load_model_from_csv(args.artifact, device=device)
        else:
            params = _load_checkpoint_f32(args.artifact, device)
        in_dim = model_input_dim(params)
        step_fn, state = make_stream_fn(params)
        state_box = [state]
        engine = f"torch-{device.type}"

        def step(frame):
            y, state_box[0] = step_fn(state_box[0], torch.as_tensor(frame, device=device)[None])
            return y.cpu().numpy().ravel().tolist()

    fin = sys.stdin if args.input == "-" else open(args.input)
    fout = sys.stdout if args.output == "-" else open(args.output, "w")
    lat_ms = []
    n = 0
    try:
        for line in fin:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            frame = np.array([float(v) for v in line.replace(",", " ").split()], dtype=np.float32)
            if frame.size != in_dim:
                raise SystemExit(
                    f"input line {n + 1}: frame has {frame.size} values; "
                    f"the model expects {in_dim} per frame"
                )
            if args.stats:
                t0 = time.perf_counter()
                y = step(frame)
                lat_ms.append((time.perf_counter() - t0) * 1e3)
            else:  # no unbounded latency buffer on long-running pipes
                y = step(frame)
            fout.write(",".join(f"{v:.8g}" for v in y) + "\n")
            fout.flush()
            n += 1
    finally:
        if fin is not sys.stdin:
            fin.close()
        if fout is not sys.stdout:
            fout.close()
        if tmpdir is not None:
            tmpdir.cleanup()
    if args.stats and lat_ms:
        lat = np.asarray(lat_ms[1:] or lat_ms)  # the first frame is the warm-up
        print(
            f"{n} frames  engine={engine}  "
            f"per-frame host latency p50 {np.percentile(lat, 50)*1e3:.1f} us  "
            f"p99 {np.percentile(lat, 99)*1e3:.1f} us  "
            f"max {lat.max()*1e3:.1f} us (first frame excluded)",
            file=sys.stderr,
        )


def _model_and_input(args, shape):
    """The checkpoint (or a random 4x40 stack, seed 0) on ``args.device``
    and a standard normal input of ``shape + (d,)`` from numpy's seed 1."""
    import numpy as np
    import torch

    from svd_lstm_tpu_torch.api import model_input_dim

    device = torch.device(args.device)
    if args.checkpoint:
        model = _load_checkpoint_f32(args.checkpoint, device)
    else:
        from svd_lstm_tpu_torch.models.lstm import init_stacked_lstm

        model = init_stacked_lstm(torch.Generator().manual_seed(0), device=device)
    shape = (*shape, model_input_dim(model))
    x = torch.tensor(np.random.default_rng(1).normal(size=shape), dtype=torch.float32, device=device)
    return model, x


def _trace(argv):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m svd_lstm_tpu_torch trace",
        description="Capture a profiler trace of whole-run inference and print "
        "the per-op time breakdown (the card's kernels; on the CPU the host's ops).",
    )
    ap.add_argument("outdir", help="trace output directory (trace.json: ui.perfetto.dev)")
    ap.add_argument("--checkpoint", default=None, help="model checkpoint (default: random 4x40)")
    ap.add_argument("--steps", type=int, default=2048, help="run length T")
    ap.add_argument("--impl", default="auto", choices=("auto", "scan", "fused", "hybrid"),
                    help="predict impl")
    ap.add_argument("--precision", default="exact", choices=("exact", "high", "fast"))
    ap.add_argument("--top", type=int, default=15, help="rows in the op table")
    ap.add_argument("--device", default="cuda", help="where the model runs (default: the card)")
    args = ap.parse_args(argv)

    from svd_lstm_tpu_torch.api import predict
    from svd_lstm_tpu_torch.bench.trace import format_breakdown, summarize

    model, x = _model_and_input(args, (args.steps,))
    fn = lambda m, xx: predict(m, xx, impl=args.impl, precision=args.precision)  # noqa: E731
    s = summarize(fn, model, x, out_dir=args.outdir, top=args.top)
    total = "device total" if x.is_cuda else "call total (CPU, host ops)"
    print(f"{total}: {s['device_ms']:.3f} ms  (T={args.steps}, impl={args.impl}, "
          f"precision={args.precision})")
    print(format_breakdown(s["ops"], total_ms=s["device_ms"]))
    print(f"\ntrace -> {args.outdir}  (view: load trace.json in ui.perfetto.dev)")


def _tune(argv):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m svd_lstm_tpu_torch tune",
        description="Measure every valid predict() implementation of a model and "
        "input shape on this device, print the table and the winner, and store "
        "the winner in the autotune cache that predict(impl='auto') consults.",
    )
    ap.add_argument("--checkpoint", default=None, help="model checkpoint (default: random 4x40)")
    ap.add_argument("--steps", type=int, default=None,
                    help="run length T (default: 2048 for inference, 200, the reference's "
                    "window length, for --train)")
    ap.add_argument("--batch", type=int, default=0,
                    help="0 = batch-1 (T, d) input; with --train the window batch (default 32)")
    ap.add_argument("--precision", default="exact", choices=("exact", "high", "fast"))
    ap.add_argument("--repeats", type=int, default=2, help="timing repeats per impl")
    ap.add_argument("--no-cache", action="store_true", help="measure only; skip the cache")
    ap.add_argument("--train", action="store_true",
                    help="tune the training step instead: one whole step (forward, backward, "
                    "optimizer; the σ-masked Hoyer step for a singular checkpoint) in the "
                    "f32, tf32 and bf16 scans and the bf16 kernels, and store the winner's "
                    "TrainConfig flags (matmul_precision, recurrence_kernel, compact_gates) "
                    "for fit's auto_flags")
    ap.add_argument("--device", default="cuda", help="where the model runs (default: the card)")
    args = ap.parse_args(argv)

    from svd_lstm_tpu_torch.bench import autotune as at

    if args.train:
        _tune_train(args, at)
        return
    T = 2048 if args.steps is None else args.steps
    shape = (args.batch, T) if args.batch else (T,)
    model, x = _model_and_input(args, shape)
    r = at.autotune(model, x, precision=args.precision, repeats=args.repeats)
    clock = "CUDA events" if x.is_cuda else "host clock"
    print(f"device: {at.device_kind(x)}   input {tuple(x.shape)}  precision={args.precision}  ({clock})")
    for impl, ms in sorted(r.table.items(), key=lambda kv: kv[1]):
        mark = " <- winner" if impl == r.impl else ""
        print(f"  {impl:<8} {ms:10.3f} ms{mark}")
    for impl, err in r.failed.items():
        print(f"  {impl:<8} FAILED: {err.splitlines()[0][:90]}")
    if not args.no_cache:
        print(f"cached -> {at.store_tuned(at.cache_key(model, x, args.precision), r.impl)}")


def _tune_train(args, at):
    """``tune --train``: every training regime's whole step on a window
    batch (B = --batch or 32, T = --steps or 200) of standard normal x and
    y from numpy's seeds 1 and 2."""
    import numpy as np
    import torch

    B, T = args.batch or 32, 200 if args.steps is None else args.steps
    model, x = _model_and_input(args, (B, T))
    y = torch.tensor(np.random.default_rng(2).normal(size=(B,)), dtype=torch.float32,
                     device=x.device)
    r = at.autotune_train(model, x, y, repeats=args.repeats)
    clock = "CUDA events" if x.is_cuda else "host clock"
    print(f"device: {at.device_kind(x)}   windows (B={B}, T={T}, d={x.shape[-1]})  whole train "
          f"step with the optimizer  ({clock})")
    for name, ms in sorted(r.table.items(), key=lambda kv: kv[1]):
        mark = ("  (exact regime: context, never the winner)" if name == "f32_scan"
                else " <- winner" if ms == r.ms else "")
        print(f"  {name:<20} {ms:10.3f} ms/step{mark}")
    for name, err in r.failed.items():
        print(f"  {name:<20} SKIPPED: {err.splitlines()[0][:90]}")
    print(f"TrainConfig flags: matmul_precision={r.matmul_precision!r}, "
          f"recurrence_kernel={r.recurrence_kernel}, compact_gates={r.compact_gates}")
    if not args.no_cache:
        flags = at.encode_train_flags(r.matmul_precision, r.recurrence_kernel, r.compact_gates)
        print(f"cached -> {at.store_tuned(at.train_cache_key(model, x), flags)}")


def main():
    cmd = sys.argv[1] if len(sys.argv) >= 2 else None
    commands = {"export": _export, "stream": _stream, "trace": _trace, "tune": _tune}
    if cmd in commands:
        commands[cmd](sys.argv[2:])
        return
    if cmd in _WORKFLOW:
        import importlib

        importlib.import_module(f"svd_lstm_tpu_torch.examples.{_WORKFLOW[cmd]}").main(sys.argv[2:])
        return
    if cmd in _NOT_PORTED:
        print(f"{cmd}: not ported yet; {_NOT_PORTED[cmd]}")
        raise SystemExit(2)
    print(__doc__)
    print("commands:", ", ".join(_COMMANDS))
    raise SystemExit(2)


if __name__ == "__main__":
    main()
