"""Command-line entry: ``python -m svd_lstm_tpu_torch <command> [args]``.

Counterpart of ``svd_lstm_tpu/__main__.py``'s deployment commands:

    export — checkpoint -> deployment artifacts: per-gate CSVs (dense) or
             two-step factor CSVs (reduced), optionally the JSON dump and the
             int8 artifacts (``model_int8.npz``, ``model_int8.bin``): the
             reference's LabVIEW export surface (code/load_preprocess.py:80-165)
    stream — frame-at-a-time inference over a CSV or stdin frame stream from
             any deployment artifact (checkpoint, CSV export directory, int8
             .bin), on the card, on the CPU or through the native C++ runtime:
             the reference's LabVIEW consumer loop
             (code/old_versions/svd_classes.py:104-119) as a pipe-able command

The JAX package's other commands are not ported yet:
ROADMAP queue 1, item 5 (the CLI).
"""

import os
import sys

_COMMANDS = ("export", "stream")


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
    from svd_lstm_tpu_torch.models.reduced import ReducedLSTM
    from svd_lstm_tpu_torch.models.singular import SingularLSTM

    params = _load_checkpoint_f32(args.checkpoint, args.device)
    if isinstance(params, SingularLSTM):
        raise SystemExit(
            "singular (factorized) checkpoints have no deployment export: "
            "collapse to dense first (factor.svd.singular_to_dense) or "
            "truncate (make_reduced_model)"
        )
    os.makedirs(args.outdir, exist_ok=True)
    is_reduced = isinstance(params, ReducedLSTM)
    if is_reduced:
        from svd_lstm_tpu_torch.io.native import save_reduced_weights_as_csv

        save_reduced_weights_as_csv(params, args.outdir)
        print(f"two-step factor CSVs -> {args.outdir}/")
    else:
        save_model_weights_as_csv(params, args.outdir)
        print(f"per-gate CSVs -> {args.outdir}/")
    if args.json:
        if is_reduced:
            raise SystemExit(
                "--json covers the reference's dense JSON dump "
                "(load_preprocess.py:80-90) only; export a dense checkpoint or drop --json"
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

            from svd_lstm_tpu_torch.models.reduced import ReducedLSTM
            from svd_lstm_tpu_torch.models.singular import SingularLSTM

            params = _load_checkpoint_f32(args.artifact, "cpu")
            if isinstance(params, SingularLSTM):
                raise SystemExit(
                    "--native cannot run a singular (factorized) checkpoint: the "
                    "native runtime consumes dense or two-step reduced exports. "
                    "Truncate first (make_reduced_model) or drop --native."
                )
            tmpdir = tempfile.TemporaryDirectory(prefix="svdlstm_stream_")
            if isinstance(params, ReducedLSTM):
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


def main():
    cmd = sys.argv[1] if len(sys.argv) >= 2 else None
    if cmd == "export":
        _export(sys.argv[2:])
        return
    if cmd == "stream":
        _stream(sys.argv[2:])
        return
    print(__doc__)
    print("commands:", ", ".join(_COMMANDS))
    raise SystemExit(2)


if __name__ == "__main__":
    main()
