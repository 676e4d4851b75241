"""Real-time streaming of the compressed model, frame at a time: the
reference's deployment loop (a batch-1 consumer feeding a LabVIEW/FPGA rig).

Counterpart of ``examples/realtime_stream.py``:

1. a seeded dense stack, factorized (split) and truncated to rank
   ``--rank``: the deployment artifact;
2. ``models/streaming.make_stream_fn`` over the frames one at a time (on
   the card one CUDA graph replay a frame), then ``stream_many`` in chunks
   of 64 frames: each within 1e-4 of the whole-run scan, with the host's
   time a frame;
3. the split CSV export through the native C++ runtime
   (``io/native.py``): within 1e-3 of the scan, its time a frame and the
   load-time dispatch of each layer. A native runtime that cannot be built
   fails the command (the JAX script skips this step then).

    python -m svd_lstm_tpu_torch.examples.realtime_stream [--quick] [--units 40,40,40,40] [--rank 25] [--frames N] [--device cuda]
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from svd_lstm_tpu_torch import examples as ex

D = 16
CHUNK = 64
STREAM_TOL = 1e-4
NATIVE_TOL = 1e-3


def run(units=(40, 40, 40, 40), rank: int = 25, frames: int = 0, quick: bool = False,
        device: str = "cuda") -> dict:
    """The streaming checks (see the module docstring). Returns each path's
    error against the whole-run scan and its host time a frame (µs)."""
    import torch

    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.io.native import NativeModel, build_native, save_reduced_weights_as_csv

    dev = ex.device_of(device)
    units = tuple(units)[:2] if quick else tuple(units)
    T = frames or (256 if quick else 2048)
    dense = P.init_stacked_lstm(torch.Generator().manual_seed(0), D, units, device=dev)
    rmodel = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=False), rank=rank)
    wc_full = sum(p.numel() for p in dense.parameters())
    wc_red = sum(p.numel() for p in rmodel.parameters())
    print(f"model {len(units)}x{units[0]} r={rank}: {wc_full} -> {wc_red} weights ({wc_red / wc_full:.2f}x)")

    frames_np = np.random.default_rng(0).normal(size=(T, D)).astype(np.float32)
    x = torch.tensor(frames_np, device=dev)
    with torch.no_grad(), P.exact_matmul():
        oracle = P.reduced_lstm_apply(rmodel, x[None])[0, :, 0].cpu().numpy()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    res = {}
    step_fn, state = P.make_stream_fn(rmodel)
    y, _ = step_fn(state, x[:1])  # warm (on the card: the graph is captured already)
    ys = []
    sync()
    t0 = time.perf_counter()
    for i in range(T):
        y, state = step_fn(state, x[i : i + 1])
        ys.append(y[0, 0].clone())
    sync()
    res["stream_us"] = (time.perf_counter() - t0) / T * 1e6
    res["stream_err"] = float(np.max(np.abs(torch.stack(ys).cpu().numpy() - oracle)))
    print(f"make_stream_fn step : {res['stream_us']:8.1f} us/frame ({dev.type}, host clock)   "
          f"max|err| {res['stream_err']:.2e}")
    if not res["stream_err"] < STREAM_TOL:
        raise AssertionError(f"stream step {res['stream_err']:.2e} from the whole-run scan")

    with torch.no_grad():
        P.stream_many(rmodel, P.init_stream(rmodel), x[None, :CHUNK])  # warm
        sync()
        t0 = time.perf_counter()
        state, outs = P.init_stream(rmodel), []
        for i in range(0, T, CHUNK):
            yc, state = P.stream_many(rmodel, state, x[None, i : i + CHUNK])
            outs.append(yc[0, :, 0])
        sync()
    res["chunk_us"] = (time.perf_counter() - t0) / T * 1e6
    res["chunk_err"] = float(np.max(np.abs(torch.cat(outs).cpu().numpy() - oracle)))
    print(f"stream_many/{CHUNK:<3}     : {res['chunk_us']:8.1f} us/frame   max|err| {res['chunk_err']:.2e}")
    if not res["chunk_err"] < STREAM_TOL:
        raise AssertionError(f"stream_many {res['chunk_err']:.2e} from the whole-run scan")

    build_native()
    with tempfile.TemporaryDirectory(prefix="realtime_stream_") as tmp:
        save_reduced_weights_as_csv(rmodel, tmp)
        nm = NativeModel(tmp, [f"lstm_{i}" for i in range(len(units))], "r" * len(units))
        for li in range(len(units)):
            info = nm.layer_info(li)
            print(f"  native layer {li}: w {'two-step' if info['w_reduced'] else 'dense'}, "
                  f"u {'two-step' if info['u_reduced'] else 'dense'}")
        nm.run(frames_np)  # warm, then timed from a reset state
        nm.reset()
        t0 = time.perf_counter()
        y_nat = nm.run(frames_np)
        res["native_us"] = (time.perf_counter() - t0) / T * 1e6
    res["native_err"] = float(np.max(np.abs(y_nat - oracle)))
    print(f"native C++ step     : {res['native_us']:8.1f} us/frame   max|err| {res['native_err']:.2e}")
    if not res["native_err"] < NATIVE_TOL:
        raise AssertionError(f"native runtime {res['native_err']:.2e} from the whole-run scan")
    print("realtime streaming demo OK")
    return {**res, "model": rmodel, "oracle": oracle, "stream": torch.stack(ys).cpu().numpy(),
            "native": y_nat}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch.examples.realtime_stream",
                                 description="Frame-at-a-time streaming of the compressed model.")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--units", default="40,40,40,40")
    ap.add_argument("--rank", type=int, default=25)
    ap.add_argument("--frames", type=int, default=0, help="0 = auto")
    ex.add_device(ap)
    args = ap.parse_args(argv)
    return run(units=tuple(int(u) for u in args.units.split(",")), rank=args.rank, frames=args.frames,
               quick=args.quick, device=args.device)


if __name__ == "__main__":
    main()
