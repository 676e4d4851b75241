#!/usr/bin/env python3
"""Design trials of the narrow train forward of the PyTorch port (K7's and
K8's ``narrow_fwd_wave``) on one CUDA card.

    python3 scripts/probe_torch_narrow_fwd.py

At run A's shapes (4x40, B = 32, T = 200, d = 16; a random stack and input
from seed 0) it launches the forward with settings the wrapper's rules would
not pick, checks each against the plain version and times them in turns in
one process (a, b, ..., ..., b, a: the card and its neighbours change
between calls):

* the lane count S = 1, 2, 4 a unit, weights staged in shared memory (the
  rule takes S = 4; S = 8 would need 1280 threads);
* at S = 4, the weights staged against read from the wrapper's
  gate-interleaved copy in global memory (the rule stages every stack that
  fits).

Prints the card's name and power limit first. Imports torch and the port,
never JAX.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from svd_lstm_tpu_torch.api import exact_matmul  # noqa: E402
from svd_lstm_tpu_torch.bench.devtime import device_time_ms  # noqa: E402
from svd_lstm_tpu_torch.ops import cuda_train as ct  # noqa: E402

UNITS, D, B, T = (40, 40, 40, 40), 16, 32, 200


def in_turns(name, variants, layers, x, want):
    """Checks each variant against the plain h and c, then times them in
    turns: each name's ms in the order of the runs."""
    for label, fn in variants:
        hs, cs = fn(layers, x)
        err = max(float((a - r).abs().max()) for a, r in zip(hs + cs, want[0] + want[1]))
        if not err <= 1e-4:
            raise SystemExit(f"{name} {label}: max abs err {err:.3g} over 1e-4")
        print(f"[check] {name} {label}: max abs err {err:.3g}")
    order = variants + variants[::-1]
    ms = [device_time_ms(fn, layers, x) for _, fn in order]
    print(f"[time] {name}, in turns: "
          + ", ".join(f"{label} {t:.3f}" for (label, _), t in zip(order, ms)) + " ms")


def forward(lanes, staged):
    return lambda layers, x: ct._launch_narrow_fwd("fused_narrow_train_fwd", layers, x, lanes, staged)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_narrow_fwd: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    layers, din = [], D
    for n in UNITS:
        layers.append(tuple(torch.tensor(rng.normal(scale=s, size=shape), dtype=torch.float32, device=dev)
                            for shape, s in (((din, 4 * n), din ** -0.5), ((n, 4 * n), n ** -0.5),
                                             ((4 * n,), 0.1))))
        din = n
    x = torch.tensor(rng.normal(size=(T, B, D)), dtype=torch.float32, device=dev)
    shape = f"4x40, B={B}, T={T}, d={D}"
    print(f"[rule] {shape}: S = {ct.narrow_fwd_lanes(UNITS, D)}, staged "
          f"{ct.narrow_fwd_smem_bytes(UNITS, D, True)} B")
    with exact_matmul(), torch.no_grad():
        want = ct.fused_narrow_train_fwd_plain(layers, x)
        in_turns(f"K7 fwd lane count ({shape})",
                 [(f"S={s}", forward(s, True)) for s in (1, 2, 4)], layers, x, want)
        in_turns(f"K7 fwd weight home at S=4 ({shape})",
                 [("staged", forward(4, True)), ("global copy", forward(4, False))], layers, x, want)
    return 0


if __name__ == "__main__":
    sys.exit(main())
