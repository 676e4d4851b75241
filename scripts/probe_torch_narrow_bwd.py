#!/usr/bin/env python3
"""Design trials of the narrow train backward of the PyTorch port (K7's and
K8's ``narrow_bwd_wave``) on one CUDA card.

    python3 scripts/probe_torch_narrow_bwd.py

It launches the backward kernel alone (no weight gradients) with settings
the wrapper's rules would not pick, checks each against the plain version
(dx, and every weight gradient reduced from the kernel's dz) and times
them in turns in one process (a, b, ..., ..., b, a: the card and its
neighbours change between calls):

* at run A's shapes (4x40, B = 32, T = 200, d = 16; a random stack and
  input from seed 0): the lane count S = 1, 2, 4 a unit, the weights read
  from the global copy, the one home S = 1 has (the rule takes S = 4; S = 8
  would need 1280 lanes);
* there, at S = 4: the weights staged in shared memory (the rule, where
  they fit) against the global copy;
* on a 4x30 stack at B = 128 (run E's widths): S = 4, every dx unit on a
  group of its own (the rule), against S = 8, where the block's 1024
  threads leave 8 of the dx units on layer 0's groups.

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

D, T = 16, 200
GRAD_RTOL = 1e-3  # chip_smoke.py's limit: 1e-3 × the largest plain value


def stack(units, B, dev, seed):
    rng = np.random.default_rng(seed)
    layers, din = [], D
    for n in units:
        layers.append(tuple(torch.tensor(rng.normal(scale=s, size=shape), dtype=torch.float32, device=dev)
                            for shape, s in (((din, 4 * n), din ** -0.5), ((n, 4 * n), n ** -0.5),
                                             ((4 * n,), 0.1))))
        din = n
    x = torch.tensor(rng.normal(size=(T, B, D)), dtype=torch.float32, device=dev)
    hs, cs = ct.fused_narrow_train_fwd_plain(layers, x)
    dh = torch.tensor(rng.normal(size=hs[-1].shape), dtype=torch.float32, device=dev)
    return layers, x, hs, cs, dh


def backward(lanes, staged):
    return lambda *args: ct._launch_narrow_bwd("fused_narrow_train_bwd", *args, lanes, staged)

def in_turns(name, variants, args):
    """Checks each variant against the plain gradients, then times them in
    turns: each name's ms in the order of the runs."""
    layers, x, hs = args[:3]
    want = ct.fused_narrow_train_bwd_plain(*args)
    for label, fn in variants:
        dx, dzs = fn(*args)
        got = [ct._layer_weight_grads(x if i == 0 else hs[i - 1], hs[i], dz) for i, dz in enumerate(dzs)]
        pairs = [(dx, want[3])] + [(g[k], want[k][i]) for i, g in enumerate(got) for k in range(3)]
        for a, r in pairs:
            err, lim = float((a - r).abs().max()), GRAD_RTOL * float(r.abs().max())
            if not err <= lim:
                raise SystemExit(f"{name} {label}: max abs err {err:.3g} over {lim:.3g}")
        print(f"[check] {name} {label}: within {GRAD_RTOL} of each gradient's largest value")
    order = variants + variants[::-1]
    ms = [device_time_ms(fn, *args) for _, fn in order]
    print(f"[time] {name}, in turns: "
          + ", ".join(f"{label} {t:.3f}" for (label, _), t in zip(order, ms)) + " ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_narrow_bwd: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    with exact_matmul(), torch.no_grad():
        units = (40,) * 4
        args = stack(units, 32, dev, 0)
        shape = f"4x40, B=32, T={T}, d={D}"
        print(f"[rule] {shape}: S = {ct.narrow_bwd_lanes(units, D)}, "
              f"staged = {ct.narrow_bwd_staged(units, D)}")
        in_turns(f"K7 bwd kernel lane count, global copy ({shape})",
                 [(f"S={s}", backward(s, False)) for s in (1, 2, 4)], args)
        in_turns(f"K7 bwd kernel weight home at S=4 ({shape})",
                 [("staged", backward(4, True)), ("global copy", backward(4, False))], args)
        units = (30,) * 4
        args = stack(units, 128, dev, 1)
        shape = f"4x30, B=128, T={T}, d={D}"
        print(f"[rule] {shape}: S = {ct.narrow_bwd_lanes(units, D)}, "
              f"staged = {ct.narrow_bwd_staged(units, D)}")
        in_turns(f"K8 bwd kernel lane count ({shape})",
                 [("S=4, dx on groups of its own", backward(4, True)),
                  ("S=8, dx partly on layer 0's groups", backward(8, True))], args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
