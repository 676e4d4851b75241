"""Timing-vs-rank curves: the reference's timing figure (plots/timing_plot.png,
slide 15) with this port's numbers.

Counterpart of ``examples/timing_curves.py``. The reference's reduced model
ran 1.31-1.39x slower than its dense one at every rank cut. Here each cut
is one whole-run batch-1 ``predict`` of the reduced model, timed against
the dense model's (CUDA events on the card, ``bench/devtime.py``; the host's
clock on the CPU):

* narrow (4x40, split factorization, cuts k = n - r): both models through
  ``impl="fused"``: K1 on the dense stack and on the reduced model's exact
  dense reconstruction (``reduced_forward_fused``, as on the TPU);
* ``--wide`` (3x512, merged factorization, kept ranks r): both through
  ``impl="hybrid"``, as the JAX script's TPU branch: K3 on each dense layer,
  K2 on each reduced one; ``--fast`` runs both in fast mode (K3f, K2f).

On the CPU the same calls run the kernels' plain versions. The models are
seeded (``torch.Generator().manual_seed(0)``) and x is standard normal from
numpy's seed 0.

    python -m svd_lstm_tpu_torch timing [--quick] [--wide [--fast]] [--T 6656] [--plots DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from svd_lstm_tpu_torch import examples as ex

D = 16
NARROW_UNITS, NARROW_KS = (40, 40, 40, 40), (1, 3, 5, 7, 9, 11, 13, 15, 17, 19)
QUICK_NARROW_UNITS, QUICK_NARROW_KS = (40, 40), (1, 5, 10, 15)
WIDE_UNITS, WIDE_RANKS = (512, 512, 512), (256, 128, 64, 32, 16)
QUICK_WIDE_RANKS = (64, 32)
QUICK_T = 512


@dataclasses.dataclass
class Curve:
    xs: list            # the cuts: k = n - r (narrow) or the kept rank r (wide)
    ranks: list         # the kept rank of each cut
    full_ms: float
    reduced_ms: list
    outputs: list       # each reduced model's output, (T, 1), from its timed predict

    @property
    def ratios(self) -> list:
        return [t / self.full_ms for t in self.reduced_ms]


def models(units, merged: bool, ranks, T: int, dev: torch.device):
    """The seeded dense stack, x (T, d) and {rank: its reduced model} (the
    direct truncation of ``make_singular_model(merged_kernel=merged)``)."""
    import svd_lstm_tpu_torch as P

    dense = P.init_stacked_lstm(torch.Generator().manual_seed(0), D, units, device=dev)
    smodel = P.make_singular_model(dense, merged_kernel=merged)
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    return dense, x, {r: P.make_reduced_model(smodel, rank=r) for r in ranks}


def run(wide: bool = False, fast: bool = False, T: int = 6656, cuts=None, units=None,
        plots: str = ex.PLOTS, device: str = "cuda", repeats: int = 3) -> Curve:
    """One curve: narrow (``cuts`` are k = n - r) or ``wide`` (``cuts`` are
    kept ranks), exact or ``fast`` (wide only, as in the JAX script)."""
    from svd_lstm_tpu_torch.api import predict
    from svd_lstm_tpu_torch.viz.plots import plot_timing_curve

    dev = ex.device_of(device)
    if wide:
        units = tuple(units or WIDE_UNITS)
        cuts = list(cuts or WIDE_RANKS)
        ranks, impl, precision = cuts, "hybrid", "fast" if fast else "exact"
    else:
        if fast:
            raise ValueError("--fast applies to --wide only (as in the JAX script)")
        units = tuple(units or NARROW_UNITS)
        cuts = list(cuts or NARROW_KS)
        ranks, impl, precision = [units[0] - k for k in cuts], "fused", "exact"
    dense, x, reduced = models(units, wide, ranks, T, dev)
    label = "x".join(map(str, units))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"device: {name} ({ex.clock(dev)}); T={T}, d={D}, impl={impl}, precision={precision}")

    def call(model):
        return predict(model, x, impl=impl, precision=precision)

    t_full = ex.time_ms(call, dense, dev=dev, repeats=repeats)
    print(f"full ({label} dense): {t_full:.3f} ms")
    curve = Curve(cuts, ranks, t_full, [], [])
    for cut, r in zip(cuts, ranks):
        t_red = ex.time_ms(call, reduced[r], dev=dev, repeats=repeats)
        curve.reduced_ms.append(t_red)
        curve.outputs.append(call(reduced[r]))
        where = f"r={r:3d}" if wide else f"k={cut:2d} (r={r:2d})"
        print(f"{where}: reduced {t_red:.3f} ms  ratio {t_red / t_full:.3f}")

    xlabel = f"kept rank r (n={units[0]})" if wide else "n - r"
    fig = "timing_plot" + ("_wide" if wide else "") + ("_fast" if fast else "") + ".png"
    path = ex.figure_path(plots, fig)
    if path:
        plot_timing_curve(cuts, curve.ratios, xlabel=xlabel, savepath=path)
        print(f"wrote {path}  (reference band: 1.31-1.39)")
    return curve


def main(argv=None) -> Curve:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch timing",
                                 description="Reduced/full timing ratio at each rank cut.")
    ap.add_argument("--quick", action="store_true")
    ex.add_plots(ap)
    ap.add_argument("--T", type=int, default=6656)
    ap.add_argument("--wide", action="store_true", help="the 3x512 curve (merged factorization)")
    ap.add_argument("--fast", action="store_true",
                    help="with --wide: both models in fast mode (bf16 operands, K3f and K2f)")
    ex.add_device(ap)
    args = ap.parse_args(argv)
    if args.fast and not args.wide:
        ap.error("--fast applies to --wide only")
    T = QUICK_T if args.quick else args.T
    if args.wide:
        cuts = QUICK_WIDE_RANKS if args.quick else WIDE_RANKS
        units = WIDE_UNITS
    else:
        cuts = QUICK_NARROW_KS if args.quick else NARROW_KS
        units = QUICK_NARROW_UNITS if args.quick else NARROW_UNITS
    return run(wide=args.wide, fast=args.fast, T=T, cuts=cuts, units=units, plots=args.plots,
               device=args.device)


if __name__ == "__main__":
    main()
