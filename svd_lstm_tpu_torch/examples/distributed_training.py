"""Distributed training: the reference workflow's two training stages (dense
pre-train, singular fine-tune) and the recovery, data-parallel over
``torch.distributed`` ranks, then pipeline-parallel whole-run inference.

Counterpart of ``examples/distributed_training.py``. The JAX script fakes
an N-device CPU mesh with ``--virtual N`` (an XLA flag); here ``--ranks N``
spawns N processes (``parallel.mesh.launch``), ``--backend`` names the
collectives (``nccl``: one card a rank; ``gloo``: the CPU, or several ranks
on one card for the dp stages) and ``--device`` where each rank computes.
One rank runs in this process, in a one-rank group. Every rank runs the
same stages on its part and gets the same results; rank 0 prints:

1. ``fit_dp`` of a seeded dense stack on the surrogate DROPBEAR run;
2. factorize, ``finetune_dp`` (σ-only, Hoyer 0.01);
3. truncate at cutoff 0.05, ``finetune_reduced_dp``, ``predict_full_run``;
4. ``make_pipeline_inference`` of the reduced model over S stages (the
   largest S ≤ ranks that divides the layer count), chunks of 128 steps,
   held to ``max|pp − direct| < 1e-4``.

The batch rounds to a multiple of the world size (``fit_dp``'s contract).
``--tp`` shapes the mesh (dp = ranks / tp); every stage uses every rank.

    python -m svd_lstm_tpu_torch distributed [--quick] [--ranks N] [--tp 1] [--backend nccl|gloo] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from svd_lstm_tpu_torch import examples as ex

PP_TOL = 1e-4  # pipeline vs the direct whole-run prediction (the JAX script's assert)


def batch_for(world: int) -> int:
    """The JAX script's batch: 64, rounded to a multiple of the world size."""
    return 64 if 64 % world == 0 else world * max(1, 64 // world)


def _stages(dev, world: int, tp: int, units, cfg, pp_steps: int, ds) -> dict:
    """One rank's run of the four stages (see the module docstring)."""
    import torch

    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch import parallel as par

    mesh = par.make_mesh(dp=world // tp, tp=tp, device=dev)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"ranks: {world} x {dev.type} ({torch.distributed.get_backend()}), mesh dp={mesh.dp} tp={mesh.tp}")

    params = P.init_stacked_lstm(torch.Generator().manual_seed(0), 16, units, device=dev)
    res = par.fit_dp(params, ds.X_train, ds.y_train, mesh, cfg=cfg, verbose=True)
    say(f"dense dp-train: loss {res.history[0]:.4f} -> {res.history[-1]:.4f}")

    sparams = P.make_singular_model(res.params, merged_kernel=False)
    fres = par.finetune_dp(sparams, ds.X_train, ds.y_train, mesh,
                           factor_cfg=P.FactorConfig(hoyer=0.01), train_cfg=cfg, verbose=True)
    say(f"singular dp-finetune: loss {fres.history[-1]:.4f}")

    rmodel = P.make_reduced_model(fres.params, cutoff=0.05)
    rres = par.finetune_reduced_dp(rmodel, ds.X_train, ds.y_train, mesh, train_cfg=cfg)
    rmodel = rres.params
    say(f"reduced dp-recovery: loss {rres.history[0]:.4f} -> {rres.history[-1]:.4f}")
    pred = P.predict_full_run(rmodel, ds.X_test)
    say(f"reduced prediction finite: {np.isfinite(pred).all()}  ({pred.shape[0]} steps)")

    S = min(len(units), world)
    while len(units) % S:
        S -= 1
    T = min(ds.X_test.shape[1], pp_steps)
    pp_pred = par.make_pipeline_inference(mesh, n_stages=S, ct=128)(rmodel, ds.X_test[:, :T])
    err = float(np.max(np.abs(pp_pred[0, :, 0].cpu().numpy() - pred[:T])))
    say(f"pp inference ({S} stages, T={T}): max|pp - direct| = {err:.2e}")
    if not err < PP_TOL:
        raise AssertionError(f"pipeline inference {err:.2e} from the direct prediction (limit {PP_TOL})")
    return {"history": res.history, "finetune_history": fres.history,
            "recovery_history": rres.history, "prediction": pred, "pp_err": err, "stages": S,
            "T": T, "model": rmodel.cpu()}


def run(units, cfg, ds, pp_steps: int, ranks: int = 1, backend: str | None = None,
        device: str = "cuda", tp: int = 1) -> dict:
    """The four stages of a seeded dense stack of ``units`` trained with
    ``cfg`` on ``ds``, pipelined over ``pp_steps`` test steps at most, on
    ``ranks`` ranks (one: in this process). Returns rank 0's histories,
    prediction, pipeline error and reduced model (on the CPU). ``backend``
    defaults to nccl for a CUDA device, gloo for the CPU."""
    from svd_lstm_tpu_torch.parallel import mesh as pm

    dev = ex.device_of(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if ranks < 1 or ranks % tp:
        raise ValueError(f"--ranks {ranks} is not a positive multiple of --tp {tp}")
    args = (ranks, tp, tuple(units), cfg, pp_steps, ds)
    if ranks == 1:
        with pm.process_group(backend):
            return _stages(pm.rank_device(dev, 0, backend), *args)
    return pm.launch(_stages, ranks, backend, device, *args)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch distributed",
                                 description="dp training and pp inference over torch.distributed ranks.")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ranks", type=int, default=1, help="processes to spawn, one a rank (default 1)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel factor of the mesh")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collectives (default: nccl on the card, gloo on the CPU)")
    ex.add_device(ap)
    args = ap.parse_args(argv)

    from svd_lstm_tpu_torch.config import TrainConfig

    ds = ex.quick_dataset(duration=12.0, split_time=8.0)
    bs = batch_for(args.ranks)
    if args.quick:
        cfg = TrainConfig(num_windows=512, window_len=80, epochs=2, batch_size=bs)
        units, pp_steps = (40, 40), 1024
    else:
        cfg = TrainConfig(epochs=10, batch_size=bs)
        units, pp_steps = (40, 40, 40, 40), 8192
    return run(units, cfg, ds, pp_steps, ranks=args.ranks, backend=args.backend, device=args.device,
               tp=args.tp)


if __name__ == "__main__":
    main()
