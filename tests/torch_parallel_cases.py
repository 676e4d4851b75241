"""The rank side of the port's parallel CPU tests (tests/test_torch_parallel*.py,
tests/test_torch_pipeline.py).

Spawned ranks import this module by name, so it imports neither JAX nor the
JAX package: a rank starts in a second or two. :func:`run_cases` is the one
function a test file launches (``parallel.mesh.launch``, gloo on the CPU):
every rank builds the meshes the cases ask for, runs every case, and
returns a dict of numpy results; the test compares them with the JAX
package's and with the port's own single-process runs.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch import parallel as par
from svd_lstm_tpu_torch.train.loop import default_apply_fn


def fit_data():
    """The data of tests/test_parallel_fit.py: a (1, 96, 6) run and its
    targets."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(1, 96, 6)).astype(np.float32),
            rng.normal(size=(96,)).astype(np.float32))


def example_dataset():
    """tests/test_torch_examples.py's cut of the surrogate run for the
    example scripts: 1.2 s to 3 s, split at 2.2 s."""
    from svd_lstm_tpu_torch import examples as ex
    from svd_lstm_tpu_torch.data import Dataset

    full = ex.quick_dataset(duration=4.5, split_time=2.2)
    keep, tr, te = full.t >= 1.2, full.t_train >= 1.2, full.t_test >= 1.2
    return Dataset(X=full.X[:, keep], y=full.y[keep], t=full.t[keep], X_train=full.X_train[:, tr],
                   y_train=full.y_train[tr], t_train=full.t_train[tr], X_test=full.X_test[:, te],
                   y_test=full.y_test[te], t_test=full.t_test[te], pin_scaler=full.pin_scaler,
                   acc_scaler=full.acc_scaler)


def seeded(seed: int):
    return torch.Generator().manual_seed(seed)


def leaves(model) -> list:
    """A port model's parameters as numpy arrays, in ``named_parameters``
    order (the JAX tree's leaf order for every family)."""
    return [p.detach().cpu().numpy().copy() for p in model.parameters()]


def _result(r) -> dict:
    return {"history": list(r.history), "val_history": list(r.val_history),
            "rollbacks": r.rollbacks, "params": leaves(r.params)}


# ---------------------------------------------------------------------------
# the cases: (mesh, *args) -> a picklable result
# ---------------------------------------------------------------------------

def case_fit(mesh, model, X, y, cfg, kw=None):
    return _result(par.fit_dp(model, X, y, mesh, cfg=cfg, **(kw or {})))


def case_finetune(mesh, smodel, X, y, fcfg, tcfg):
    return _result(par.finetune_dp(smodel, X, y, mesh, factor_cfg=fcfg, train_cfg=tcfg))


def case_finetune_reduced(mesh, rmodel, X, y, tcfg):
    return _result(par.finetune_reduced_dp(rmodel, X, y, mesh, train_cfg=tcfg))


def case_raises(mesh, model, X, y, cfg):
    try:
        par.fit_dp(model, X, y, mesh, cfg=cfg)
    except ValueError as e:
        return str(e)
    return None


def case_checkpoint(mesh, model, X, y, cfg, path):
    r = par.fit_dp(model, X, y, mesh, cfg=cfg, validation=(X, y),
                   checkpoint_path=path.format(rank=mesh.rank))
    return _result(r)


def case_sharded_step(mesh, model, x, y, lr, steps):
    """``steps`` sharded Adam steps; the losses and the unsharded model."""
    local = par.shard_params_for_mesh(model, mesh)
    opt = torch.optim.Adam(local.parameters(), lr=lr)
    step = par.make_sharded_train_step(mesh, opt)
    losses = [step(local, x, y) for _ in range(steps)]
    return {"losses": losses, "params": leaves(par.unshard_params_from_mesh(local, mesh)),
            "local": leaves(local)}


def case_dp_step(mesh, model, x, y, lr, steps):
    model = copy.deepcopy(model).to(mesh.device)  # the cases of a rank share their inputs
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = par.make_dp_train_step(mesh, opt, P.stacked_lstm_apply)
    losses = [step(model, x, y) for _ in range(steps)]
    return {"losses": losses, "params": leaves(model)}


def case_dp_finetune_step(mesh, smodel, x, y, fcfg, lr, steps):
    smodel = copy.deepcopy(smodel).to(mesh.device)
    step, _ = par.make_dp_finetune_step(mesh, smodel, fcfg, lr)
    losses = [step(smodel, x, y) for _ in range(steps)]
    return {"losses": losses, "params": leaves(smodel)}


def case_batched(mesh, model, x):
    run = par.make_batched_inference(mesh, default_apply_fn(model))
    try:
        return run(model.to(mesh.device), x).cpu().numpy()
    except ValueError as e:
        return str(e)


def case_batched_fast(mesh, model, x):
    run = par.make_batched_fast_inference(mesh)
    return run(model.to(mesh.device), x).cpu().numpy()


def case_pipeline(mesh, model, x, n_stages, ct, return_sequences=True):
    try:
        run = par.make_pipeline_inference(mesh, n_stages=n_stages, ct=ct,
                                          return_sequences=return_sequences)
        return run(model.to(mesh.device), x).cpu().numpy()
    except ValueError as e:
        return str(e)


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


def run_cases(device, cases: list) -> dict:
    """Every case of ``cases``, ``(key, mesh (dp, tp), case name, args)``, on
    this rank; the meshes are built once each, in the order they first
    appear (the same on every rank). Returns ``{key: result}``."""
    meshes = {}
    for _, shape, _, _ in cases:
        if shape not in meshes:
            meshes[shape] = par.make_mesh(*shape, device=device)
    return {key: CASES[name](meshes[shape], *args) for key, shape, name, args in cases}
