"""The plain reference of a stacked-LSTM regressor: forward, window-end loss,
and Adam, in plain PyTorch.

The cell is Keras's LSTM as the reference repository trains it
(dncoble/LSTM-acceleration-with-singular-value-decomposition,
``code/train_full_model_v4.py``): z = x·W + h·U + b with the gates in the
order i, f, g, o; i, f, o sigmoid, g tanh; c' = f·c + i·g; h' = o·tanh(c');
a Dense head on h. Weights are float tensors (W (d, 4n), U (n, 4n), b
(4n,)), head (w (n, out), b (out,)).

``precision`` says how every product is computed:

* ``"float64"``: the reference itself, every product and state in float64;
* ``"tf32"``: the control, float32 with each operand of every product
  rounded to TF32 (10 mantissa bits, to nearest) as the tensor cores round
  it, and the sums in float32: the precision one step below the float32
  with TF32 off that the configurations state.

Nothing here imports the program.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest (ties away
    from zero, as ``cvt.rna.tf32.f32``); the exponent is float32's."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with TF32 operands, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = g @ tf32_round(b).transpose(-1, -2)
        gb = (tf32_round(a).transpose(-1, -2) @ g) if b.requires_grad else None
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        if a.dim() > 2 and b.dim() == 2:  # (..., k) @ (k, m)
            return _TF32MatMul.apply(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], b.shape[1])
        return _TF32MatMul.apply(a, b)
    return a @ b


def cell_update(z: torch.Tensor, c: torch.Tensor):
    n = c.shape[-1]
    s = torch.sigmoid(z)
    i, f, o = s[..., :n], s[..., n:2 * n], s[..., 3 * n:]
    g = torch.tanh(z[..., 2 * n:3 * n])
    c = f * c + i * g
    return o * torch.tanh(c), c


def stack_forward(layers, head, x: torch.Tensor, precision: str, sequences: bool = True):
    """x (B, T, d) -> (B, T, out), or (B, out) at the last step only when
    ``sequences`` is False. ``layers``: [(W, U, b)], ``head``: (w, b), all in
    the dtype of ``precision``. Layer by layer: the input side of every step
    in one product, then the time loop."""
    h_seq = x
    for W, U, b in layers:
        B, T, _ = h_seq.shape
        n = U.shape[0]
        xp = matmul(h_seq, W, precision) + b
        h = torch.zeros(B, n, dtype=x.dtype, device=x.device)
        c = torch.zeros_like(h)
        hs = []
        for t in range(T):
            h, c = cell_update(xp[:, t] + matmul(h, U, precision), c)
            hs.append(h)
        h_seq = torch.stack(hs, dim=1)
    w, hb = head
    if not sequences:
        return matmul(h_seq[:, -1], w, precision) + hb
    return matmul(h_seq, w, precision) + hb


@torch.no_grad()
def predict(layers, head, x: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """Whole-run prediction of each of the B sequences of x (B, T, d), in
    ``precision``; weights and x are cast to its dtype here."""
    dt = dtype_of(precision)
    layers = [tuple(p.to(dt) for p in l) for l in layers]
    head = tuple(p.to(dt) for p in head)
    return stack_forward(layers, head, x.to(dt), precision)


def train_steps(layers, head, batches, lr: float, precision: str = "float64",
                betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """Adam on the window-end MSE, one step a batch of ``batches`` [(x (B,
    T, d), y (B,))], from the given weights. Returns ``{"losses": [...],
    "first_grads": {leaf: tensor}, "params": {leaf: tensor}, "start":
    {leaf: tensor}}``: each step's loss, the gradient of the first step,
    and the leaves before and after the steps. Leaves are named
    ``layers.<i>.W|U|b`` and ``head.w|b``."""
    dt = dtype_of(precision)
    names, params = [], []
    for i, l in enumerate(layers):
        for key, p in zip(("W", "U", "b"), l):
            names.append(f"layers.{i}.{key}")
            params.append(p.detach().to(dt).clone().requires_grad_(True))
    for key, p in zip(("w", "b"), head):
        names.append(f"head.{key}")
        params.append(p.detach().to(dt).clone().requires_grad_(True))
    start = {k: p.detach().clone() for k, p in zip(names, params)}
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first = [], None
    b1, b2 = betas
    for step, (x, y) in enumerate(batches, start=1):
        L = len(layers)
        model_layers = [tuple(params[3 * i:3 * i + 3]) for i in range(L)]
        pred = stack_forward(model_layers, tuple(params[3 * L:]), x.to(dt), precision,
                             sequences=False)[:, 0]
        loss = torch.mean(torch.square(pred - y.to(dt)))
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = mi / (1 - b1 ** step)
                vhat = vi / (1 - b2 ** step)
                p.sub_(lr * mhat / (vhat.sqrt() + eps))
    return {"losses": losses, "first_grads": first,
            "params": {k: p.detach() for k, p in zip(names, params)}, "start": start}
