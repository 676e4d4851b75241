"""Seeded weights of a configuration that has no committed checkpoint.

Made on the device from the seed, with one ``torch.Generator`` there and one
draw for all of them, in float32 (the type they are served in): every
kernel, W (d, 4n), U (n, 4n) and the head's w (n, out), Glorot-uniform over
its whole shape as Keras draws W; biases zero but the forget gate's, 1
(Keras ``unit_forget_bias``). U is Glorot-uniform too, not Keras's
orthogonal: every singular value of an orthogonal block is 1, so a
truncation to a rank would keep an arbitrary subspace, where trained
weights have a spread of singular values for it to choose from.

The program and the reference are each given their own copy of the same
numbers.
"""

from __future__ import annotations

import math

import torch


def seeded_dense(config: dict, seed: int, device) -> tuple:
    """``(layers, head)``: [(W, U, b)] and (w, b), float32 on ``device``."""
    shapes, d = [], config["input_dim"]
    for n in config["units"]:
        shapes += [(d, 4 * n), (n, 4 * n)]
        d = n
    shapes.append((d, config["head_dim"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(a * b for a, b in shapes), generator=gen, device=device,
                      dtype=torch.float32)
    mats, off = [], 0
    for rows, cols in shapes:
        limit = math.sqrt(6.0 / (rows + cols))
        mats.append((flat[off:off + rows * cols].view(rows, cols) * 2 - 1) * limit)
        off += rows * cols
    layers = []
    for i, n in enumerate(config["units"]):
        b = torch.zeros(4 * n, dtype=torch.float32, device=device)
        b[n:2 * n] = 1.0
        layers.append((mats[2 * i].contiguous(), mats[2 * i + 1].contiguous(), b))
    head = (mats[-1].contiguous(), torch.zeros(config["head_dim"], dtype=torch.float32, device=device))
    return layers, head
