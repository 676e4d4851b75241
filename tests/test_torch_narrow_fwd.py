"""The narrow forward's launch rules (svd_lstm_tpu_torch/ops/cuda_train.py),
on the CPU, without a card.

The forward of K7 and K8 (``narrow_fwd_wave`` in ops/csrc/lstm_train.cu)
gives every unit a group of S lanes. The wrapper picks S
(``narrow_fwd_lanes``) and where the weights live (staged in shared memory,
``narrow_fwd_smem_bytes``, or K7's copy ``pack_gates`` in global memory)
and passes both to the launcher, which only checks them. These tests hold
the rules to their promises:

* the block stays within 1024 threads for every stack K7 admits (at most 8
  layers, every width and the input at most 128);
* the repo's stacks and the edge stacks of the card tests get the lane
  count and weight home the card tests name for them;
* K8's forward needs no more shared memory than K8's first backward,
  whose size is its route rule (``compact_smem_bytes``, ``compact_fits``),
  so no stack changes route;
* K7's gate-interleaved copy of the weights (``pack_gates``) inverts
  exactly to the Keras layout.
"""

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.ops.cuda_lstm import _SMEM_LIMIT


def _stacks(rng, count, max_layers, max_units):
    """Uniform stacks of every depth and width, then random uneven ones."""
    for L in range(1, max_layers + 1):
        for n in range(1, max_units + 1):
            yield [n] * L
    for _ in range(count):
        yield list(rng.integers(1, max_units + 1, size=rng.integers(1, max_layers + 1)))


def test_lane_rule_keeps_the_block_within_1024_threads():
    """Also: S ≤ 2 (more than 256 units) never goes with staged weights,
    which would need over 240 KB (61 477 floats at the least, over 8 layers)."""
    rng = np.random.default_rng(0)
    for units in _stacks(rng, 1000, ct.MAX_LAYERS, ct.NARROW_MAX):
        for d in (1, 16, 57, ct.NARROW_MAX):
            lanes = ct.narrow_fwd_lanes(units, d)
            threads = ct.narrow_fwd_threads(units, d, lanes)
            assert lanes in (1, 2, 4, 8)
            assert lanes * sum(units) <= threads <= ct.FWD_MAX_THREADS == 1024, (units, d)
            assert threads >= ct.NARROW_ROWS * d  # one thread for each entry of x_t
            if lanes < 8:  # the next larger S would not fit
                assert ct.narrow_fwd_threads(units, d, 2 * lanes) > 1024, (units, d)
            if lanes <= 2:
                assert ct.narrow_fwd_smem_bytes(units, d, staged=True) > _SMEM_LIMIT, (units, d)


# (units, d, S, staged): every lane count and weight home the rule reaches
RULE_CASES = [
    ((40, 40, 40, 40), 16, 4, True),      # run A (K7) and K8's 4x40: 640 threads
    ((30, 30, 30, 30), 16, 8, True),      # the dense view of run E's 4x30 r = 15: 960
    ((8, 12, 5), 16, 8, True),
    ((128,) * 8, 128, 1, False),          # the largest K7 stack: 1024 threads
    ((100,) * 4, 16, 2, False),           # 800 threads
    ((128, 30), 128, 4, False),           # 640 threads
    ((128,), 128, 8, False),              # 1024 threads
]


@pytest.mark.parametrize("units,d,lanes,staged", RULE_CASES)
def test_lane_rule_at_the_repo_shapes(units, d, lanes, staged):
    assert ct.narrow_fwd_lanes(units, d) == lanes
    assert (ct.narrow_fwd_smem_bytes(units, d, staged=True) <= _SMEM_LIMIT) == staged
    assert ct.narrow_fwd_smem_bytes(units, d, staged) <= _SMEM_LIMIT


def test_k8_forward_needs_no_more_shared_memory_than_its_backward():
    """Over a grid of stacks that compact_fits admits. The forward holds x_t
    twice (one step's barrier separates its store and its reads), the
    backward once: where d > 20·max(n) the forward may exceed the backward
    by at most 12·d bytes and stays far inside the limit."""
    rng = np.random.default_rng(1)
    checked = 0
    for units in _stacks(rng, 1000, ct.MAX_LAYERS, ct.COMPACT_MAX_UNITS):
        for d in (1, 3, 16, 40, 100, ct.NARROW_MAX):
            if not ct.compact_fits(units, d):
                continue
            fwd = ct.narrow_fwd_smem_bytes(units, d, staged=True)
            bwd = ct.compact_smem_bytes(units, d)
            assert fwd <= _SMEM_LIMIT, (units, d)
            if d <= 20 * max(units):
                assert fwd <= bwd, (units, d, fwd, bwd)
            else:
                assert fwd <= bwd + 12 * d, (units, d, fwd, bwd)
            checked += 1
    assert checked > 5_000
    # the repo's K8 stacks: 195 072 B (4x40) and 112 832 B (4x30)
    assert ct.narrow_fwd_smem_bytes([40] * 4, 16, True) == 195_072 < ct.compact_smem_bytes([40] * 4, 16)
    assert ct.narrow_fwd_smem_bytes([30] * 4, 16, True) == 112_832 < ct.compact_smem_bytes([30] * 4, 16)


@pytest.mark.parametrize("din,n", [(16, 40), (40, 40), (128, 30), (3, 1)])
def test_pack_gates_inverts_to_keras(din, n):
    rng = np.random.default_rng(din * 1000 + n)
    W = torch.tensor(rng.normal(size=(din, 4 * n)), dtype=torch.float32)
    U = torch.tensor(rng.normal(size=(n, 4 * n)), dtype=torch.float32)
    P = ct.pack_gates(W, U)
    assert P.shape == (din + n, n, 4) and P.is_contiguous()
    assert torch.equal(P[:din].transpose(1, 2).reshape(din, 4 * n), W)
    assert torch.equal(P[din:].transpose(1, 2).reshape(n, 4 * n), U)
    # one float4 gives unit j's four gates at input k
    k, j = din - 1, n - 1
    assert torch.equal(P[k, j], W[k, [j, n + j, 2 * n + j, 3 * n + j]])
