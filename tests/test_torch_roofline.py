"""The H100 bounds of ``bench/roofline.py``: the work it counts against the
JAX package's counts, and the bounds of PERF.md's kernel table reproduced
to their printed digits (K1 4x30, K3, K5 bf16, K9 forward)."""

import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.bench import roofline as jroof
from svd_lstm_tpu_torch.bench import roofline as roof

T = 6656


@pytest.mark.parametrize("d,units", [(16, (30,) * 4), (16, (40,) * 4), (16, (512,) * 3), (5, (8, 12))])
def test_dense_macs_match_jax(d, units):
    assert roof.dense_step_cost(d, units, head_dim=0).macs == jroof.dense_step_cost(d, units).macs
    # the head adds n·out
    assert roof.dense_step_cost(d, units).macs == jroof.dense_step_cost(d, units).macs + units[-1]


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("d,units,r", [(16, (512,) * 3, 24), (16, (30,) * 4, 15), (16, (40,) * 4, 25)])
def test_reduced_macs_are_jax_less_the_identity_block(merged, d, units, r):
    """The JAX module counts the identity block of [I|C] as r·4n of work
    (merged) or r_g·n a gate (split); here it is a copy: each side counts
    r² (merged) or 4·r_g² (split) less."""
    got = roof.reduced_step_cost(d, units, [r] * len(units), merged=merged, head_dim=0).macs
    want = jroof.reduced_step_cost(d, units, [r] * len(units), merged=merged).macs
    identity = 2 * len(units) * (r * r if merged else 4 * r * r)
    assert got == want - identity


def test_reduced_step_cost_reads_per_gate_ranks_of_a_model():
    """Per-layer (input-side, recurrent-side) ranks of a split truncation
    count exactly the products its factors define (and their entries are
    the weights' bytes)."""
    m = P.make_reduced_model(P.make_singular_model(
        P.load_params("model_saves/pretrained_30units_v4_n1.5.npz", device="cpu"), merged_kernel=False), rank=15)
    cost = roof.reduced_step_cost(16, [l.units for l in m.layers], roof.layer_ranks(m), merged=False)
    factors = sum(p.numel() for l in m.layers for p in (*l.wB, *l.wC, *l.uB, *l.uC))
    assert cost.macs == factors + 30
    assert cost.weight_bytes == 4 * sum(p.numel() for p in m.parameters())


@pytest.mark.parametrize("B,T_,units", [(128, 200, (512,) * 3), (32, 200, (40,) * 4), (512, 200, (40,) * 4)])
def test_train_model_macs_match_jax(B, T_, units):
    ours = (roof.wide_train_step_cost if units[0] % 128 == 0 else roof.narrow_train_step_cost)(16, units, B, T_)
    theirs = (jroof.wide_train_step_cost if units[0] % 128 == 0 else jroof.narrow_train_step_cost)(
        16, units, B, T_)
    assert ours.macs_model == theirs.macs_model
    assert ours.macs_executed == 4 * ours.macs_model // 3  # z recomputed in every backward
    assert ours.floor_fraction(4.0) > ours.floor_fraction(2.5) > 0
    assert 0 < ours.mfu(400.0) < ours.mfu(250.0)


def test_train_costs_refuse_other_stacks():
    with pytest.raises(ValueError):
        roof.wide_train_step_cost(16, (512, 256), 128, 200)
    with pytest.raises(ValueError):
        roof.narrow_train_step_cost(16, (256,), 128, 200)


def test_bounds_reproduce_perf_md():
    """PERF.md §6's bound column, to its printed digits."""
    k1 = roof.dense_step_cost(16, (30,) * 4).call_bound(T)
    assert (round(k1["bound_ms"], 4), k1["bound_by"]) == (0.0054, "operations")
    k3 = roof.recurrence_step_cost(512).call_bound(T)
    assert (round(k3["bound_ms"], 4), k3["bound_by"]) == (0.2083, "operations")
    k5 = roof.recurrence_step_cost(512, B=256, dtype=torch.bfloat16).call_bound(128)
    assert (round(k5["bound_ms"], 4), k5["bound_by"]) == (0.0695, "operations")
    k9 = roof.bound(roof.lstm_macs(200, 128, [(512, 512)]), 0)
    assert (round(k9["bound_ms"], 4), k9["bound_by"]) == (1.6026, "operations")
    k3f = roof.recurrence_step_cost(512, dtype="bfloat16").call_bound(T)
    assert (round(k3f["bound_ms"], 4), k3f["bound_by"]) == (0.0210, "bytes")
    k2 = roof.reduced_recurrence_step_cost(512, (24,)).call_bound(T)
    assert (round(k2["bound_ms"], 4), k2["bound_by"]) == (0.0204, "bytes")


def test_call_bound_counts_each_input_and_output_once():
    """A K1 call over T steps: x, every parameter and the output, each
    once, and the products of the stack and the head (the rule the kernel
    table's bounds follow)."""
    m = P.load_params("model_saves/pretrained_30units_v4_n1.5.npz", device="cpu")
    cost = roof.dense_step_cost(16, (30,) * 4)
    moved = T * 16 * 4 + sum(p.numel() for p in m.parameters()) * 4 + T * 4
    assert T * cost.bytes + cost.weight_bytes == moved
    assert cost.call_bound(T) == roof.bound(T * cost.macs, moved)
    fast = roof.dense_step_cost(16, (30,) * 4, dtype="bfloat16")
    wide = sum(p.numel() for l in m.layers for p in (l.W, l.U))
    assert fast.weight_bytes == cost.weight_bytes - 2 * wide
    assert fast.compute_floor_us() == pytest.approx(cost.compute_floor_us() * 67 / 989)


def test_step_floor_and_report():
    cost = roof.dense_step_cost(16, (512,) * 3)
    assert cost.floor_us() == max(cost.compute_floor_us(), cost.bandwidth_floor_us())
    assert cost.stages == 3 and roof.reduced_step_cost(16, (512,) * 3, [24] * 3).stages == 6
    s = roof.report(cost, measured_us_per_step=6.07)
    assert "ns/step" in s and "the floor" in s
    with pytest.raises(ValueError):
        roof.bound(1, 1, "float16")
    assert roof.dtype_name(torch.float32) == "float32"
    np.testing.assert_allclose(roof.PEAK_FLOPS["bfloat16"] / roof.PEAK_FLOPS["float32"], 989 / 67)
