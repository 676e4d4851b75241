"""The yardstick's counts of model FLOPs and bytes against hand counts: the
model's own form, whatever route runs it, and no recompute."""

import pytest

from benchmark.core import cell as cells
from benchmark.counts import lstm as counts


def config(name: str) -> dict:
    return cells.load_json(cells.HERE / "configs" / f"{name}.json")


# multiply-adds of one batch-1 step, counted by hand:
# * 3x512 dense: (16 + 512)·2048 + 2·(512 + 512)·2048 + 512 (head)
# * 3x512 merged r = 24 (layer 0's input side at 16): 16·16 + 16·2032, then
#   512·24 + 24·2024 for each of the five other sides, + 512
# * 4x40 dense: (16 + 40)·160 + 3·(40 + 40)·160 + 40
# * 4x40 split r = 25 a gate (layer 0's input side at 16): 4·(16·16 + 16·24),
#   then 4·(40·25 + 25·15) for each of the seven other sides, + 40
@pytest.mark.parametrize("name,form,macs", [
    ("wide_3x512", "dense", 5_276_160),
    ("wide_3x512", "reduced", 337_600),
    ("dropbear_4x40", "dense", 47_400),
    ("dropbear_4x40", "reduced", 41_100),
])
def test_step_macs(name, form, macs):
    assert counts.step_macs(config(name), form) == macs


def test_reduced_4x40_counts_its_own_form_not_the_dense_reconstruction():
    # the program runs this model through its dense reconstruction (K1); the
    # yardstick still counts the two-step form
    call = counts.predict_call(config("dropbear_4x40"), "reduced", 6656)
    assert call["flops"] == 2 * 6656 * 41_100


@pytest.mark.parametrize("form,ms", [("reduced", 4.4943e9 / 67e9), ("dense", 7.0236e10 / 67e9)])
def test_predict_call_bound(form, ms):
    # compute-bound: 2·T·macs over 67 TFLOP/s (0.067 and 1.048 ms)
    call = counts.predict_call(config("wide_3x512"), form, 6656)
    assert call["bound_s"] * 1e3 == pytest.approx(ms, rel=1e-4)
    assert call["bound_s"] == call["flops"] / counts.PEAK_FLOPS["float32"]


def test_predict_call_bytes():
    # frames in, predictions out, each weight of the form once (4x40 split
    # r = 25: the 41 060 entries of B and C, 4·160 biases, the head's 41)
    call = counts.predict_call(config("dropbear_4x40"), "reduced", 100)
    assert call["bytes"] == 4 * (100 * 16 + 100 * 1 + 41_060 + 640 + 41)


def test_train_step_is_three_forwards():
    step = counts.train_step(config("wide_3x512"), 128, 200)
    macs = 3 * (128 * 200 * 5_275_648 + 128 * 512)
    assert macs == pytest.approx(4.05e11, rel=1e-3)
    assert step["flops"] == 2 * macs
    params = 5_275_648 + 3 * 2048 + 513
    assert counts.parameter_count(config("wide_3x512")) == params
    # windows and labels read once; parameters and Adam's two moments read and written
    assert step["bytes"] == 4 * (128 * 200 * 16 + 128 + 6 * params)
    assert step["bound_s"] == pytest.approx(2 * macs / 67e12)
