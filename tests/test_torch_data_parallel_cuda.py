"""chip_smoke.py phase 26 on the card, one test for each part: (a) main.py
under the env triplet at world 1 over NCCL, (b) two gloo ranks on one card
against one process, (c) a CcGAN iteration on two ranks, (d) the native
dataset cache gathered into pinned memory, (e) the folded upsample. Each
needs an NVIDIA card and skips without one; this file imports no JAX (run
them with `python -m pytest tests/test_torch_data_parallel_cuda.py -m cuda`
on the card)."""

import pytest
import torch


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the phase drives the CUDA kernels and NCCL")
    import chip_smoke

    return chip_smoke, torch.device("cuda"), torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_world_1_over_nccl():
    chip_smoke, device, card = _card()
    record = chip_smoke.data_parallel_path(device, card, {}, parts=("world1",))
    assert record["world1"]["backend"] == "nccl"
    assert record["world1"]["max_abs_diff"] <= record["world1"]["bound"]


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["two_ranks", "ccgan"])
def test_two_ranks_on_one_card(part):
    chip_smoke, device, card = _card()
    record = chip_smoke.data_parallel_path(device, card, {}, parts=(part,))
    assert record[part]["ranks_equal"]


@pytest.mark.cuda
def test_native_gather_into_pinned_memory():
    chip_smoke, device, card = _card()
    record = chip_smoke.data_parallel_path(device, card, {}, parts=("native",))
    assert record["native_gather"]["exact"] and record["native_gather"]["mirror"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["conv3", "conv2x3"])
def test_folded_upsample(variant):
    chip_smoke, device, _ = _card()
    record = {}
    chip_smoke.upsample_fold_check(device, record, variants=(variant,))
    fold = record["upsample_fold"]
    assert fold[variant]["max_abs_err"] <= fold["bound"]
