"""The benchmark's operation and byte counts against hand counts."""

import pytest

from perfbench.counts import lm, peaks, resnet


def test_lm_forward_flops_by_hand():
    # B 2, T 4, 1 layer, d 8, V 10: 2 * 8 tokens * (10*8 + 12*64) + 2*16*8
    assert lm.forward_flops(2, 4, 1, 8, 10) == 2 * 8 * (80 + 768) + 1 * 2 * 2 * 16 * 8
    assert lm.train_flops(2, 4, 1, 8, 10) == 3 * lm.forward_flops(2, 4, 1, 8, 10)


def test_flash_counts_by_hand():
    # B 1, T 3, H 2, D 4, bf16: causal pairs 2 * (1 + 2 + 3) = 12
    assert lm.causal_pairs(1, 2, 3) == 12
    f, b = lm.flash_forward(1, 3, 2, 4, 2)
    assert f == 2 * 4 * 12 * 2           # QK^T and PV
    act = 1 * 3 * 2 * 4 * 2              # one [B, T, H, D] bf16 tensor
    assert b == 4 * act + 1 * 2 * 3 * 4  # q k v o, f32 row statistics
    f, b = lm.flash_backward(1, 3, 2, 4, 2)
    assert f == 2 * 4 * 12 * 5
    assert b == 8 * act + 1 * 2 * 3 * 4  # q k v o dO in, dq dk dv out
    least = lm.flash_step_least_s(1, 3, 2, 4, 2, layers=3)
    assert least == pytest.approx(3 * (
        peaks.least_s(*lm.flash_forward(1, 3, 2, 4, 2))
        + peaks.least_s(*lm.flash_backward(1, 3, 2, 4, 2))))


def test_paged_counts_by_hand():
    f, b = lm.paged_step([5, 7], heads=2, head_dim=4, kv_esize=2)
    assert f == 4.0 * 4 * 2 * (5 + 7)
    assert b == 2 * (5 + 7) * 2 * 4 * 2 + 2 * 2 * 2 * 4 * 2


def test_least_time_takes_the_larger_bound():
    assert peaks.least_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_s(0, 3.35e12) == pytest.approx(1.0)


def _resnet50_by_hand():
    """Layer-by-layer multiply-adds of ResNet-50 v1 (stride on the first
    1x1 of a block) on one 224x224 image, 1000 classes."""
    macs = 64 * 3 * 7 * 7 * 112 * 112          # stem, 112x112 out
    hw, c_in = 56, 64                          # after the 3x3/2 pool
    for i, (n, w) in enumerate(zip([3, 4, 6, 3], [64, 128, 256, 512])):
        for b in range(n):
            s = 2 if (b == 0 and i > 0) else 1
            out = hw // s
            if b == 0:
                macs += 4 * w * c_in * out * out   # projection shortcut
            macs += w * c_in * out * out           # 1x1, strided
            macs += w * w * 9 * out * out          # 3x3
            macs += 4 * w * w * out * out          # 1x1 up
            hw, c_in = out, 4 * w
    return macs + 2048 * 1000                  # fc


def test_resnet50_program_macs_match_the_layer_by_layer_sum():
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import resnet as model

    from perfbench.drivers.fluid_image_train import image_program

    main, _, _, _ = image_program(
        fluid, lambda x, k: model.resnet_imagenet(x, k, depth=50),
        [3, 224, 224], 1000, True, 0.01, 0.9)
    got = resnet.program_macs(main.global_block())
    assert got == _resnet50_by_hand()
    # the published v1 figure is about 3.9 GMACs a 224x224 image
    assert 3.8e9 < got < 4.0e9
    assert resnet.train_flops_per_image(got) == 6 * got
