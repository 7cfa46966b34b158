"""The work counts of ``perfbench/counts`` against counts made by hand."""

import json

import pytest

from conftest import ROOT
from perfbench.counts import tts

CSMSC_DECODER = {"upsample_rates": [6, 5, 5, 2], "upsample_kernel_sizes": [12, 11, 11, 4],
                 "upsample_initial_channel": 512, "resblock_kernel_sizes": [3, 7, 11],
                 "resblock_dilation_sizes": [[1, 3, 5]] * 3}


def test_resblock_layer_by_hand():
    # B=2, T=10, C=8, k=3: two convs of 3 taps, 8 -> 8, over 20 frames: 2 * 3 * 64 * 20 MACs each
    flops, nbytes = tts.resblock_layer(2, 10, 8, 3)
    assert flops == 2 * (2 * 3 * 8 * 8 * 20)
    # x read and y written (2 x 160 floats), two kernels of 3 x 8 x 8 and their biases
    assert nbytes == 4 * (2 * 160 + 2 * (192 + 8))


def test_snap_and_statistics_by_hand():
    # N=5 rows, H=2 heads of d=3 against K=4 codewords
    flops, nbytes = tts.snap(5, 2, 3, 4)
    assert flops == 2 * 5 * 2 * 3 * 4 + 3 * 5 * 2 * 4  # x.e products; |e|^2 add, 2x, compare per distance
    assert nbytes == 4 * (30 + 24 + 30 + 10)  # x read, codebook read, codewords and indices written
    flops_s, nbytes_s = tts.snap_stats(5, 4, 2, 3, 4)
    assert flops_s == flops + 4 * 2 * (2 * 3 + 1)  # each valid row adds its count and its d sums a head
    assert nbytes_s == nbytes + 4 * (5 + 2 * 4 + 2 * 3 * 4)  # the mask read, counts and sums written


def test_mrf_layers_of_one_decode():
    layers = tts.mrf_layers(CSMSC_DECODER, 4, 512)
    assert len(layers) == 36
    assert {(T, C) for _, T, C, _ in layers} == {(3072, 256), (15360, 128), (76800, 64), (153600, 32)}


def test_36_layers_give_chip_smokes_bound():
    """The MRF layers of one batch of 4 at 512 frames: three TF32 passes at
    495 TFLOP/s is chip_smoke.py's 5.65 ms bound, one pass 1.88 ms."""
    flops = sum(tts.resblock_layer(*layer)[0] for layer in tts.mrf_layers(CSMSC_DECODER, 4, 512))
    assert 3 * flops / tts.PEAK_FLOPS * 1e3 == pytest.approx(5.65, abs=0.005)
    assert flops / tts.PEAK_FLOPS * 1e3 == pytest.approx(1.88, abs=0.005)
    t, kind = tts.least_s(flops, 0)
    assert kind == "operations" and t == pytest.approx(1.883e-3, rel=1e-3)


def test_request_counts_scale_with_the_request_and_not_the_batch():
    task = json.loads((ROOT / "perfbench" / "configs" / "csmsc_tts.json").read_text())["program"]["task"]
    one = tts.request_flops(task, 72, 288)
    assert tts.request_flops(task, 72, 576) > 1.9 * one  # frames dominate: the decoder
    dec = tts.decoder_flops(dict(task["autoencoder"]["decoder_config"], num_mels=256), 288)
    assert 0.5 * one < dec < one
    snaps = tts.predict_batch_snaps(task, 16, 512)
    assert [s[0] for s in snaps] == [tts.snap(16 * 128, 4, 64, 64)[0]] * 2 + [tts.snap(16 * 512, 4, 64, 64)[0]] * 2
