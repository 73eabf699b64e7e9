"""The FLOP and byte counts against hand counts."""
import json
from pathlib import Path

from benchmark import flops

# code 2 + xyz 3 = 5 inputs; hidden 8 (narrowed to 3 before the layer that
# takes the input again) and 4; one output
TINY = {"code_length": 2, "network_specs": {"dims": [8, 4], "latent_in": [1]},
        "encoder_specs": {"per_point_feat": [6, 3]}}


def test_decoder_layers_narrow_before_the_input_is_fed_again():
    assert flops.decoder_layers(TINY) == [(5, 3), (8, 4), (4, 1)]


def test_forward_counts_every_product_and_the_std_head():
    # 2 (5*3 + 8*4 + 4*1) + 2*4 (std head on the last hidden layer)
    assert flops.decoder_fwd_flops(TINY) == 110


def test_gradient_flows_back_to_xyz_only():
    # layer 0: xyz columns 2*3*3; layer 1: hidden part 2*3*4 and the xyz
    # columns fed again 2*3*4; layer 2: 2*4*1
    assert flops.decoder_grad_flops(TINY) == 110 + 18 + 24 + 24 + 8


def test_encoder_per_point():
    assert flops.encoder_flops(TINY) == 2 * (6 * 3 + 3 * 2)


def test_bytes_read_and_written_once():
    params = (5 * 3 + 3) + (8 * 4 + 4) + (4 * 1 + 1) + (4 + 1)
    assert flops.decode_grad_bytes(TINY, 10) == 4 * (10 * (5 + 1 + 1 + 3) + params)
    assert flops.decode_fwd_bytes(TINY, 10) == 4 * (10 * (5 + 2) + params)


def test_the_prior_matches_the_kernel_table_counts():
    hyper = json.loads((Path(__file__).resolve().parents[2]
                        / "di-checkpoints/study_mixed/hyper.json").read_text())
    # kernel 1 at 8192 points: 1.49 GFLOP; kernel 3 at 2^20 sites: 103.6 GFLOP
    assert abs(8192 * flops.decoder_grad_flops(hyper) - 1.495e9) < 1e6
    assert abs((1 << 20) * flops.decoder_fwd_flops(hyper) - 1.036e11) < 1e8


def test_roofline_share_is_bound_over_time():
    peaks = {"tf32_flops_per_s": 100.0, "bytes_per_s": 10.0}
    # 200 flops -> 2 s, 10 bytes -> 1 s: bound 2 s a launch, two in 8 s
    assert flops.roofline_share([(200, 10), (200, 10)], peaks, 8.0) == 50.0
