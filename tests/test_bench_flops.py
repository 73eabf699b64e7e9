"""The benchmark's work counts at DeepSDF's published widths against hand
counts, and the reader of kernel 3's device time an extract."""
import json
from pathlib import Path
from types import SimpleNamespace

from benchmark import flops
from benchmark.run import load_reader

ROOT = Path(__file__).resolve().parents[1]


def test_published_widths_count_as_the_hand_count():
    """DeepSDF's layers (259, 512), (512, 512) x 2, (512, 253), (512, 512) x 4,
    (512, 1): forward 2 x 1,835,520 multiply-adds + 2 x 512 (the std head)
    = 3,672,064 FLOP a point; the gradient to xyz 3,146,752 more (every
    layer's hidden width back, the xyz columns at layers 0 and 4) =
    6,818,816: 55.9 GFLOP at the 8192-point budget, 3.85 TFLOP a 2^20-site
    dispatch."""
    hyper = json.loads((ROOT / "di-checkpoints/deepsdf_mixed/hyper.json").read_text())
    assert flops.decoder_layers(hyper) == [(259, 512), (512, 512), (512, 512), (512, 253),
                                           (512, 512), (512, 512), (512, 512), (512, 512),
                                           (512, 1)]
    assert flops.decoder_fwd_flops(hyper) == 3_672_064
    assert flops.decoder_grad_flops(hyper) == 6_818_816
    peaks = {"tf32_flops_per_s": 495e12, "bytes_per_s": 3.35e12}
    n = 1 << 20
    assert abs(flops.bound_s(n * 3_672_064, flops.decode_fwd_bytes(hyper, n), peaks)
               - 7.78e-3) < 1e-5
    assert abs(flops.bound_s(8192 * 6_818_816, flops.decode_grad_bytes(hyper, 8192), peaks)
               - 112.9e-6) < 1e-7


class _Trace:
    def __init__(self, recs):
        self.recs = recs

    def kernel_time(self, part):
        hits = [s for name, s in self.recs if part in name]
        return len(hits), sum(hits)


def test_decode_fwd_ms_reads_kernel_3_an_extract():
    """Every launch whose name holds decode_fwd_kernel (either instance),
    over the traced window's extracts; nothing to read, no number."""
    read = load_reader("decode_fwd_ms")
    trace = _Trace([("decode_fwd_kernel_wide<256, 512, 8, 4>", 0.03),
                    ("decode_fwd_kernel(float const*)", 0.01),
                    ("mc_emit_kernel", 0.5)])
    assert abs(read(SimpleNamespace(trace=trace, counts={"extracts": 2})) - 20.0) < 1e-9
    assert read(SimpleNamespace(trace=_Trace([]), counts={"extracts": 2})) is None
    assert read(SimpleNamespace(trace=trace, counts={})) is None


PIGAN = {"code_length": 256, "network_name": "pigan_film",
         "network_specs": {"hidden_dim": 256, "n_layers": 8, "mapping_hidden_dim": 256}}


def test_pigan_widths_count_as_the_hand_count():
    """pi-GAN's FiLM-SIREN at latent_dim 256, hidden_dim 256, eight FiLM
    layers and a 256-wide mapping: forward 3 x 256 + 7 x 256 x 256 + 2 x 256
    multiply-adds = 920,064 FLOP a point; the gradient to xyz 256 + 7 x 256
    x 256 + 3 x 256 more = 1,839,616 (15.1 GFLOP at the 8192-point budget);
    the mapping 256 x 256 + 2 x 256 x 256 + 256 x 4,096 a code = 2,490,368,
    with the code in and 4,096 floats out."""
    fam = flops.decoders.load(PIGAN)
    assert flops.decoder_fwd_flops(PIGAN) == 920_064
    assert flops.decoder_grad_flops(PIGAN) == 1_839_616
    assert fam.cond_flops(PIGAN) == 2_490_368
    assert fam.cond_row_floats(PIGAN) == 256 + 4096
    assert abs(8192 * flops.decoder_grad_flops(PIGAN) - 15.07e9) < 0.01e9
    # weights: mapping 1,250,048 + trunk 461,568 + heads 514 floats (6.85 MB)
    assert flops.decoder_param_bytes(PIGAN) == 4 * (1_250_048 + 461_568 + 514)


def test_film_map_readers_read_the_mapping_kernel():
    """film_map_ms.export / .frame: the launches whose name holds
    film_map_kernel over the window's extracts / frames; film_map_roofline:
    the extracts' live blocks' mapping work over that time; no launch, no
    number (the parent, or another family)."""
    trace = _Trace([("film_map_kernel<256, 256, 8, 256>", 0.002),
                    ("cbn_cond_kernel<256, 256, 5>", 0.5)])
    export = load_reader("film_map_ms.export")
    frame = load_reader("film_map_ms.frame")
    assert abs(export(SimpleNamespace(trace=trace, counts={"extracts": 4})) - 0.5) < 1e-9
    assert abs(frame(SimpleNamespace(trace=trace, frames=lambda: 100)) - 0.02) < 1e-9
    empty = SimpleNamespace(trace=_Trace([]), counts={"extracts": 4}, frames=lambda: 100)
    assert export(empty) is None and frame(empty) is None
    roof = load_reader("film_map_roofline")
    ctx = SimpleNamespace(trace=trace, counts={"extracts": 4}, flops=flops, hyper=PIGAN,
                          driver=SimpleNamespace(blocks=lambda: 4700),
                          peaks={"tf32_flops_per_s": 495e12, "bytes_per_s": 3.35e12})
    rows = 4 * 4700   # the bytes bound it: 4,352 floats a row against 2.49 MFLOP
    want = 100 * max(rows * 2_490_368 / 495e12, rows * 4 * 4352 / 3.35e12) / 0.002
    assert abs(roof(ctx) - want) < 1e-6 * want
    assert roof(SimpleNamespace(**{**vars(ctx), "trace": _Trace([])})) is None
