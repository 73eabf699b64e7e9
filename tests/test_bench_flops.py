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
