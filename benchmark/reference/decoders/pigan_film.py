"""``pigan_film``: pi-GAN's FiLM-SIREN generator (Chan et al., "pi-GAN:
Periodic Implicit Generative Adversarial Networks for 3D-Aware Image
Synthesis", CVPR 2021, arXiv:2012.00926; github.com/marcoamonteiro/pi-GAN
siren/siren.py: ``CustomMappingNetwork``, ``FiLMLayer``, ``TALLSIREN``),
with the code z the voxel's latent:

    m = W_3 lrelu(W_2 lrelu(W_1 lrelu(W_0 z + b_0) + b_1) + b_2) + b_3
    f, phi = m[:NL H], m[NL H:];  gamma_i = 15 f_i + 30,  beta_i = phi_i
    h_0 = 2 xyz;  h_{i+1} = sin(gamma_i (W_i h_i + b_i) + beta_i)
    sdf = tanh(fc_out(h_NL)),  std = 0.05 + 0.5 softplus(uncertainty(h_NL))

(lrelu's slope 0.2; f_i, phi_i the i-th H-wide slices), evaluated here
unfolded, every row mapped from its own code.  Departures from pi-GAN,
each in the configuration's ``assumed`` too: the output is DI-Fusion's
probabilistic SDF read off the last FiLM layer (the sdf and std heads of
``di_decoder`` and ``onet_cbn``) in place of pi-GAN's density; its colour
branch (``color_layer_sine`` on the ray direction, and the mapping's ninth
slice) is dropped, so the mapping outputs 2 x NL x H; the input is the
voxel-local point through pi-GAN's ``UniformBoxWarp`` with a side of one
voxel (x' = 2 xyz); the code comes from the encoder with no noise prior;
the prior is trained with the NLL and code regularisation, not
adversarially.  The raw weights: ``decoder.mapping#<k>.{w,b}`` (k = 0 ..
3), ``decoder.film#<i>.{w,b}``, ``decoder.fc_out`` and
``decoder.uncertainty``; linears ``w`` (out, in).

Work: the trunk's matrix products a point, counted once.  The mapping
depends on the code alone; the port computes it once a voxel or block, so
it is left out of the per-point counts (``cond_flops`` counts it a code):
2.49 MFLOP a block against ~3.8 GFLOP of trunk over its 4,096 sites at r =
8, the published widths, under 0.1%.
"""
from __future__ import annotations

import numpy as np
import torch

F32 = 4
LRELU = 0.2
FREQ_SCALE, FREQ_SHIFT = 15.0, 30.0
WARP = 2.0


def widths(hyper: dict):
    """(code L, hidden H, FiLM layers NL, mapping hidden MH)."""
    spec = hyper.get("network_specs") or {}
    return (int(hyper["code_length"]), int(spec.get("hidden_dim", 256)),
            int(spec.get("n_layers", 8)), int(spec.get("mapping_hidden_dim", 256)))


def build(w, hyper: dict, lin, tensors):
    _, H, NL, _ = widths(hyper)

    def linear(prefix, rows=slice(None)):
        return tensors(w[f"{prefix}.w"][rows], w[f"{prefix}.b"][rows])

    mapping = [linear(f"decoder.mapping#{k}") for k in range(3)]
    # the last mapping layer by slice: layer i's f rows, then its phi rows
    last = [(linear("decoder.mapping#3", slice(i * H, (i + 1) * H)),
             linear("decoder.mapping#3", slice((NL + i) * H, (NL + i + 1) * H)))
            for i in range(NL)]
    film = [linear(f"decoder.film#{i}") for i in range(NL)]
    fc_out = linear("decoder.fc_out")
    unc = linear("decoder.uncertainty")

    def decode(latent: torch.Tensor, xyz: torch.Tensor):
        """(N, L), (N, 3) -> sdf (N,), std (N,)."""
        a = latent
        for Wb in mapping:
            a = torch.nn.functional.leaky_relu(lin(a, *Wb), LRELU)
        h = WARP * xyz
        for i, Wb in enumerate(film):
            f_i, phi_i = last[i]
            gamma = FREQ_SCALE * lin(a, *f_i) + FREQ_SHIFT
            h = torch.sin(gamma * lin(h, *Wb) + lin(a, *phi_i))
        sdf = torch.tanh(lin(h, *fc_out))[:, 0]
        std = 0.05 + 0.5 * torch.nn.functional.softplus(lin(h, *unc))[:, 0]
        return sdf, std

    return decode


def fwd_flops(hyper: dict) -> int:
    """One point's trunk forward: the first FiLM layer (3 -> H), NL - 1
    products of H x H, and the two heads on h_NL."""
    _, H, NL, _ = widths(hyper)
    return 2 * (3 * H + (NL - 1) * H * H + 2 * H)


def grad_flops(hyper: dict) -> int:
    """The forward plus d sdf / d xyz counted once, as a reverse pass: back
    through the sdf head, the NL - 1 products, and into xyz along the first
    layer's 3 columns (the std head and the code held constant)."""
    _, H, NL, _ = widths(hyper)
    return fwd_flops(hyper) + 2 * (H + (NL - 1) * H * H + 3 * H)


def cond_flops(hyper: dict) -> int:
    """One code's mapping: L x MH, two MH x MH, and MH x (2 NL H)."""
    L, H, NL, MH = widths(hyper)
    return 2 * (L * MH + 2 * MH * MH + MH * 2 * NL * H)


def param_bytes(hyper: dict) -> int:
    """Every weight and bias of the mapping, the trunk and the heads."""
    L, H, NL, MH = widths(hyper)
    mapping = (L * MH + MH) + 2 * (MH * MH + MH) + (MH * 2 * NL * H + 2 * NL * H)
    trunk = (3 * H + H) + (NL - 1) * (H * H + H)
    return F32 * (mapping + trunk + 2 * (H + 1))


def fwd_point_floats(hyper: dict) -> int:
    """A site's row index and xyz in, sdf and std out (its code's
    modulation is read from the per-code table, counted per code)."""
    return 1 + 3 + 2


def grad_point_floats(hyper: dict) -> int:
    """A point's row index and xyz in, sdf, std and the xyz gradient out."""
    return 1 + 3 + 1 + 1 + 3


def cond_row_floats(hyper: dict) -> int:
    """One code's mapping call: the code in, every layer's (gamma, beta)
    out."""
    L, H, NL, _ = widths(hyper)
    return L + 2 * NL * H
