"""``onet_cbn``: Occupancy Networks' conditional-batch-norm decoder
(``DecoderCBatchNorm``, Mescheder et al., CVPR 2019, arXiv:1812.03828;
github.com/autonomousvision/occupancy_networks im2mesh/onet/models/decoder.py
and im2mesh/layers.py) with z_dim 0, the code c the voxel's latent, and
DI-Fusion's probabilistic output in place of the occupancy logit:

    net = fc_p(xyz)
    net = net + fc_1(relu(CBN_{2i+1}(fc_0(relu(CBN_{2i}(net, c))), c)))
    h = relu(CBN_last(net, c))
    sdf = tanh(fc_out(h)),  std = 0.05 + 0.5 softplus(uncertainty(h))

with CBN_j(x, c) = (W_g c + b_g) * (x - mean) / sqrt(var + eps) + (W_b c +
b_b), BN's running statistics as stored (the inference form), evaluated
here unfolded, every row conditioned on its own code.  The raw weights:
``decoder.fc_p.{w,b}``, ``decoder.blocks#<i>.fc_0.{w,b}`` and ``.fc_1``,
``decoder.cbn#<j>.{gamma_w, gamma_b, beta_w, beta_b, mean, var}``,
``decoder.fc_out`` and ``decoder.uncertainty``; linears ``w`` (out, in).

Work: the trunk's matrix products a point, counted once.  The conditioning
(2 x (2 blocks + 1) products of hidden x code) depends on the code alone;
the port computes it once a voxel or block, so it is left out of the
per-point counts, which then under-count an export's work by under 0.1%
(2.88 MFLOP a block against ~5.4 GFLOP of trunk over its 4,096 sites at
r = 8, the published widths).
"""
from __future__ import annotations

import numpy as np
import torch

F32 = 4
BN_EPS = 1e-5


def build(w, hyper: dict, lin, tensors):
    def linear(prefix):
        return tensors(w[f"{prefix}.w"].astype(np.float64), w[f"{prefix}.b"].astype(np.float64))

    n_blocks = 0
    while f"decoder.blocks#{n_blocks}.fc_0.w" in w:
        n_blocks += 1
    fc_p = linear("decoder.fc_p")
    blocks = [(linear(f"decoder.blocks#{i}.fc_0"), linear(f"decoder.blocks#{i}.fc_1"))
              for i in range(n_blocks)]
    cbn = []
    for j in range(2 * n_blocks + 1):
        p = f"decoder.cbn#{j}"
        cbn.append((tensors(w[f"{p}.gamma_w"], w[f"{p}.gamma_b"]),
                    tensors(w[f"{p}.beta_w"], w[f"{p}.beta_b"]),
                    tensors(w[f"{p}.mean"], w[f"{p}.var"])))
    fc_out = linear("decoder.fc_out")
    unc = linear("decoder.uncertainty")

    def decode(latent: torch.Tensor, xyz: torch.Tensor):
        """(N, L), (N, 3) -> sdf (N,), std (N,)."""
        def cbn_j(j, x):
            (gw, gb), (bw, bb), (mean, var) = cbn[j]
            return lin(latent, gw, gb) * ((x - mean) / torch.sqrt(var + BN_EPS)) \
                + lin(latent, bw, bb)
        net = lin(xyz, *fc_p)
        for i, (fc_0, fc_1) in enumerate(blocks):
            a = lin(torch.relu(cbn_j(2 * i, net)), *fc_0)
            net = net + lin(torch.relu(cbn_j(2 * i + 1, a)), *fc_1)
        h = torch.relu(cbn_j(2 * n_blocks, net))
        sdf = torch.tanh(lin(h, *fc_out))[:, 0]
        std = 0.05 + 0.5 * torch.nn.functional.softplus(lin(h, *unc))[:, 0]
        return sdf, std

    return decode


def widths(hyper: dict):
    """(code L, hidden H, residual blocks NB)."""
    spec = hyper.get("network_specs") or {}
    return (int(hyper["code_length"]), int(spec.get("hidden_size", 256)),
            int(spec.get("n_blocks", 5)))


def fwd_flops(hyper: dict) -> int:
    """One point's trunk forward: fc_p (3 -> H), two H x H products a
    block, and the two heads on h."""
    _, H, NB = widths(hyper)
    return 2 * (3 * H + 2 * NB * H * H + 2 * H)


def grad_flops(hyper: dict) -> int:
    """The forward plus d sdf / d xyz: back through the sdf head, both
    products of every block, and into xyz along fc_p's 3 columns (the std
    head and the code held constant, as the tracker does)."""
    _, H, NB = widths(hyper)
    return fwd_flops(hyper) + 2 * (H + 2 * NB * H * H + 3 * H)


def cond_flops(hyper: dict) -> int:
    """One code's conditioning: each CBN's gamma and beta maps (H x L)."""
    L, H, NB = widths(hyper)
    return 2 * (2 * NB + 1) * 2 * H * L


def param_bytes(hyper: dict) -> int:
    """Every weight, bias and running statistic."""
    L, H, NB = widths(hyper)
    nc = 2 * NB + 1
    return F32 * ((3 * H + H) + NB * 2 * (H * H + H) + nc * (2 * (H * L + H) + 2 * H)
                  + 2 * (H + 1))


def fwd_point_floats(hyper: dict) -> int:
    """A site's row index and xyz in, sdf and std out (its code's
    conditioning is read from the per-code table, counted per code)."""
    return 1 + 3 + 2


def grad_point_floats(hyper: dict) -> int:
    """A point's row index and xyz in, sdf, std and the xyz gradient out."""
    return 1 + 3 + 1 + 1 + 3


def cond_row_floats(hyper: dict) -> int:
    """One code's conditioning call: the code in, every CBN's (gamma',
    beta') out."""
    L, H, NB = widths(hyper)
    return L + (2 * NB + 1) * 2 * H
