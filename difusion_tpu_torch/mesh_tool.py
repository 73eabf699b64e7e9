"""Offline mesh extraction from a saved map snapshot, dense or hash-indexed
(counterpart of difusion_tpu/mesh_tool.py): load the map, extract every
observed block at a higher resolution and triangle budget than the
interactive run.

Usage:
    python -m difusion_tpu_torch.mesh_tool map.npz out.ply \\
        --hyper di-checkpoints/study_mixed/hyper.json --epoch 300 \\
        --resolution 8 [--max-std 0.15] [--max-triangles 10000000] \\
        [--no-interpolate] [--fast [--refine-fraction 0.2]] [--shard] [--device cpu]

Runs on the card unless ``--device cpu`` is given.  ``--fast`` decodes
coarse-to-fine (~3x fewer decoder evaluations at r = 8).  ``--shard``
spreads each decode chunk over every visible card (one card, or the CPU:
the unsharded extract, as the JAX tool on one device).
"""
from __future__ import annotations

import argparse
import logging

from .core import hash_map as HM
from .core import map as M
from .core.meshing import HashMeshExtractor, MeshExtractor
from .models.weights import load_prior


def main(argv=None):
    parser = argparse.ArgumentParser(description="difusion-tpu offline mesher (PyTorch)")
    parser.add_argument("map", help="map .npz written by SLAMSystem.save_map")
    parser.add_argument("output", help="output mesh (.ply or .obj)")
    parser.add_argument("--hyper", required=True, help="prior hyper.json")
    parser.add_argument("--epoch", type=int, default=300)
    parser.add_argument("--resolution", type=int, default=8)
    parser.add_argument("--max-std", type=float, default=2000.0)
    parser.add_argument("--max-triangles", type=int, default=int(1e7))
    parser.add_argument("--no-interpolate", action="store_true")
    parser.add_argument("--fast", action="store_true",
                        help="coarse-to-fine lattice evaluation: ~3x fewer "
                             "decoder evaluations at r=8")
    parser.add_argument("--refine-fraction", type=float, default=0.2,
                        help="--fast: the fraction of a block's (2r)^3 sites "
                             "decoded exactly")
    parser.add_argument("--shard", action="store_true",
                        help="shard the decoder lattice evaluation over all "
                             "visible cards (multi-card offline meshing)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    dec, _, _ = load_prior(args.hyper, args.epoch, device=args.device)
    cfg, state = M.load_map(args.map, device=args.device)
    mesher_cls = HashMeshExtractor if isinstance(cfg, HM.HashMapConfig) else MeshExtractor
    mesher = mesher_cls(cfg, dec, voxel_resolution=args.resolution,
                        max_triangles=args.max_triangles,
                        interpolate=not args.no_interpolate, fast=args.fast,
                        refine_fraction=args.refine_fraction, shard=args.shard)
    mesher.extract(state, max_std=args.max_std, no_cache=True)
    tris, _ = mesher.triangles()
    logging.info("extracted %d triangles at resolution %d", len(tris), args.resolution)
    if args.output.endswith(".obj"):
        mesher.write_obj(args.output)
    else:
        mesher.write_ply(args.output)
    print(f"{args.output}: {len(tris)} triangles")
    return mesher


if __name__ == "__main__":
    main()
