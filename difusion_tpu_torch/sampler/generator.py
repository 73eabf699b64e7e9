"""LIF training-data generator (counterpart of difusion_tpu/sampler/generator.py;
parity with pytorch/dataset/training/main_generator.py and the mesh providers
in shapenet_model.py / simple_shape.py).

    python -m difusion_tpu_torch.sampler.generator configs/data-simple.yaml [--device cpu]

Differences from the reference, by design:

* The CUDA sampler subprocess (main_generator.py:36-52) is an in-process call
  to :mod:`.sampler`, whose visibility and kNN passes run on the card; the
  per-mesh ``.cam`` / ``.raw`` / ``.surf`` temp-file dance disappears.
* Mesh providers build primitives with :mod:`.mesh_io` instead of Open3D.
* The voxel split (:func:`split_into_lifs`) is host-side offline tooling:
  cube range queries through scipy cKDTree with the L-inf metric (the
  reference uses sklearn chebyshev radius_neighbors, main_generator.py:90-98).
"""
from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..utils.motion import Isometry
from . import mesh_io
from .sampler import (SamplerConfig, equidist_points_on_sphere,
                      generate_mesh_samples)


class ShapeNetGenerator:
    """ShapeNetCore.v2 provider (reference shapenet_model.py:11-78)."""

    def __init__(self, shapenet_path, categories, shapes_per_category, scale,
                 valid_list_path: Optional[str] = None, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.data_sources: List[Path] = []
        self.data_scales: List[float] = []
        valid = {}
        if valid_list_path and Path(valid_list_path).exists():
            valid = json.loads(Path(valid_list_path).read_text()).get("ShapeNetV2", {})
        for cat, count, cat_scale in zip(categories, shapes_per_category, scale):
            cat_path = Path(shapenet_path) / cat
            objs = valid.get(cat) or sorted(p.name for p in cat_path.iterdir())
            if count != -1:
                objs = list(rng.choice(objs, size=count, replace=False))
            self.data_sources += [cat_path / o for o in objs]
            self.data_scales += [cat_scale] * len(objs)

    def __len__(self):
        return len(self.data_sources)

    def get_source(self, idx):
        return str(self.data_sources[idx])

    def __getitem__(self, idx):
        obj_path = self.data_sources[idx] / "models" / "model_normalized.obj"
        cams = [Isometry.look_at(p, np.zeros(3))
                for p in equidist_points_on_sphere(300)]
        # (window-half, zmin, zmax) ortho intrinsics (shapenet_model.py:74)
        return str(obj_path), (0.8, cams), self.data_scales[idx]

    def clean(self, idx):
        pass


class SimpleShapeGenerator:
    """Random box/sphere/cylinder provider (reference simple_shape.py:8-117),
    built on :mod:`.mesh_io` primitives instead of Open3D."""

    def __init__(self, n_shapes: int, seed: int = 0):
        self.n_shapes = n_shapes
        self.rng = np.random.default_rng(seed)
        self.translation_range = (-0.5, 0.5)
        self.scale_range = (0.1, 1.5)
        self.kinds = self.rng.integers(0, 3, size=n_shapes)
        self._cache = {}

    def __len__(self):
        return self.n_shapes

    def get_source(self, idx):
        return ["Cube", "Sphere", "Cylinder"][self.kinds[idx]]

    def _build(self, idx) -> mesh_io.TriMesh:
        rng = self.rng
        lo, hi = self.scale_range
        kind = self.kinds[idx]
        if kind == 0:
            mesh = mesh_io.make_box(rng.uniform(lo, hi), rng.uniform(lo, hi),
                                    rng.uniform(lo, hi))
            center = (mesh.vertices.min(0) + mesh.vertices.max(0)) / 2
            mesh = mesh_io.TriMesh(mesh.vertices - center, mesh.faces)
        elif kind == 1:
            mesh = mesh_io.make_sphere(0.5, resolution=40)
            s = np.diag(rng.uniform(lo, hi, 3)).astype(np.float32)
            mesh = mesh_io.TriMesh((mesh.vertices @ s).astype(np.float32), mesh.faces)
        else:
            mesh = mesh_io.make_cylinder(0.5, 1.0, resolution=60)
            s = np.diag(rng.uniform(lo, hi, 3)).astype(np.float32)
            mesh = mesh_io.TriMesh((mesh.vertices @ s).astype(np.float32), mesh.faces)
        tf = Isometry.random(rng)
        tf.t = rng.uniform(*self.translation_range, size=3)
        return mesh.transformed(tf.matrix.astype(np.float32))

    def __getitem__(self, idx):
        mesh = self._build(idx)
        self._cache[idx] = mesh
        lo, hi = mesh.bounds()
        center = (lo + hi) / 2
        cam_scale = max(float(np.linalg.norm(hi - center)) * 1.1, 0.8)
        cams = [Isometry.look_at(p * cam_scale + center, center)
                for p in equidist_points_on_sphere(100)]
        return mesh, (cam_scale, cams), 1.0

    def clean(self, idx):
        self._cache.pop(idx, None)


class HeightFieldGenerator:
    """Random smooth height-field sheets: a data-free corpus of gently
    curved OPEN surfaces -- the local geometry a depth camera actually sees
    indoors (walls, floors, curved sheets), which the closed
    box/sphere/cylinder corpus under-represents.  No reference counterpart
    (the reference's only data-free provider is simple_shape.py); the
    payload/acceptance format is identical to the other providers, so
    height-field datasets mix freely with them in a trainer ``train_set``.

    Each sheet is a sum of ``n_waves`` random low-frequency sinusoids over
    an ``extent`` x ``extent`` grid, randomly oriented.  The sampler's
    z-buffer visibility and 11-vote kNN sign handle open sheets exactly as
    they handle real scan crops (front/back views see opposite signs from
    the face normals' consistent winding)."""

    def __init__(self, n_shapes: int, seed: int = 0, extent: float = 2.4,
                 grid: int = 56, n_waves: int = 4):
        self.n_shapes = n_shapes
        self.seed = seed
        self.extent = extent
        self.grid = grid
        self.n_waves = n_waves
        self._cache = {}

    def __len__(self):
        return self.n_shapes

    def get_source(self, idx):
        return "HeightField"

    def _build(self, idx) -> mesh_io.TriMesh:
        rng = np.random.default_rng((self.seed, idx))
        g, e = self.grid, self.extent
        lin = np.linspace(-e / 2, e / 2, g, dtype=np.float32)
        xx, yy = np.meshgrid(lin, lin, indexing="ij")
        zz = np.zeros_like(xx)
        for _ in range(self.n_waves):
            fx, fy = rng.uniform(0.4, 3.0, 2)        # cycles over the sheet
            px, py = rng.uniform(0.0, 2.0 * np.pi, 2)
            amp = rng.uniform(0.02, 0.18)
            zz += amp * np.sin(2 * np.pi * fx * xx / e + px) \
                      * np.cos(2 * np.pi * fy * yy / e + py)
        v = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
        i = np.arange(g * g, dtype=np.int32).reshape(g, g)
        quad = np.stack([i[:-1, :-1], i[1:, :-1], i[1:, 1:], i[:-1, 1:]],
                        -1).reshape(-1, 4)
        faces = np.concatenate([quad[:, [0, 1, 2]],
                                quad[:, [0, 2, 3]]]).astype(np.int32)
        tf = Isometry.random(rng)
        tf.t = rng.uniform(-0.3, 0.3, size=3)
        return mesh_io.TriMesh(v, faces).transformed(
            tf.matrix.astype(np.float32))

    def __getitem__(self, idx):
        mesh = self._build(idx)
        self._cache[idx] = mesh
        lo, hi = mesh.bounds()
        center = (lo + hi) / 2
        cam_scale = max(float(np.linalg.norm(hi - center)) * 1.1, 0.8)
        cams = [Isometry.look_at(p * cam_scale + center, center)
                for p in equidist_points_on_sphere(100)]
        return mesh, (cam_scale, cams), 1.0

    def clean(self, idx):
        self._cache.pop(idx, None)


def split_into_lifs(data_arr: np.ndarray, surface_arr: np.ndarray,
                    voxel_size: float, nn_size: float = 2.0):
    """Partition SDF/surface sample clouds into per-voxel LIF payloads.

    Yields ``(vox_min, vox_max, data, surface)`` per accepted voxel.  The
    acceptance rules and payload format are interchange requirements shared
    with the reference generator (main_generator.py:85-135): a candidate
    voxel (one containing at least one SDF sample) is kept when it has >= 50
    strictly-inside samples and >= 50 nearby surface points, and its
    positive-SDF fraction is informative (within [0.1, 0.9]); the payload
    gathers everything within a chebyshev radius of ``nn_size/2`` voxels and
    rescales coordinates and SDF to voxel-local units.  The cube range
    queries run through one scipy cKDTree per cloud (L-inf metric).
    """
    from scipy.spatial import cKDTree

    centers = np.unique(np.ceil(data_arr[:, :3] / voxel_size) - 1.0, axis=0)
    centers = (centers + 0.5) * voxel_size
    tree_data = cKDTree(data_arr[:, :3])
    tree_surf = cKDTree(surface_arr[:, :3])
    reach = voxel_size * nn_size / 2.0
    gathered = tree_data.query_ball_point(centers, r=reach, p=np.inf)
    inside = tree_data.query_ball_point(centers, r=0.5 * voxel_size, p=np.inf)
    near_surf = tree_surf.query_ball_point(centers, r=reach, p=np.inf)

    for center, g_idx, in_idx, s_idx in zip(centers, gathered, inside,
                                            near_surf):
        if len(in_idx) < 50 or len(s_idx) < 50:
            continue
        block = data_arr[np.asarray(g_idx, np.int64)].copy()
        frac_pos = np.mean(block[:, 3] > 0)
        if not (0.1 <= frac_pos <= 0.9):
            continue
        surf = surface_arr[np.asarray(s_idx, np.int64)].copy()
        block[:, :3] = (block[:, :3] - center) / voxel_size
        block[:, 3] /= voxel_size
        surf[:, :3] = (surf[:, :3] - center) / voxel_size
        half = 0.5 * voxel_size
        yield center - half, center + half, block, surf


def generate_samples(idx: int, args, provider, output_base: Path,
                     source_list: list, sampler_cfg: SamplerConfig,
                     rng: np.random.Generator, device="cuda") -> int:
    """Per-mesh pipeline (reference generate_samples,
    main_generator.py:20-156): sample SDF data, split into per-voxel LIFs
    with count/ratio filters, normalize to voxel-local coords, write npz.
    Returns the number of LIFs written."""
    mesh_or_path, (half_window, cams), sampler_mult = provider[idx]
    mesh = (mesh_or_path if isinstance(mesh_or_path, mesh_io.TriMesh)
            else mesh_io.load_mesh(mesh_or_path))

    data_arr, surface_arr = generate_mesh_samples(mesh, cams, half_window,
                                                  sampler_cfg, rng, device=device)
    provider.clean(idx)
    if len(data_arr) == 0:
        return 0
    data_arr = data_arr * np.array([sampler_mult] * 3 + [sampler_mult], np.float32)
    surface_arr[:, :3] *= sampler_mult

    payload_dir = output_base / "payload"
    n_written = 0
    for vox_min, vox_max, block, surf in split_into_lifs(
            data_arr, surface_arr, args.voxel_size,
            getattr(args, "nn_size", 2.0)):
        lif_id = len(source_list)
        source_list.append([provider.get_source(idx), idx, n_written])
        np.savez(payload_dir / ("%08d.npz" % lif_id),
                 min=vox_min, max=vox_max, data=block, surface=surf)
        n_written += 1
    return n_written


def run_generation(args, sampler_cfg: Optional[SamplerConfig] = None,
                   device="cuda") -> int:
    """Dataset-level loop (main_generator.py:160-207).  ``args`` follows
    the reference data-shapenet.yaml surface (provider/provider_kwargs/output/
    sampler_count/sampler_var/voxel_size/nn_size).  The sampler's passes run
    on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    providers = {
        "simple_shape": SimpleShapeGenerator,
        "shapenet_model": ShapeNetGenerator,
        "height_field": HeightFieldGenerator,
    }
    provider = providers[args.provider](**args.provider_kwargs)
    output_path = Path(args.output)
    if output_path.exists():
        shutil.rmtree(output_path)
    (output_path / "payload").mkdir(parents=True)

    if sampler_cfg is None:
        sampler_cfg = SamplerConfig(
            reference_method=int(getattr(args, "sample_method", 1)),
            num_sample=int(getattr(args, "sampler_count", 500000)),
            variance=float(getattr(args, "sampler_var", 0.005)))

    rng = np.random.default_rng(getattr(args, "seed", 4))
    source_list: list = []
    for idx in range(len(provider)):
        n = generate_samples(idx, args, provider, output_path, source_list,
                             sampler_cfg, rng, device=device)
        logging.info("mesh %d (%s): %d LIFs (total %d)", idx,
                     provider.get_source(idx), n, len(source_list))
        # flush the index after EVERY mesh: generation is hours-long on a
        # slow host, and an interrupted run with a fresh source.json is a
        # usable (smaller) dataset instead of a loss (the reference writes
        # it once at the end, main_generator.py:204-205, and loses the run)
        (output_path / "source.json").write_text(json.dumps(source_list,
                                                            indent=2))
    return len(source_list)


def main(argv=None):
    from ..config import ArgumentParserX
    logging.basicConfig(level=logging.INFO)
    parser = ArgumentParserX(add_hyper_arg=True,
                             description="difusion-tpu LIF data generator (PyTorch)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = args.device
    del args.device
    return run_generation(args, device=device)


if __name__ == "__main__":
    main()
