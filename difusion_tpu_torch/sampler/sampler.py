"""SDF training-sample generation (counterpart of
difusion_tpu/sampler/sampler.py, which re-expresses the reference's CUDA
sampler, pytorch/sampler_cuda/PreprocessMesh.cu).

* Visibility is a scatter-min z-buffer over candidate surface samples: every
  candidate is projected into every virtual (orthographic) camera, a batch of
  cameras at a time, and kept when it wins, or nearly wins, its pixel's depth
  race after a 3x3 min-pool that wraps around the border (``torch.roll``, as
  the JAX package's ``jnp.roll``).
* The SDF of a query is the 11-vote sign test against the visible-surface
  cloud, NaN where the votes disagree (ComputeSDFKernel,
  PreprocessMesh.cu:136-185).  The 11 nearest neighbours come from
  ``||q||^2 + ||r||^2 - 2 q.r`` distances (``torch.matmul``, f32: the entry
  points turn TF32 off) over ``REF_TILE`` columns of the cloud at a time,
  with a running top-11.  Ties go to the lowest index, as ``jax.lax.top_k``
  and the JAX package's tile merge give them: ``torch.topk`` promises no
  order among equal values, so the selection sorts its candidates by
  (distance, index) (:func:`_smallest`).
* Triangle sampling and the query draws stay numpy, so that one numpy seed
  gives both packages the same points.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .mesh_io import TriMesh


def equidist_points_on_sphere(samples: int) -> np.ndarray:
    """Fibonacci spiral (reference shapenet_model.py:44-58)."""
    i = np.arange(samples, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - (i / float(samples - 1)) * 2
    radius = np.sqrt(1 - y * y)
    theta = phi * i
    return np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius], axis=1)


def sample_on_triangles(mesh: TriMesh, n: int, rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-CDF triangle sampling (SamplePointKernel, PreprocessMesh.cu:92-134).
    Returns (points (n, 3), face_ids (n,))."""
    areas = mesh.face_areas()
    cdf = np.cumsum(areas)
    u = rng.random(n) * cdf[-1]
    tri = np.searchsorted(cdf, u).clip(0, len(areas) - 1)
    a = mesh.vertices[mesh.faces[tri, 0]]
    b = mesh.vertices[mesh.faces[tri, 1]]
    c = mesh.vertices[mesh.faces[tri, 2]]
    r1 = rng.random((n, 1))
    r2 = rng.random((n, 1))
    wa = 1.0 - np.sqrt(r1)
    wb = (1.0 - wa) * (1.0 - r2)
    wc = r2 * (1.0 - wa)
    return (wa * a + wb * b + wc * c).astype(np.float32), tri.astype(np.int32)


# ---------------------------------------------------------------------------
# Visibility (z-buffer over candidate samples)
# ---------------------------------------------------------------------------


def _visible_pass(points: torch.Tensor, cam_R: torch.Tensor, cam_t: torch.Tensor,
                  half_window: float, res: int) -> torch.Tensor:
    """One camera batch: project the (N, 3) points orthographically into each
    camera's (res, res) grid, scatter-min the depth, and flag the points
    within eps of their pixel's pooled winner.  cam_R (C, 3, 3), cam_t
    (C, 3): world -> camera.  Returns (N,) bool, visible from any camera."""
    C = cam_R.shape[0]
    p_cam = torch.einsum("cij,nj->cni", cam_R, points) + cam_t[:, None, :]
    # a 0-d device tensor: CUDA divides by a host scalar as a product by its
    # reciprocal, the JAX package by true division
    hw = torch.full((), float(half_window), device=points.device)
    u = (p_cam[..., 0] / hw * 0.5 + 0.5) * res
    v = (p_cam[..., 1] / hw * 0.5 + 0.5) * res
    z = p_cam[..., 2]
    ui = torch.clamp(u.to(torch.int32), 0, res - 1)
    vi = torch.clamp(v.to(torch.int32), 0, res - 1)
    inside = (u >= 0) & (u < res) & (v >= 0) & (v < res) & (z > 0)
    pix = (vi * res + ui).to(torch.int64)                     # (C, N)
    zsafe = torch.where(inside, z, torch.inf)
    flat = pix + torch.arange(C, device=pix.device)[:, None] * (res * res)
    zbuf = torch.full((C * res * res,), torch.inf, dtype=z.dtype, device=z.device)
    zbuf.scatter_reduce_(0, flat.reshape(-1), zsafe.reshape(-1), "amin")
    # candidates are point samples, not rasterized triangles: a 3x3 min-pool
    # fills pixel-scale gaps so that interior points cannot win an empty pixel
    zimg = zbuf.view(C, res, res)
    pooled = zimg
    for dv in (-1, 0, 1):
        for du in (-1, 0, 1):
            pooled = torch.minimum(pooled, torch.roll(zimg, (dv, du), dims=(1, 2)))
    winner = torch.gather(pooled.reshape(C, res * res), 1, pix)
    eps = 1e-3 + 0.002 * torch.abs(z)
    visible = inside & (z <= winner + eps)
    return visible.any(dim=0)


def visible_surface_samples(mesh: TriMesh, cameras: list, half_window: float,
                            n_candidates: int, rng: np.random.Generator,
                            res: int = 400, cam_batch: int = 25, device="cuda"
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Surface points and face normals visible from at least one virtual
    camera (the reference's FBO harvesting, Utils.cu:28-89).  ``cameras`` are
    camera-to-world Isometry poses looking at the object (+z forward, so
    camera z is depth), orthographic with window half-size ``half_window``.
    ``cam_batch`` cameras go through one pass (25 x 500,000 candidates: each
    (C, N) plane 50 MB)."""
    dev = resolve_device(device)
    pts, tri = sample_on_triangles(mesh, n_candidates, rng)
    normals = mesh.face_normals()[tri]
    R = np.stack([c.inv().q.rotation_matrix for c in cameras]).astype(np.float32)
    t = np.stack([c.inv().t for c in cameras]).astype(np.float32)
    pj = torch.from_numpy(pts).to(dev)
    Rj, tj = torch.from_numpy(R).to(dev), torch.from_numpy(t).to(dev)
    vis = torch.zeros(n_candidates, dtype=torch.bool, device=dev)
    for s in range(0, len(cameras), cam_batch):
        vis |= _visible_pass(pj, Rj[s:s + cam_batch], tj[s:s + cam_batch], half_window, res)
    vis = vis.cpu().numpy()
    return pts[vis], normals[vis]


# ---------------------------------------------------------------------------
# SDF via kNN voting
# ---------------------------------------------------------------------------


# columns of the reference cloud a distance pass holds: (Q, REF_TILE) f32 is
# the pass's live memory (8192 x 32768 x 4 B = 1 GiB)
REF_TILE = 32768
QUERY_CHUNK = 8192


def _lex_first(d: torch.Tensor, idx: torch.Tensor, k: int):
    """The k first of each row's (distance, index) pairs in lexicographic
    order (indices unique within a row)."""
    by_idx = torch.argsort(idx, dim=1)
    d, idx = d.gather(1, by_idx), idx.gather(1, by_idx)
    by_d = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return d.gather(1, by_d), idx.gather(1, by_d)


def _smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of d2 (Q, n) and their column
    indices, ordered by (distance, index): equal distances go to the lowest
    index.  ``topk`` takes 2k candidates; a row whose k-th and last candidate
    distances are equal may have left equal entries out, and goes through a
    stable sort of the whole row instead (equal f32 distances at that rank
    are rare, so this costs one check a pass)."""
    n = d2.shape[1]
    k = min(k, n)
    m = min(2 * k, n)
    v, i = torch.topk(d2, m, dim=1, largest=False, sorted=True)
    v, i = _lex_first(v, i, m)
    if m < n:
        bad = v[:, k - 1] == v[:, m - 1]
        if bool(bad.any()):
            rows = bad.nonzero()[:, 0]
            sv, si = torch.sort(d2[rows], dim=1, stable=True)
            v[rows, :k], i[rows, :k] = sv[:, :k], si[:, :k]
    return v[:, :k], i[:, :k]


def _sdf_chunk(q: torch.Tensor, ref_xyz: torch.Tensor, ref_normal: torch.Tensor,
               ref_norm2: torch.Tensor, stdv: float, max_ref_dist: float,
               num_votes: int) -> torch.Tensor:
    """SDF of one query chunk (Q, 3) against the reference cloud
    (ComputeSDFKernel semantics); NaN marks ambiguous sign votes.  The
    cloud's columns go REF_TILE at a time, the running top-k merged with
    each tile's own (the carry's lower indices first on ties)."""
    qn2 = torch.sum(q * q, dim=1)[:, None]                    # (Q, 1)
    best_d = best_i = None
    for s in range(0, ref_xyz.shape[0], REF_TILE):
        rx = ref_xyz[s:s + REF_TILE]
        d2 = qn2 + ref_norm2[None, s:s + REF_TILE] - 2.0 * q @ rx.T
        td, ti = _smallest(d2, num_votes)
        ti = ti + s
        if best_d is None:
            best_d, best_i = td, ti
        else:
            best_d, best_i = _lex_first(torch.cat([best_d, td], 1),
                                        torch.cat([best_i, ti], 1), num_votes)
    idx = best_i
    nb = ref_xyz[idx]                                         # (Q, K, 3)
    nn = ref_normal[idx]
    ray = q[:, None, :] - nb
    ray_len = torch.sqrt(torch.clamp(torch.sum(ray * ray, dim=-1), min=1e-30))
    d = torch.sum(nn * ray, dim=-1) / ray_len                 # (Q, K)
    num_pos = torch.sum(d > 0, dim=-1)
    first_len = ray_len[:, 0]
    proj = torch.abs(torch.sum(nn[:, 0] * ray[:, 0], dim=-1))
    sdf_abs = torch.where(first_len < stdv, proj, first_len)
    sdf = torch.where(num_pos == 0, -sdf_abs,
                      torch.where(num_pos == num_votes, sdf_abs, torch.nan))
    return torch.where(first_len > max_ref_dist, torch.nan, sdf)


def compute_sdf(queries: np.ndarray, ref_xyz: np.ndarray, ref_normal: np.ndarray,
                stdv: float, max_ref_dist: float = 1e8, num_votes: int = 11,
                chunk: int = QUERY_CHUNK, device="cuda") -> np.ndarray:
    """11-vote signed distance of ``queries`` (N, 3) to the surface cloud
    (R, 3) with normals; numpy in and out, the work on ``device``.  Unlike
    the JAX package, which pads the cloud to a size bucket so that its jitted
    program compiles once per bucket (pad rows at 1e9, which never vote),
    the port tiles the cloud as it is, the last tile short: the votes are the
    unpadded program's."""
    dev = resolve_device(device)
    rx = torch.from_numpy(np.ascontiguousarray(ref_xyz, np.float32)).to(dev)
    rn = torch.from_numpy(np.ascontiguousarray(ref_normal, np.float32)).to(dev)
    r2 = torch.sum(rx * rx, dim=1)
    qs = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    stdv32, far32 = float(np.float32(stdv)), float(np.float32(max_ref_dist))
    out = [_sdf_chunk(qs[s:s + chunk], rx, rn, r2, stdv32, far32, num_votes)
           for s in range(0, len(qs), chunk)]
    return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.float32)


# ---------------------------------------------------------------------------
# End-to-end per-mesh generation
# ---------------------------------------------------------------------------


class SamplerConfig(NamedTuple):
    """PreprocessMesh CLI surface (PreprocessMesh.cu:354-383 and the
    main_generator invocation, main_generator.py:37-45).

    ``reference_method`` selects the surface reference cloud like the
    binary's ``-r`` flag: 1 = camera-visibility filtered samples, 2 = raw
    mesh samples with face normals (no visibility), 3 = an external (xyz,
    normal) cloud passed to :func:`generate_mesh_samples`."""
    reference_method: int = 1
    num_sample: int = 500000
    near_surface_ratio: float = 0.8
    variance: float = 0.005
    bbox_expand: float = 1.2
    num_votes: int = 11
    max_ref_dist: float = 1e8
    n_surface_candidates: int = 500000
    zbuffer_res: int = 400


def generate_mesh_samples(mesh: TriMesh, cameras: list, half_window: float,
                          cfg: SamplerConfig, rng: np.random.Generator,
                          reference_points: np.ndarray = None, device="cuda"
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Full sampler pass for one mesh.  Returns (data (N, 4) xyz+sdf with the
    ambiguous rows dropped, surface (M, 6) xyzn).  ``reference_points``
    ((M, 6) xyzn) is required for reference_method 3."""
    if cfg.reference_method == 1:
        surf_xyz, surf_normal = visible_surface_samples(
            mesh, cameras, half_window, cfg.n_surface_candidates, rng,
            res=cfg.zbuffer_res, device=device)
    elif cfg.reference_method == 2:
        surf_xyz, tri = sample_on_triangles(mesh, cfg.n_surface_candidates, rng)
        surf_normal = mesh.face_normals()[tri]
    elif cfg.reference_method == 3:
        if reference_points is None:
            raise ValueError("reference_method 3 needs reference_points")
        surf_xyz = np.asarray(reference_points[:, :3], np.float32)
        surf_normal = np.asarray(reference_points[:, 3:6], np.float32)
    else:
        raise ValueError(f"unknown reference_method {cfg.reference_method}")
    if len(surf_xyz) < 100:
        return np.zeros((0, 4), np.float32), np.zeros((0, 6), np.float32)

    # queries: two perturbation scales around fresh surface samples (half
    # each, PreprocessMesh.cu:120-133) and uniform box samples
    n_near = int(cfg.num_sample * cfg.near_surface_ratio)
    n_half = n_near // 2
    n_uniform = cfg.num_sample - 2 * n_half
    base, _ = sample_on_triangles(mesh, n_half, rng)
    q1 = base + rng.standard_normal((n_half, 3)).astype(np.float32) * np.sqrt(cfg.variance)
    q2 = base + rng.standard_normal((n_half, 3)).astype(np.float32) * np.sqrt(cfg.variance / 5.0)
    lo, hi = mesh.bounds()
    center, half = (lo + hi) / 2, (hi - lo) / 2 * cfg.bbox_expand
    qu = (center + (rng.random((n_uniform, 3)) * 2 - 1) * half).astype(np.float32)
    queries = np.concatenate([q1, q2, qu])

    sdf = compute_sdf(queries, surf_xyz, surf_normal, stdv=np.sqrt(cfg.variance),
                      max_ref_dist=cfg.max_ref_dist, num_votes=cfg.num_votes,
                      device=device)
    keep = ~np.isnan(sdf)
    data = np.concatenate([queries[keep], sdf[keep, None]], axis=1)
    surface = np.concatenate([surf_xyz, surf_normal], axis=1)
    return data.astype(np.float32), surface.astype(np.float32)
