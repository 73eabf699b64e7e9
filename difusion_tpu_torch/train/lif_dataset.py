"""LIF (local implicit function) training dataset (the port's own copy of
difusion_tpu/train/lif_dataset.py; only :func:`prefetch_device` differs).

Parity with pytorch/dataset/training/lif_dataset.py: per-voxel npz payloads
(``payload/%08d.npz`` with "data" (M, 4) xyz+sdf and "surface" (K, 6) xyzn,
indexed by ``source.json``), positive/negative-balanced SDF sampling,
Y/X/Z/3D rotation augmentation, surface noise + normal perturbation.

Numpy end to end up to the upload: :func:`iterate_batches` assembles
batches, optionally in a background thread pool (the analog of the
reference's 8-worker torch DataLoader); ``LifDataset.__getitem__`` is
thread-safe via per-call child generators.  :func:`prefetch_device` casts
each batch to the upload dtype and uploads it from pinned memory on a copy
stream, a few batches ahead of the consumer.  Given the same numpy seed the
batches are bit-equal to the JAX package's loader's.
"""
from __future__ import annotations

import json
import queue
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.motion import Quaternion


def perturb_normal(normals: np.ndarray, theta_range: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Random cone perturbation of unit normals: tilt each normal by a
    uniform angle in [0, theta_range) about a uniform in-plane azimuth (the
    reference's normal-noise augmentation, lif_dataset.py:10-24; the tangent
    frame construction here is our own).

    Each normal's tangent basis comes from crossing it with whichever
    coordinate axis it is least aligned with (z, else x) -- degenerate-free
    for unit inputs, and since the azimuth is uniform the particular basis
    choice does not change the output distribution."""
    n = np.asarray(normals, np.float64)
    use_z = np.abs(n[:, 2]) < 0.9
    helper = np.where(use_z[:, None], np.array([0.0, 0.0, 1.0]),
                      np.array([1.0, 0.0, 0.0]))
    t1 = np.cross(n, helper)
    t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-12)
    t2 = np.cross(n, t1)
    theta = rng.random((len(n), 1)) * theta_range
    phi = rng.random((len(n), 1)) * (2.0 * np.pi)
    tilt = np.cos(phi) * t1 + np.sin(phi) * t2
    return np.cos(theta) * n + np.sin(theta) * tilt


def _random_rotation(kind: Optional[str], rng: np.random.Generator) -> Optional[np.ndarray]:
    if kind is None:
        return None
    if kind == "3D":
        return Quaternion.random(rng).rotation_matrix
    if kind == "X":
        return Quaternion(axis=np.array([1.0, 0.0, 0.0]), degrees=360.0 * rng.random()).rotation_matrix
    if kind == "Y":
        base = rng.choice([0.0, 90.0, 180.0, 270.0])
        return Quaternion(axis=np.array([0.0, 1.0, 0.0]), degrees=base + 30.0 * rng.random()).rotation_matrix
    return Quaternion(axis=np.array([0.0, 0.0, 1.0]), degrees=360.0 * rng.random()).rotation_matrix


class LifDataset:
    """One payload directory (lif_dataset.py:27-92)."""

    def __init__(self, data_path: str, num_sample: int,
                 num_surface_sample: int = 0, augment_rotation: Optional[str] = None,
                 augment_noise: Tuple[float, float] = (0.0, 0.0),
                 surface_format: str = "xyzn", seed: int = 0,
                 cache_payloads: bool = False):
        # the reference prefixes cache specs like "cached$local://<path>"
        # (dataset/base.py expand_path); "cached$" means the payload set is
        # held in RAM after first touch (with the pos/neg split below cached
        # alongside): the per-item loader then reads each npz once, not once
        # an epoch.
        cache = cache_payloads
        if data_path.startswith("cached$"):
            data_path = data_path[len("cached$"):]
            cache = True
        if "://" in data_path:
            data_path = data_path.split("://", 1)[1]
        self.data_path = Path(data_path)
        # dict get/set are atomic under the GIL -> thread-safe for the batch
        # prefetch pool; worst case two threads load the same idx once
        self._cache: Optional[dict] = {} if cache else None
        with (self.data_path / "source.json").open() as f:
            self.data_sources = json.load(f)
        self.num_sample = num_sample
        self.num_surface_sample = num_surface_sample
        self.augment_rotation = augment_rotation
        self.augment_noise = tuple(augment_noise)
        # per-call child generators: __getitem__ must be thread-safe for the
        # batch prefetch pool, and a shared Generator is not
        self._seed = seed
        import itertools
        self._draw = itertools.count()   # atomic under the GIL

    def __len__(self) -> int:
        return len(self.data_sources)

    def get_raw_data(self, idx: int):
        if self._cache is not None:
            hit = self._cache.get(idx)
            if hit is None:
                with np.load(self.data_path / "payload"
                             / ("%08d.npz" % idx)) as raw:
                    hit = {k: raw[k] for k in raw.files}
                self._cache[idx] = hit
            return hit
        return np.load(self.data_path / "payload" / ("%08d.npz" % idx))

    def read_raw_once(self, idx: int) -> dict:
        """One-shot payload read that NEVER populates the cached$ dict.

        :class:`PackedLifDataset` packs every payload into flat arrays and
        never touches ``get_raw_data`` again, so routing packing through the
        cache would leave a second full copy of the corpus resident for the
        whole training run."""
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        with np.load(self.data_path / "payload" / ("%08d.npz" % idx)) as raw:
            return {k: raw[k] for k in raw.files}

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        raw = self.get_raw_data(idx)
        rng = np.random.default_rng((self._seed, idx, next(self._draw)))

        # pos/neg split cached alongside the payload: the boolean masking
        # copies the whole (M, 4) payload twice per draw.  Boolean masks
        # preserve row order, so cached splits give bit-identical draws to
        # splitting inline.
        split = raw.get("_posneg") if self._cache is not None else None
        if split is None:
            data = raw["data"]
            split = (data[data[:, 3] > 0], data[data[:, 3] <= 0])
            if self._cache is not None:
                raw["_posneg"] = split
        pos, neg = split
        half = self.num_sample // 2
        sample_pos = pos[(rng.random(half) * len(pos)).astype(int)]
        sample_neg = neg[(rng.random(half) * len(neg)).astype(int)]
        samples = np.concatenate([sample_pos, sample_neg], axis=0).astype(np.float32)

        surface = raw["surface"]
        surface = surface[rng.choice(len(surface), size=self.num_surface_sample,
                                     replace=True)].astype(np.float32)

        rot = _random_rotation(self.augment_rotation, rng)
        if rot is not None:
            samples[:, 0:3] = samples[:, 0:3] @ rot.T.astype(np.float32)
            surface[:, 0:3] = surface[:, 0:3] @ rot.T.astype(np.float32)
            surface[:, 3:6] = surface[:, 3:6] @ rot.T.astype(np.float32)

        if self.augment_noise[0] > 0.0:
            surface[:, 0:3] += rng.standard_normal((len(surface), 3)).astype(np.float32) \
                * self.augment_noise[0]
            surface[:, 3:6] = perturb_normal(surface[:, 3:6],
                                             np.deg2rad(self.augment_noise[1]), rng)
        return samples, surface


class LifCombinedDataset:
    """Concatenation of several LifDatasets (lif_dataset.py:95-116)."""

    def __init__(self, *datasets: LifDataset):
        assert datasets
        self.datasets = datasets
        self.cumulative_sizes = np.cumsum([len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self.cumulative_sizes[-1])

    def __getitem__(self, idx: int):
        d = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        local = idx if d == 0 else idx - int(self.cumulative_sizes[d - 1])
        return self.datasets[d][local]


def _perturb_normal_batch(n: np.ndarray, theta_range: float, u_theta: np.ndarray,
                          u_phi: np.ndarray) -> np.ndarray:
    """Vectorized :func:`perturb_normal` over an (..., 3) normal array with
    caller-supplied uniform draws (same math, float32 throughout -- the cone
    distribution is identical; only the RNG consumption order differs from
    the per-LIF path)."""
    n = np.asarray(n, np.float32)
    use_z = np.abs(n[..., 2:3]) < 0.9
    helper = np.where(use_z, np.array([0, 0, 1], np.float32),
                      np.array([1, 0, 0], np.float32))
    t1 = np.cross(n, helper)
    t1 /= np.maximum(np.linalg.norm(t1, axis=-1, keepdims=True), 1e-12)
    t2 = np.cross(n, t1)
    theta = (u_theta * theta_range)[..., None].astype(np.float32)
    phi = (u_phi * (2.0 * np.pi))[..., None].astype(np.float32)
    tilt = np.cos(phi) * t1 + np.sin(phi) * t2
    return np.cos(theta) * n + np.sin(theta) * tilt


def _rotation_batch(kind: Optional[str], B: int, rng: np.random.Generator) -> Optional[np.ndarray]:
    """(B, 3, 3) random rotations matching :func:`_random_rotation`'s
    per-kind distribution, built without per-item Quaternion objects."""
    if kind is None:
        return None
    if kind == "3D":
        # uniform quaternions (Shoemake); same distribution as
        # Quaternion.random
        u1, u2, u3 = rng.random((3, B))
        q = np.stack([np.sqrt(1 - u1) * np.sin(2 * np.pi * u2),
                      np.sqrt(1 - u1) * np.cos(2 * np.pi * u2),
                      np.sqrt(u1) * np.sin(2 * np.pi * u3),
                      np.sqrt(u1) * np.cos(2 * np.pi * u3)], axis=1)
        w, x, y, z = q[:, 3], q[:, 0], q[:, 1], q[:, 2]
        R = np.empty((B, 3, 3), np.float64)
        R[:, 0, 0] = 1 - 2 * (y * y + z * z); R[:, 0, 1] = 2 * (x * y - z * w); R[:, 0, 2] = 2 * (x * z + y * w)
        R[:, 1, 0] = 2 * (x * y + z * w); R[:, 1, 1] = 1 - 2 * (x * x + z * z); R[:, 1, 2] = 2 * (y * z - x * w)
        R[:, 2, 0] = 2 * (x * z - y * w); R[:, 2, 1] = 2 * (y * z + x * w); R[:, 2, 2] = 1 - 2 * (x * x + y * y)
        return R
    if kind == "Y":
        base = rng.choice([0.0, 90.0, 180.0, 270.0], size=B)
        ang = np.deg2rad(base + 30.0 * rng.random(B))
    else:
        ang = 2.0 * np.pi * rng.random(B)
    c, s, zero, one = np.cos(ang), np.sin(ang), np.zeros(B), np.ones(B)
    if kind == "X":
        rows = [one, zero, zero, zero, c, -s, zero, s, c]
    elif kind == "Y":
        rows = [c, zero, s, zero, one, zero, -s, zero, c]
    else:   # "Z"
        rows = [c, -s, zero, s, c, zero, zero, zero, one]
    return np.stack(rows, axis=1).reshape(B, 3, 3)


class PackedLifDataset:
    """Epoch-level pre-packed view of a :class:`LifDataset`: every payload's
    pos/neg/surface rows concatenated once into three flat arrays, so a whole
    batch assembles as three fancy-index gathers plus batched-matmul
    augmentation -- no per-LIF Python loop (the answer to the reference's
    8-worker DataLoader, network_trainer.py:68: one host thread assembles a
    batch without a worker pool).

    Draw distributions are identical to ``LifDataset.__getitem__`` (uniform
    row choice per half, per-item rotation kind, Gaussian surface noise,
    cone normal perturbation); only the RNG stream differs, so individual
    draws are not bit-identical to the per-item path.
    """

    PACK_CACHE_VERSION = 2      # v2: meta covers payload bytes/mtime

    def __init__(self, ds: LifDataset, disk_cache: bool = True):
        self.num_sample = ds.num_sample
        self.num_surface_sample = ds.num_surface_sample
        self.augment_rotation = ds.augment_rotation
        self.augment_noise = ds.augment_noise
        self._n = len(ds)
        if disk_cache and self._load_pack_cache(ds):
            return
        pos_parts, neg_parts, surf_parts = [], [], []
        self.pos_count = np.empty(self._n, np.int64)
        self.neg_count = np.empty(self._n, np.int64)
        self.surf_count = np.empty(self._n, np.int64)
        for i in range(self._n):
            raw = ds.read_raw_once(i)
            data = raw["data"]
            pos = data[data[:, 3] > 0]
            neg = data[data[:, 3] <= 0]
            surf = raw["surface"]
            self.pos_count[i], self.neg_count[i] = len(pos), len(neg)
            self.surf_count[i] = len(surf)
            # fail LOUDLY like the per-item path would (IndexError on an
            # empty array): with a zero count, off[id] + floor(u*0) lands on
            # the NEXT LIF's first row -- silent wrong-LIF training data
            if not (len(pos) and len(neg) and len(surf)):
                raise ValueError(
                    f"payload {i} has empty pos/neg/surface split "
                    f"({len(pos)}/{len(neg)}/{len(surf)}); packed sampling "
                    "requires at least one row of each (the generator's "
                    "min-count filters guarantee this for generated corpora)")
            pos_parts.append(pos); neg_parts.append(neg); surf_parts.append(surf)
        # copy=False + clear(): peak stays at corpus + one concatenated copy
        # instead of 2x corpus + stale part lists
        self.pos = np.concatenate(pos_parts).astype(np.float32, copy=False)
        pos_parts.clear()
        self.neg = np.concatenate(neg_parts).astype(np.float32, copy=False)
        neg_parts.clear()
        self.surf = np.concatenate(surf_parts).astype(np.float32, copy=False)
        surf_parts.clear()
        self._finish_offsets()
        if disk_cache:
            try:
                self._write_pack_cache(ds)
            except OSError:
                pass   # read-only dataset dir: packing still works, in RAM

    def _finish_offsets(self):
        self.pos_off = np.concatenate([[0], np.cumsum(self.pos_count)[:-1]])
        self.neg_off = np.concatenate([[0], np.cumsum(self.neg_count)[:-1]])
        self.surf_off = np.concatenate([[0], np.cumsum(self.surf_count)[:-1]])

    # -- disk pack cache: packing decompresses every npz payload and the
    # result is identical every run, so persist the flat arrays as raw .npy
    # next to the payloads and mmap them back.  mmap makes the corpus
    # file-backed: the page cache holds hot rows and the kernel can evict
    # under pressure, where packed arrays in anonymous memory cannot go.

    def _pack_meta(self, ds: LifDataset) -> dict:
        src = ds.data_path / "source.json"
        st = src.stat()
        # cover the payload FILES too, not just source.json: regenerating
        # payloads in place (same count, untouched index) must invalidate
        # the cache; a stat() a payload is cheap next to the npz decode a
        # false hit would silently skip.
        pay_bytes = pay_mtime = 0.0
        for i in range(self._n):
            pst = (ds.data_path / "payload" / ("%08d.npz" % i)).stat()
            pay_bytes += pst.st_size
            pay_mtime = max(pay_mtime, pst.st_mtime)
        return {"version": self.PACK_CACHE_VERSION, "n": self._n,
                "source_size": st.st_size, "source_mtime": st.st_mtime,
                "payload_bytes": pay_bytes,
                "payload_max_mtime": pay_mtime}

    def _load_pack_cache(self, ds: LifDataset) -> bool:
        cdir = ds.data_path / "packed_cache"
        meta_p = cdir / "meta.json"
        if not meta_p.exists():
            return False
        try:
            meta = json.loads(meta_p.read_text())
        except (OSError, json.JSONDecodeError):
            return False
        if meta != self._pack_meta(ds):
            return False
        try:
            self.pos = np.load(cdir / "pos.npy", mmap_mode="r")
            self.neg = np.load(cdir / "neg.npy", mmap_mode="r")
            self.surf = np.load(cdir / "surf.npy", mmap_mode="r")
            counts = np.load(cdir / "counts.npz")
        except OSError:
            return False
        self.pos_count = counts["pos"]
        self.neg_count = counts["neg"]
        self.surf_count = counts["surf"]
        self._finish_offsets()
        return True

    def _write_pack_cache(self, ds: LifDataset) -> None:
        cdir = ds.data_path / "packed_cache"
        cdir.mkdir(exist_ok=True)
        np.save(cdir / "pos.npy", self.pos)
        np.save(cdir / "neg.npy", self.neg)
        np.save(cdir / "surf.npy", self.surf)
        np.savez(cdir / "counts.npz", pos=self.pos_count, neg=self.neg_count,
                 surf=self.surf_count)
        # meta LAST: a crash mid-write leaves an invalid cache, not a wrong one
        (cdir / "meta.json").write_text(json.dumps(self._pack_meta(ds)))

    def __len__(self) -> int:
        return self._n

    def sample_batch(self, ids: np.ndarray, rng: np.random.Generator
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, S, 4) sdf samples + (B, N, 6) surface for LIF ids (B,)."""
        B = len(ids)
        half = self.num_sample // 2
        K = self.num_surface_sample

        def gather(flat, off, cnt, n_draw):
            rows = off[ids, None] + (rng.random((B, n_draw))
                                     * cnt[ids, None]).astype(np.int64)
            return flat[rows.reshape(-1)].reshape(B, n_draw, -1)

        sample_pos = gather(self.pos, self.pos_off, self.pos_count, half)
        sample_neg = gather(self.neg, self.neg_off, self.neg_count, half)
        samples = np.concatenate([sample_pos, sample_neg], axis=1)
        surface = gather(self.surf, self.surf_off, self.surf_count, K)

        rot = _rotation_batch(self.augment_rotation, B, rng)
        if rot is not None:
            rT = np.swapaxes(rot, 1, 2).astype(np.float32)
            samples[:, :, 0:3] = samples[:, :, 0:3] @ rT
            surface[:, :, 0:3] = surface[:, :, 0:3] @ rT
            surface[:, :, 3:6] = surface[:, :, 3:6] @ rT

        if self.augment_noise[0] > 0.0:
            surface[:, :, 0:3] += rng.standard_normal(
                (B, K, 3)).astype(np.float32) * self.augment_noise[0]
            surface[:, :, 3:6] = _perturb_normal_batch(
                surface[:, :, 3:6], np.deg2rad(self.augment_noise[1]),
                rng.random((B, K)), rng.random((B, K)))
        return samples, surface


class PackedCombinedDataset:
    """Packed analog of :class:`LifCombinedDataset`: each sub-dataset keeps
    its own augmentation settings; a batch is assembled by routing ids to
    their owning pack and scattering the results back in batch order."""

    def __init__(self, combined: LifCombinedDataset):
        self.packs = [PackedLifDataset(d) for d in combined.datasets]
        self.cumulative_sizes = combined.cumulative_sizes
        p0 = self.packs[0]
        assert all(p.num_sample == p0.num_sample
                   and p.num_surface_sample == p0.num_surface_sample
                   for p in self.packs), \
            "packed batching needs uniform sample counts across train_set"

    def __len__(self) -> int:
        return int(self.cumulative_sizes[-1])

    def sample_batch(self, ids: np.ndarray, rng: np.random.Generator):
        ids = np.asarray(ids)
        B = len(ids)
        p0 = self.packs[0]
        # 2*(S//2): each pack returns half pos + half neg rows, which is
        # S-1 when S is odd -- mirror the per-item path's actual row count
        samples = np.empty((B, 2 * (p0.num_sample // 2), 4), np.float32)
        surface = np.empty((B, p0.num_surface_sample, 6), np.float32)
        owner = np.searchsorted(self.cumulative_sizes, ids, side="right")
        for d, pack in enumerate(self.packs):
            sel = np.nonzero(owner == d)[0]
            if len(sel) == 0:
                continue
            local = ids[sel] - (0 if d == 0 else int(self.cumulative_sizes[d - 1]))
            s, f = pack.sample_batch(local, rng)
            samples[sel], surface[sel] = s, f
        return samples, surface


def pack_dataset(dataset):
    """Pack a LifDataset / LifCombinedDataset for vectorized batching."""
    if isinstance(dataset, LifCombinedDataset):
        return PackedCombinedDataset(dataset)
    return PackedLifDataset(dataset)


def iterate_batches_packed(packed, batch_size: int, rng: np.random.Generator,
                           drop_last: bool = True
                           ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Shuffled epoch iterator over a packed dataset; same yield contract as
    :func:`iterate_batches`.  No worker pool needed -- assembly is an order
    of magnitude cheaper than the device step."""
    order = rng.permutation(len(packed))
    n_full = len(order) // batch_size
    end = n_full * batch_size if drop_last else len(order)
    for b in range(0, end, batch_size):
        ids = order[b:b + batch_size]
        s, f = packed.sample_batch(ids, rng)
        yield s, f, ids.astype(np.int32)


def _upload(array: np.ndarray, device: torch.device, stream):
    """Host array -> (device tensor, the event its copy ends with, or None
    on the CPU).  On the card the copy leaves pinned memory on ``stream``."""
    t = torch.from_numpy(array)
    if stream is None:
        return t, None
    with torch.cuda.stream(stream):
        out = t.pin_memory().to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    return out, done


def prefetch_device(batches, device, upload_dtype=np.float32, depth: int = 2):
    """Yield ``(sdf_data, surface, ids)`` with the two arrays cast to
    ``upload_dtype`` and on ``device``; a background thread casts, pins and
    uploads ``depth`` batches ahead of the consumer, on a copy stream of its
    own on the card, so that the upload and the next batch's assembly
    overlap the device step.  Worker exceptions re-raise in the consumer;
    closing the generator stops the worker."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that gives up when the consumer is gone, so that an
        # early exit does not pin depth + 1 batches for the life of the process
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for sdf_data, surface, ids in batches:
                item = (_upload(np.ascontiguousarray(sdf_data.astype(upload_dtype)),
                                device, stream),
                        _upload(np.ascontiguousarray(surface.astype(upload_dtype)),
                                device, stream), ids)
                if stop.is_set() or not _put(item):
                    return
            _put(done)
        except BaseException as e:          # noqa: BLE001 -- re-raised below
            _put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            (sdf_t, ev_a), (surf_t, ev_b), ids = item
            if ev_a is not None:
                current = torch.cuda.current_stream(device)
                for t, ev in ((sdf_t, ev_a), (surf_t, ev_b)):
                    current.wait_event(ev)
                    t.record_stream(current)
            yield sdf_t, surf_t, ids
    finally:
        stop.set()
        while not q.empty():        # drop pinned buffers promptly
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)


def iterate_batches(dataset, batch_size: int, rng: np.random.Generator,
                    drop_last: bool = True, n_workers: int = 0
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Shuffled epoch iterator yielding (sdf_samples (B, S, 4),
    surface (B, N, 6), idx (B,)).

    ``n_workers`` > 0 assembles batches in a background thread pool (the
    analog of the reference's 8-worker DataLoader, network_trainer.py:68):
    npz reads + augmentation overlap with the device step.
    """
    order = rng.permutation(len(dataset))
    n_full = len(order) // batch_size
    end = n_full * batch_size if drop_last else len(order)
    starts = list(range(0, end, batch_size))

    def build(b):
        ids = order[b:b + batch_size]
        items = [dataset[int(i)] for i in ids]
        return (np.stack([s for s, _ in items]),
                np.stack([f for _, f in items]),
                ids.astype(np.int32))

    if n_workers <= 0:
        for b in starts:
            yield build(b)
        return

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        window = 2 * n_workers
        futures = [pool.submit(build, b) for b in starts[:window]]
        nxt = window
        for i in range(len(starts)):
            yield futures[i].result()
            if nxt < len(starts):
                futures.append(pool.submit(build, starts[nxt]))
                nxt += 1
