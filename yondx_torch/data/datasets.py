"""Host-side datasets and the batch loader (port of yondx/data/datasets.py).

The host produces uint8 sRGB crops; the trainer moves them to the device,
where the unprocessing and the noise run (train/trainer.py).

- `NpyFolderDataset`: a directory of {train,eval}/*.npy sRGB crops (uint8
  or uint16), with a batched readinto path for uniform corpora;
- `SyntheticSRGBDataset`: procedural crops (multi-octave smooth fields,
  flat rectangles, band-limited textures, sharp edges, block-mosaic
  charts and thin strokes), deterministic per index, numpy copied from
  the JAX package; the whole set is built once at construction into an
  .npy disk cache and memory-mapped after that. `python -m
  yondx_torch.cli.eval_synth --content texture` builds its scenes from it;
- `SIDDValDataset`: the SIDD validation / benchmark crop blocks the
  eval and test modes of `python -m yondx_torch.cli.yond` read;
- `BatchLoader`: shuffled drop-last batches, a thread pool prefetching in
  submission order (the order of the single-threaded loader); `to_unit`
  moves a batch onto the device.
"""
from __future__ import annotations

import glob
import os
import tempfile
import threading
from typing import Iterator, Optional

import numpy as np
import torch

# the port's own cache directory (the JAX package uses /tmp/yondx_synth)
DEFAULT_DISK_CACHE = os.path.join(tempfile.gettempdir(), "yondx_torch_synth")


class NpyFolderDataset:
    """Directory of npy sRGB crops: {root}/{mode}[_{subname}]/*.npy."""

    def __init__(self, root_dir: str, mode: str = "train",
                 subname: Optional[str] = None):
        sub = f"{mode}_{subname}" if (mode == "train" and subname) else mode
        self.dir = os.path.join(root_dir, sub)
        self.paths = sorted(glob.glob(os.path.join(self.dir, "*.npy")))
        if not self.paths:
            raise FileNotFoundError(f"no npy crops under {self.dir}")
        self.names = [os.path.basename(p)[:-4] for p in self.paths]
        self._probe_lock = threading.Lock()

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        arr = np.load(self.paths[idx])
        if arr.dtype == np.uint8:
            return arr            # the train step normalises uint8
        return arr.astype(np.float32) / 65535.0

    def _probe_headers(self):
        """One stat per file and a 16-file header sample: a corpus of equal
        file sizes and identical sampled headers gets one data offset."""
        from numpy.lib import format as npf
        self._fast = False
        if len({os.path.getsize(p) for p in self.paths}) != 1:
            return
        n = len(self.paths)
        sample = {0, n - 1, n // 2} | set(range(min(16, n)))
        shape = dtype = off = None
        for i in sorted(sample):
            with open(self.paths[i], "rb") as f:
                ver = npf.read_magic(f)
                shp, fortran, dt = npf._read_array_header(f, ver)
                if fortran:
                    return
                if shape is None:
                    shape, dtype, off = shp, dt, f.tell()
                elif (shp, dt, f.tell()) != (shape, dtype, off):
                    return
        self._offset = off
        self.item_shape = shape
        self.item_dtype = dtype
        self._fast = np.dtype(dtype) == np.dtype(np.uint8)

    def read_batch(self, idxs) -> Optional[np.ndarray]:
        """Items `idxs` read into one [B, ...] array with readinto; None
        when the corpus is not uniform uint8 (the caller then stacks
        items)."""
        with self._probe_lock:
            if not hasattr(self, "_fast"):
                self._probe_headers()
        if not self._fast:
            return None
        out = np.empty((len(idxs),) + tuple(self.item_shape),
                       self.item_dtype)
        flat = out.reshape(len(idxs), -1)
        for j, i in enumerate(idxs):
            with open(self.paths[int(i)], "rb") as f:
                f.seek(self._offset)
                f.readinto(memoryview(flat[j]).cast("B"))
        return out


class SyntheticSRGBDataset:
    """Procedural sRGB crops: multi-octave smooth fields + flat rectangles
    + band-limited textures + sharp edges, per-index deterministic (the
    eval-mode setup_seed(idx) contract). With `cache` and a `disk_cache`
    directory every item is built at construction into
    v{version}_s{seed}_p{size}_n{length}.npy there (or memory-mapped from
    it when present); otherwise items are memoized in RAM as they are
    built."""

    def __init__(self, length: int = 1024, size: int = 256, seed: int = 1997,
                 cache: bool = True, disk_cache: str = DEFAULT_DISK_CACHE,
                 version: int = 6):
        self.length = length
        self.size = size
        self.seed = seed
        # content version: 6 = round-3 mix (12% thin strokes); 7 =
        # stroke-emphasis mix (30% stroke crops, denser stroke counts,
        # an axis-aligned angle mode)
        self.version = version
        self._cache = {} if cache else None
        self._disk = None
        if cache and disk_cache:
            os.makedirs(disk_cache, exist_ok=True)
            path = os.path.join(disk_cache,
                                f"v{version}_s{seed}_p{size}_n{length}.npy")
            if os.path.exists(path):
                self._disk = np.load(path, mmap_mode="r")
            else:
                arr = np.stack([self._generate(i) for i in range(length)])
                tmp = path.replace(".npy", f".tmp{os.getpid()}.npy")
                np.save(tmp, arr)
                os.replace(tmp, path)
                self._disk = arr
            self._cache = None

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._disk is not None:
            return np.asarray(self._disk[idx])
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        return self._generate(idx)

    def _generate(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        S = self.size
        # ~12% of crops: thin random strokes (arbitrary-angle segments,
        # 1-4 px) on a flat ground — stroke preservation at low noise is
        # the one held-out class the round-3 nets still lose on
        # (glyphs_lo, docs/STATUS.md). Construction deliberately differs
        # from the held-out suite's axis-aligned cell glyphs.
        stroke_p = 0.30 if self.version >= 7 else 0.12
        if rng.random() < stroke_p:
            bg = rng.random(3) * 0.7 + 0.15
            fg = np.clip(bg + (0.5 if bg.mean() < 0.5 else -0.5), 0, 1)
            img = np.ones((S, S, 3), np.float32) * bg
            yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
            n_strokes = int(rng.integers(30, 240)) if self.version >= 7 \
                else int(rng.integers(20, 60))
            for _ in range(n_strokes):
                x0, y0 = rng.random(2) * S
                # v7: 30% of strokes axis-aligned — a 1-2 px axis-aligned
                # stroke lands in a SINGLE RGGB plane row/column after the
                # mosaic (the hardest to tell from noise); v6's uniform
                # angle draw made that case measure-zero
                if self.version >= 7 and rng.random() < 0.3:
                    ang = 0.0 if rng.random() < 0.5 else np.pi / 2
                else:
                    ang = rng.random() * np.pi
                ln = rng.integers(S // 20, S // 2)
                w = 0.5 + rng.random() * 1.5          # half-width 0.5-2 px
                dx, dy = np.cos(ang), np.sin(ang)
                t = (xx - x0) * dx + (yy - y0) * dy
                dist = np.abs(-(xx - x0) * dy + (yy - y0) * dx)
                m = (dist < w) & (t > 0) & (t < ln)
                col = fg if rng.random() < 0.8 else rng.random(3)
                img[m] = col
            img = np.clip(img * (0.4 + rng.random()), 0, 1)
            img = (img * 255.0 + 0.5).astype(np.uint8)
            if self._cache is not None:
                self._cache[idx] = img
            return img
        # ~1 in 5 crops: a hard block-mosaic "chart" — adjoining flat
        # rectangles spanning the full brightness range incl. saturated
        # blocks next to dark ones. Real SIDD validation scenes are such
        # charts; round-2 diagnosis showed the nets scored a content-
        # dependent ~22 dB floor on this class at ANY sigma because the
        # smooth-field generator never produced it.
        if rng.random() < 0.35:
            gy, gx = rng.integers(2, 9, 2)
            levels = rng.random((gy, gx, 3)).astype(np.float32)
            if rng.random() < 0.5:   # force saturated + near-black blocks
                levels[rng.integers(gy), rng.integers(gx)] = 1.0
                levels[rng.integers(gy), rng.integers(gx)] = 0.02
            img = np.kron(levels, np.ones((-(-S // gy), -(-S // gx), 1),
                                          np.float32))[:S, :S]
            if rng.random() < 0.5:   # mild vignette so blocks aren't DC
                yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S - 0.5
                img = img * (1.0 - 0.3 * rng.random()
                             * (yy * yy + xx * xx))[..., None]
            img = np.clip(img, 0.0, 1.0)
            img = (img * 255.0 + 0.5).astype(np.uint8)
            if self._cache is not None:
                self._cache[idx] = img
            return img
        img = np.zeros((S, S, 3), np.float32)
        # multi-octave smooth background per channel (Perlin-like)
        for c in range(3):
            acc = np.zeros((S, S), np.float32)
            amp, total = 1.0, 0.0
            for g in (3, 7, 17, 41):
                acc += amp * _bilinear_resize(rng.random((g, g)), S)
                total += amp
                amp *= 0.5
            img[..., c] = acc / total
        # random flat rectangles with distinct colors (flat regions for NLE)
        for _ in range(rng.integers(3, 10)):
            y0, x0 = rng.integers(0, S, 2)
            h, w = rng.integers(S // 16, S // 2, 2)
            img[y0:y0 + h, x0:x0 + w] = rng.random(3)
        # band-limited texture patch
        if rng.random() < 0.7:
            y0, x0 = rng.integers(0, S // 2, 2)
            h = int(rng.integers(S // 8, S // 2))
            freq = rng.random() * 0.3 + 0.02
            yy, xx = np.mgrid[0:h, 0:h]
            tex = 0.5 + 0.25 * np.sin(2 * np.pi * freq * (xx + yy)
                                      + rng.random() * 6.28)
            img[y0:y0 + h, x0:x0 + h] *= tex[..., None].astype(np.float32)
        # occasional hard diagonal edge (gradient-direction diversity)
        if rng.random() < 0.5:
            yy, xx = np.mgrid[0:S, 0:S]
            a, b = rng.normal(size=2)
            mask = (a * (yy - S / 2) + b * (xx - S / 2)) > 0
            img[mask] = img[mask] * rng.random() + rng.random(3) * 0.3
        # saturated highlights: real unprocessed raw keeps blown regions at
        # the white point (safe_invert_gains' highlight mask,
        # unprocess.py:115-121) — the denoiser must learn to preserve them
        if rng.random() < 0.6:
            for _ in range(rng.integers(1, 4)):
                y0, x0 = rng.integers(0, S - 8, 2)
                h, w = rng.integers(S // 16, S // 3, 2)
                img[y0:y0 + h, x0:x0 + w] = 1.0
        # global brightness jitter (occasionally pushing into clipping),
        # stored as uint8 (4x less host -> device transfer)
        img = np.clip(img * (0.4 + rng.random() * (1.2 if rng.random() < 0.3
                                                   else 1.0)), 0.0, 1.0)
        img = (img * 255.0 + 0.5).astype(np.uint8)
        if self._cache is not None:
            self._cache[idx] = img
        return img



def _bilinear_resize(g: np.ndarray, S: int) -> np.ndarray:
    gh, gw = g.shape
    yi = np.linspace(0, gh - 1, S)
    xi = np.linspace(0, gw - 1, S)
    y0 = np.floor(yi).astype(int).clip(0, gh - 2)
    x0 = np.floor(xi).astype(int).clip(0, gw - 2)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return ((1 - wy) * ((1 - wx) * a + wx * b)
            + wy * ((1 - wx) * c + wx * d)).astype(np.float32)


class SIDDValDataset:
    """SIDD validation (mode 'eval', with GT) or benchmark (mode 'test',
    no `hr`) crop blocks, the official layout under root_dir:
      SIDD_Validation_Raw/{ValidationNoisyBlocksRaw,ValidationGtBlocksRaw,
      BenchmarkNoisyBlocksRaw}.mat ([scenes, 32, 256, 256] in [0, 1]);
      SIDD_Benchmark_Data/<scene>/<scene>_{METADATA,NOISY}_010.MAT
    (optional: scene names, metadata and the CFA; without it scene i is
    named f"{i:04d}" and read as RGGB)."""

    def __init__(self, root_dir: str, mode: str = "eval"):
        import scipy.io as sio
        from ..isp.metadata import read_sidd_metadata
        self.mode = mode
        val = os.path.join(root_dir, "SIDD_Validation_Raw")
        if mode == "eval":
            self.lr = sio.loadmat(
                os.path.join(val, "ValidationNoisyBlocksRaw.mat")
            )["ValidationNoisyBlocksRaw"]
            self.hr = sio.loadmat(
                os.path.join(val, "ValidationGtBlocksRaw.mat")
            )["ValidationGtBlocksRaw"]
        else:
            self.lr = sio.loadmat(
                os.path.join(val, "BenchmarkNoisyBlocksRaw.mat")
            )["BenchmarkNoisyBlocksRaw"]
            self.hr = None
        bench = os.path.join(root_dir, "SIDD_Benchmark_Data")
        self.names = sorted(os.listdir(bench)) if os.path.isdir(bench) else []
        metas = sorted(glob.glob(os.path.join(bench, "*", "*_METADATA_*.MAT")))
        lrs = sorted(glob.glob(os.path.join(bench, "*", "*_NOISY_*.MAT")))
        self.infos = []
        for i in range(self.lr.shape[0]):
            meta = None
            if i < len(metas):
                meta = read_sidd_metadata(sio.loadmat(metas[i]))
            self.infos.append({
                "name": self.names[i] if i < len(self.names) else f"{i:04d}",
                "metadata": meta,
                "lr_path": lrs[i] if i < len(lrs) else None,
            })

    def __len__(self):
        return self.lr.shape[0]

    def __getitem__(self, idx: int) -> dict:
        info = self.infos[idx]
        meta = info["metadata"]
        data = {
            "name": info["name"],
            "lr": self.lr[idx].astype(np.float32),
            "meta": meta,
            "lr_path_full": info["lr_path"],
            "cfa": meta["bayer_2by2"] if meta else [[1, 2], [2, 3]],
        }
        if self.hr is not None:
            data["hr"] = self.hr[idx].astype(np.float32)
        return data


def to_unit(batch, device) -> torch.Tensor:
    """A host batch onto `device`, uint8 scaled to [0, 1] by 1/255 (as
    XLA folds the JAX trainers' x / 255 into x * (1 / 255))."""
    x = torch.as_tensor(np.asarray(batch)).to(device, non_blocking=True)
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) * float(np.float32(1.0 / 255.0))
    return x


class BatchLoader:
    """Shuffled, drop-last batches with a thread pool of `workers` that
    keeps `prefetch` batches in flight and yields them in submission
    order, so the order is that of a single-threaded loader."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 8, workers: int = 8):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = max(prefetch, workers)
        self.workers = max(1, workers)

    def __len__(self):
        return len(self.ds) // self.bs

    def _load_batch(self, idxs) -> np.ndarray:
        rb = getattr(self.ds, "read_batch", None)
        if rb is not None:
            out = rb(idxs)
            if out is not None:
                return out
        return np.stack([self.ds[int(i)] for i in idxs])

    def epoch(self, epoch: int = 0) -> Iterator[np.ndarray]:
        """The batches of an epoch, in the order that
        np.random.default_rng(seed + epoch) shuffles the items into."""
        from concurrent.futures import ThreadPoolExecutor
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        starts = iter(range(0, len(order) - self.bs + 1, self.bs))
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = []
            for s in starts:
                pending.append(pool.submit(self._load_batch,
                                           order[s:s + self.bs]))
                if len(pending) >= self.prefetch:
                    break
            for s in starts:
                yield pending.pop(0).result()
                pending.append(pool.submit(self._load_batch,
                                           order[s:s + self.bs]))
            while pending:
                yield pending.pop(0).result()
