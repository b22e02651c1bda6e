"""Host image pipeline: decode → composite → resize → tensors on the device.

The port of the JAX package's `data/pipeline.py` (the reference's
`CameraDataset` + `DataLoader`, `scene/__init__.py:31-67`,
`train.py:116-124`). `load_view` matches `CameraDataset.__getitem__`: RGBA
images are alpha-composited onto the record's background colour, resized
to the camera's resolution, float32 in [0, 1], HWC. PIL decodes: the JAX
package's native decoder is not ported (the card's machine has no libpng
headers to build it, and decoding runs once per view per fit).

`EpochSampler` draws numpy's `default_rng` permutations, so both packages
visit the views in the same order for the same seed. `Prefetcher` decodes
in threads and hands over tensors on its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cameras import Camera
from .readers import CameraRecord

_GT_SCALE = float(np.float32(1.0 / 255.0))


def decode_image(path: str, bg: np.ndarray, width: int, height: int) -> np.ndarray:
    """Decode one image to float32 [H, W, 3] in [0, 1], compositing alpha
    onto `bg` (`scene/__init__.py:44-63`), with PIL's bilinear resize."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True  # reference `scene/__init__.py:28`
    with Image.open(path) as im:
        if im.size != (width, height):
            im = im.resize((width, height), Image.BILINEAR)
        arr = np.asarray(im.convert("RGBA"), np.float32) / 255.0
    rgb = arr[..., :3]
    a = arr[..., 3:4]
    return rgb * a + np.asarray(bg, np.float32) * (1.0 - a)


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file."""
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def load_view(rec: CameraRecord, cam: Camera) -> np.ndarray:
    return decode_image(rec.image_path, rec.bg, cam.width, cam.height)


def gt_to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] → float32 [0, 1]; float passes through unchanged.

    The one conversion of every ground-truth path: a multiply by exactly
    float32(1/255), as the JAX package's, not a divide (a one-ulp
    difference between two training paths is amplified by Adam's 1e-15
    epsilon into sign-flipped updates)."""
    if not x.dtype.is_floating_point:
        return x.to(torch.float32) * _GT_SCALE
    return x


def to_uint8(imgs: np.ndarray) -> np.ndarray:
    """float images in [0, 1] → uint8, as the JAX device cache stores them."""
    return (np.clip(imgs, 0.0, 1.0) * 255).astype(np.uint8)


class EpochSampler:
    """Shuffled epoch order over view indices (DataLoader(shuffle=True)
    with batch 1, `train.py:116-124`)."""

    def __init__(self, n: int, seed: int = 0, shuffle: bool = True):
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle

    def __iter__(self) -> Iterator[int]:
        while True:
            order = self.rng.permutation(self.n) if self.shuffle else np.arange(self.n)
            yield from order.tolist()


class Prefetcher:
    """Background decode in threads. `next()` returns (view indices,
    float32 tensor [batch, H, W, 3] on `device`), in sampler order.
    `indices` restricts the sampling to those views (default: all)."""

    def __init__(
        self,
        records: Sequence[CameraRecord],
        cameras: Sequence[Camera],
        device,
        seed: int = 0,
        depth: int = 4,
        workers: int = 4,
        batch: int = 1,
        shuffle: bool = True,
        indices: Optional[Sequence[int]] = None,
    ):
        assert len(records) == len(cameras)
        self.records = list(records)
        self.cameras = list(cameras)
        self.device = torch.device(device)
        idx = list(indices) if indices is not None else list(range(len(records)))
        self._sampler = iter(EpochSampler(len(idx), seed, shuffle))
        self._index_map = idx
        self.batch = batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._seq = 0          # ticket dispenser so output order == sample order
        self._emit = 0
        self._emit_cv = threading.Condition()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(workers)]
        for t in self._threads:
            t.start()

    def _sample_ticket(self) -> Tuple[int, List[int]]:
        with self._lock:
            ticket = self._seq
            self._seq += 1
            views = [self._index_map[next(self._sampler)] for _ in range(self.batch)]
        return ticket, views

    def _worker(self):
        while not self._stop.is_set():
            ticket, views = self._sample_ticket()
            try:
                item = (views, np.stack([load_view(self.records[v], self.cameras[v])
                                         for v in views], 0))
            except Exception as e:  # surfaced to the consumer by next()
                item = e
            # Keep the sampler's order across threads: wait for this
            # ticket's turn, then put outside the condition lock.
            with self._emit_cv:
                while self._emit != ticket and not self._stop.is_set():
                    self._emit_cv.wait(0.1)
            if self._stop.is_set():
                return
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            with self._emit_cv:
                self._emit += 1
                self._emit_cv.notify_all()

    def next(self) -> Tuple[List[int], torch.Tensor]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        views, gt = item
        return views, torch.from_numpy(gt).to(self.device)

    def close(self):
        self._stop.set()
        with self._emit_cv:
            self._emit_cv.notify_all()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=1.0)


def view_stack(records: Sequence[CameraRecord], cameras: Sequence[Camera],
               batch_decode: int = 64) -> np.ndarray:
    """Every view decoded and stored as uint8 [N, H, W, 3] (the device
    cache's host side), `batch_decode` float images at a time."""
    n = len(records)
    chunks = []
    for i in range(0, n, batch_decode):
        imgs = np.stack([load_view(records[j], cameras[j])
                         for j in range(i, min(i + batch_decode, n))])
        chunks.append(to_uint8(imgs))
    return np.concatenate(chunks, 0)
