"""Image+pose dataset: JSON-of-records -> (image, q, t, CameraInfo) items.

Port of ``taichi_3d_gaussian_splatting_tpu/data/dataset.py``, item for item:

- items are plain numpy on the host; the trainer moves each to the device
  on its main thread. ``PrefetchLoader`` runs decode/resize on a thread
  pool and keeps a bounded queue ahead of the training loop, in the order
  of ``np.random.default_rng(seed)``'s shuffles.
- images arrive as (H, W, 3) float32 in [0, 1], channels last.
- images over 1600 px are resized (short edge 1024, long edge at most
  1600), and dimensions are cropped to a multiple of the rasterizer tile.

PIL (decode, resize) and scipy (rotation matrix -> quaternion) are
imported where an item is built, so the module imports without them.
"""
from __future__ import annotations

import json
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from taichi_3d_gaussian_splatting_tpu_torch.data.camera import CameraInfo

MAX_RESOLUTION_TRAIN = 1600


@dataclass
class DatasetItem:
    image: np.ndarray                  # (H, W, 3) f32 in [0, 1]
    q_pointcloud_camera: np.ndarray    # (4,) xyzw
    t_pointcloud_camera: np.ndarray    # (3,)
    camera_info: CameraInfo
    index: int


def _se3_to_qt(T: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4x4 -> (q xyzw, t)."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(T[:3, :3]).as_quat()  # xyzw
    return q.astype(np.float32), T[:3, 3].astype(np.float32)


def _resize_min_edge(img, size: int, max_size: int):
    """torchvision ``resize(size=..., max_size=...)`` semantics: scale so
    the short edge == size, but cap the long edge at max_size."""
    import PIL.Image

    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    scale = size / short
    if long * scale > max_size:
        scale = max_size / long
    new_w, new_h = round(w * scale), round(h * scale)
    return img.resize((new_w, new_h), PIL.Image.BILINEAR)


class ImagePoseDataset:
    REQUIRED_COLUMNS = (
        "image_path", "T_pointcloud_camera", "camera_intrinsics",
        "camera_height", "camera_width", "camera_id",
    )

    def __init__(self, dataset_json_path: str, tile_size: int = 32,
                 cache_mb: int = 4096):
        with open(dataset_json_path) as f:
            records = json.load(f)
        if isinstance(records, dict):  # orient="records" may be dict-of-lists
            keys = list(records.keys())
            n = len(records[keys[0]])
            records = [{k: records[k][i] for k in keys} for i in range(n)]
        for col in self.REQUIRED_COLUMNS:
            if col not in records[0]:
                raise ValueError(f"column {col} is not in the dataset")
        self.records = records
        self.tile_size = tile_size
        # Decoded-item cache, bounded by ``cache_mb`` (0 disables): a long
        # run revisits each view hundreds of times. A cached DatasetItem is
        # immutable by convention (downsample_item allocates a new array).
        self._cache: dict = {}
        self._cache_left = cache_mb * (1 << 20)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> DatasetItem:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        import PIL.Image

        rec = self.records[idx]
        T = np.asarray(rec["T_pointcloud_camera"], np.float32).reshape(4, 4)
        q, t = _se3_to_qt(T)
        K = np.asarray(rec["camera_intrinsics"], np.float32).reshape(3, 3)
        base_h = int(rec["camera_height"])
        base_w = int(rec["camera_width"])

        img = PIL.Image.open(rec["image_path"])
        if img.mode not in ("RGB", "L"):
            # palette/16-bit/alpha modes would decode to palette indices or
            # out-of-[0,1] values; PIL normalizes them all to 8-bit RGB
            img = img.convert("RGB")
        w, h = img.size
        # rescale intrinsics from the reported to the actual size
        K = K.copy()
        K[0, :] *= w / base_w
        K[1, :] *= h / base_h

        if h > MAX_RESOLUTION_TRAIN or w > MAX_RESOLUTION_TRAIN:
            img = _resize_min_edge(img, 1024, MAX_RESOLUTION_TRAIN)
            new_w, new_h = img.size
            K[0, :] *= new_w / w
            K[1, :] *= new_h / h
            w, h = new_w, new_h

        # crop to a tile multiple
        w -= w % self.tile_size
        h -= h % self.tile_size
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        arr = arr[:h, :w, :3] / 255.0

        info = CameraInfo(
            camera_intrinsics=K, camera_height=h, camera_width=w,
            camera_id=int(rec["camera_id"]),
        )
        item = DatasetItem(
            image=np.ascontiguousarray(arr), q_pointcloud_camera=q,
            t_pointcloud_camera=t, camera_info=info, index=idx,
        )
        nbytes = item.image.nbytes
        if nbytes <= self._cache_left:
            # benign under concurrent decodes (GIL-atomic dict store; a
            # double decode just wastes one budget line)
            self._cache[idx] = item
            self._cache_left -= nbytes
        return item


class PrefetchLoader:
    """Threaded prefetcher: shuffled epochs, bounded readahead. Threads
    suffice because decode is in PIL/numpy C code (the GIL is released);
    the threads touch no device."""

    def __init__(self, dataset: ImagePoseDataset, shuffle: bool = True,
                 num_threads: int = 4, prefetch: int = 8, seed: int = 0,
                 loop: bool = True):
        self.dataset = dataset
        self.shuffle = shuffle
        self.loop = loop
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)

    def _index_stream(self) -> Iterator[int]:
        while True:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                self.rng.shuffle(order)
            yield from order.tolist()
            if not self.loop:
                return

    def __iter__(self) -> Iterator[DatasetItem]:
        from concurrent.futures import ThreadPoolExecutor

        q_out: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        index_iter = self._index_stream()
        ticket = threading.Semaphore(self.prefetch)
        stop = threading.Event()
        SENTINEL = object()

        # one ordering thread dispatches decodes to a bounded pool
        # (num_threads workers), keeping stream order through the pending
        # queue of futures; the `prefetch` semaphore bounds decoded but
        # unconsumed items
        pending: "queue.Queue" = queue.Queue()
        pool = ThreadPoolExecutor(max_workers=max(self.num_threads, 1),
                                  thread_name_prefix="dataset-decode")

        def decode(i):
            return self.dataset[i]

        def acquire_interruptible(sem):
            # a plain acquire() would block forever once the consumer
            # abandons the iterator (stop cannot interrupt it): poll
            while not stop.is_set():
                if sem.acquire(timeout=0.25):
                    return True
            return False

        def producer():
            while not stop.is_set():
                try:
                    idx = next(index_iter)
                except StopIteration:
                    pending.put(SENTINEL)
                    return
                if not acquire_interruptible(ticket):
                    return
                # the consumer's finally may shut the pool down between the
                # acquire above and this submit: the RuntimeError ("cannot
                # schedule new futures after shutdown") means stop
                if stop.is_set():
                    return
                try:
                    pending.put(pool.submit(decode, idx))
                except RuntimeError:
                    return

        def collector():
            while True:
                fut = pending.get()
                if fut is SENTINEL:
                    q_out.put(SENTINEL)
                    return
                try:
                    item = fut.result()
                except Exception as e:  # raised again in the consumer
                    item = e
                while not stop.is_set():
                    try:
                        q_out.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
                ticket.release()

        threading.Thread(target=producer, daemon=True).start()
        threading.Thread(target=collector, daemon=True).start()
        try:
            while True:
                item = q_out.get()
                if item is SENTINEL:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)


def downsample_item(item: DatasetItem, factor: float,
                    tile_size: int = 32) -> DatasetItem:
    """Progressive-resolution downsample of one item: box-average by an
    integer factor, then crop to a tile multiple; K scaled by 1/factor."""
    if factor == 1:
        return item
    f = int(factor)
    h, w, _ = item.image.shape
    h_f, w_f = (h // f), (w // f)
    img = item.image[: h_f * f, : w_f * f].reshape(h_f, f, w_f, f, 3)
    img = img.mean(axis=(1, 3))
    h_c = h_f - h_f % tile_size
    w_c = w_f - w_f % tile_size
    img = img[:h_c, :w_c]
    k = item.camera_info.camera_intrinsics.copy()
    k[0, :] /= f
    k[1, :] /= f
    info = CameraInfo(k, h_c, w_c, item.camera_info.camera_id)
    return DatasetItem(
        image=np.ascontiguousarray(img, np.float32),
        q_pointcloud_camera=item.q_pointcloud_camera,
        t_pointcloud_camera=item.t_pointcloud_camera,
        camera_info=info, index=item.index,
    )
