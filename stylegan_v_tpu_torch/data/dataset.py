"""Frame datasets: flat image folders and depth-2 video-frame folders/zips.

Behavioral parity with reference src/training/dataset.py, adjusted for TPU:
  * images are returned HWC (NHWC pipeline) instead of CHW;
  * every stochastic choice takes an explicit RandomState (per-worker streams
    instead of the reference's global `random` module);
  * no torch dependency — plain Python iterables consumed by data/loader.py.

Layouts:
  ImageFolderDataset       — flat images in a dir or zip (reference dataset.py:174-256)
  VideoFramesFolderDataset — <root>/<video_dir>/<frame>.jpg depth-2 structure
                             in a dir or zip (reference dataset.py:260-452)
Labels: optional `dataset.json` with {"labels": [[fname, label], ...]};
int labels => one-hot at read time (reference dataset.py:115-121).

A copy of stylegan_v_tpu/data/dataset.py on the port's SamplingConfig, with
two changes that add no feature: Pillow is imported at first use, and binary
PPM/PGM frames (P6/P5 at maxval 255, already one of the formats) are read
with numpy wherever a frame is opened, the shape probe included, so a host
without Pillow can train from them. Every other format goes through Pillow.
tests/test_torch_data.py holds the items equal to the JAX package's.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.config import SamplingConfig
from .sampling import sample_frames

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff", ".ppm"}

NUMPY_INTEGER_TYPES = (np.int8, np.int16, np.int32, np.int64,
                       np.uint8, np.uint16, np.uint32, np.uint64)
NUMPY_FLOAT_TYPES = (np.float16, np.float32, np.float64)


def _file_ext(fname: str) -> str:
    return os.path.splitext(fname)[1].lower()


def read_binary_pnm(data: bytes) -> Optional[np.ndarray]:
    """A binary PPM (P6) or PGM (P5) at maxval 255 as HWC uint8, read with
    numpy; None for any other format or maxval, which Pillow then reads."""
    if data[:2] not in (b"P5", b"P6"):
        return None
    fields, pos = [], 2
    while len(fields) < 3:                      # width, height, maxval
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":           # a comment runs to the end of its line
            pos = data.find(b"\n", pos)
            if pos < 0:
                return None
            continue
        start = pos
        while data[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            return None
        fields.append(int(data[start:pos]))
    width, height, maxval = fields
    if maxval != 255:
        return None
    pos += 1                                    # the one whitespace byte after maxval
    channels = 3 if data[1:2] == b"6" else 1
    size = width * height * channels
    if len(data) - pos < size:
        raise ValueError(f"truncated PNM: {len(data) - pos} bytes of pixels, "
                         f"{width}x{height}x{channels} expected")
    return np.frombuffer(data, np.uint8, size, pos).reshape(height, width, channels).copy()


def load_image_from_buffer(f) -> np.ndarray:
    """Decode to HWC uint8 (reference dataset.py:456-465, minus the CHW transpose)."""
    data = f.read()
    image = read_binary_pnm(data)
    if image is not None:
        return image
    import PIL.Image
    image = np.array(PIL.Image.open(io.BytesIO(data)))
    if image.ndim == 2:
        image = image[:, :, np.newaxis]
    return image


def remove_root(fname: str, root_name: str) -> str:
    """Strip a leading root dir (reference dataset.py:485-493; tested by the
    reference's only pytest file, tests/test_data_utils.py)."""
    if fname == root_name or fname == "/" + root_name:
        return ""
    if fname.startswith(root_name + "/"):
        return fname[len(root_name) + 1:]
    return fname


class Dataset:
    """Base: max_size subsetting, xflip doubling, label handling
    (reference dataset.py:37-171)."""

    def __init__(self, name: str, raw_shape: List[int], max_size: Optional[int] = None,
                 use_labels: bool = False, xflip: bool = False, random_seed: int = 0):
        self._name = name
        self._raw_shape = list(raw_shape)      # [N, H, W, C]
        self._use_labels = use_labels
        self._raw_labels = None
        self._label_shape = None

        self._raw_idx = np.arange(self._raw_shape[0], dtype=np.int64)
        if max_size is not None and self._raw_idx.size > max_size:
            np.random.RandomState(random_seed).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])

        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip, np.ones_like(self._xflip)])

    # -- to be overridden --
    def close(self):
        pass

    def _load_raw_image(self, raw_idx: int) -> np.ndarray:
        raise NotImplementedError

    def _load_raw_labels(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def _get_raw_labels(self) -> np.ndarray:
        if self._raw_labels is None:
            self._raw_labels = self._load_raw_labels() if self._use_labels else None
            if self._raw_labels is None:
                self._raw_labels = np.zeros([self._raw_shape[0], 0], dtype=np.float32)
            assert self._raw_labels.shape[0] == self._raw_shape[0]
            assert self._raw_labels.dtype in (np.float32, np.int64)
        return self._raw_labels

    def __len__(self) -> int:
        return self._raw_idx.size

    def __getitem__(self, idx: int) -> Dict:
        image = self._load_raw_image(int(self._raw_idx[idx]))
        assert image.dtype == np.uint8
        if self._xflip[idx]:
            image = image[:, ::-1, :]          # HWC horizontal flip
        return {"image": np.ascontiguousarray(image), "label": self.get_label(idx)}

    def get_label(self, idx: int) -> np.ndarray:
        label = self._get_raw_labels()[self._raw_idx[idx]]
        if label.dtype == np.int64:
            onehot = np.zeros(self.label_shape, dtype=np.float32)
            onehot[label] = 1
            label = onehot
        return label.copy()

    @property
    def name(self):
        return self._name

    @property
    def image_shape(self):                      # [H, W, C]
        return list(self._raw_shape[1:])

    @property
    def num_channels(self):
        return self.image_shape[2]

    @property
    def resolution(self):
        assert self.image_shape[0] == self.image_shape[1]
        return self.image_shape[0]

    @property
    def label_shape(self):
        if self._label_shape is None:
            raw_labels = self._get_raw_labels()
            if raw_labels.dtype == np.int64:
                self._label_shape = [int(np.max(raw_labels)) + 1]
            else:
                self._label_shape = list(raw_labels.shape[1:])
        return list(self._label_shape)

    @property
    def label_dim(self):
        assert len(self.label_shape) == 1
        return self.label_shape[0]

    @property
    def has_labels(self):
        return any(x != 0 for x in self.label_shape)


class _ArchiveMixin:
    """Shared dir/zip access (reference dataset.py:203-224, 335-356)."""
    _path: str
    _type: str
    _zipfile = None

    def _get_zipfile(self):
        assert self._type == "zip"
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._path)
        return self._zipfile

    def _open_file(self, fname, root=None):
        if self._type == "dir":
            return open(os.path.join(root if root is not None else self._path, fname), "rb")
        return self._get_zipfile().open(fname, "r")

    def close(self):
        try:
            if self._zipfile is not None:
                self._zipfile.close()
        finally:
            self._zipfile = None


class ImageFolderDataset(_ArchiveMixin, Dataset):
    """Flat image dir/zip; used by FID via frames-as-images
    (reference dataset.py:174-256)."""

    def __init__(self, path: str, resolution: Optional[int] = None, **super_kwargs):
        self._path = path
        self._zipfile = None
        if os.path.isdir(path):
            self._type = "dir"
            self._all_fnames = {
                os.path.relpath(os.path.join(root, f), start=path)
                for root, _dirs, files in os.walk(path) for f in files}
        elif _file_ext(path) == ".zip":
            self._type = "zip"
            self._all_fnames = set(self._get_zipfile().namelist())
        else:
            raise IOError("Path must point to a directory or zip")

        self._image_fnames = sorted(f for f in self._all_fnames if _file_ext(f) in _IMG_EXTS)
        if not self._image_fnames:
            raise IOError("No image files found in the specified path")

        name = os.path.splitext(os.path.basename(path))[0]
        raw_shape = [len(self._image_fnames)] + list(self._load_raw_image(0).shape)
        if resolution is not None and (raw_shape[1] != resolution or raw_shape[2] != resolution):
            raise IOError(f"Images do not match resolution {resolution}: {raw_shape}")
        super().__init__(name=name, raw_shape=raw_shape, **super_kwargs)

    def _load_raw_image(self, raw_idx: int) -> np.ndarray:
        with self._open_file(self._image_fnames[raw_idx]) as f:
            return load_image_from_buffer(f)

    def _load_raw_labels(self):
        labels_files = [f for f in self._all_fnames if f.endswith("dataset.json")]
        if not labels_files:
            return None
        with self._open_file(labels_files[0]) as f:
            labels = json.load(f)["labels"]
        if labels is None:
            return None
        labels = dict(labels)
        labels = [labels[remove_root(f, self._name).replace("\\", "/")]
                  for f in self._image_fnames]
        labels = np.array(labels)
        if labels.dtype in NUMPY_INTEGER_TYPES:
            return labels.astype(np.int64)
        if labels.dtype in NUMPY_FLOAT_TYPES:
            return labels.astype(np.float32)
        raise NotImplementedError(f"Unsupported label dtype: {labels.dtype}")


class VideoFramesFolderDataset(_ArchiveMixin, Dataset):
    """The main dataset: depth-2 video_dir/frame layout, sparse sampling in
    training mode, consecutive loading in eval mode (reference dataset.py:260-452).

    __getitem__ returns {'image': [F, H, W, C] u8, 'label', 'times': frame
    indices relative to the sampling window, 'video_len'}.
    """

    def __init__(self, path: str, sampling: Optional[SamplingConfig] = None,
                 max_num_frames: int = 1024, resolution=None,
                 load_n_consecutive: Optional[int] = None,
                 load_n_consecutive_random_offset: bool = True,
                 subsample_factor: int = 1, discard_short_videos: bool = False,
                 seed: int = 0, **super_kwargs):
        self.sampling = sampling
        self.max_num_frames = max_num_frames
        self._path = path
        self._zipfile = None
        self.load_n_consecutive = load_n_consecutive
        self.load_n_consecutive_random_offset = load_n_consecutive_random_offset
        self.subsample_factor = subsample_factor
        self.discard_short_videos = discard_short_videos
        self._seed = seed
        self._rng = np.random.RandomState(seed)

        if subsample_factor > 1 and load_n_consecutive is None:
            raise NotImplementedError(
                "Can do subsampling only when loading consecutive frames.")

        name = os.path.splitext(os.path.basename(path))[0]
        if os.path.isdir(path):
            self._type = "dir"
            self._root = os.path.dirname(path)
            base = os.path.basename(path)
            video_dirs = sorted(d for d in os.listdir(path)
                                if os.path.isdir(os.path.join(path, d)))
            self._video_dir2frames = {}
            for d in video_dirs:
                frames = sorted(
                    os.path.join(base, d, f)
                    for f in os.listdir(os.path.join(path, d))
                    if _file_ext(f) in _IMG_EXTS)
                if frames:
                    self._video_dir2frames[os.path.join(base, d)] = frames
            self._all_objects = {o for fs in self._video_dir2frames.values() for o in fs}
            for extra in os.listdir(path):
                if extra.endswith(".json"):
                    self._all_objects.add(os.path.join(base, extra))
        elif _file_ext(path) == ".zip":
            self._type = "zip"
            self._root = None
            self._all_objects = set(self._get_zipfile().namelist())
            self._video_dir2frames = {}
            for o in sorted(self._all_objects):
                if _file_ext(o) not in _IMG_EXTS:
                    continue
                d = os.path.dirname(o)
                assert d, f"Frame {o} must live inside a video directory"
                self._video_dir2frames.setdefault(d, []).append(o)
            for d in self._video_dir2frames:
                self._video_dir2frames[d] = sorted(self._video_dir2frames[d])
        else:
            raise IOError("Path must be either a directory or point to a zip archive")

        num_before_discard = len(self._video_dir2frames)
        if discard_short_videos:
            need = (load_n_consecutive or 1) * subsample_factor
            self._video_dir2frames = {
                d: fs for d, fs in self._video_dir2frames.items() if len(fs) >= need}

        self._video_idx2frames = list(self._video_dir2frames.values())
        if not self._video_idx2frames:
            if num_before_discard:
                raise IOError(
                    f"All {num_before_discard} videos are shorter than the "
                    f"required {(load_n_consecutive or 1) * subsample_factor} "
                    f"frames (load_n_consecutive={load_n_consecutive}, "
                    f"subsample_factor={subsample_factor})")
            raise IOError("No videos found in the specified archive")

        raw_shape = ([len(self._video_idx2frames)]
                     + list(self._load_raw_frames(0, np.array([0]))[0][0].shape))
        super().__init__(name=name, raw_shape=raw_shape, **super_kwargs)

    def _open_frame(self, fname):
        return self._open_file(fname, root=self._root)

    def _load_raw_labels(self):
        labels_files = [f for f in self._all_objects if f.endswith("dataset.json")]
        if not labels_files:
            return None
        with self._open_frame(sorted(labels_files)[0]) as f:
            labels = json.load(f)["labels"]
        if labels is None:
            return None
        labels = dict(labels)
        # per-frame labels -> per-video labels (reference dataset.py:374-385)
        video_labels = {}
        for filename, label in labels.items():
            dirname = os.path.dirname(filename)
            if dirname in video_labels:
                assert video_labels[dirname] == label
            else:
                video_labels[dirname] = label
        labels = [video_labels[os.path.normpath(d).split(os.path.sep)[-1]]
                  for d in self._video_dir2frames]
        labels = np.array(labels)
        if labels.dtype in NUMPY_INTEGER_TYPES:
            return labels.astype(np.int64)
        if labels.dtype in NUMPY_FLOAT_TYPES:
            return labels.astype(np.float32)
        raise NotImplementedError(f"Unsupported label dtype: {labels.dtype}")

    def __getitem__(self, idx: int) -> Dict:
        if self.load_n_consecutive:
            avail = len(self._video_idx2frames[self._raw_idx[idx]])
            span = self.load_n_consecutive * self.subsample_factor
            assert avail - span >= 0, (
                f"Only {avail} frames available, cannot load {self.load_n_consecutive}")
            if self.load_n_consecutive_random_offset:
                # per-ITEM deterministic offset (seeded by raw index): eval
                # stats are independent of read order, so replica-striped
                # extraction merges to exactly the serial result and cached
                # stats are reproducible (unlike the reference's global-RNG
                # offsets, dataset.py:398-408).
                item_rng = np.random.RandomState(
                    [self._seed, int(self._raw_idx[idx])])
                offset = item_rng.randint(0, avail - span + self.subsample_factor)
            else:
                offset = 0
            frames_idx = np.arange(0, span, self.subsample_factor) + offset
        else:
            frames_idx = None

        frames, times = self._load_raw_frames(int(self._raw_idx[idx]), frames_idx)
        assert frames.dtype == np.uint8
        if self._xflip[idx]:
            frames = frames[:, :, ::-1, :]      # FHWC horizontal flip
        return {
            "image": np.ascontiguousarray(frames),
            "label": self.get_label(idx),
            "times": times,
            "video_len": self.get_video_len(idx),
        }

    def get_video_len(self, idx: int) -> int:
        return min(self.max_num_frames, len(self._video_idx2frames[self._raw_idx[idx]]))

    def _load_raw_frames(self, raw_idx: int, frames_idx: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse sampling with a random window offset when the video exceeds
        max_num_frames (reference dataset.py:431-449)."""
        frame_paths = self._video_idx2frames[raw_idx]
        total_len = len(frame_paths)
        offset = 0
        if frames_idx is None:
            assert self.sampling is not None, (
                "Dataset created without a sampling config cannot sample frames")
            if total_len > self.max_num_frames:
                offset = self._rng.randint(0, total_len - self.max_num_frames + 1)
            frames_idx = sample_frames(
                self.sampling, total_video_len=min(total_len, self.max_num_frames),
                rng=self._rng) + offset
        frames_idx = np.round(np.asarray(frames_idx)).astype(np.int64)
        paths = [frame_paths[int(fi)] for fi in frames_idx]

        # Native C++ batch decode (GIL-free thread pool) when all frames are
        # JPEG and the target shape is known; PIL otherwise. Only profitable
        # on multi-core hosts (TPU VMs have many cores; PIL's SIMD
        # libjpeg-turbo wins single-core) — override with SGV_FORCE_NATIVE_JPEG.
        native_ok = (os.cpu_count() or 1) >= 4 or os.environ.get(
            "SGV_FORCE_NATIVE_JPEG")
        if (native_ok and getattr(self, "_raw_shape", None) is not None
                and all(_file_ext(p) in (".jpg", ".jpeg") for p in paths)):
            from ..native import fastjpeg
            if fastjpeg.is_available():
                bufs = []
                for p in paths:
                    with self._open_frame(p) as f:
                        bufs.append(f.read())
                H, W, C = self.image_shape
                try:
                    return (fastjpeg.decode_jpeg_batch(bufs, H, W, C),
                            frames_idx - offset)
                except (ValueError, RuntimeError):
                    pass        # corrupt / mismatched: fall back to PIL below

        images = []
        for p in paths:
            with self._open_frame(p) as f:
                images.append(load_image_from_buffer(f))
        return np.stack(images), frames_idx - offset

    def compute_max_num_frames(self) -> int:
        return max(len(fs) for fs in self._video_idx2frames)
