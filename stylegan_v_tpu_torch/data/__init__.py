from .dataset import (  # noqa: F401
    Dataset,
    ImageFolderDataset,
    VideoFramesFolderDataset,
    load_image_from_buffer,
    read_binary_pnm,
    remove_root,
)
from .loader import DeviceLoader, TrainingDataLoader, infinite_indices  # noqa: F401
from .sampling import random_frame_sampling, sample_frames, uniform_frame_sampling  # noqa: F401
