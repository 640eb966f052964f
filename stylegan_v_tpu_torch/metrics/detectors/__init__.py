"""The metrics' feature extractors as torch modules: I3D (FVD), InceptionV3
(FID, KID, IS) and C3D (ISv), each with its features function."""
from .c3d import C3D, c3d_features_fn, load_c3d_state_dict  # noqa: F401
from .common import random_init_  # noqa: F401
from .i3d import InceptionI3d, i3d_features_fn, load_i3d_state_dict  # noqa: F401
from .inception_v3 import (InceptionV3, inception_features_fn,  # noqa: F401
                           load_inception_state_dict)
