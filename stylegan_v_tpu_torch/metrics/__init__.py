"""The metrics (FVD, FID, KID, IS, ISv) on the port's detectors and Generator:
counterpart of stylegan_v_tpu/metrics/, in one process or one replica a process."""
from . import metric_main  # noqa: F401
from .metric_utils import (  # noqa: F401
    FeatureStats,
    MetricOptions,
    register_detector,
)
