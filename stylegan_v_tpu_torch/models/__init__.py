from .config import (  # noqa: F401
    DiscriminatorConfig,
    GeneratorConfig,
    MotionConfig,
    SamplingConfig,
    TimeEncConfig,
)
from .discriminator import Discriminator  # noqa: F401
from .generator import Generator, SynthesisNetwork  # noqa: F401
from .motion import AlignedTimeEncoder, MotionMappingNetwork  # noqa: F401
from .mocogan import (MoCoGANDiscriminator, MoCoGANVideoDiscriminator,  # noqa: F401
                      SubVideoDiscriminator, VideoDiscriminator)
