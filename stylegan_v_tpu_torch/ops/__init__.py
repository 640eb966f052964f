from .bias_act import activation_funcs, bias_act, leaky_relu  # noqa: F401
from .conv2d_resample import conv2d_resample  # noqa: F401
from .fir_kernels import (  # noqa: F401
    downfirdn2d_x2,
    downfirdn2d_x2_bwd,
    downfirdn2d_x2_bwd_plain,
    downfirdn2d_x2_plain,
)
from .grid_sample import (  # noqa: F401
    affine_grid_sample,
    affine_grid_sample_bwd_plain,
    affine_grid_sample_plain,
    affine_warp,
    affine_warp_bwd,
)
from .modulated_conv2d import modulated_conv2d  # noqa: F401
from .shear_warp import (  # noqa: F401
    shear_affine_grid_sample,
    shear_pass,
    shear_pass_plain,
    shear_resample_bwd,
    shear_resample_bwd_plain,
    shear_resample_plain,
    shear_shift,
    shear_shift_plain,
)
from .upfirdn2d import (  # noqa: F401
    downsample2d,
    filter2d,
    setup_filter,
    upfirdn2d,
    upsample2d,
)
from .upfirdn2d_kernel import upfirdn2d_k2, upfirdn2d_k2_plain  # noqa: F401
