"""The paper's fixed-point scheme: ap_fixed<W,I> quantization
(``fixed_point``) and post-training quantization with AUC profiling
(``ptq``)."""
from repro_torch.core.quant.fixed_point import (  # noqa: F401
    FixedPointConfig,
    fixed_point_error_bound,
    from_ints,
    grid_constants,
    is_native_int,
    native_bits,
    packed_weight_bytes,
    quantize,
    quantize_np,
    quantize_params,
    saturates,
    to_ints,
)
