from qasr.utils.debug import checkify_fn, deterministic_mode, nan_debug
from qasr.utils.profiling import (
    DEVICE_PEAKS,
    DeviceSpec,
    conv_roofline,
    device_spec,
    qconv_flops,
    steady_state_time,
    trace,
)

__all__ = [
    "checkify_fn",
    "deterministic_mode",
    "nan_debug",
    "DEVICE_PEAKS",
    "DeviceSpec",
    "conv_roofline",
    "device_spec",
    "qconv_flops",
    "steady_state_time",
    "trace",
]
