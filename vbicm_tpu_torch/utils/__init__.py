from .roofline import device_peaks, least_time_s, mfu_fields, share_fields
from .timing import Timer, benchmark_fn, card_line, profile_trace

__all__ = ["device_peaks", "least_time_s", "mfu_fields", "share_fields", "Timer", "benchmark_fn",
           "card_line", "profile_trace"]
