from .profiling import Timer, trace
