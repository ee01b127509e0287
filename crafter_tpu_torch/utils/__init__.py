from .profiling import (Collector, card_line, count, launches, set_sink,
                        span, tool_device, trace, zero_launches)
