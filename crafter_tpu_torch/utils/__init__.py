from .profiling import (Timer, card_line, launches, tool_device, trace,
                        zero_launches)
