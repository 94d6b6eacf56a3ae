from finch_tpu_torch.utils.metrics import (Meter, get_meter, metrics_enabled,
                                           report, span, trace)

__all__ = ["Meter", "get_meter", "metrics_enabled", "report", "span",
           "trace"]
