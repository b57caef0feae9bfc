from .complexity import count_params, estimate_macs, model_complexity
from .convert import from_flax, load_flax, to_flax
from .export import export_graph, export_weights_json, weight_dynamic_range
from .parse_logs import final_valid_losses, parse_log_file, parse_log_text
from .profiling import device_memory_stats, throughput, time_fn, time_fn_amortized, trace
from .tensorboard import MetricsWriter

__all__ = [
    "count_params",
    "estimate_macs",
    "model_complexity",
    "from_flax",
    "load_flax",
    "to_flax",
    "export_graph",
    "export_weights_json",
    "weight_dynamic_range",
    "final_valid_losses",
    "parse_log_file",
    "parse_log_text",
    "device_memory_stats",
    "throughput",
    "time_fn",
    "time_fn_amortized",
    "trace",
    "MetricsWriter",
]
