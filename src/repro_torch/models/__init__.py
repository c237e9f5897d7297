"""The LM stack of the port (``repro/models``): the config, the dense
blocks, prefill and one-token decode, and the weight converter."""
from .layers import KVCache, prefill_into_cache
from .lm import (LM, ModelConfig, active_param_count, forward,
                 init_decode_cache, init_params, make_prefill_step,
                 make_serve_step, model_flops_per_token, param_count)

__all__ = ["ModelConfig", "LM", "KVCache", "init_params", "forward",
           "make_prefill_step", "init_decode_cache", "make_serve_step",
           "prefill_into_cache", "param_count", "active_param_count",
           "model_flops_per_token"]
