"""The LM stack of the port (``repro/models``): the config, the dense,
MoE (``moe.py``), RWKV-6 (``rwkv.py``) and Mamba-2 (``ssm.py``) blocks,
the training forward, loss and step, prefill and one-token decode, and
the weight converter."""
from .layers import KVCache, prefill_into_cache
from .lm import (LM, ModelConfig, active_param_count, forward,
                 init_decode_cache, init_params, loss_fn, make_prefill_step,
                 make_serve_step, make_train_step, model_flops_per_token,
                 param_count, value_and_grad)

__all__ = ["ModelConfig", "LM", "KVCache", "init_params", "forward",
           "loss_fn", "value_and_grad", "make_train_step",
           "make_prefill_step", "init_decode_cache", "make_serve_step",
           "prefill_into_cache", "param_count", "active_param_count",
           "model_flops_per_token"]
