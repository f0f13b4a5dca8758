from .sage import ModelConfig, forward, init_params
from .convert import first_copy, params_from_jax

__all__ = ["ModelConfig", "forward", "init_params", "params_from_jax",
           "first_copy"]
