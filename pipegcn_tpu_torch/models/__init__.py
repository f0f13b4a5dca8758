from .sage import ModelConfig, forward, init_params
from .convert import params_from_jax

__all__ = ["ModelConfig", "forward", "init_params", "params_from_jax"]
