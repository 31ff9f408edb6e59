from .checkpoint import load_params, save_params

__all__ = ["load_params", "save_params"]
