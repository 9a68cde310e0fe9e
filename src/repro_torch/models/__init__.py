from .gcn_model import init_params

__all__ = ["init_params"]
