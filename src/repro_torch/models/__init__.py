# Model zoo (mirrors repro.models): the GCN weights (gcn_model.py) and the
# LM stack (config.ArchConfig, the dense transformer, unified by lm.py;
# only the dense family is ported so far).
from .config import ArchConfig
from .gcn_model import init_params
from . import lm

__all__ = ["ArchConfig", "init_params", "lm"]
