# Model zoo (mirrors repro.models): the paper's GCN / GraphSAGE models
# (gcn_model.py, plus the flat weight stack of the stacked-core Trainer)
# and the five LM stack families serving the 10 assigned architectures
# (transformer/moe/mamba2/hybrid/encdec, unified by lm.py).
from .config import ArchConfig
from .gcn_model import (GCNConfig, accuracy, gcn_forward, gcn_loss,
                        init_gcn_params, init_params, pick_orders)
from . import lm

__all__ = ["ArchConfig", "GCNConfig", "accuracy", "gcn_forward", "gcn_loss",
           "init_gcn_params", "init_params", "pick_orders", "lm"]
